"""Build and EXECUTE the tutorial notebook (docs/Introduction_to_pycsou_tpu.ipynb).

The reference's onboarding artifact is a 65-cell executed notebook
(/root/reference/Introduction to Pycsou.ipynb).  This script assembles the
same narrative arc — operators -> functional calculus -> solve -> scaling ->
Bayesian uncertainty — as nbformat cells and runs them through nbclient on
the forced 8-device CPU mesh, so the committed .ipynb carries real outputs:

    python docs/make_notebook.py
"""
import os
import pathlib

import nbformat as nbf
from nbclient import NotebookClient

OUT = pathlib.Path(__file__).resolve().parent / "Introduction_to_pycsou_tpu.ipynb"
ROOT = pathlib.Path(__file__).resolve().parent.parent

MD = lambda s: nbf.v4.new_markdown_cell(s.strip())
CODE = lambda s: nbf.v4.new_code_cell(s.strip())

cells = [
    MD("""
# Introduction to pycsou_tpu

`pycsou_tpu` is a JAX framework for solving **convex inverse
problems** — the capabilities of [Pycsou](https://github.com/dhamm97/pycsou)
re-designed around JAX/XLA.  This notebook walks the
same arc as the reference's introduction notebook:

1. matrix-free **linear operators** and their algebra,
2. **functionals** with automatic gradient/prox calculus,
3. composing and **solving** a TV-regularised deconvolution with
   primal-dual splitting (and how the expression recognizer fuses it),
4. **scaling out** over a device mesh without changing the expression,
5. **Bayesian uncertainty quantification** with proximal MCMC.

Everything below runs on a virtual 8-device CPU mesh; on a GPU the same
code runs unchanged (measurements in `PERF.md`).
"""),
    CODE("""
import os
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
import sys, pathlib
sys.path.insert(0, str(pathlib.Path.cwd().parent))
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

print("devices:", jax.device_count())
"""),
    MD("""
## 1. A measurement model from matrix-free operators

The ground truth is a piecewise-constant image; the instrument blurs it
with a Gaussian point-spread function and adds noise.  `Convolve2D` is a
**matrix-free** `LinearOperator`: `apply`/`adjoint` are jitted XLA
computations, and `A.lipschitz` is a tight spectral bound computed at
construction.
"""),
    CODE("""
from pycsou_tpu.ops.conv import Convolve2D
from pycsou_tpu.ops.diff import Gradient

rng = np.random.default_rng(0)
shape = (64, 64)
x_true = np.zeros(shape, np.float32)
x_true[16:48, 16:48] = 1.0
x_true[24:40, 24:40] = 2.0
k = np.arange(9) - 4
g = np.exp(-(k**2) / (2 * 1.5**2))
psf = (np.outer(g, g) / np.outer(g, g).sum()).astype(np.float32)

A = Convolve2D(shape, psf)          # the blur
K = Gradient(shape)                 # finite-difference gradient (for TV)
y = A(jnp.asarray(x_true)) + 0.02 * jnp.asarray(rng.standard_normal(shape), jnp.float32)
print("A:", A.dim_shape, "->", A.codim_shape, " lipschitz:", round(float(A.lipschitz), 4))
print("adjoint consistency <Ax, y> == <x, A^H y>:",
      bool(jnp.allclose(jnp.vdot(A(y), y), jnp.vdot(y, A.adjoint(y)), rtol=1e-4)))
"""),
    MD("""
Operators compose with ordinary arithmetic — sums, scalings, products —
and every composite stays matrix-free with propagated Lipschitz constants:
"""),
    CODE("""
B = 2.0 * A @ A + 0.5 * A.T   # still a matrix-free LinearOperator
print(type(B).__name__, "lipschitz ≤", round(float(B.lipschitz), 4))
print("gram of A is the fused exact A^H A:", type(A.gram).__name__)
"""),
    MD("""
## 2. Functionals and automatic gradient/prox calculus

The objective is

$$\\min_x \\;\\|A x - y\\|_2^2 \\;+\\; \\lambda \\|\\nabla x\\|_{2,1}
\\;+\\; \\imath_{x \\ge 0}(x).$$

`SquaredL2Loss * A` composes to a `LeastSquaresLoss` whose gradient routes
through the fused Gram; `0.05 * L21Norm` keeps a closed-form prox through
the scaling rule.
"""),
    CODE("""
from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
from pycsou_tpu.func.penalty import L21Norm

F = SquaredL2Loss(shape, data=y) * A
G = NonNegativeOrthant(shape)
H = 0.05 * L21Norm((2,) + shape, axis=0)
print(type(F).__name__, " diff_lipschitz:", round(float(F.diff_lipschitz), 4),
      "== 2||A||^2:", bool(np.isclose(F.diff_lipschitz, 2 * A.lipschitz**2)))
"""),
    MD("""
## 3. Solve with Condat–Vũ primal–dual splitting

`PDS` auto-tunes the step sizes from the reference's closed-form rules.
On construction it also **pattern-matches the expression tree**: this
(F, G, H, K) configuration is recognised as TV deconvolution and the
iteration is delegated to the hand-fused solver — same iterates, with the
data gradient through the fused convolution Gram.
"""),
    CODE("""
from pycsou_tpu.opt import PDS

solver = PDS(shape, F=F, G=G, H=H, K=K, max_iter=1000, accuracy_threshold=1e-5)
print("fused realisation:", type(solver._fused).__name__)
info = solver.solve()
x_hat = np.asarray(info["x"])
err_blur = np.linalg.norm(np.asarray(y) - x_true) / np.linalg.norm(x_true)
err_rec = np.linalg.norm(x_hat - x_true) / np.linalg.norm(x_true)
print(f"converged={info.converged} after {info.n_iter} iterations")
print(f"relative error: blurred {err_blur:.3f} -> reconstructed {err_rec:.3f}")
print("per-variable diagnostics:", sorted(info.diagnostics))
"""),
    MD("""
Other reference patterns fuse too: anisotropic TV (`L1Norm` over the
gradient field), inpainting (`SquaredL2Loss * Masking`), LASSO
(`APGD`/FISTA), and plain proximal gradient (`FBS` at `rho=1`):
"""),
    CODE("""
from pycsou_tpu.func.penalty import L1Norm
from pycsou_tpu.ops.sampling import Masking

aniso = PDS(shape, F=F, G=G, H=0.05 * L1Norm((2,) + shape), K=K, max_iter=200)
keep = rng.random(shape) < 0.5
M = Masking(shape, keep)
inpaint = PDS(shape, F=SquaredL2Loss(M.codim_shape, data=M(y)) * M,
              H=0.05 * L21Norm((2,) + shape, axis=0), K=K, max_iter=200)
print("anisotropic ->", type(aniso._fused).__name__, "(iso =", aniso._fused.iso, ")")
print("inpainting  ->", type(inpaint._fused).__name__,
      "(diagonal Gram:", inpaint._fused.mask is not None, ")")
"""),
    MD("""
## 4. Scale out: same expression, device mesh

`with_shardings` turns the solve into an SPMD program over a mesh.  When
the fused TV pattern matched AND the requested partition is spatial, the
solve re-dispatches onto the hand-written distributed solver
(`DistributedTVDeconv2D`: ppermute halo exchange, fused Gram per
shard); anything else runs through XLA's GSPMD partitioner.  Iterates
are identical either way.
"""),
    CODE("""
from jax.sharding import NamedSharding, PartitionSpec as P
from pycsou_tpu.parallel import make_mesh

mesh = make_mesh(axis_names=("sp",))
sharded = solver.with_shardings(
    x=NamedSharding(mesh, P("sp", None)),
    z=NamedSharding(mesh, P(None, "sp", None)),
)
print("sharded delegate:", type(sharded._fused).__name__)
info_sp = sharded.solve()
print("sharded == single-device:",
      bool(np.allclose(np.asarray(info_sp["x"]), x_hat, atol=1e-4)))
print("state sharded over", len(info_sp["x"].sharding.device_set), "devices")
"""),
    MD("""
## 5. Bayesian uncertainty quantification (proximal MCMC)

`PMYULA` samples the posterior `exp(-F(x) - G(x))` with a Moreau–Yosida
unadjusted Langevin chain, streaming the MMSE estimate, pointwise
standard deviation and P² quantiles on device, inside one jitted loop.
"""),
    CODE("""
from pycsou_tpu.opt import PMYULA

mc = PMYULA(shape, F=F, G=G, max_iter=1500, nb_burnin_iterations=300,
            thinning_factor=5, pvalues=(0.05, 0.95), accuracy_threshold=0.0)
post = mc.solve().iterand
print("samples:", int(post["n_samples"]))
print("posterior mean std:", round(float(np.mean(np.asarray(post["std"]))), 4))
q05, q95 = post["quantiles"][0.05], post["quantiles"][0.95]
inside = np.mean((np.asarray(q05) <= x_true) & (x_true <= np.asarray(q95)))
print(f"90% credible band covers {100 * inside:.0f}% of the truth")
"""),
    MD("""
## Where to go next

* `docs/TUTORIAL.md` — this walkthrough in prose.
* `docs/THEORY.md` — the mathematical background (proximal calculus,
  primal-dual splitting, Moreau envelopes).
* `docs/EXTENDING.md` — writing your own operators/functionals (the
  reference's plugin pattern).
* `PERF.md` — measurements on the card and their method.
* `examples/` — runnable configurations for every benchmark problem.
"""),
]


def main():
    nb = nbf.v4.new_notebook(
        cells=cells,
        metadata={
            "kernelspec": {"name": "python3", "display_name": "Python 3", "language": "python"},
            "language_info": {"name": "python"},
        },
    )
    client = NotebookClient(nb, timeout=1200, kernel_name="python3",
                            resources={"metadata": {"path": str(ROOT / "docs")}})
    client.execute()
    nbf.write(nb, OUT)
    n_out = sum(1 for c in nb.cells if c.cell_type == "code" and c.get("outputs"))
    print(f"wrote {OUT.name}: {len(nb.cells)} cells, {n_out} executed with outputs")


if __name__ == "__main__":
    main()

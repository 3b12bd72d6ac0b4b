"""Executable companion of docs/TUTORIAL.md — the reference notebook's arc
(operators -> functionals -> solve -> uncertainty) end to end.
Run: python examples/tutorial.py
"""
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def main():
    rng = np.random.default_rng(0)
    shape = (64, 64)
    x_true = np.zeros(shape, np.float32)
    x_true[16:48, 16:48] = 1.0
    x_true[24:40, 24:40] = 2.0
    k = np.arange(9) - 4
    g = np.exp(-(k**2) / (2 * 1.5**2))
    psf = (np.outer(g, g) / np.outer(g, g).sum()).astype(np.float32)

    # -- operators ----------------------------------------------------------
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.ops.diff import Gradient

    A = Convolve2D(shape, psf)
    K = Gradient(shape)
    y = A(jnp.asarray(x_true)) + 0.02 * jnp.asarray(rng.standard_normal(shape), jnp.float32)

    # -- functionals (automatic gradient/prox rules) -------------------------
    from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu.func.penalty import L21Norm

    F = SquaredL2Loss(shape, data=y) * A
    G = NonNegativeOrthant(shape)
    H = 0.05 * L21Norm((2,) + shape, axis=0)
    assert np.isclose(F.diff_lipschitz, 2 * A.lipschitz**2)

    # -- solve ----------------------------------------------------------------
    from pycsou_tpu.opt import PDS

    solver = PDS(shape, F=F, G=G, H=H, K=K, max_iter=1000, accuracy_threshold=1e-5)
    info = solver.solve()
    x_hat = np.asarray(info["x"])
    err_blur = np.linalg.norm(np.asarray(y) - x_true) / np.linalg.norm(x_true)
    err_rec = np.linalg.norm(x_hat - x_true) / np.linalg.norm(x_true)
    assert "z" in info.diagnostics  # dual trajectory recorded

    # -- scale out (generic SPMD over the mesh) ------------------------------
    from pycsou_tpu.parallel import make_mesh

    if jax.device_count() > 1:
        mesh = make_mesh(axis_names=("sp",))
        sharded = solver.with_shardings(
            x=NamedSharding(mesh, P("sp", None)),
            z=NamedSharding(mesh, P(None, "sp", None)),
        )
        info_sp = sharded.solve()
        assert np.allclose(np.asarray(info_sp["x"]), x_hat, atol=1e-4)

    # -- uncertainty quantification ------------------------------------------
    from pycsou_tpu.opt import PMYULA

    mc = PMYULA(
        shape, F=F, G=G, max_iter=1500, nb_burnin_iterations=300, thinning_factor=5,
        pvalues=(0.05, 0.95), accuracy_threshold=0.0,
    )
    post = mc.solve().iterand
    std_mean = float(np.mean(np.asarray(post["std"])))

    print(
        f"converged={info.converged} iters={info.n_iter} "
        f"blur_err={err_blur:.3f} -> rec_err={err_rec:.3f}; "
        f"posterior mean std={std_mean:.4f}"
    )


if __name__ == "__main__":
    main()

"""TV inpainting + anisotropic variant (sampling-operator data terms).

``min_x ||M x - y||^2 + lam ||grad x||_{2,1} (+ i_{x>=0})`` where M keeps a
random 40% of the pixels — the reference's Masking data term
(sampling.py:125-196) under a TV prior.  The expression matcher recognises
``SquaredL2Loss * Masking`` and rewrites the solve onto TVDeconvolution's
diagonal-Gram mode (elementwise data gradient, one fused pass per
iteration).  The anisotropic flavour (``lam * L1Norm o Gradient`` — the
reference's own PDS doc example, proxalgs.py:91-119) rides the same path.

Run: python examples/inpainting_tv.py
"""
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import jax.numpy as jnp

from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
from pycsou_tpu.func.penalty import L1Norm, L21Norm
from pycsou_tpu.ops.diff import Gradient
from pycsou_tpu.ops.sampling import Masking
from pycsou_tpu.opt import PDS
from pycsou_tpu.utils.misc import peaks


def psnr(a, b):
    rng_v = float(np.max(b) - np.min(b))
    return 20 * np.log10(rng_v / np.sqrt(np.mean((a - b) ** 2)))


def main():
    rng = np.random.default_rng(0)
    n = 256
    g = np.linspace(-3, 3, n)
    xx, yy = np.meshgrid(g, g)
    x_true = np.array(
        peaks(jnp.asarray(xx, jnp.float32), jnp.asarray(yy, jnp.float32)), np.float32
    )
    x_true -= x_true.min()  # nonnegative ground truth

    keep = rng.random((n, n)) < 0.4
    M = Masking((n, n), keep)
    y = M(jnp.asarray(x_true)) + 0.02 * jnp.asarray(
        rng.standard_normal(int(keep.sum())), jnp.float32
    )
    zero_fill = np.asarray(M.adjoint(y))

    results = {}
    for name, H in [
        ("isotropic", 0.02 * L21Norm((2, n, n), axis=0)),
        ("anisotropic", 0.02 * L1Norm((2, n, n))),
    ]:
        solver = PDS(
            (n, n), F=SquaredL2Loss(M.codim_shape, data=y) * M,
            G=NonNegativeOrthant((n, n)), H=H, K=Gradient((n, n)),
            max_iter=4000, accuracy_threshold=1e-5,
        )
        assert solver._fused is not None and solver._fused.mask is not None
        info = solver.solve()
        results[name] = np.asarray(info["x"])
        print(
            f"{name}: fused={type(solver._fused).__name__} iso={solver._fused.iso} "
            f"iters={info.n_iter} converged={info.converged}"
        )

    p0 = psnr(zero_fill, x_true)
    p_iso = psnr(results["isotropic"], x_true)
    p_ani = psnr(results["anisotropic"], x_true)
    print(
        f"PSNR zero-filled={p0:.2f} dB -> inpainted iso={p_iso:.2f} dB / "
        f"aniso={p_ani:.2f} dB (40% pixels observed)"
    )
    assert p_iso > p0 + 6 and p_ani > p0 + 6


if __name__ == "__main__":
    main()

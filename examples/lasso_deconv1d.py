"""LASSO 1-D deconvolution (BASELINE config 1).

Sparse spike recovery: ``min_x ||h * x - y||^2 + lam ||x||_1`` solved with
APGD/FISTA — the reference's flagship example (proxalgs.py:91-119).
Run: python examples/lasso_deconv1d.py
"""
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import jax.numpy as jnp

from pycsou_tpu.func import L1Norm, SquaredL2Loss
from pycsou_tpu.ops.conv import Convolve1D
from pycsou_tpu.opt import APGD


def main():
    rng = np.random.default_rng(0)
    n = 256
    # sparse spikes
    x_true = np.zeros(n, np.float32)
    idx = rng.choice(n, 12, replace=False)
    x_true[idx] = rng.standard_normal(12).astype(np.float32) * 2

    # Gaussian blur kernel
    t = np.arange(-10, 11)
    h = np.exp(-(t**2) / 8).astype(np.float32)
    h /= h.sum()

    A = Convolve1D((n,), h)  # exact ||A|| known from max|FFT(h)|
    y = A(jnp.asarray(x_true)) + 0.01 * jnp.asarray(rng.standard_normal(n), jnp.float32)

    lam = 0.005
    F = SquaredL2Loss((n,), data=y) * A  # beta = 2||A||^2 auto-propagated
    G = lam * L1Norm((n,))

    solver = APGD((n,), F=F, G=G, acceleration="CD", max_iter=2000, accuracy_threshold=1e-7, verbose=200)
    info = solver.solve()
    x_rec = np.asarray(info["x_temp"])

    err = np.linalg.norm(x_rec - x_true) / np.linalg.norm(x_true)
    print(f"converged={info.converged} iters={info.n_iter} rel_err={err:.3f}")
    print(f"support recovered: {np.sum((np.abs(x_rec) > 0.05) & (np.abs(x_true) > 0))}/{len(idx)}")


if __name__ == "__main__":
    main()

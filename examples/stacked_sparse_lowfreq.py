"""Stacked-operator sparse + low-frequency recovery (BASELINE config 4).

Measurements y = VStack(Masking, DCT-lowpass) x of a DCT-sparse signal;
recovery ``min_x ||K x - y||^2 + lam ||DCT x||_1`` where the penalty prox is
exact through the *unitary precomposition rule*
(/root/reference/pycsou/core/functional.py:302-313) and the stack's operator
norm comes from on-device power iteration.
Run: python examples/stacked_sparse_lowfreq.py
"""
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import jax.numpy as jnp

from pycsou_tpu.func import L1Norm, SquaredL2Loss
from pycsou_tpu.ops import DCTOperator, IDCTOperator, Masking, SubSampling
from pycsou_tpu.ops.stack import LinOpVStack
from pycsou_tpu.opt import APGD


def main():
    rng = np.random.default_rng(0)
    n = 512
    # signal sparse in the DCT domain (random cosine mixture)
    c_true = np.zeros(n, np.float32)
    c_true[rng.choice(200, 20, replace=False)] = rng.standard_normal(20).astype(np.float32)
    dct = DCTOperator((n,))
    x_true = dct.adjoint(jnp.asarray(c_true))

    mask = rng.uniform(size=n) < 0.3
    M = Masking((n,), mask)  # random time-domain samples
    P = SubSampling((n,), np.arange(32))  # low-frequency band
    low = P * dct

    K = LinOpVStack([M, low])
    K.compute_lipschitz_cst()  # on-device power iteration (auto step size)

    y = K(x_true)
    y = y + 0.005 * jnp.asarray(rng.standard_normal(y.shape), jnp.float32)

    F = SquaredL2Loss(K.codim_shape, data=y) * K
    G = 0.01 * (L1Norm((n,)) * dct)  # prox via unitary rule: U^H soft(U x)
    solver = APGD((n,), F=F, G=G, max_iter=4000, accuracy_threshold=1e-9, verbose=1000)
    info = solver.solve()
    x = np.asarray(info["x_temp"])
    rel = np.linalg.norm(x - np.asarray(x_true)) / np.linalg.norm(np.asarray(x_true))
    print(f"||K||={K.lipschitz:.3f} iters={info.n_iter} rel err={rel:.3f}")


if __name__ == "__main__":
    main()

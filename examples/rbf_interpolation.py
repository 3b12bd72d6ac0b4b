"""Scattered-data RBF interpolation with Green-function kernels.

Fit ``f(t) = sum_j a_j phi(|t - t_j|)`` to noisy scattered samples by ridge
regression on a ``MappedDistanceMatrix`` operator with a Matern kernel —
the reference's kernel-matrix workflow (sampling.py:772+, math/green.py).
Run: python examples/rbf_interpolation.py
"""
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import jax.numpy as jnp

from pycsou_tpu.func import SquaredL2Loss
from pycsou_tpu.func.penalty import SquaredL2Norm
from pycsou_tpu.math import Matern
from pycsou_tpu.ops.sampling import MappedDistanceMatrix
from pycsou_tpu.opt import APGD


def main():
    rng = np.random.default_rng(0)
    n_samples, n_centers = 120, 60
    t_obs = np.sort(rng.uniform(0, 1, n_samples)).astype(np.float32)
    f_true = lambda t: np.sin(6 * np.pi * t) * np.exp(-t)
    y = jnp.asarray(f_true(t_obs) + 0.05 * rng.standard_normal(n_samples).astype(np.float32))

    centers = np.linspace(0, 1, n_centers).astype(np.float32)
    K = MappedDistanceMatrix(t_obs, centers, Matern(k=2, epsilon=0.08))
    K.compute_lipschitz_cst()

    # ridge-regularised fit: min_a ||K a - y||^2 + mu ||a||^2
    F = SquaredL2Loss((n_samples,), data=y) * K
    G = 0.05 * SquaredL2Norm((n_centers,))
    info = APGD((n_centers,), F=F, G=G, max_iter=2000, accuracy_threshold=1e-8).solve()
    a = info["x_temp"]

    # evaluate on a dense grid through a second kernel operator
    t_grid = np.linspace(0, 1, 512).astype(np.float32)
    K_grid = MappedDistanceMatrix(t_grid, centers, Matern(k=2, epsilon=0.08))
    f_hat = np.asarray(K_grid(a))
    rel = np.linalg.norm(f_hat - f_true(t_grid)) / np.linalg.norm(f_true(t_grid))
    print(f"||K||={K.lipschitz:.2f} iters={info.n_iter} interpolation rel err={rel:.3f}")


def main_large():
    """Compact-support Wendland fit at a size the dense backend cannot hold:
    50k x 50k kernel matrix would be 10 GB dense; the sparse backend stores
    only the ~30 in-support neighbours per point (reference
    sampling.py:975-1019 workflow, on-device gather/segment_sum apply)."""
    from pycsou_tpu.math.green import Wendland

    rng = np.random.default_rng(1)
    n = 50_000
    pts = rng.uniform(size=(n, 2)).astype(np.float32)
    f_true = lambda p: np.sin(4 * np.pi * p[:, 0]) * np.cos(3 * np.pi * p[:, 1])
    y = jnp.asarray(f_true(pts) + 0.02 * rng.standard_normal(n).astype(np.float32))

    K = MappedDistanceMatrix(pts, pts, Wendland(k=2, epsilon=0.02), backend="sparse")
    kmax = K._nbr_idx.shape[1]
    K.compute_lipschitz_cst(maxiter=32)

    F = SquaredL2Loss((n,), data=y) * K
    G = 1e-3 * SquaredL2Norm((n,))
    info = APGD((n,), F=F, G=G, max_iter=200, accuracy_threshold=1e-6).solve()
    f_hat = np.asarray(K(info["x_temp"]))
    rel = np.linalg.norm(f_hat - f_true(pts)) / np.linalg.norm(f_true(pts))
    print(
        f"sparse MDM: n={n} kmax={kmax} (dense would be {n*n*4/1e9:.0f} GB) "
        f"iters={info.n_iter} fit rel err={rel:.3f}"
    )

    # speedup evidence vs the O(m n) matrix-free backend on the same kernel
    import time

    Kmf = MappedDistanceMatrix(pts, pts, Wendland(k=2, epsilon=0.02), backend="matrix-free", block=2048)
    x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    for op in (K, Kmf):  # warm up compiles
        op(x).block_until_ready()
    # CHAIN the matvecs (K is square) so every dispatch sees a new input —
    # chained applies (each sees the previous output), fenced at the end
    r_sp = x
    t0 = time.perf_counter()
    for _ in range(5):
        r_sp = K(r_sp)
    r_sp.block_until_ready()
    t_sp = (time.perf_counter() - t0) / 5
    # the matrix-free leg is chained the same way
    r_mf = x
    t0 = time.perf_counter()
    for _ in range(2):
        r_mf = Kmf(r_mf)
    r_mf.block_until_ready()
    t_mf = (time.perf_counter() - t0) / 2
    print(f"matvec: sparse {t_sp*1e3:.1f} ms vs matrix-free {t_mf*1e3:.1f} ms -> {t_mf/t_sp:.0f}x")


if __name__ == "__main__":
    main()
    main_large()

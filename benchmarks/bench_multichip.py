"""Multi-device scaling benchmark for the distributed TV deconvolution solver.

On several GPUs this measures iterations/s vs device count for the
row-sharded Condat-Vu iteration (fused Gram + halo exchanges only; no
global collectives inside an iteration, so scaling is bounded by the
O(kernel x W) halo traffic between the cards).

Without multi-chip hardware it still runs on the virtual CPU mesh
(JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8) to
validate that every mesh size compiles and agrees with 1-device execution —
CPU timings are NOT meaningful as scaling numbers.

Usage:  python benchmarks/bench_multichip.py [image_size] [kernel_size]
"""
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo root


def main():
    import jax
    import jax.numpy as jnp

    from pycsou_tpu.parallel import DistributedTVDeconv2D, make_mesh

    N = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 15
    rng = np.random.default_rng(0)
    a = np.arange(K) - K // 2
    g = np.exp(-(a**2) / 8)
    h = np.outer(g, g).astype(np.float32)
    h /= h.sum()
    y = np.abs(rng.standard_normal((N, N))).astype(np.float32)

    n_total = jax.device_count()
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_total and N % n == 0]
    print(f"devices available: {n_total}; backend: {jax.default_backend()}")

    results = {}
    ref_x = None
    for n in sizes:
        mesh = make_mesh((n,), ("sp",))
        solver = DistributedTVDeconv2D((N, N), h, y, lam=0.05, mesh=mesh)
        x, z = solver.run(20)
        jax.block_until_ready(x)
        t0 = time.perf_counter()
        x, z = solver.run(50, x=x, z=z)
        jax.block_until_ready(x)
        dt = time.perf_counter() - t0
        ips = 50 / dt
        results[n] = ips
        if ref_x is None:
            ref_x = np.asarray(jax.device_get(x))
        else:
            err = np.max(np.abs(np.asarray(jax.device_get(x)) - ref_x))
            assert err < 1e-3, f"{n}-device result diverges from 1-device: {err}"
        scaling = ips / (results[sizes[0]] * n) * 100
        print(f"  {n:3d} devices: {ips:8.2f} iters/s   ({scaling:5.1f}% of linear)")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Slope-timed generic (unfused) PDS chain at 4096^2 — the bench.py
generic-raw leg in isolation.

Run on the GPU: python benchmarks/bench_generic.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu.func.penalty import L21Norm
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.ops.diff import Gradient
    from pycsou_tpu.opt import PDS

    SHAPE = (4096, 4096)
    k = 15
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * 2.0**2))
    h = np.outer(g, g).astype(np.float32)
    h /= h.sum()
    rng = np.random.default_rng(0)
    y = jnp.asarray(np.abs(rng.standard_normal(SHAPE)).astype(np.float32))

    A = Convolve2D(SHAPE, h)
    F = SquaredL2Loss(SHAPE, data=y) * A
    solver = PDS(
        SHAPE, F=F, G=NonNegativeOrthant(SHAPE),
        H=0.05 * L21Norm((2,) + SHAPE, axis=0), K=Gradient(SHAPE),
        max_iter=4000, fuse=False,
    )

    iters, long_iters = 50, 250
    state = solver.run_fixed(iters)
    jax.block_until_ready(state["x"])
    state = solver.run_fixed(long_iters, state=state)
    jax.block_until_ready(state["x"])
    slopes, means = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state = solver.run_fixed(iters, state=state)
        jax.block_until_ready(state["x"])
        t_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = solver.run_fixed(long_iters, state=state)
        jax.block_until_ready(state["x"])
        t_l = time.perf_counter() - t0
        slopes.append((t_l - t_s) / (long_iters - iters))
        means.append(t_l / long_iters)
        print(f"short {t_s*1e3:.1f} ms / long {t_l*1e3:.1f} ms", file=sys.stderr)
    valid = [s for s in slopes if s > 0] or means
    per_iter = min(float(np.median(valid)), min(means))
    print(f"generic-raw: {per_iter*1e3:.3f} ms/iter -> {1/per_iter:.1f} iters/s")
    print(f"final metric {float(state['metric']):.3e} it {int(state['it'])}")


if __name__ == "__main__":
    main()

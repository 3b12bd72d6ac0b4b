"""Consensus-ADMM block-partitioned 3-D deconvolution across scenario
batches (BASELINE config 5).

Each device holds one blurred observation of the same volume (different
PSFs); the consensus variable is averaged with one psum per iteration and
the per-scenario x-updates are exact FFT-domain solves.
Run (8 virtual devices):
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
  python examples/consensus_admm_3d.py
"""
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import jax
import jax.numpy as jnp

from pycsou_tpu.func import NonNegativeOrthant
from pycsou_tpu.ops.conv import CircularConvolve
from pycsou_tpu.opt.admm import ConsensusADMM
from pycsou_tpu.parallel import make_mesh


def main():
    rng = np.random.default_rng(0)
    n_dev = jax.device_count()
    mesh = make_mesh((n_dev,), ("dp",))
    shape = (32, 32, 32)

    x_true = np.zeros(shape, np.float32)
    for _ in range(10):  # random bright blobs
        c = rng.integers(4, 28, size=3)
        x_true[c[0] - 2 : c[0] + 2, c[1] - 2 : c[1] + 2, c[2] - 2 : c[2] + 2] = 1.0

    h_hats, ys = [], []
    for s in range(n_dev):
        k = np.arange(5) - 2
        g = np.exp(-(k**2) / (1.0 + 0.3 * s))
        h = np.einsum("i,j,k->ijk", g, g, g).astype(np.float32)
        h /= h.sum()
        op = CircularConvolve(shape, h)
        h_hats.append(op.h_hat)  # stays on device
        ys.append(np.asarray(op(jnp.asarray(x_true))) + 0.01 * rng.standard_normal(shape).astype(np.float32))

    admm = ConsensusADMM(shape, jnp.stack(h_hats), np.stack(ys),
                         g=NonNegativeOrthant(shape), rho=0.5, mesh=mesh)
    z = np.asarray(admm.run(100))
    rel = np.linalg.norm(z - x_true) / np.linalg.norm(x_true)
    print(f"devices={n_dev} scenarios={n_dev} rel err={rel:.3f}")


if __name__ == "__main__":
    main()

"""2-D isotropic TV denoising (BASELINE config 2).

``min_x ||x - y||^2 + lam ||grad x||_{2,1}`` with Condat-Vu PDS.
Run: python examples/tv_denoise2d.py
"""
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import jax.numpy as jnp

from pycsou_tpu.func import SquaredL2Loss
from pycsou_tpu.func.penalty import L21Norm
from pycsou_tpu.ops.diff import Gradient
from pycsou_tpu.opt import PDS
from pycsou_tpu.utils.misc import peaks


def main():
    rng = np.random.default_rng(0)
    n = 512
    g = np.linspace(-3, 3, n)
    xx, yy = np.meshgrid(g, g)
    clean = np.asarray(peaks(jnp.asarray(xx, jnp.float32), jnp.asarray(yy, jnp.float32)))
    noisy = jnp.asarray(clean + 0.5 * rng.standard_normal((n, n)).astype(np.float32))

    K = Gradient((n, n))  # exact ||K|| <= sqrt(8) set in closed form
    lam = 0.8
    F = SquaredL2Loss((n, n), data=noisy)
    H = lam * L21Norm((2, n, n), axis=0)  # isotropic TV

    solver = PDS((n, n), F=F, H=H, K=K, max_iter=500, accuracy_threshold=1e-5, verbose=100)
    info = solver.solve()
    x = np.asarray(info["x"])

    def psnr(a, b):
        mse = np.mean((a - b) ** 2)
        return 10 * np.log10((clean.max() - clean.min()) ** 2 / mse)

    print(f"iters={info.n_iter} PSNR noisy={psnr(np.asarray(noisy), clean):.2f} dB "
          f"-> denoised={psnr(x, clean):.2f} dB")


if __name__ == "__main__":
    main()

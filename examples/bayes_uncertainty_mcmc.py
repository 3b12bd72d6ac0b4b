"""Bayesian uncertainty quantification with PMYULA (reference mcmc.py demo).

Sample the posterior of a sparse deconvolution problem and report MMSE +
pointwise credible intervals from the streaming P^2 quantiles.
Run: python examples/bayes_uncertainty_mcmc.py
"""
import sys as _sys
from pathlib import Path as _Path

_sys.path.insert(0, str(_Path(__file__).resolve().parent.parent))  # repo root

import numpy as np
import jax.numpy as jnp

from pycsou_tpu.func import L1Norm, SquaredL2Loss
from pycsou_tpu.ops.conv import Convolve1D
from pycsou_tpu.opt.mcmc import PMYULA


def main():
    rng = np.random.default_rng(1)
    n = 128
    x_true = np.zeros(n, np.float32)
    x_true[rng.choice(n, 6, replace=False)] = 2.0

    t = np.arange(-6, 7)
    h = np.exp(-(t**2) / 6).astype(np.float32)
    h /= h.sum()
    A = Convolve1D((n,), h)
    sigma = 0.05
    y = A(jnp.asarray(x_true)) + sigma * jnp.asarray(rng.standard_normal(n), jnp.float32)

    # -log posterior = ||Ax-y||^2 / (2 sigma^2) + lam |x|_1
    F = (1.0 / (2 * sigma**2)) * (SquaredL2Loss((n,), data=y) * A)
    G = 10.0 * L1Norm((n,))

    sampler = PMYULA(
        (n,), F=F, G=G,
        nb_burnin_iterations=2000, max_iter=20000, min_iter=20000,
        accuracy_threshold=0.0, pvalues=(0.025, 0.5, 0.975), seed=0,
    )
    out = sampler.solve().iterand
    mmse = np.asarray(out["mmse"])
    lo = np.asarray(out["quantiles"][0.025])
    hi = np.asarray(out["quantiles"][0.975])
    inside = np.mean((x_true >= lo) & (x_true <= hi))
    print(f"samples={int(out['n_samples'])} mmse rel err="
          f"{np.linalg.norm(mmse - x_true)/np.linalg.norm(x_true):.3f} "
          f"95% CI coverage={inside:.2%}")


if __name__ == "__main__":
    main()

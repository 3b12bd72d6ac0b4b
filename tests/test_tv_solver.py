"""Tuned TVDeconvolution solver == generic PDS on the same problem."""
import jax.numpy as jnp
import numpy as np

from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
from pycsou_tpu.func.penalty import L21Norm
from pycsou_tpu.ops.conv import Convolve2D
from pycsou_tpu.ops.diff import Gradient
from pycsou_tpu.opt import PDS, TVDeconvolution


def test_tv_solver_matches_generic_pds(rng):
    H, W = 32, 32
    h = jnp.asarray(rng.standard_normal((5, 5)) / 5, jnp.float32)
    A = Convolve2D((H, W), h)
    x_true = jnp.asarray(np.abs(rng.standard_normal((H, W))), jnp.float32)
    y = A(x_true) + 0.01 * jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    lam = 0.05

    tuned = TVDeconvolution((H, W), y, lam, filt=h, nonneg=True, max_iter=100)
    state = tuned.run_fixed(60)

    F = SquaredL2Loss((H, W), data=y) * A
    ref = PDS(
        (H, W), F=F, G=NonNegativeOrthant((H, W)),
        H=lam * L21Norm((2, H, W), axis=0), K=Gradient((H, W)),
        tau=tuned.tau, sigma=tuned.sigma, rho=tuned.rho, max_iter=100,
        fuse=False,  # the oracle must step the generic expression tree
    )
    ref_state = ref.run_fixed(60)
    np.testing.assert_allclose(np.asarray(state["x"]), np.asarray(ref_state["x"]), rtol=1e-4, atol=1e-5)


def test_tv_denoise_mode(rng):
    H, W = 32, 32
    y = jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    s = TVDeconvolution((H, W), y, lam=0.3, filt=None, nonneg=False,
                        max_iter=400, accuracy_threshold=1e-7, min_iter=50)
    info = s.solve()
    assert s.objective(info["x"]) < s.objective(jnp.zeros((H, W))) + 1e-3
    assert s.objective(info["x"]) < s.objective(y)

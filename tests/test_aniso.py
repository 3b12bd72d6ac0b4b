"""Anisotropic TV (``iso=False``): per-component box dual projection.

The reference's own PDS doc example uses ``lam * L1Norm o Gradient``
(/root/reference/pycsou/opt/proxalgs.py:91-119) — anisotropic TV.  Every
solver threads the same static ``iso`` flag into the shared ``_dual_prox``
(kernels/tv.py); each Gram route is checked against an explicit oracle with
``iso=False``, and the expression matcher against the generic chain (the
mathematical oracle).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from pycsou_tpu.kernels.tv import tv_pds_stencil_step_xla

KW = dict(tau=0.05, sigma=0.05, rho=0.9, lam=0.05, nonneg=True, iso=False)


def test_xla_twin_box_projection(rng):
    """iso=False clamps each dual component into [-lam, lam] independently."""
    x = jnp.asarray(rng.standard_normal((16, 16)), jnp.float32)
    z = jnp.zeros((16, 16), jnp.float32)
    g = jnp.zeros((16, 16), jnp.float32)
    kw = dict(tau=0.5, sigma=5.0, rho=1.0, lam=0.05, nonneg=False)
    _, za, zb = tv_pds_stencil_step_xla(x, z, z, g, iso=False, **kw)
    assert float(jnp.max(jnp.abs(jnp.stack([za, zb])))) <= 0.05 + 1e-7
    # and differs from the isotropic projection on a generic input
    _, zai, zbi = tv_pds_stencil_step_xla(x, z, z, g, iso=True, **kw)
    assert not np.allclose(np.asarray(jnp.stack([za, zb])), np.asarray(jnp.stack([zai, zbi])))


def _aniso_pds(shape, y, A, fuse):
    from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu.func.penalty import L1Norm
    from pycsou_tpu.ops.diff import Gradient
    from pycsou_tpu.opt import PDS

    H, W = shape
    F = SquaredL2Loss(shape, data=y)
    return PDS(
        shape, F=F * A if A is not None else F, G=NonNegativeOrthant(shape),
        H=0.05 * L1Norm((2, H, W)), K=Gradient(shape), max_iter=200, fuse=fuse,
    )


@pytest.mark.parametrize("mode", ["denoise", "deconv"])
def test_aniso_stencil_kernels_match_xla(rng, mode):
    """Anisotropic TV on a 32x256 image: the fused TVDeconvolution == the
    unfused generic PDS chain, denoising and deconvolution alike."""
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.opt import TVDeconvolution

    H, W = 32, 256
    y = jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    A = None
    if mode == "deconv":
        g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
        A = Convolve2D((H, W), (np.outer(g, g) / np.outer(g, g).sum()).astype(np.float32))
    fused, generic = _aniso_pds((H, W), y, A, True), _aniso_pds((H, W), y, A, False)
    assert isinstance(fused._fused, TVDeconvolution) and fused._fused.iso is False
    st_f = fused.run_fixed(30)
    st_g = generic.run_fixed(30)
    np.testing.assert_allclose(np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5)
    z_f = np.stack([np.asarray(st_f["z0"]), np.asarray(st_f["z1"])])
    np.testing.assert_allclose(z_f, np.asarray(st_g["z"]), rtol=1e-4, atol=1e-5)


def _solver_vs_oracle(rng, filt, H, W, n_steps, rtol, atol):
    """``n_steps`` TVDeconvolution(isotropic=False) steps == the explicit
    oracle: data gradient 2 (A^H A x - A^H y) + the XLA stencil."""
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.opt.tv import TVDeconvolution

    y = jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    s = TVDeconvolution((H, W), y, KW["lam"], filt=filt, tau=KW["tau"],
                        isotropic=False, max_iter=10)
    A = Convolve2D((H, W), filt, method="fft")
    atb = A.adjoint(y)
    st = s._wrap_state(s.initial_state())
    x = z0 = z1 = jnp.zeros((H, W), jnp.float32)
    for _ in range(n_steps):
        st = s.step(st)
        g = 2.0 * (A.adjoint(A.apply(x)) - atb)
        x, z0, z1 = tv_pds_stencil_step_xla(x, z0, z1, g, **KW)
    np.testing.assert_allclose(np.asarray(st["x"]), np.asarray(x), rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(st["z0"]), np.asarray(z0), rtol=rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(st["z1"]), np.asarray(z1), rtol=rtol, atol=atol)


def test_aniso_mega2_matches_oracle(rng):
    """Rank-1 PSF (banded Gram route): one step == the oracle."""
    ax = np.arange(9) - 4
    filt = np.outer(np.exp(-(ax**2) / 8.0), np.exp(-(ax**2) / 3.0)).astype(np.float32)
    _solver_vs_oracle(rng, filt / filt.sum(), 64, 384, 1, 3e-5, 3e-6)


def test_aniso_mega3_matches_two_oracle_iterations(rng):
    """Rank-1 PSF: two chained steps == two oracle iterations."""
    ax = np.arange(9) - 4
    filt = np.outer(np.exp(-(ax**2) / 8.0), np.exp(-(ax**2) / 3.0)).astype(np.float32)
    _solver_vs_oracle(rng, filt / filt.sum(), 64, 384, 2, 1e-4, 1e-5)


def test_aniso_megar_matches_oracle(rng):
    """Rank-2 PSF (FFT Gram route): one step == the oracle."""
    u = rng.standard_normal((9, 2)) * 0.3
    v = rng.standard_normal((7, 2)) * 0.3
    filt = (u @ v.T).astype(np.float32)
    _solver_vs_oracle(rng, filt / np.abs(filt).sum(), 96, 384, 1, 3e-4, 3e-5)


def test_fused_anisotropic_tv_matches_generic(rng):
    """PDS(H = lam * L1Norm o Gradient) fuses onto TVDeconvolution
    (isotropic=False) and computes the generic chain's iterates exactly."""
    from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu.func.penalty import L1Norm
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.ops.diff import Gradient
    from pycsou_tpu.opt import PDS, TVDeconvolution

    H, W = 32, 32
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    h = np.outer(g, g).astype(np.float32)
    h /= h.sum()
    A = Convolve2D((H, W), h)
    x_true = jnp.asarray(np.abs(rng.standard_normal((H, W))), jnp.float32)
    y = A(x_true) + 0.01 * jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    mk = lambda fuse: PDS(
        (H, W), F=SquaredL2Loss((H, W), data=y) * A,
        G=NonNegativeOrthant((H, W)),
        H=0.05 * L1Norm((2, H, W)), K=Gradient((H, W)),
        max_iter=200, fuse=fuse,
    )
    fused, generic = mk(True), mk(False)
    assert isinstance(fused._fused, TVDeconvolution)
    assert fused._fused.iso is False
    st_f = fused.run_fixed(60)
    st_g = generic.run_fixed(60)
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )
    z_f = np.stack([np.asarray(st_f["z0"]), np.asarray(st_f["z1"])])
    np.testing.assert_allclose(z_f, np.asarray(st_g["z"]), rtol=1e-4, atol=1e-5)


def test_tv_solver_aniso_converges(rng):
    """Anisotropic denoise recovers a piecewise-constant image at least as
    well as the noisy input (end-to-end solve on the XLA/CPU path)."""
    from pycsou_tpu.opt.tv import TVDeconvolution

    x_true = jnp.zeros((32, 32)).at[8:24, 8:24].set(1.0)
    ij = jnp.arange(32)[:, None] + jnp.arange(32)[None, :]
    y = x_true + 0.2 * (-1.0) ** ij
    solver = TVDeconvolution((32, 32), y, lam=0.3, nonneg=True, max_iter=300, isotropic=False)
    info = solver.solve()
    assert float(jnp.linalg.norm(info["x"] - x_true)) < 0.5 * float(
        jnp.linalg.norm(y - x_true)
    )


def test_aniso_objective_uses_l1_term(rng):
    """objective() with isotropic=False scores sum|dx| + sum|dy|, the
    functional the anisotropic solver actually minimises (regression: it
    once always scored the L21 term)."""
    from pycsou_tpu.ops.diff import fdiff_forward
    from pycsou_tpu.opt.tv import TVDeconvolution

    y = jnp.asarray(rng.standard_normal((16, 16)), jnp.float32)
    s = TVDeconvolution((16, 16), y, 0.2, nonneg=False, isotropic=False)
    x = jnp.asarray(rng.standard_normal((16, 16)), jnp.float32)
    dx, dy = fdiff_forward(x, 0), fdiff_forward(x, 1)
    want = float(jnp.sum((x - y) ** 2) + 0.2 * (jnp.sum(jnp.abs(dx)) + jnp.sum(jnp.abs(dy))))
    np.testing.assert_allclose(float(s.objective(x)), want, rtol=1e-5)

"""Masked (diagonal-Gram) TV: inpainting / zero-fill super-resolution.

``min ||A x - y||^2 + lam TV(x)`` with A a sampling operator
(Masking/DownSampling/SubSampling, reference sampling.py:125-196) has
``A^H A = diag(A^H 1)`` — an elementwise data gradient, so the whole PDS
iteration fuses into one XLA pass.  The expression matcher recognises
``SquaredL2Loss * Masking`` (etc.) and rewrites onto TVDeconvolution's
diagonal-Gram mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from pycsou_tpu.kernels.tv import tv_pds_stencil_step_xla


def _masked_pds(M, y, shape, lam, iso, nonneg, fuse):
    from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu.func.penalty import L1Norm, L21Norm
    from pycsou_tpu.ops.diff import Gradient
    from pycsou_tpu.opt import PDS

    H, W = shape
    pen = L21Norm((2, H, W), axis=0) if iso else L1Norm((2, H, W))
    return PDS(
        shape, F=SquaredL2Loss(M.codim_shape, data=y) * M,
        G=NonNegativeOrthant(shape) if nonneg else None,
        H=lam * pen, K=Gradient(shape), max_iter=200, fuse=fuse,
    )


@pytest.mark.parametrize("iso", [True, False])
@pytest.mark.parametrize("nonneg", [True, False])
def test_sweepm_kernel_matches_xla(rng, iso, nonneg):
    """Mask mode, isotropic or anisotropic, with or without the
    nonnegativity prox: the fused TVDeconvolution == the unfused generic
    PDS chain, primal and dual iterates, on a tile-unfriendly 64x256."""
    from pycsou_tpu.ops.sampling import Masking
    from pycsou_tpu.opt import TVDeconvolution

    H, W = 64, 256
    keep = rng.random((H, W)) < 0.4
    M = Masking((H, W), keep)
    y = jnp.asarray(rng.standard_normal(int(keep.sum())), jnp.float32)
    fused = _masked_pds(M, y, (H, W), 0.05, iso, nonneg, True)
    generic = _masked_pds(M, y, (H, W), 0.05, iso, nonneg, False)
    assert isinstance(fused._fused, TVDeconvolution) and fused._fused.mask is not None
    assert fused._fused.iso == iso and fused._fused.nonneg == nonneg
    st_f = fused.run_fixed(30)
    st_g = generic.run_fixed(30)
    np.testing.assert_allclose(np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5)
    z_f = np.stack([np.asarray(st_f["z0"]), np.asarray(st_f["z1"])])
    np.testing.assert_allclose(z_f, np.asarray(st_g["z"]), rtol=1e-4, atol=1e-5)


def test_masked_solver_matches_generic_pds(rng):
    """PDS(F = SquaredL2Loss * Masking, H = lam L21 o Gradient) fuses onto
    the diagonal-Gram TVDeconvolution and computes the generic chain's
    iterates exactly (inpainting oracle)."""
    from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu.func.penalty import L21Norm
    from pycsou_tpu.ops.diff import Gradient
    from pycsou_tpu.ops.sampling import Masking
    from pycsou_tpu.opt import PDS, TVDeconvolution

    H, W = 32, 32
    keep = rng.random((H, W)) < 0.5
    M = Masking((H, W), keep)
    x_true = jnp.asarray(np.abs(rng.standard_normal((H, W))), jnp.float32)
    y = M(x_true) + 0.01 * jnp.asarray(rng.standard_normal(int(keep.sum())), jnp.float32)
    mk = lambda fuse: PDS(
        (H, W), F=SquaredL2Loss(M.codim_shape, data=y) * M,
        G=NonNegativeOrthant((H, W)),
        H=0.05 * L21Norm((2, H, W), axis=0), K=Gradient((H, W)),
        max_iter=200, fuse=fuse,
    )
    fused, generic = mk(True), mk(False)
    assert isinstance(fused._fused, TVDeconvolution)
    assert fused._fused.mask is not None
    st_f = fused.run_fixed(60)
    st_g = generic.run_fixed(60)
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )
    z_f = np.stack([np.asarray(st_f["z0"]), np.asarray(st_f["z1"])])
    np.testing.assert_allclose(z_f, np.asarray(st_g["z"]), rtol=1e-4, atol=1e-5)


def test_downsampling_superres_matches_generic_pds(rng):
    """Zero-fill super-resolution: F = SquaredL2Loss * DownSampling."""
    from pycsou_tpu.func import SquaredL2Loss
    from pycsou_tpu.func.penalty import L21Norm
    from pycsou_tpu.ops.diff import Gradient
    from pycsou_tpu.ops.sampling import DownSampling
    from pycsou_tpu.opt import PDS, TVDeconvolution

    H, W = 32, 32
    D = DownSampling((H, W), 2)
    x_true = jnp.asarray(np.abs(rng.standard_normal((H, W))), jnp.float32)
    y = D(x_true)
    mk = lambda fuse: PDS(
        (H, W), F=SquaredL2Loss(D.codim_shape, data=y) * D,
        H=0.1 * L21Norm((2, H, W), axis=0), K=Gradient((H, W)),
        max_iter=200, fuse=fuse,
    )
    fused, generic = mk(True), mk(False)
    assert isinstance(fused._fused, TVDeconvolution)
    st_f = fused.run_fixed(50)
    st_g = generic.run_fixed(50)
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )


def test_masked_solver_inpaints(rng):
    """End-to-end: TV inpainting fills a hole with values near its rim."""
    from pycsou_tpu.opt.tv import TVDeconvolution

    H, W = 32, 32
    x_true = jnp.ones((H, W))
    keep = np.ones((H, W), bool)
    keep[12:20, 12:20] = False  # hole
    m = jnp.asarray(keep.astype(np.float32))
    y_img = m * x_true
    solver = TVDeconvolution((H, W), y_img, lam=0.1, mask=m, nonneg=True, max_iter=500)
    info = solver.solve()
    hole = np.asarray(info["x"])[12:20, 12:20]
    assert np.all(np.abs(hole - 1.0) < 0.2)


def test_mask_mode_validation():
    from pycsou_tpu.opt.tv import TVDeconvolution

    y = jnp.zeros((16, 16))
    m = jnp.ones((16, 16))
    # filt + mask is now the COMBINED (blur + mask) mode
    s = TVDeconvolution((16, 16), y, 0.1, filt=np.ones((3, 3), np.float32), mask=m)
    assert s.conv is not None and s.mask is not None
    with pytest.raises(ValueError, match="mask shape"):
        TVDeconvolution((16, 16), y, 0.1, mask=jnp.ones((8, 8)))
    with pytest.raises(ValueError, match="removed"):
        # the masked stencil engines were removed: naming one raises
        TVDeconvolution((16, 16), y, 0.1, mask=m, stencil="sweepm")


def test_masked_objective_scores_observed_pixels_only(rng):
    """objective() in mask mode evaluates the data term over OBSERVED
    pixels only (regression: the gram-is-None branch once scored all
    pixels against the zero-filled back-projection)."""
    from pycsou_tpu.ops.diff import fdiff_forward
    from pycsou_tpu.opt.tv import TVDeconvolution

    H, W = 16, 16
    keep = rng.random((H, W)) < 0.5
    m = jnp.asarray(keep.astype(np.float32))
    y_img = m * jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    s = TVDeconvolution((H, W), y_img, 0.1, mask=m, nonneg=False)
    x = jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    dx, dy = fdiff_forward(x, 0), fdiff_forward(x, 1)
    want = float(
        jnp.sum(m * (x - y_img) ** 2)
        + 0.1 * jnp.sum(jnp.sqrt(dx**2 + dy**2))
    )
    np.testing.assert_allclose(float(s.objective(x)), want, rtol=1e-5)


@pytest.mark.parametrize("iso", [True, False])
def test_sweepm2_double_step_matches_two_single_steps(rng, iso):
    """Two solver steps in mask mode == two explicit oracle iterations
    (diagonal-Gram gradient + the XLA stencil), chained twice."""
    from pycsou_tpu.opt.tv import TVDeconvolution

    H, W = 96, 256
    m = jnp.asarray((rng.random((H, W)) < 0.4).astype(np.float32))
    atb = m * jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    s = TVDeconvolution((H, W), atb, 0.05, mask=m, tau=0.06, sigma=0.04,
                        isotropic=iso, max_iter=10)
    kw = dict(tau=0.06, sigma=0.04, rho=0.9, lam=0.05, nonneg=True, iso=iso)
    x_o = z0_o = z1_o = jnp.zeros((H, W), jnp.float32)
    st = s._wrap_state(s.initial_state())
    for _ in range(2):
        st = s.step(s.step(st))
        for _ in range(2):
            g = 2.0 * (m * x_o - atb)
            x_o, z0_o, z1_o = tv_pds_stencil_step_xla(x_o, z0_o, z1_o, g, **kw)
        np.testing.assert_allclose(np.asarray(st["x"]), np.asarray(x_o), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(st["z0"]), np.asarray(z0_o), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(st["z1"]), np.asarray(z1_o), rtol=1e-5, atol=1e-6)


def test_masked_solver_sweepm2_iteration_units(rng):
    """Mask mode runs one iteration per step (it/history in iteration
    units) and solves to the same answer as the generic chain; the removed
    double-step engine name raises instead of degrading."""
    from pycsou_tpu.opt.tv import TVDeconvolution

    H, W = 64, 256
    keep = rng.random((H, W)) < 0.6
    m = jnp.asarray(keep.astype(np.float32))
    y_img = m * jnp.asarray(np.abs(rng.standard_normal((H, W))), jnp.float32)
    s = TVDeconvolution((H, W), y_img, 0.05, mask=m, max_iter=60)
    st = s.run_fixed(60)
    assert int(st["it"]) == 60
    with pytest.raises(ValueError, match="sweepm2"):
        TVDeconvolution((H, W), y_img, 0.05, mask=m, stencil="sweepm2")


def test_megarm_kernel_matches_oracle(rng):
    """Combined blur + mask mode with a rank-2 PSF: chained solver steps ==
    the explicit oracle g = 2(A^H(m * A x) - atb) + the XLA stencil."""
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.opt.tv import TVDeconvolution

    H, W = 96, 384
    u = rng.standard_normal((9, 2)) * 0.3
    v = rng.standard_normal((7, 2)) * 0.3
    filt = (u @ v.T).astype(np.float32)
    filt /= np.abs(filt).sum()
    A = Convolve2D((H, W), filt, method="fft")
    m = jnp.asarray((rng.random((H, W)) < 0.5).astype(np.float32))
    y_img = m * jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    s = TVDeconvolution((H, W), y_img, 0.1, filt=filt, mask=m, tau=0.05, max_iter=10)
    atb = A.adjoint(y_img)
    kw = dict(tau=0.05, sigma=0.05, rho=0.9, lam=0.1, nonneg=True)
    x = z0 = z1 = jnp.zeros((H, W), jnp.float32)
    st = s._wrap_state(s.initial_state())
    for _ in range(3):
        st = s.step(st)
        g = 2.0 * (A.adjoint(m * A.apply(x)) - atb)
        x, z0, z1 = tv_pds_stencil_step_xla(x, z0, z1, g, **kw)
        np.testing.assert_allclose(np.asarray(st["x"]), np.asarray(x), rtol=3e-4, atol=3e-5)
        np.testing.assert_allclose(np.asarray(st["z0"]), np.asarray(z0), rtol=3e-4, atol=3e-5)
        np.testing.assert_allclose(np.asarray(st["z1"]), np.asarray(z1), rtol=3e-4, atol=3e-5)


def test_blurred_masking_superres_matches_generic_pds(rng):
    """F = SquaredL2Loss o Masking o Convolve2D (partial blurred
    measurements) fuses onto the COMBINED TVDeconvolution mode and computes
    the generic chain's iterates exactly."""
    from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu.func.penalty import L21Norm
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.ops.diff import Gradient
    from pycsou_tpu.ops.sampling import Masking
    from pycsou_tpu.opt import PDS, TVDeconvolution

    H, W = 32, 32
    g1 = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    h = np.outer(g1, g1).astype(np.float32)
    h /= h.sum()
    A = Convolve2D((H, W), h)
    keep = rng.random((H, W)) < 0.5
    M = Masking((H, W), keep)
    x_true = jnp.asarray(np.abs(rng.standard_normal((H, W))), jnp.float32)
    y = M(A(x_true)) + 0.01 * jnp.asarray(
        rng.standard_normal(int(keep.sum())), jnp.float32
    )
    mk = lambda fuse: PDS(
        (H, W), F=SquaredL2Loss(M.codim_shape, data=y) * (M * A),
        G=NonNegativeOrthant((H, W)),
        H=0.05 * L21Norm((2, H, W), axis=0), K=Gradient((H, W)),
        max_iter=200, fuse=fuse,
    )
    fused, generic = mk(True), mk(False)
    assert isinstance(fused._fused, TVDeconvolution)
    assert fused._fused.conv is not None and fused._fused.mask is not None
    st_f = fused.run_fixed(50)
    st_g = generic.run_fixed(50)
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )
    z_f = np.stack([np.asarray(st_f["z0"]), np.asarray(st_f["z1"])])
    np.testing.assert_allclose(z_f, np.asarray(st_g["z"]), rtol=1e-4, atol=1e-5)
    # objective parity with the expression's own value
    xs = jnp.asarray(st_g["x"])
    want = float(mk(False).objective(xs))
    np.testing.assert_allclose(float(fused._fused.objective(xs)), want, rtol=1e-4)


def test_combined_mode_validation(rng):
    from pycsou_tpu.opt.tv import TVDeconvolution

    y = jnp.zeros((32, 32))
    m = jnp.ones((32, 32))
    hf = np.abs(rng.standard_normal((5, 5))).astype(np.float32)  # full rank
    hf /= hf.sum()
    with pytest.raises(ValueError, match="megarm"):
        TVDeconvolution((32, 32), y, 0.1, filt=hf, mask=m, stencil="megarm")
    # full-rank PSF + mask: the combined mode, FFT convolutions
    s = TVDeconvolution((32, 32), y, 0.1, filt=hf, mask=m)
    assert s.conv is not None and s.conv.method == "fft"


def test_near_miss_note_knows_masked_conv_F(rng, caplog):
    """A masked-conv F is a SUPPORTED slot: the near-miss note for a K-only
    mismatch must blame K, not F (regression: _why_F lagged the matcher)."""
    import logging

    from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu.func.penalty import L21Norm
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.ops.diff import Gradient
    from pycsou_tpu.ops.sampling import Masking
    from pycsou_tpu.opt import PDS

    H, W = 32, 32
    g1 = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    h = np.outer(g1, g1).astype(np.float32)
    h /= h.sum()
    A = Convolve2D((H, W), h)
    M = Masking((H, W), rng.random((H, W)) < 0.5)
    y = M(A(jnp.ones((H, W))))
    with caplog.at_level(logging.WARNING, logger="pycsou_tpu.fuse"):
        solver = PDS(
            (H, W), F=SquaredL2Loss(M.codim_shape, data=y) * (M * A),
            G=NonNegativeOrthant((H, W)),
            H=0.05 * L21Norm((2, H, W), axis=0),
            K=Gradient((H, W), step=2.0),  # the ONLY mismatch
            max_iter=50,
        )
    assert solver._fused is None
    notes = [r.message for r in caplog.records if "NOT fused" in r.message]
    assert notes and "steps" in notes[0] and "F is" not in notes[0]

"""Expression recognition (opt/fuse.py): generic PDS configurations that
match the TV-deconvolution pattern are rewritten onto the fused engines,
computing the SAME Condat-Vu iterates as the generic expression chain
(reference semantics: /root/reference/pycsou/opt/proxalgs.py:343-355)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
from pycsou_tpu.func.penalty import L21Norm, Segment
from pycsou_tpu.ops.conv import Convolve2D
from pycsou_tpu.ops.diff import Gradient
from pycsou_tpu.opt import CPS, PDS, TVDeconvolution


def _problem(rng, H=32, W=32, sep=True):
    if sep:
        g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
        h = np.outer(g, g).astype(np.float32)
        h /= h.sum()
    else:
        h = np.abs(rng.standard_normal((5, 5))).astype(np.float32)
        h /= h.sum()
    A = Convolve2D((H, W), h)
    x_true = jnp.asarray(np.abs(rng.standard_normal((H, W))), jnp.float32)
    y = A(x_true) + 0.01 * jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    return h, A, y


def _pds(A, y, lam=0.05, fuse=True, **kw):
    H, W = y.shape
    F = SquaredL2Loss((H, W), data=y) * A
    return PDS(
        (H, W), F=F, G=NonNegativeOrthant((H, W)),
        H=lam * L21Norm((2, H, W), axis=0), K=Gradient((H, W)),
        max_iter=200, fuse=fuse, **kw,
    )


def test_pds_auto_fuses_and_matches_generic(rng):
    _, A, y = _problem(rng)
    fused = _pds(A, y)
    generic = _pds(A, y, fuse=False)
    assert isinstance(fused._fused, TVDeconvolution)
    assert generic._fused is None
    # identical auto step sizes on both routes
    assert fused.tau == generic.tau and fused.rho == generic.rho
    st_f = fused.run_fixed(60)
    st_g = generic.run_fixed(60)
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )
    z_f = np.stack([np.asarray(st_f["z0"]), np.asarray(st_f["z1"])])
    np.testing.assert_allclose(z_f, np.asarray(st_g["z"]), rtol=1e-4, atol=1e-5)


def test_fused_solve_keeps_generic_contract(rng):
    """solve() on a fused PDS returns the stacked dual under 'z' and
    per-variable diagnostics, like the generic route."""
    _, A, y = _problem(rng)
    solver = _pds(A, y, accuracy_threshold=1e-5)
    assert solver._fused is not None
    info = solver.solve()
    assert "z" in info.iterand and info.iterand["z"].shape == (2,) + y.shape
    assert "z0" not in info.iterand
    assert info.n_iter > 0 and np.isfinite(info.history[info.n_iter - 1])
    # warm-started solves seed the fused state
    x0 = jnp.ones_like(y)
    warm = _pds(A, y, x0=x0)
    st = warm._wrap_state(warm.initial_state())
    np.testing.assert_array_equal(np.asarray(st["x"]), np.asarray(x0))


def test_fused_denoise_pattern(rng):
    H, W = 24, 24
    y = jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    F = SquaredL2Loss((H, W), data=y)
    mk = lambda fuse: PDS(
        (H, W), F=F, G=NonNegativeOrthant((H, W)),
        H=0.3 * L21Norm((2, H, W), axis=0), K=Gradient((H, W)),
        max_iter=100, fuse=fuse,
    )
    fused, generic = mk(True), mk(False)
    assert fused._fused is not None
    st_f, st_g = fused.run_fixed(40), generic.run_fixed(40)
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )


def test_fused_full_rank_psf(rng):
    """Non-separable PSFs also fuse (FFT-Gram route inside the engine)."""
    _, A, y = _problem(rng, sep=False)
    fused = _pds(A, y)
    assert fused._fused is not None
    st_f = fused.run_fixed(30)
    st_g = _pds(A, y, fuse=False).run_fixed(30)
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )


def test_fused_tau_ne_sigma_matches_generic(rng):
    """tau != sigma now fuses (VERDICT r3 task 3a): every kernel plumbs both
    step sizes into the stencil, so the rewrite stays iterate-exact."""
    _, A, y = _problem(rng)
    fused = _pds(A, y, tau=0.08, sigma=0.21)
    generic = _pds(A, y, fuse=False, tau=0.08, sigma=0.21)
    assert isinstance(fused._fused, TVDeconvolution)
    assert fused._fused.tau == 0.08 and fused._fused.sigma == 0.21
    st_f = fused.run_fixed(60)
    st_g = generic.run_fixed(60)
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )
    z_f = np.stack([np.asarray(st_f["z0"]), np.asarray(st_f["z1"])])
    np.testing.assert_allclose(z_f, np.asarray(st_g["z"]), rtol=1e-4, atol=1e-5)


def test_no_fusion_on_mismatched_patterns(rng):
    _, A, y = _problem(rng)
    H, W = y.shape
    F = SquaredL2Loss((H, W), data=y) * A
    l21 = 0.05 * L21Norm((2, H, W), axis=0)
    # backward-difference K
    assert (
        PDS((H, W), F=F, H=l21, K=Gradient((H, W), kind="backward"), tau=0.1)._fused
        is None
    )
    # non-unit Gradient step
    assert (
        PDS((H, W), F=F, H=l21, K=Gradient((H, W), step=0.5), tau=0.1)._fused is None
    )
    # G not the nonnegative orthant
    assert (
        PDS((H, W), F=F, G=Segment((H, W), 0.0, 1.0), H=l21, K=Gradient((H, W)))._fused
        is None
    )
    # L21 over the wrong axis
    assert (
        PDS(
            (H, W), F=F, H=0.05 * L21Norm((2, H, W), axis=1),
            K=Gradient((H, W)), tau=0.1,
        )._fused
        is None
    )
    # CPS has no differentiable term -> nothing to match
    assert CPS((H, W), G=NonNegativeOrthant((H, W)), H=l21, K=Gradient((H, W)))._fused is None


def test_fused_with_shardings_drops_to_generic(rng):
    """GSPMD sharding of a fused PDS that the distributed solvers can NOT
    take (tau != sigma) steps the generic expression; iterates equal the
    single-device generic chain.  (A routable request re-dispatches onto
    the distributed solvers instead — tests/test_generic_sharded.py.)"""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    _, A, y = _problem(rng)
    fused = _pds(A, y, tau=0.08, sigma=0.05)
    assert fused._fused is not None
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    sh = NamedSharding(mesh, P("sp", None))
    shz = NamedSharding(mesh, P(None, "sp", None))
    sharded = fused.with_shardings(x=sh, z=shz)
    assert sharded._fused is None
    st_s = sharded.run_fixed(30)
    st_g = _pds(A, y, fuse=False, tau=0.08, sigma=0.05).run_fixed(30)
    np.testing.assert_allclose(
        np.asarray(st_s["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )


def test_fused_diagnostics_keep_generic_contract(rng):
    """Fused PDS reports per-variable diagnostics under the GENERIC keys
    (x, stacked z) and the values match the unfused chain (the stacked-dual
    improvement recombines exactly from the split-dual partial sums)."""
    _, A, y = _problem(rng)
    inf_f = _pds(A, y).solve()
    inf_g = _pds(A, y, fuse=False).solve()
    assert sorted(inf_f.diagnostics) == sorted(inf_g.diagnostics) == ["x", "z"]
    n = min(inf_f.n_iter, inf_g.n_iter)
    np.testing.assert_allclose(
        inf_f.diagnostics["z"][5:n], inf_g.diagnostics["z"][5:n], rtol=1e-3, atol=1e-5
    )


def test_no_fusion_for_subclassed_nodes(rng):
    """Subclasses with overridden behavior must NOT be rewritten (exact
    node-type checks in opt/fuse.py)."""
    from pycsou_tpu.func.loss import LeastSquaresLoss

    _, A, y = _problem(rng)
    H, W = y.shape

    class WeightedLSQ(LeastSquaresLoss):
        def jacobianT(self, x):
            return 2.0 * super().jacobianT(x)  # deliberately different

    F = WeightedLSQ(A, y)
    s = PDS(
        (H, W), F=F, G=NonNegativeOrthant((H, W)),
        H=0.05 * L21Norm((2, H, W), axis=0), K=Gradient((H, W)), tau=0.05,
    )
    assert s._fused is None


# ---------------------------------------------------------------------------
# LASSO / APGD fusion (VERDICT r3 task 3b)
# ---------------------------------------------------------------------------


def _apgd(A, y, lam=0.02, fuse=True, **kw):
    from pycsou_tpu.func.penalty import L1Norm
    from pycsou_tpu.opt import APGD

    H, W = y.shape
    F = SquaredL2Loss((H, W), data=y) * A
    return APGD((H, W), F=F, G=lam * L1Norm((H, W)), max_iter=200, fuse=fuse, **kw)


def test_apgd_auto_fuses_and_matches_generic(rng):
    from pycsou_tpu.opt import LassoDeconvolution

    _, A, y = _problem(rng)
    fused = _apgd(A, y)
    generic = _apgd(A, y, fuse=False)
    assert isinstance(fused._fused, LassoDeconvolution)
    assert generic._fused is None
    assert fused._fused.tau == fused.tau and fused._fused.lam == 0.02
    st_f = fused.run_fixed(80)
    st_g = generic.run_fixed(80)
    np.testing.assert_allclose(
        np.asarray(st_f["x_temp"]), np.asarray(st_g["x_temp"]), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-5, atol=1e-6
    )


def test_apgd_no_fusion_on_mismatch(rng):
    from pycsou_tpu.func.penalty import L1Norm, L2Norm
    from pycsou_tpu.opt import APGD

    _, A, y = _problem(rng)
    H, W = y.shape
    F = SquaredL2Loss((H, W), data=y) * A
    # G not an L1 norm
    assert APGD((H, W), F=F, G=0.02 * L2Norm((H, W)))._fused is None

    # subclassed L1 must not be rewritten
    class MyL1(L1Norm):
        def prox(self, x, tau):
            return 0.5 * super().prox(x, tau)

    assert APGD((H, W), F=F, G=MyL1((H, W)), tau=0.1)._fused is None


def test_lasso_megaf_kernel_matches_gram_engine(rng):
    """The LASSO solver (Gram-routed FISTA, opt/lasso.py) == the generic
    APGD expression chain over a real multi-iteration run, iterates and
    stopping-metric history alike."""
    from pycsou_tpu.func.penalty import L1Norm
    from pycsou_tpu.opt import APGD, LassoDeconvolution

    H, W = 64, 384
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    h = np.outer(g, g).astype(np.float32)
    h /= h.sum()
    A = Convolve2D((H, W), h)
    x_true = jnp.asarray(np.abs(rng.standard_normal((H, W))), jnp.float32)
    y = A(x_true) + 0.01 * jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    lasso = LassoDeconvolution((H, W), y, 0.02, filt=h, max_iter=100)
    generic = APGD(
        (H, W), F=SquaredL2Loss((H, W), data=y) * A, G=0.02 * L1Norm((H, W)),
        tau=lasso.tau, max_iter=100, fuse=False,
    )
    st_m = lasso.run_fixed(40)
    st_g = generic.run_fixed(40)
    np.testing.assert_allclose(
        np.asarray(st_m["x_temp"]), np.asarray(st_g["x_temp"]), rtol=1e-4, atol=5e-5
    )
    np.testing.assert_allclose(
        np.asarray(st_m["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=5e-5
    )
    hist_m = np.asarray(st_m["history"])[5:40]
    hist_g = np.asarray(st_g["history"])[5:40]
    np.testing.assert_allclose(hist_m, hist_g, rtol=1e-3, atol=1e-6)


def test_lasso_nonneg_shrink(rng):
    """nonneg=True uses the one-sided shrink: iterates stay >= 0 and match
    the explicit prox composition."""
    from pycsou_tpu.opt import LassoDeconvolution

    H, W = 32, 32
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    h = np.outer(g, g).astype(np.float32)
    h /= h.sum()
    A = Convolve2D((H, W), h)
    y = A(jnp.asarray(np.abs(rng.standard_normal((H, W))), jnp.float32))
    s = LassoDeconvolution((H, W), y, 0.02, filt=h, nonneg=True, max_iter=100)
    st = s.run_fixed(50)
    assert float(jnp.min(st["x_temp"])) >= 0.0


def test_near_miss_note_logged(rng, caplog):
    """A configuration one default away from the fused pattern logs a
    one-line "why not fused" note (opt/fuse.py explain_*; r3 failed silently)."""
    import logging

    _, A, y = _problem(rng)
    H, W = y.shape
    F = SquaredL2Loss((H, W), data=y) * A
    l21 = 0.05 * L21Norm((2, H, W), axis=0)
    with caplog.at_level(logging.INFO, logger="pycsou_tpu.fuse"):
        s = PDS((H, W), F=F, H=l21, K=Gradient((H, W), kind="backward"), tau=0.1)
    assert s._fused is None
    assert any("NOT fused" in r.message and "backward" in r.message for r in caplog.records)

    # a totally unrelated config logs nothing
    caplog.clear()
    from pycsou_tpu.func.penalty import L2Norm
    from pycsou_tpu.ops.basic import DenseOperator

    D = DenseOperator(jnp.eye(16))
    with caplog.at_level(logging.INFO, logger="pycsou_tpu.fuse"):
        PDS((4, 4), F=SquaredL2Loss((4, 4), data=jnp.ones((4, 4))),
            G=Segment((4, 4), 0.0, 1.0), H=0.1 * L2Norm((4, 4)), tau=0.1)
    assert not any("NOT fused" in r.message for r in caplog.records)


def test_fbs_routes_to_fused_fista(rng):
    """FBS (PDS with H=None) at rho=1 is plain proximal gradient == FISTA
    with zero momentum: the matcher routes it onto the fused LASSO engine
    and the iterates match the generic chain exactly (VERDICT r4 task 2)."""
    from pycsou_tpu.func.penalty import L1Norm
    from pycsou_tpu.opt import FBS
    from pycsou_tpu.opt.lasso import LassoDeconvolution

    h, A, y = _problem(rng)
    Hs = y.shape
    mk = lambda fuse: FBS(
        Hs, F=SquaredL2Loss(Hs, data=y) * A, G=0.02 * L1Norm(Hs),
        rho=1.0, max_iter=200, fuse=fuse,
    )
    fused, generic = mk(True), mk(False)
    assert isinstance(fused._fused, LassoDeconvolution)
    assert fused._fused.acceleration is None
    assert generic._fused is None
    st_f = fused.run_fixed(40)
    st_g = generic.run_fixed(40)
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )
    # solve() keeps working end-to-end on the delegate state layout
    info = mk(True).solve()
    assert info.n_iter > 0


def test_fbs_rho_relaxation_stays_generic(rng, caplog):
    """rho != 1 blends with the previous iterate — not expressible in the
    fused FISTA kernel, so the matcher declines and says why."""
    import logging

    from pycsou_tpu.func.penalty import L1Norm
    from pycsou_tpu.opt import FBS

    h, A, y = _problem(rng)
    Hs = y.shape
    with caplog.at_level(logging.WARNING, logger="pycsou_tpu.fuse"):
        solver = FBS(Hs, F=SquaredL2Loss(Hs, data=y) * A, G=0.02 * L1Norm(Hs), max_iter=50)
    assert solver._fused is None
    assert any("rho" in r.message for r in caplog.records)


def test_cps_tv_denoise_fuses_and_matches_generic(rng):
    """CPS TV denoising (F=None, data prox in G) fuses onto the denoise
    TVDeconvolution via the tau' = tau/(1+2tau) identity — iterates equal
    the generic Chambolle-Pock chain exactly."""
    H, W = 32, 32
    y = jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    mk = lambda fuse: CPS(
        (H, W), G=SquaredL2Loss((H, W), data=y),
        H=0.1 * L21Norm((2, H, W), axis=0), K=Gradient((H, W)),
        max_iter=200, fuse=fuse,
    )
    fused, generic = mk(True), mk(False)
    assert isinstance(fused._fused, TVDeconvolution)
    # denoise: identity Gram, elementwise data gradient 2 (x - y)
    assert not fused._fused.nonneg and fused._fused.gram is None
    st_f = fused.run_fixed(60)
    st_g = generic.run_fixed(60)
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )
    z_f = np.stack([np.asarray(st_f["z0"]), np.asarray(st_f["z1"])])
    np.testing.assert_allclose(z_f, np.asarray(st_g["z"]), rtol=1e-4, atol=1e-5)


def test_cps_aniso_tv_denoise_fuses(rng):
    from pycsou_tpu.func.penalty import L1Norm

    H, W = 24, 24
    y = jnp.asarray(rng.standard_normal((H, W)), jnp.float32)
    mk = lambda fuse: CPS(
        (H, W), G=SquaredL2Loss((H, W), data=y),
        H=0.1 * L1Norm((2, H, W)), K=Gradient((H, W)),
        max_iter=100, fuse=fuse,
    )
    fused = mk(True)
    assert isinstance(fused._fused, TVDeconvolution) and not fused._fused.iso
    st_f = fused.run_fixed(40)
    st_g = mk(False).run_fixed(40)
    np.testing.assert_allclose(
        np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5
    )

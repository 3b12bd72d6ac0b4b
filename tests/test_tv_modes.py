"""Every TVDeconvolution data-term mode against the unfused generic PDS
chain, and the removed engine names.

The PDS expression matcher (opt/fuse.py) rewrites each supported
``PDS(F, G, H, K)`` configuration onto ``TVDeconvolution``; the rewrite must
compute the generic chain's Condat-Vu iterates (reference update rule
pycsou/opt/proxalgs.py:343-355) in every mode: denoising,
rank-1 / rank-2 / full-rank deconvolution, sampling masks, and blur followed
by a mask, isotropic and anisotropic alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
from pycsou_tpu.func.penalty import L1Norm, L21Norm
from pycsou_tpu.ops.conv import Convolve2D
from pycsou_tpu.ops.diff import Gradient
from pycsou_tpu.ops.sampling import Masking
from pycsou_tpu.opt import PDS, TVDeconvolution
from pycsou_tpu.opt.tv import REMOVED_STENCILS


def _psf(kind, rng):
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    if kind == "rank1":
        h = np.outer(g, g)
    elif kind == "rank2":
        g2 = np.exp(-((np.arange(5) - 2) ** 2) / 0.8)
        h = np.outer(g, g) + 0.4 * np.outer(g2, np.linspace(0.5, 1.5, 5))
    else:
        h = np.abs(np.random.default_rng(9).standard_normal((5, 5)))
    return (h / h.sum()).astype(np.float32)


def _pds(mode, shape, rng, iso, fuse):
    H, W = shape
    keep = np.random.default_rng(5).random(shape) < 0.6
    x_true = jnp.asarray(np.abs(np.random.default_rng(6).standard_normal(shape)), jnp.float32)
    if mode == "denoise":
        op = None
    elif mode in ("rank1", "rank2", "full"):
        op = Convolve2D(shape, _psf(mode, rng))
    elif mode == "mask":
        op = Masking(shape, keep)
    else:  # blur followed by a sampling mask
        op = Masking(shape, keep) * Convolve2D(shape, _psf("rank1", rng))
    y = x_true if op is None else op(x_true)
    F = SquaredL2Loss(shape if op is None else op.codim_shape, data=y)
    F = F if op is None else F * op
    pen = L21Norm((2, H, W), axis=0) if iso else L1Norm((2, H, W))
    return PDS(
        shape, F=F, G=NonNegativeOrthant(shape), H=0.05 * pen,
        K=Gradient(shape), max_iter=100, fuse=fuse,
    )


MODES = ["denoise", "rank1", "rank2", "full", "mask", "blurmask"]


@pytest.mark.parametrize("iso", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_fused_mode_matches_generic_chain(rng, mode, iso):
    shape = (24, 40)
    fused = _pds(mode, shape, rng, iso, True)
    generic = _pds(mode, shape, rng, iso, False)
    assert isinstance(fused._fused, TVDeconvolution)
    assert fused._fused.iso == iso
    st_f = fused.run_fixed(25)
    st_g = generic.run_fixed(25)
    np.testing.assert_allclose(np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5)
    z_f = np.stack([np.asarray(st_f["z0"]), np.asarray(st_f["z1"])])
    np.testing.assert_allclose(z_f, np.asarray(st_g["z"]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 8), (33, 17), (1, 64), (64, 1)])
def test_fused_odd_shapes_match_generic_chain(rng, shape):
    """Degenerate and odd shapes: the stencil's edge rules (zero last
    row/column of the forward difference) hold at every size."""
    fused = _pds("denoise", shape, rng, True, True)
    generic = _pds("denoise", shape, rng, True, False)
    st_f = fused.run_fixed(20)
    st_g = generic.run_fixed(20)
    np.testing.assert_allclose(np.asarray(st_f["x"]), np.asarray(st_g["x"]), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", REMOVED_STENCILS)
def test_removed_stencil_engine_raises(name):
    y = jnp.zeros((32, 32), jnp.float32)
    with pytest.raises(ValueError, match="removed"):
        TVDeconvolution((32, 32), y, 0.1, stencil=name)


def test_removed_bandg_method_raises():
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    with pytest.raises(ValueError, match="removed"):
        Convolve2D((64, 64), np.outer(g, g), method="bandg")


@pytest.mark.parametrize("solver", ["tv", "lasso", "pmyula", "distributed", "spatial2d"])
def test_removed_use_pallas_option_is_refused(solver):
    """The engine switch went with the engines: passing it is an error, not
    a silently ignored keyword."""
    from pycsou_tpu.opt import LassoDeconvolution, PMYULA
    from pycsou_tpu.parallel.mesh import make_mesh
    from pycsou_tpu.parallel.solvers import DistributedTVDeconv2D, Spatial2DTVDeconv2D

    y = jnp.zeros((32, 32), jnp.float32)
    h = np.ones((3, 3), np.float32) / 9.0
    build = {
        "tv": lambda: TVDeconvolution((32, 32), y, 0.1, use_pallas="interpret"),
        "lasso": lambda: LassoDeconvolution((32, 32), y, 0.1, use_pallas="interpret"),
        "pmyula": lambda: PMYULA((32, 32), F=SquaredL2Loss((32, 32), data=y), use_pallas="interpret"),
        "distributed": lambda: DistributedTVDeconv2D((32, 32), h, y, 0.1, use_pallas="interpret"),
        "spatial2d": lambda: Spatial2DTVDeconv2D(
            (32, 32), h, y, 0.1, mesh=make_mesh((2, 2), ("sp0", "sp1")), use_pallas="interpret"
        ),
    }[solver]
    with pytest.raises(TypeError, match="use_pallas"):
        build()


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm"])
def test_solver_path_is_backend_independent(monkeypatch, platform):
    """No backend branch is left in the library: with the platform string
    patched, TVDeconvolution traces the same step and Convolve2D picks the
    same route."""
    y = jnp.asarray(np.random.default_rng(0).standard_normal((16, 24)), jnp.float32)
    h = _psf("rank1", np.random.default_rng(1))
    ref = TVDeconvolution((16, 24), y, 0.1, filt=h)
    want = str(jax.make_jaxpr(ref.step)(ref.initial_state()))
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    s = TVDeconvolution((16, 24), y, 0.1, filt=h)
    assert str(jax.make_jaxpr(s.step)(s.initial_state())) == want
    assert Convolve2D((16, 24), h).method == "band"
    assert Convolve2D((16, 24), _psf("rank2", np.random.default_rng(1))).method == "fft"

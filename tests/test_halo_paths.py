"""The sharded solvers' XLA halo path (``ppermute`` under ``shard_map``)
against the single-device ``TVDeconvolution``, on 2, 4 and 8 virtual CPU
devices, for every data-term mode each solver supports.

``DistributedTVDeconv2D`` row-shards over a 1-D mesh: banded rank-1 Gram,
FFT overlap-save Gram (rank 2 and full rank), forward + adjoint when the
local blocks are thinner than the kernel, sampling masks, denoising and
anisotropic TV.  ``Spatial2DTVDeconv2D`` shards rows and columns over a 2-D
mesh: banded rank-1 Gram, per-rank forward-then-adjoint composition (rank
2), and masks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pycsou_tpu.opt import TVDeconvolution
from pycsou_tpu.parallel import make_mesh
from pycsou_tpu.parallel.solvers import DistributedTVDeconv2D, Spatial2DTVDeconv2D

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

H, W = 64, 48
ITERS = 15


def _g(k, s):
    ax = np.arange(k) - k // 2
    return np.exp(-(ax**2) / (2 * s * s))


def _psf(kind):
    if kind == "rank1":
        h = np.outer(_g(5, 1.0), _g(5, 1.5))
    elif kind == "rank2":
        h = np.outer(_g(5, 1.0), _g(5, 1.5)) + 0.4 * np.outer(_g(5, 0.6), np.linspace(0.5, 1.5, 5))
    else:
        h = np.abs(np.random.default_rng(9).standard_normal((5, 5)))
    return (h / h.sum()).astype(np.float32)


def _data(shape=(H, W), seed=4):
    return jnp.asarray(np.abs(np.random.default_rng(seed).standard_normal(shape)), jnp.float32)


def _single(y, filt=None, mask=None, tau=None, iso=True, iters=ITERS):
    s = TVDeconvolution(y.shape, y, 0.05, filt=filt, mask=mask, tau=tau, isotropic=iso, max_iter=100)
    return s.run_fixed(iters)


def _check(x, st, rtol=2e-4, atol=2e-5):
    np.testing.assert_allclose(np.asarray(x), np.asarray(st["x"]), rtol=rtol, atol=atol)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("mode", ["rank1", "rank2", "full", "mask", "denoise", "aniso"])
def test_distributed_halo_path_matches_single_device(n_dev, mode):
    mesh = make_mesh((n_dev,), ("sp",))
    y = _data()
    filt = mask = None
    iso = mode != "aniso"
    if mode in ("rank1", "rank2", "full", "aniso"):
        filt = _psf("rank1" if mode == "aniso" else mode)
    elif mode == "mask":
        mask = jnp.asarray((np.random.default_rng(2).random((H, W)) < 0.6).astype(np.float32))
        y = mask * y
    else:
        filt = np.ones((1, 1), np.float32)
    dist = DistributedTVDeconv2D((H, W), filt, y, 0.05, mesh=mesh, isotropic=iso, mask=mask, max_iter=100)
    if mode == "rank1":
        assert dist._use_band
    if mode in ("rank2", "full"):
        assert dist._use_gram and not dist._use_band
    x, _ = dist.run(ITERS)
    assert not x.sharding.is_fully_replicated
    ref = _single(y, filt=None if mode == "denoise" else filt, mask=mask, tau=dist.tau, iso=iso)
    _check(x, ref)


@pytest.mark.parametrize("n_dev", [4, 8])
def test_distributed_forward_adjoint_path_matches_single_device(n_dev):
    """Blocks thinner than the kernel: the Gram strips do not fit, so each
    iteration runs the sharded forward and adjoint convolutions."""
    mesh = make_mesh((n_dev,), ("sp",))
    Hs = 4 * n_dev
    g = _g(5, 1.0)
    filt = (np.outer(g, g) / np.outer(g, g).sum()).astype(np.float32)
    y = _data((Hs, W))
    dist = DistributedTVDeconv2D((Hs, W), filt, y, 0.05, mesh=mesh, max_iter=100)
    assert not dist._use_gram and not dist._use_band
    x, _ = dist.run(ITERS)
    _check(x, _single(y, filt=filt, tau=dist.tau))


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2), (2, 2), (4, 2), (2, 4)])
@pytest.mark.parametrize("mode", ["rank1", "rank2", "mask"])
def test_spatial2d_halo_path_matches_single_device(mesh_shape, mode):
    mesh = make_mesh(mesh_shape, ("sp0", "sp1"))
    y = _data()
    filt = mask = None
    if mode == "mask":
        mask = jnp.asarray((np.random.default_rng(3).random((H, W)) < 0.6).astype(np.float32))
        y = mask * y
    else:
        filt = _psf(mode)
    dist = Spatial2DTVDeconv2D((H, W), filt, y, 0.05, mesh=mesh, mask=mask, max_iter=100)
    x, _ = dist.run(ITERS)
    _check(x, _single(y, filt=filt, mask=mask, tau=dist.tau))


def test_spatial2d_rank2_objective_matches_single_device():
    """The rank >= 2 Gram composition also scores the objective."""
    mesh = make_mesh((2, 2), ("sp0", "sp1"))
    y = _data()
    filt = _psf("rank2")
    dist = Spatial2DTVDeconv2D((H, W), filt, y, 0.05, mesh=mesh, max_iter=100)
    single = TVDeconvolution((H, W), y, 0.05, filt=filt, tau=dist.tau, max_iter=100)
    x = _data(seed=8)
    np.testing.assert_allclose(float(dist.objective(x)), float(single.objective(x)), rtol=2e-4)

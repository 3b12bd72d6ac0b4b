"""Sharded == single-device equality tests on the virtual 8-device CPU mesh
(the on-device version of the reference's serial-vs-parallel doctests,
SURVEY §4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pycsou_tpu.ops.conv import Convolve2D
from pycsou_tpu.ops.diff import Gradient
from pycsou_tpu.parallel import (
    DistributedTVDeconv2D,
    make_mesh,
    sharded_conv2d,
    sharded_conv2d_adjoint,
    sharded_grad2d,
    sharded_grad2d_adjoint,
)

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")


@pytest.fixture
def mesh():
    return make_mesh((8,), ("sp",))


def smap(mesh, f, in_specs, out_specs):
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs))


def test_sharded_grad_matches_global(rng, mesh):
    x = jnp.asarray(rng.standard_normal((32, 16)), dtype=jnp.float32)
    G = Gradient((32, 16))
    expected = G(x)
    f = smap(mesh, lambda b: sharded_grad2d(b, "sp"), (P("sp", None),), P(None, "sp", None))
    np.testing.assert_allclose(np.asarray(f(x)), np.asarray(expected), rtol=1e-5, atol=1e-6)


def test_sharded_grad_adjoint_matches_global(rng, mesh):
    g = jnp.asarray(rng.standard_normal((2, 32, 16)), dtype=jnp.float32)
    G = Gradient((32, 16))
    expected = G.adjoint(g)
    f = smap(mesh, lambda b: sharded_grad2d_adjoint(b, "sp"), (P(None, "sp", None),), P("sp", None))
    np.testing.assert_allclose(np.asarray(f(g)), np.asarray(expected), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kshape", [(3, 3), (5, 4)])
def test_sharded_conv_matches_global(rng, mesh, kshape):
    x = jnp.asarray(rng.standard_normal((32, 16)), dtype=jnp.float32)
    h = jnp.asarray(rng.standard_normal(kshape), dtype=jnp.float32)
    A = Convolve2D((32, 16), h, method="fft")
    expected = A(x)
    f = smap(mesh, lambda b: sharded_conv2d(b, h, "sp"), (P("sp", None),), P("sp", None))
    np.testing.assert_allclose(np.asarray(f(x)), np.asarray(expected), rtol=1e-3, atol=1e-4)

    expected_adj = A.adjoint(x)
    fa = smap(mesh, lambda b: sharded_conv2d_adjoint(b, h, "sp"), (P("sp", None),), P("sp", None))
    np.testing.assert_allclose(np.asarray(fa(x)), np.asarray(expected_adj), rtol=1e-3, atol=1e-4)


def test_distributed_tv_deconv_matches_single_device(rng, mesh):
    """8-way sharded PDS produces the SAME iterates as the single-device
    PrimalDualSplitting on an identical TV deconvolution problem."""
    from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu.func.penalty import L21Norm
    from pycsou_tpu.opt import PDS

    H, W = 32, 16
    h = jnp.asarray(rng.standard_normal((5, 5)) / 5, dtype=jnp.float32)
    x_true = jnp.asarray(np.abs(rng.standard_normal((H, W))), dtype=jnp.float32)
    A = Convolve2D((H, W), h)
    y = A(x_true) + 0.01 * jnp.asarray(rng.standard_normal((H, W)), dtype=jnp.float32)
    lam = 0.05

    dist = DistributedTVDeconv2D((H, W), h, y, lam, nonneg=True, mesh=mesh)
    xd, zd = dist.run(60)

    F = SquaredL2Loss((H, W), data=y) * A
    K = Gradient((H, W))
    Hfun = lam * L21Norm((2, H, W), axis=0)
    ref = PDS(
        (H, W), F=F, G=NonNegativeOrthant((H, W)), H=Hfun, K=K,
        tau=dist.tau, sigma=dist.sigma, rho=dist.rho, max_iter=100, fuse=False,
    )
    state = ref.run_fixed(60)
    np.testing.assert_allclose(np.asarray(xd), np.asarray(state["x"]), rtol=1e-3, atol=1e-4)
    # and the distributed solve actually reduces the objective
    assert dist.objective(xd) < dist.objective(dist.x0)


@pytest.mark.parametrize("kshape", [(5, 5), (4, 3), (3, 4), (7, 7)])
def test_sharded_gram_matches_fused_gram(rng, mesh, kshape):
    """Row-sharded fused Gram == single-device ConvGram2D (exact)."""
    from pycsou_tpu.parallel.spatial import sharded_conv2d_gram

    H, W = 64, 32
    h = jnp.asarray(rng.standard_normal(kshape), dtype=jnp.float32)
    A = Convolve2D((H, W), h, method="fft")
    x = jnp.asarray(rng.standard_normal((H, W)), dtype=jnp.float32)
    expected = A.gram(x)
    f = smap(mesh, lambda b: sharded_conv2d_gram(b, h, "sp"), (P("sp", None),), P("sp", None))
    np.testing.assert_allclose(np.asarray(f(x)), np.asarray(expected), rtol=2e-3, atol=2e-4)


def test_sharded_gram_single_device(rng):
    from pycsou_tpu.parallel import make_mesh
    from pycsou_tpu.parallel.spatial import sharded_conv2d_gram

    mesh1 = make_mesh((1,), ("sp",))
    H, W = 24, 16
    h = jnp.asarray(rng.standard_normal((5, 5)), dtype=jnp.float32)
    A = Convolve2D((H, W), h)
    x = jnp.asarray(rng.standard_normal((H, W)), dtype=jnp.float32)
    f = smap(mesh1, lambda b: sharded_conv2d_gram(b, h, "sp"), (P("sp", None),), P("sp", None))
    np.testing.assert_allclose(np.asarray(f(x)), np.asarray(A.gram(x)), rtol=2e-3, atol=2e-4)


def test_batched_2d_mesh_matches_per_image(rng):
    """dp x sp 2-D mesh: each image in the batch solves identically to a
    1-D-mesh per-image solve."""
    from pycsou_tpu.parallel import BatchedDistributedTVDeconv2D, make_mesh

    mesh2d = make_mesh((2, 4), ("dp", "sp"))
    H, W, B = 32, 16, 2
    h = jnp.asarray(rng.standard_normal((5, 5)) / 5, dtype=jnp.float32)
    A = Convolve2D((H, W), h)
    ys = []
    for _ in range(B):
        xt = jnp.asarray(np.abs(rng.standard_normal((H, W))), dtype=jnp.float32)
        ys.append(np.asarray(A(xt)))
    y = jnp.asarray(np.stack(ys))

    batched = BatchedDistributedTVDeconv2D((H, W), h, y, lam=0.05, mesh=mesh2d)
    xb, zb = batched.run(40)

    mesh1d = make_mesh((4,), ("sp",))
    for b in range(B):
        single = DistributedTVDeconv2D((H, W), h, ys[b], lam=0.05, mesh=mesh1d,
                                       tau=batched.tau, rho=batched.rho)
        xs, _ = single.run(40)
        np.testing.assert_allclose(
            np.asarray(xb)[b], np.asarray(xs), rtol=1e-4, atol=1e-5
        )


def test_distributed_solver_is_first_class(rng, mesh):
    """VERDICT r1 task 3: the distributed solver runs the full
    IterativeSolver machinery — stopping metric (GSPMD-reduced), on-device
    history, per-variable diagnostics — and can assert convergence to 1e-6
    on the mesh."""
    H, W = 32, 16
    h = jnp.asarray(rng.standard_normal((5, 5)) / 5, dtype=jnp.float32)
    x_true = jnp.asarray(np.abs(rng.standard_normal((H, W))), dtype=jnp.float32)
    A = Convolve2D((H, W), h)
    y = A(x_true)

    dist = DistributedTVDeconv2D(
        (H, W), h, y, 0.02, mesh=mesh, max_iter=3000, accuracy_threshold=1e-6
    )
    info = dist.solve()
    assert info.converged, f"did not reach 1e-6 in {info.n_iter} iters"
    assert info.history[info.n_iter - 1] <= 1e-6
    assert set(info.diagnostics) == {"x", "z"}
    # the solution is still sharded over the mesh
    assert not info["x"].sharding.is_fully_replicated


def test_distributed_solver_checkpoint_resume(rng, mesh, tmp_path):
    """Checkpoint/resume reaches the same iterate as an uninterrupted solve."""
    H, W = 32, 16
    h = jnp.asarray(rng.standard_normal((5, 5)) / 5, dtype=jnp.float32)
    y = jnp.asarray(np.abs(rng.standard_normal((H, W))), dtype=jnp.float32)
    mk = lambda: DistributedTVDeconv2D(
        (H, W), h, y, 0.05, mesh=mesh, max_iter=40, min_iter=5, accuracy_threshold=0.0, verbose=20
    )
    full = mk().solve()
    ck = str(tmp_path / "dist_ck")
    s1 = mk()
    s1.max_iter = 20
    s1.solve(checkpoint_dir=ck)  # stops at 20, checkpointed
    resumed = mk().solve(checkpoint_dir=ck)  # resumes 20 -> 40
    np.testing.assert_allclose(
        np.asarray(resumed["x"]), np.asarray(full["x"]), rtol=1e-4, atol=1e-5
    )


def _gauss_taps(k, s=1.5):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s * s))
    return g / np.sqrt((g**2).sum())


@pytest.mark.parametrize("K", [5, 7])
def test_sharded_sepgram_rank1_matches_single_device(rng, mesh, K):
    """Row-sharded banded rank-1 Gram (NO FFT) == SeparableConvGram2D."""
    from pycsou_tpu.kernels.band import make_gram_band
    from pycsou_tpu.parallel.spatial import sharded_sepgram_rank1

    H, W = 96, 32
    u, v = _gauss_taps(K), _gauss_taps(K, 2.0)
    h = jnp.asarray(np.outer(u, v), dtype=jnp.float32)
    A = Convolve2D((H, W), h)
    from pycsou_tpu.ops.conv import SeparableConvGram2D

    G = A.gram
    assert isinstance(G, SeparableConvGram2D)  # rank-1 must take the banded path
    x = jnp.asarray(rng.standard_normal((H, W)), dtype=jnp.float32)
    expected = G(x)

    def _jn(gp):
        (b0, b1, lead), Et, Eb, L = gp
        Et = None if Et is None else jnp.asarray(Et)
        Eb = None if Eb is None else jnp.asarray(Eb)
        return ((jnp.asarray(b0), jnp.asarray(b1), lead), Et, Eb, L)

    g_rows = _jn(make_gram_band(u, H))
    g_cols = _jn(make_gram_band(v, W))
    f = smap(
        mesh,
        lambda b: sharded_sepgram_rank1(b, g_rows, g_cols, "sp"),
        (P("sp", None),),
        P("sp", None),
    )
    np.testing.assert_allclose(np.asarray(f(x)), np.asarray(expected), rtol=1e-5, atol=1e-5)
    # exactness vs adjoint(apply(x)) too (the gram-parity invariant)
    np.testing.assert_allclose(
        np.asarray(f(x)), np.asarray(A.adjoint(A(x))), rtol=1e-4, atol=1e-4
    )


def test_distributed_tv_banded_gram_path(rng, mesh):
    """A rank-1 (Gaussian) PSF flips DistributedTVDeconv2D onto the banded
    Gram path, and its iterates still match the generic single-device PDS."""
    from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu.func.penalty import L21Norm
    from pycsou_tpu.opt import PDS

    H, W = 96, 32
    h = jnp.asarray(np.outer(_gauss_taps(7), _gauss_taps(7)), dtype=jnp.float32)
    x_true = jnp.asarray(np.abs(rng.standard_normal((H, W))), dtype=jnp.float32)
    A = Convolve2D((H, W), h)
    y = A(x_true) + 0.01 * jnp.asarray(rng.standard_normal((H, W)), dtype=jnp.float32)
    lam = 0.05

    dist = DistributedTVDeconv2D((H, W), h, y, lam, nonneg=True, mesh=mesh)
    assert dist._use_band, "rank-1 PSF must select the banded Gram"
    xd, _ = dist.run(60)

    F = SquaredL2Loss((H, W), data=y) * A
    ref = PDS(
        (H, W), F=F, G=NonNegativeOrthant((H, W)),
        H=lam * L21Norm((2, H, W), axis=0), K=Gradient((H, W)),
        tau=dist.tau, sigma=dist.sigma, rho=dist.rho, max_iter=100, fuse=False,
    )
    state = ref.run_fixed(60)
    np.testing.assert_allclose(np.asarray(xd), np.asarray(state["x"]), rtol=1e-3, atol=1e-4)


def test_distributed_tv_band_disabled_for_full_rank(rng, mesh):
    """A full-rank PSF must stay on the FFT Gram (banded path gated off)."""
    h = jnp.asarray(rng.standard_normal((5, 5)) / 5, dtype=jnp.float32)
    y = jnp.asarray(rng.standard_normal((64, 16)), dtype=jnp.float32)
    dist = DistributedTVDeconv2D((64, 16), h, y, 0.05, mesh=mesh)
    assert not dist._use_band and dist._use_gram


def test_sharded_sepgram_rank1_2d_mesh(rng):
    """Rank-1 banded Gram on a TRUE 2-D (2x4) spatial mesh == single-device."""
    from pycsou_tpu.kernels.band import make_gram_band
    from pycsou_tpu.parallel.spatial import sharded_sepgram_rank1_2d

    mesh2 = make_mesh((2, 4), ("sp0", "sp1"))
    H, W = 32, 64
    K = 5
    u, v = _gauss_taps(K), _gauss_taps(K, 2.0)
    h = jnp.asarray(np.outer(u, v), dtype=jnp.float32)
    A = Convolve2D((H, W), h)
    x = jnp.asarray(rng.standard_normal((H, W)), dtype=jnp.float32)
    expected = A.gram(x)

    def _jn(gp):
        (b0, b1, lead), Et, Eb, L = gp
        Et = None if Et is None else jnp.asarray(Et)
        Eb = None if Eb is None else jnp.asarray(Eb)
        return ((jnp.asarray(b0), jnp.asarray(b1), lead), Et, Eb, L)

    g_rows = _jn(make_gram_band(u, H))
    g_cols = _jn(make_gram_band(v, W))
    f = smap(
        mesh2,
        lambda b: sharded_sepgram_rank1_2d(b, g_rows, g_cols, "sp0", "sp1"),
        (P("sp0", "sp1"),),
        P("sp0", "sp1"),
    )
    np.testing.assert_allclose(np.asarray(f(x)), np.asarray(expected), rtol=1e-5, atol=1e-5)


def test_sharded_grad2d_2d_mesh(rng):
    from pycsou_tpu.parallel.spatial import sharded_grad2d_2d, sharded_grad2d_adjoint_2d

    mesh2 = make_mesh((2, 4), ("sp0", "sp1"))
    H, W = 16, 32
    G = Gradient((H, W))
    x = jnp.asarray(rng.standard_normal((H, W)), dtype=jnp.float32)
    f = smap(mesh2, lambda b: sharded_grad2d_2d(b, "sp0", "sp1"), (P("sp0", "sp1"),), P(None, "sp0", "sp1"))
    np.testing.assert_allclose(np.asarray(f(x)), np.asarray(G(x)), rtol=1e-5, atol=1e-6)
    g = jnp.asarray(rng.standard_normal((2, H, W)), dtype=jnp.float32)
    fa = smap(mesh2, lambda b: sharded_grad2d_adjoint_2d(b, "sp0", "sp1"), (P(None, "sp0", "sp1"),), P("sp0", "sp1"))
    np.testing.assert_allclose(np.asarray(fa(g)), np.asarray(G.adjoint(g)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kshape", [(5, 5), (6, 4)])
def test_sharded_sepconv2d_2d_mesh(rng, kshape):
    """Rank-1 separable conv apply/adjoint on a 2-D mesh == Convolve2D
    (VERDICT r2 task 8: the fully-sharded A / A^H used at solver init),
    including even-sized kernels (offset-convention parity)."""
    from pycsou_tpu.kernels.band import make_band_blocks
    from pycsou_tpu.parallel.spatial import (
        sharded_sepconv2d_2d,
        sharded_sepconv2d_adjoint_2d,
    )

    mesh2 = make_mesh((2, 4), ("sp0", "sp1"))
    H, W = 32, 64
    m0, m1 = kshape
    u = _gauss_taps(m0) + 0.1 * rng.standard_normal(m0)
    v = _gauss_taps(m1) + 0.1 * rng.standard_normal(m1)
    h = jnp.asarray(np.outer(u, v), dtype=jnp.float32)
    A = Convolve2D((H, W), h)
    x = jnp.asarray(rng.standard_normal((H, W)), dtype=jnp.float32)

    rp = (make_band_blocks(u, m0 // 2), m0 - 1)
    cp = (make_band_blocks(v, m1 // 2), m1 - 1)
    f = smap(
        mesh2,
        lambda b: sharded_sepconv2d_2d(b, rp, cp, "sp0", "sp1"),
        (P("sp0", "sp1"),),
        P("sp0", "sp1"),
    )
    np.testing.assert_allclose(np.asarray(f(x)), np.asarray(A(x)), rtol=1e-4, atol=1e-5)

    rpa = (make_band_blocks(u[::-1], m0 - 1 - m0 // 2), m0 - 1)
    cpa = (make_band_blocks(v[::-1], m1 - 1 - m1 // 2), m1 - 1)
    fa = smap(
        mesh2,
        lambda b: sharded_sepconv2d_adjoint_2d(b, rpa, cpa, "sp0", "sp1"),
        (P("sp0", "sp1"),),
        P("sp0", "sp1"),
    )
    np.testing.assert_allclose(
        np.asarray(fa(x)), np.asarray(A.adjoint(x)), rtol=1e-4, atol=1e-5
    )


def test_spatial2d_init_adjoint_is_sharded(rng):
    """Spatial2DTVDeconv2D's A^H y at init equals the single-device adjoint
    AND is materialised as (H/n0, W/n1) blocks per device."""
    from pycsou_tpu.parallel import Spatial2DTVDeconv2D

    mesh2 = make_mesh((2, 4), ("sp0", "sp1"))
    H, W = 32, 64
    h = jnp.asarray(np.outer(_gauss_taps(5), _gauss_taps(5)), dtype=jnp.float32)
    y = jnp.asarray(rng.standard_normal((H, W)), dtype=jnp.float32)
    dist = Spatial2DTVDeconv2D((H, W), h, y, 0.05, mesh=mesh2)
    expected = Convolve2D((H, W), h).adjoint(y)
    np.testing.assert_allclose(np.asarray(dist.atb), np.asarray(expected), rtol=1e-4, atol=1e-5)
    shard_shapes = {s.data.shape for s in dist.atb.addressable_shards}
    assert shard_shapes == {(H // 2, W // 4)}


def test_spatial2d_tv_deconv_matches_single_device(rng):
    """2-D-mesh (2x4) TV deconvolution == generic single-device PDS, and the
    first-class solve() machinery (metric/history) works on the 2-D mesh."""
    from pycsou_tpu.func import NonNegativeOrthant, SquaredL2Loss
    from pycsou_tpu.func.penalty import L21Norm
    from pycsou_tpu.opt import PDS
    from pycsou_tpu.parallel import Spatial2DTVDeconv2D

    mesh2 = make_mesh((2, 4), ("sp0", "sp1"))
    H, W = 32, 64
    h = jnp.asarray(np.outer(_gauss_taps(5), _gauss_taps(5)), dtype=jnp.float32)
    x_true = jnp.asarray(np.abs(rng.standard_normal((H, W))), dtype=jnp.float32)
    A = Convolve2D((H, W), h)
    y = A(x_true) + 0.01 * jnp.asarray(rng.standard_normal((H, W)), dtype=jnp.float32)
    lam = 0.05

    dist = Spatial2DTVDeconv2D((H, W), h, y, lam, nonneg=True, mesh=mesh2)
    xd, _ = dist.run(60)

    F = SquaredL2Loss((H, W), data=y) * A
    ref = PDS(
        (H, W), F=F, G=NonNegativeOrthant((H, W)),
        H=lam * L21Norm((2, H, W), axis=0), K=Gradient((H, W)),
        tau=dist.tau, sigma=dist.sigma, rho=dist.rho, max_iter=100, fuse=False,
    )
    state = ref.run_fixed(60)
    np.testing.assert_allclose(np.asarray(xd), np.asarray(state["x"]), rtol=1e-3, atol=1e-4)

    # first-class solve with stopping metric on the 2-D mesh
    info = Spatial2DTVDeconv2D(
        (H, W), h, y, lam, mesh=mesh2, max_iter=40, min_iter=5, accuracy_threshold=0.0
    ).solve()
    assert info.n_iter == 40 and np.isfinite(info.history[1:]).all()
    # objective decreases
    assert float(dist.objective(xd)) < float(dist.objective(dist.initial_state()["x"]))


def test_spatial2d_rejects_full_rank(rng):
    from pycsou_tpu.parallel import Spatial2DTVDeconv2D

    mesh2 = make_mesh((2, 4), ("sp0", "sp1"))
    h = jnp.asarray(rng.standard_normal((5, 5)), dtype=jnp.float32)
    with pytest.raises(ValueError, match="rank <= 4"):
        Spatial2DTVDeconv2D((32, 64), h, jnp.zeros((32, 64)), 0.05, mesh=mesh2)


def test_distributed_tv_rejects_multiaxis_mesh(rng):
    """DistributedTVDeconv2D shards rows over a 1-D mesh; a 2-D mesh must
    raise a clear error instead of an opaque FFT shape mismatch."""
    from pycsou_tpu.parallel import DistributedTVDeconv2D, make_mesh

    h = jnp.asarray(rng.standard_normal((3, 3)) / 3, jnp.float32)
    y = jnp.asarray(rng.standard_normal((32, 16)), jnp.float32)
    mesh2d = make_mesh((2, 4), ("sp", "b"))
    with pytest.raises(ValueError, match="1-D mesh"):
        DistributedTVDeconv2D((32, 16), h, y, 0.05, mesh=mesh2d)


def test_distributed_aniso_matches_single_device(rng):
    """DistributedTVDeconv2D(isotropic=False) == the single-device
    anisotropic solver across the mesh."""
    import numpy as np

    from pycsou_tpu.opt.tv import TVDeconvolution
    from pycsou_tpu.parallel import DistributedTVDeconv2D, make_mesh

    H, W = 64, 32
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    h = np.outer(g, g).astype(np.float32)
    h /= h.sum()
    y = np.abs(rng.standard_normal((H, W))).astype(np.float32)
    mesh = make_mesh(axis_names=("sp",))
    dist = DistributedTVDeconv2D((H, W), h, y, lam=0.05, nonneg=True,
                                 mesh=mesh, isotropic=False)
    single = TVDeconvolution((H, W), jnp.asarray(y), 0.05, filt=h, nonneg=True,
                             isotropic=False, max_iter=100)
    st_d = dist.run_fixed(30)
    st_s = single.run_fixed(30)
    np.testing.assert_allclose(
        np.asarray(st_d["x"]), np.asarray(st_s["x"]), rtol=2e-4, atol=2e-5
    )


def test_distributed_mask_mode_matches_single_device(rng):
    """DistributedTVDeconv2D(mask=...) — the distributed inpainting mode —
    equals the single-device diagonal-Gram solver across the mesh."""
    import numpy as np

    from pycsou_tpu.opt.tv import TVDeconvolution
    from pycsou_tpu.parallel import DistributedTVDeconv2D, make_mesh

    H, W = 64, 32
    keep = rng.random((H, W)) < 0.5
    m = keep.astype(np.float32)
    y_img = m * np.abs(rng.standard_normal((H, W))).astype(np.float32)
    mesh = make_mesh(axis_names=("sp",))
    dist = DistributedTVDeconv2D((H, W), None, y_img, lam=0.05, nonneg=True,
                                 mesh=mesh, mask=m)
    assert dist.mask is not None and dist.filt is None
    single = TVDeconvolution((H, W), jnp.asarray(y_img), 0.05, mask=jnp.asarray(m),
                             nonneg=True, max_iter=100)
    st_d = dist.run_fixed(30)
    st_s = single.run_fixed(30)
    np.testing.assert_allclose(
        np.asarray(st_d["x"]), np.asarray(st_s["x"]), rtol=2e-4, atol=2e-5
    )
    # objective parity too (observed pixels only)
    np.testing.assert_allclose(
        float(dist.objective(st_d["x"])), float(single.objective(st_s["x"])), rtol=1e-5
    )


def test_spatial2d_mask_mode_matches_single_device(rng):
    """Spatial2DTVDeconv2D(mask=...) on a 2-D (sp0, sp1) mesh == the
    single-device diagonal-Gram solver (elementwise grad per shard; the
    gradient-stencil halos ride sharded_grad2d_2d)."""
    import numpy as np

    from pycsou_tpu.opt.tv import TVDeconvolution
    from pycsou_tpu.parallel import Spatial2DTVDeconv2D, make_mesh

    H, W = 32, 64
    keep = rng.random((H, W)) < 0.5
    m = keep.astype(np.float32)
    y_img = m * np.abs(rng.standard_normal((H, W))).astype(np.float32)
    mesh = make_mesh((2, 4), ("sp0", "sp1"))
    dist = Spatial2DTVDeconv2D((H, W), None, y_img, lam=0.05, nonneg=True,
                               mesh=mesh, mask=m)
    assert dist.mask is not None
    single = TVDeconvolution((H, W), jnp.asarray(y_img), 0.05, mask=jnp.asarray(m),
                             nonneg=True, max_iter=100)
    st_d = dist.run_fixed(30)
    st_s = single.run_fixed(30)
    np.testing.assert_allclose(
        np.asarray(st_d["x"]), np.asarray(st_s["x"]), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        float(dist.objective(st_d["x"])), float(single.objective(st_s["x"])), rtol=1e-5
    )

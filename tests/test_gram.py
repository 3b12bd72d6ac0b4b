"""Fused convolution Gram: exactness against adjoint(apply) for all kernel
parities, and the LeastSquaresLoss fusion path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pycsou_tpu.ops.conv import Convolve2D


@pytest.mark.parametrize("kshape", [(3, 3), (5, 5), (4, 4), (5, 4), (1, 3), (7, 2)])
@pytest.mark.parametrize("shape", [(16, 16), (17, 13)])
def test_conv2d_gram_exact(rng, kshape, shape):
    h = jnp.asarray(rng.standard_normal(kshape), dtype=jnp.float32)
    A = Convolve2D(shape, h, method="fft")
    g = A.gram
    x = jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)
    expected = A.adjoint(A(x))
    np.testing.assert_allclose(np.asarray(g(x)), np.asarray(expected), rtol=1e-3, atol=1e-4)


def test_least_squares_loss_fusion(rng):
    from pycsou_tpu.func import SquaredL2Loss
    from pycsou_tpu.func.loss import LeastSquaresLoss

    shape = (16, 16)
    h = jnp.asarray(rng.standard_normal((5, 5)) / 5, dtype=jnp.float32)
    A = Convolve2D(shape, h)
    y = jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)
    F = SquaredL2Loss(shape, data=y) * A
    assert isinstance(F, LeastSquaresLoss)
    x = jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(F.gradient(x)), np.asarray(2 * A.adjoint(A(x) - y)), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(float(F(x)), float(jnp.sum((A(x) - y) ** 2)), rtol=1e-4)
    assert np.isclose(F.diff_lipschitz, 2 * A.lipschitz**2)


def test_least_squares_loss_dense(rng):
    """Generic operators keep working through the same node."""
    from pycsou_tpu.func import SquaredL2Loss
    from pycsou_tpu.func.loss import LeastSquaresLoss
    from pycsou_tpu.ops.basic import DenseOperator

    A = DenseOperator(jnp.asarray(rng.standard_normal((9, 6)), dtype=jnp.float32))
    A.compute_lipschitz_cst()
    y = jnp.asarray(rng.standard_normal(9), dtype=jnp.float32)
    F = SquaredL2Loss((9,), data=y) * A
    assert isinstance(F, LeastSquaresLoss)
    x = jnp.asarray(rng.standard_normal(6), dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(F.gradient(x)), np.asarray(2 * A.adjoint(A(x) - y)), rtol=1e-4, atol=1e-5
    )


@pytest.mark.parametrize("m", [3, 4, 7, 10])
def test_conv1d_gram_exact(rng, m):
    from pycsou_tpu.ops.conv import Convolve1D

    n = 48
    h = jnp.asarray(rng.standard_normal(m), dtype=jnp.float32)
    A = Convolve1D((n,), h, method="fft")
    g = A.gram
    x = jnp.asarray(rng.standard_normal(n), dtype=jnp.float32)
    np.testing.assert_allclose(
        np.asarray(g(x)), np.asarray(A.adjoint(A(x))), rtol=1e-3, atol=1e-4
    )


@pytest.mark.parametrize("kshape", [(3, 3), (5, 5), (4, 4), (5, 4), (7, 2)])
@pytest.mark.parametrize("shape", [(32, 32), (64, 48), (48, 32)])
def test_conv2d_gram_wrap_exact(rng, kshape, shape):
    """Exact-size circular Gram + wraparound corrections == adjoint(apply)."""
    from pycsou_tpu.ops.conv import ConvGram2D, next_fast_len

    assert all(next_fast_len(n) == n for n in shape)
    h = jnp.asarray(rng.standard_normal(kshape), dtype=jnp.float32)
    A = Convolve2D(shape, h, method="fft")
    g = ConvGram2D(A, wrap=True)
    assert g.wrap
    x = jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)
    expected = A.adjoint(A(x))
    np.testing.assert_allclose(np.asarray(g(x)), np.asarray(expected), rtol=2e-3, atol=2e-4)


def test_conv2d_gram_auto_policy(rng):
    from pycsou_tpu.ops.conv import ConvGram2D

    h = jnp.asarray(rng.standard_normal((5, 5)), dtype=jnp.float32)
    assert ConvGram2D(Convolve2D((64, 64), h)).wrap       # fast size
    assert not ConvGram2D(Convolve2D((65, 64), h)).wrap   # 65 not a fast size
    assert not ConvGram2D(Convolve2D((16, 64), h)).wrap   # 16 < 4*5


# -------------------- banded matmul (separable) gram path --------------------


def _gauss2d(k, s):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s**2))
    g2 = np.outer(g, g)
    return jnp.asarray(g2 / g2.sum(), jnp.float32)


def test_gram_dispatch_lowrank_vs_full(rng):
    """Gaussian PSFs route to the banded matmul gram; full-rank kernels keep
    the FFT path."""
    from pycsou_tpu.ops.conv import ConvGram2D, SeparableConvGram2D

    g = Convolve2D((64, 64), _gauss2d(15, 2.0)).gram
    assert isinstance(g, SeparableConvGram2D) and g.rank == 1
    full = Convolve2D((64, 64), jnp.asarray(rng.standard_normal((5, 5)), jnp.float32) + 0.0).gram
    # a random 5x5 kernel has numerical rank 5 > max_rank
    assert isinstance(full, ConvGram2D)


@pytest.mark.parametrize(
    "kshape,shape",
    [((15, 15), (64, 96)), ((8, 8), (100, 90)), ((129, 3), (200, 140)), ((2, 9), (40, 129))],
)
def test_separable_gram_exact(rng, kshape, shape):
    """Banded gram == adjoint(apply) for rank-1/2 kernels of all parities,
    including kernels at the 129-tap tile-reach limit."""
    from pycsou_tpu.ops.conv import SeparableConvGram2D

    u = rng.standard_normal(kshape[0])
    v = rng.standard_normal(kshape[1])
    h = jnp.asarray(np.outer(u, v), jnp.float32)
    A = Convolve2D(shape, h, method="fft")
    g = A.gram
    assert isinstance(g, SeparableConvGram2D)
    x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    expected = np.asarray(A.adjoint(A(x)))
    # scale-aware atol: entries span ~|expected|_max, f32 roundoff is relative
    atol = 1e-5 * float(np.max(np.abs(expected))) + 1e-5
    np.testing.assert_allclose(np.asarray(g(x)), expected, rtol=1e-3, atol=atol)
    # self-adjointness (dot test on the symmetric operator)
    y = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    np.testing.assert_allclose(
        float(jnp.vdot(y, g(x))), float(jnp.vdot(g(y), x)), rtol=1e-3
    )


def test_band_conv_matches_convolve1d_rows_cols(rng):
    """kernels/band.py 'same' semantics == the Convolve operators'."""
    from pycsou_tpu.kernels.band import band_conv_cols, band_conv_rows, make_band_blocks
    from pycsou_tpu.ops.conv import Convolve1D

    for K in (15, 4, 1):
        taps = rng.standard_normal(K).astype(np.float32)
        plan = make_band_blocks(taps, K // 2)
        C = Convolve1D((130,), taps, method="fft")
        x = jnp.asarray(rng.standard_normal((7, 130)), jnp.float32)
        want = jnp.stack([C(row) for row in x])
        got = band_conv_cols(x, plan)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-5)
        got_r = band_conv_rows(x.T, plan)
        np.testing.assert_allclose(np.asarray(got_r), np.asarray(want.T), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "shape,kshape",
    [((12, 14, 10), (3, 5, 4)), ((16, 12, 10, 6), (3, 3, 2, 2)), ((20,), (5,))],
)
def test_convnd_gram_exact(rng, shape, kshape):
    """Exact fused n-D Gram (1-D/3-D/4-D) == adjoint(apply)."""
    from pycsou_tpu.ops.conv import ConvolveND

    h = jnp.asarray(rng.standard_normal(kshape), jnp.float32)
    A = ConvolveND(shape, h)
    g = A.gram
    x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    expected = np.asarray(A.adjoint(A(x)))
    atol = 1e-5 * float(np.max(np.abs(expected))) + 1e-6
    np.testing.assert_allclose(np.asarray(g(x)), expected, rtol=1e-3, atol=atol)


def test_convolve1d_overlap_add(rng):
    """'overlap-add' == 'fft' for long signals (reference conv.py:163)."""
    from pycsou_tpu.ops.conv import Convolve1D

    for n, m in [(1000, 63), (5000, 128)]:
        x = jnp.asarray(rng.standard_normal(n), jnp.float32)
        h = rng.standard_normal(m).astype(np.float32)
        a = Convolve1D((n,), h, method="fft")
        b = Convolve1D((n,), h, method="overlap-add")
        np.testing.assert_allclose(np.asarray(b(x)), np.asarray(a(x)), rtol=1e-3, atol=1e-4)
        # adjoint consistency (via linear_transpose of the OA apply)
        y = jnp.asarray(rng.standard_normal(n), jnp.float32)
        lhs = float(jnp.vdot(y, b(x)))
        rhs = float(jnp.vdot(b.adjoint(y), x))
        np.testing.assert_allclose(lhs, rhs, rtol=1e-3)


@pytest.mark.parametrize("shape,ks", [((24, 30, 36), (7, 5, 7)), ((32, 24), (5, 7)), ((48,), (9,))])
def test_separable_convnd_gram_rank1(rng, shape, ks):
    """Rank-1 n-D kernels take the zero-FFT banded Gram; exact vs both
    adjoint(apply) and the FFT Gram."""
    from pycsou_tpu.ops.conv import ConvGramND, ConvolveND, SeparableConvGramND

    # anisotropic Gaussian: exactly rank-1, different width per axis
    us = []
    for i, k in enumerate(ks):
        ax = np.arange(k) - k // 2
        us.append(np.exp(-(ax**2) / (2 * (1.0 + 0.5 * i) ** 2)))
    filt = us[0]
    for u in us[1:]:
        filt = np.multiply.outer(filt, u)
    filt = (filt / filt.sum()).astype(np.float32)

    A = ConvolveND(shape, filt)
    g = A.gram
    assert isinstance(g, SeparableConvGramND)
    x = jnp.asarray(rng.standard_normal(shape), jnp.float32)
    expected = np.asarray(A.adjoint(A(x)))
    atol = 1e-5 * float(np.max(np.abs(expected))) + 1e-6
    np.testing.assert_allclose(np.asarray(g(x)), expected, rtol=1e-3, atol=atol)
    fft_g = ConvGramND(A)
    np.testing.assert_allclose(np.asarray(g(x)), np.asarray(fft_g(x)), rtol=1e-3, atol=atol)


def test_separable_convnd_gram_rejects_nonseparable(rng):
    from pycsou_tpu.ops.conv import ConvGramND, ConvolveND

    h = rng.standard_normal((3, 3, 3)).astype(np.float32)  # full-rank tensor
    A = ConvolveND((16, 16, 16), h)
    assert isinstance(A.gram, ConvGramND)


def test_rank1_factors_nd_roundtrip(rng):
    from pycsou_tpu.ops.conv import rank1_factors_nd

    u = rng.standard_normal(5)
    v = rng.standard_normal(7)
    w = rng.standard_normal(3)
    filt = np.multiply.outer(np.multiply.outer(u, v), w)
    us = rank1_factors_nd(filt)
    assert us is not None
    rec = np.multiply.outer(np.multiply.outer(us[0], us[1]), us[2])
    np.testing.assert_allclose(rec, filt, rtol=1e-6, atol=1e-9)
    assert rank1_factors_nd(rng.standard_normal((3, 3, 3))) is None


@pytest.mark.parametrize(
    "n_shape,m_shape",
    [((5, 40), (8, 3)), ((40, 5), (3, 8)), ((4, 40), (9, 3)), ((6, 6), (9, 9))],
)
def test_fft_gram_small_images(rng, n_shape, m_shape):
    """Images smaller than the kernel reach (n < m-1 per axis): the frame
    corrections must clamp their slab starts (silent-wrong before the fix)."""
    h = jnp.asarray(rng.standard_normal(m_shape), jnp.float32)
    A = Convolve2D(n_shape, h, method="fft")
    x = jnp.asarray(rng.standard_normal(n_shape), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(A.gram(x)), np.asarray(A.adjoint(A(x))), rtol=1e-4, atol=1e-4
    )


def test_gram1d_small_signal(rng):
    from pycsou_tpu.ops.conv import Convolve1D

    A = Convolve1D((4,), jnp.asarray(rng.standard_normal(9), jnp.float32), method="fft")
    x = jnp.asarray(rng.standard_normal(4), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(A.gram(x)), np.asarray(A.adjoint(A(x))), rtol=1e-4, atol=1e-5
    )


def test_wrap_gram_rejects_small_images(rng):
    """Explicit wrap=True on an image too small for the wraparound bands
    must raise instead of silently returning a wrong Gram."""
    from pycsou_tpu.ops.conv import ConvGram2D

    h = jnp.asarray(rng.standard_normal((9, 9)), jnp.float32)
    A = Convolve2D((16, 16), h, method="fft")
    with pytest.raises(ValueError, match="2m-1"):
        ConvGram2D(A, wrap=True)


def test_explicit_bandg_rejects_ineligible(rng):
    """method='bandg' with a rank-1 or shape-ineligible kernel raises a
    clear ValueError instead of crashing on plan unpacking."""
    g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
    h1 = np.outer(g, g).astype(np.float32)  # rank 1
    with pytest.raises(ValueError, match="bandg"):
        Convolve2D((512, 512), h1, method="bandg")

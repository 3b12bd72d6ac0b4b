"""Every ``Convolve2D`` route (band / fft / direct, and the auto choice)
against a numpy/scipy reference, for rank-1, rank-2, rank-6 and full-rank
kernels: apply, adjoint and the fused Gram.

The reference is the definition of the 'same' convolution with the
reference's centre offset ``m // 2`` (linop/conv.py:159-162): a full
``scipy.signal.convolve2d`` cropped at that offset; the adjoint is the
cropped full correlation, zero-padded back to the full extent.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.signal import convolve2d

from pycsou_tpu.ops.conv import ConvGram2D, Convolve2D, SeparableConvGram2D

SHAPE = (40, 36)


def _kernel(rank, m=(7, 5), seed=3):
    r = np.random.default_rng(seed)
    if rank == "full":
        return np.abs(r.standard_normal(m)).astype(np.float32) / 10.0
    u = r.standard_normal((m[0], rank))
    v = r.standard_normal((m[1], rank))
    return (u @ v.T / 10.0).astype(np.float32)


def _apply_ref(x, h):
    o0, o1 = h.shape[0] // 2, h.shape[1] // 2
    full = convolve2d(x.astype(np.float64), h.astype(np.float64), mode="full")
    return full[o0 : o0 + x.shape[0], o1 : o1 + x.shape[1]]


def _adjoint_ref(y, h):
    n0, n1 = y.shape
    m0, m1 = h.shape
    o0, o1 = m0 // 2, m1 // 2
    # adjoint of "pad to full, crop at (o0, o1)": embed y in the full grid,
    # then correlate with h (= convolve with the flipped kernel, 'valid')
    full = np.zeros((n0 + m0 - 1, n1 + m1 - 1))
    full[o0 : o0 + n0, o1 : o1 + n1] = y
    return convolve2d(full, h[::-1, ::-1].astype(np.float64), mode="valid")


ROUTES = [
    (1, "band"), (1, "fft"), (1, "direct"), (1, "auto"),
    (2, "band"), (2, "fft"), (2, "direct"), (2, "auto"),
    (6, "fft"), (6, "direct"), (6, "auto"),
    ("full", "fft"), ("full", "direct"), ("full", "auto"),
]


@pytest.mark.parametrize("rank,method", ROUTES)
def test_apply_matches_numpy(rng, rank, method):
    h = _kernel(rank)
    A = Convolve2D(SHAPE, h, method=method)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    np.testing.assert_allclose(np.asarray(A.apply(jnp.asarray(x))), _apply_ref(x, h), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("rank,method", ROUTES)
def test_adjoint_matches_numpy(rng, rank, method):
    h = _kernel(rank)
    A = Convolve2D(SHAPE, h, method=method)
    y = rng.standard_normal(SHAPE).astype(np.float32)
    np.testing.assert_allclose(np.asarray(A.adjoint(jnp.asarray(y))), _adjoint_ref(y, h), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("rank,method", ROUTES)
def test_gram_matches_numpy(rng, rank, method):
    h = _kernel(rank)
    A = Convolve2D(SHAPE, h, method=method)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    want = _adjoint_ref(_apply_ref(x, h), h)
    np.testing.assert_allclose(np.asarray(A.gram.apply(jnp.asarray(x))), want, rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize(
    "rank,method,gram",
    [(1, "band", SeparableConvGram2D), (2, "fft", ConvGram2D), (6, "fft", ConvGram2D), ("full", "fft", ConvGram2D)],
)
def test_auto_rule(rank, method, gram):
    """The auto choice measured on the card: banded passes for rank-1
    kernels only; the FFT (apply and Gram) for everything else."""
    A = Convolve2D(SHAPE, _kernel(rank))
    assert A.method == method
    assert type(A.gram) is gram


def test_next_fast_len_is_five_smooth():
    from pycsou_tpu.ops.conv import next_fast_len

    for n in (1, 2, 7, 4110, 4124, 1025):
        L = next_fast_len(n)
        assert L >= n
        r = L
        for p in (2, 3, 5):
            while r % p == 0:
                r //= p
        assert r == 1, (n, L)
    assert next_fast_len(4110) == 4320

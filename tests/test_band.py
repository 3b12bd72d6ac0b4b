"""Unit tests for the banded-convolution engine (kernels/band.py): the
block-bidiagonal matmul form, the channel-conv lane form, and the exact Gram
plans — against brute-force numpy convolution (the reference's semantics,
/root/reference/pycsou/linop/conv.py:159-162 zero-boundary 'same')."""
import jax.numpy as jnp
import numpy as np
import pytest

from pycsou_tpu.kernels.band import (
    CHAN_TILE,
    band_conv_cols,
    band_conv_rows,
    chanconv_cols,
    gram_band_cols,
    gram_band_rows,
    gram_chanconv_cols,
    make_band_blocks,
    make_chanconv,
    make_gram_band,
)


def _same_conv_np(x, taps, offset):
    """out[j] = sum_k taps[k] x[j - k + offset], zero boundary (last axis)."""
    B, n = x.shape
    out = np.zeros_like(x)
    for k, t in enumerate(taps):
        src = np.arange(n) - k + offset
        valid = (src >= 0) & (src < n)
        out[:, valid] += t * x[:, src[valid]]
    return out


@pytest.mark.parametrize("K,offset", [(15, 7), (4, 2), (9, 0), (9, 8), (29, 14), (1, 0)])
def test_band_and_chanconv_match_bruteforce(rng, K, offset):
    taps = rng.standard_normal(K)
    x = rng.standard_normal((12, 96)).astype(np.float32)
    ref = _same_conv_np(x, taps, offset)

    plan = make_band_blocks(taps, offset)
    got_band = np.asarray(band_conv_cols(jnp.asarray(x), plan))
    np.testing.assert_allclose(got_band, ref, rtol=2e-5, atol=1e-5)

    Kc = make_chanconv(taps, offset)
    assert Kc is not None
    got_chan = np.asarray(chanconv_cols(jnp.asarray(x), Kc))
    np.testing.assert_allclose(got_chan, ref, rtol=2e-5, atol=1e-5)

    # row-direction twin on the transposed problem
    got_rows = np.asarray(band_conv_rows(jnp.asarray(x.T.copy()), plan)).T
    np.testing.assert_allclose(got_rows, ref, rtol=2e-5, atol=1e-5)


def test_chanconv_rejects_wide_band():
    # window-3 coverage is 2*tile - 1 per side
    assert make_chanconv(np.ones(4 * CHAN_TILE + 1), 2 * CHAN_TILE) is None


@pytest.mark.parametrize("K", [15, 4, 9, 1])
def test_gram_plans_match_dense_tht(rng, K):
    """Exact Gram plans (banded AND chanconv forms) == dense T^T T."""
    n = 96
    taps = rng.standard_normal(K)
    o = K // 2
    T = np.zeros((n, n))
    for j in range(n):
        for k in range(K):
            p = j - k + o
            if 0 <= p < n:
                T[j, p] += taps[k]
    G = T.T @ T

    x = rng.standard_normal((8, n)).astype(np.float32)
    ref = x @ G.T.astype(np.float32)

    gplan = make_gram_band(taps, n)
    got = np.asarray(gram_band_cols(jnp.asarray(x), gplan))
    scale = np.max(np.abs(ref)) + 1e-12
    np.testing.assert_allclose(got / scale, ref / scale, atol=3e-6)

    got_r = np.asarray(gram_band_rows(jnp.asarray(x.T.copy()), gplan)).T
    np.testing.assert_allclose(got_r / scale, ref / scale, atol=3e-6)

    if K > 1:
        acorr = np.convolve(taps, taps[::-1])
        Kc = make_chanconv(acorr, K - 1)
        assert Kc is not None
        _, Et, Eb, L = gplan
        E = None if Et is None else (Et, Eb)
        got_c = np.asarray(gram_chanconv_cols(jnp.asarray(x), Kc, E, L))
        np.testing.assert_allclose(got_c / scale, ref / scale, atol=3e-6)

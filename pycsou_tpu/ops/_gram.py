"""Fused exact Gram operator for 'same'-mode 2-D convolution.

For ``A = S o conv_full(h) o P`` ('same' linear convolution, zero boundary),
the normal-operator matvec is

    A^H A x = irfft(|H|^2 rfft(x))[:n]  -  A_full^T((I - S^T S) A_full x)

where the first term (the Gram of the FULL convolution, exact for FFT size
L >= n + 2m - 2) costs ONE rfft/irfft roundtrip, and the correction involves
only thin boundary strips of width ~kernel size, computed by small direct
convolutions.  A gradient-descent / PDS iteration then needs 2 large FFTs
instead of 4 (forward + adjoint).  Exactness is asserted against
``adjoint(apply(x))`` in tests/test_gram.py.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "conv_full_direct",
    "conv2d_gram_apply",
    "make_conv2d_gram",
    "convnd_gram_apply",
    "make_convnd_gram",
]


def conv_full_direct(a: jax.Array, h: jax.Array, h_hat=None) -> jax.Array:
    """Small 'full'-mode 2-D convolution for thin boundary strips.

    FFT-based: strip arrays are thin, so these FFTs are tiny next to the
    main Gram roundtrip.  Pass ``h_hat`` (from :func:`full_transfer` for the same
    slab shape) to skip the kernel FFT."""
    from pycsou_tpu.ops.conv import next_fast_len

    a0, a1 = a.shape
    m0, m1 = h.shape
    f0, f1 = a0 + m0 - 1, a1 + m1 - 1
    s = (next_fast_len(f0), next_fast_len(f1))
    A = jnp.fft.rfft2(a, s=s)
    H = jnp.fft.rfft2(h, s=s) if h_hat is None else h_hat
    return jnp.fft.irfft2(A * H, s=s)[:f0, :f1].astype(a.dtype)


def full_transfer(h: jax.Array, slab_shape: Tuple[int, int]) -> jax.Array:
    """Precompute the kernel rFFT used by ``conv_full_direct`` for slabs of
    ``slab_shape``."""
    from pycsou_tpu.ops.conv import next_fast_len

    s = (next_fast_len(slab_shape[0] + h.shape[0] - 1), next_fast_len(slab_shape[1] + h.shape[1] - 1))
    return jnp.fft.rfft2(h, s=s)


def _corr_into(out, strip, h, row_off: int, col_off: int, c_hat=None):
    """Add ``A_full^T`` of a strip located at full-grid offset (row_off,
    col_off) into ``out`` (the n-sized result).  Correlation = convolution
    with the flipped kernel, shifted by m-1."""
    m0, m1 = h.shape
    n0, n1 = out.shape
    c = conv_full_direct(strip, h[::-1, ::-1], h_hat=c_hat)
    # c index q corresponds to output index j = q + off - (m - 1)
    j0_lo = row_off - (m0 - 1)
    j1_lo = col_off - (m1 - 1)
    q0_lo = max(0, -j0_lo)
    q1_lo = max(0, -j1_lo)
    j0_start = max(0, j0_lo)
    j1_start = max(0, j1_lo)
    q0_hi = min(c.shape[0], n0 - j0_lo)
    q1_hi = min(c.shape[1], n1 - j1_lo)
    if q0_hi <= q0_lo or q1_hi <= q1_lo:
        return out
    block = c[q0_lo:q0_hi, q1_lo:q1_hi]
    return out.at[
        j0_start : j0_start + (q0_hi - q0_lo), j1_start : j1_start + (q1_hi - q1_lo)
    ].add(-block)


def make_pad_cache(dim_shape: Tuple[int, int], filt_np: np.ndarray) -> dict:
    """Precompute the kernel transfers used by ``conv2d_gram_apply``'s frame
    corrections (same role as :func:`make_wrap_cache` for the wrap path):
    each apply then spends FFTs only on the data slabs, not on the constant
    kernel — the frame convs otherwise each pay an image-height kernel rFFT
    per matvec inside solver loops."""
    n0, n1 = dim_shape
    filt = jnp.asarray(filt_np)
    m0, m1 = filt.shape
    o0, o1 = m0 // 2, m1 // 2
    b0, b1 = m0 - 1 - o0, m1 - 1 - o1
    f = filt[::-1, ::-1]
    cache = {}
    if o0 > 0:
        cache["frame_top_h"] = full_transfer(filt, (min(o0, n0), n1))
        cache["frame_top_c"] = full_transfer(f, (o0, n1 + m1 - 1))
    if b0 > 0:
        start0 = max(0, n0 - (m0 - 1))
        cache["frame_bot_h"] = full_transfer(filt, (n0 - start0, n1))
        cache["frame_bot_c"] = full_transfer(f, (b0, n1 + m1 - 1))
    if o1 > 0:
        cache["frame_left_h"] = full_transfer(filt, (n0, min(o1, n1)))
        cache["frame_left_c"] = full_transfer(f, (n0, o1))
    if b1 > 0:
        start1 = max(0, n1 - (m1 - 1))
        cache["frame_right_h"] = full_transfer(filt, (n0, n1 - start1))
        cache["frame_right_c"] = full_transfer(f, (n0, b1))
    # re/im split: real pairs keep closure-jit usable
    return {
        k: ((jnp.real(v), jnp.imag(v)) if jnp.iscomplexobj(v) else v)
        for k, v in cache.items()
    }


def conv2d_gram_apply(x: jax.Array, filt: jax.Array, h2_hat: jax.Array, L: Tuple[int, int], cache: dict = None) -> jax.Array:
    """Exact ``A^H A x`` for 'same' 2-D convolution (centre offset m//2).

    ``h2_hat = |rfft2(filt, L)|^2`` must be precomputed with
    ``L >= n + 2m - 2`` per axis; pass ``cache`` from :func:`make_pad_cache`
    to skip the per-apply kernel transfers of the frame corrections.
    """
    cache = cache or {}
    n0, n1 = x.shape
    m0, m1 = filt.shape
    o0, o1 = m0 // 2, m1 // 2
    b0, b1 = m0 - 1 - o0, m1 - 1 - o1

    # main term: Gram of the full (uncropped) convolution
    X = jnp.fft.rfft2(x, s=L)
    g = jnp.fft.irfft2(X * h2_hat, s=L)[:n0, :n1].astype(x.dtype)

    h = filt
    # --- boundary corrections: subtract A_full^T(frame * A_full x) --------
    if o0 > 0:
        top = conv_full_direct(x[:o0], h, h_hat=_cget(cache, "frame_top_h"))[:o0]
        g = _corr_into(g, top, h, row_off=0, col_off=0, c_hat=_cget(cache, "frame_top_c"))
    if b0 > 0:
        # clamped slab start (n0 may be < m0-1): local row r of the full
        # conv <-> global full row start_in + r; want rows [o0+n0, n0+m0-1)
        start0 = max(0, n0 - (m0 - 1))
        cb = conv_full_direct(x[start0:], h, h_hat=_cget(cache, "frame_bot_h"))
        r_lo = (o0 + n0) - start0
        bot = cb[r_lo : r_lo + b0]
        g = _corr_into(g, bot, h, row_off=o0 + n0, col_off=0, c_hat=_cget(cache, "frame_bot_c"))
    if o1 > 0:
        ml = conv_full_direct(x[:, :o1], h, h_hat=_cget(cache, "frame_left_h"))[o0 : o0 + n0, :o1]
        g = _corr_into(g, ml, h, row_off=o0, col_off=0, c_hat=_cget(cache, "frame_left_c"))
    if b1 > 0:
        start1 = max(0, n1 - (m1 - 1))
        cr = conv_full_direct(x[:, start1:], h, h_hat=_cget(cache, "frame_right_h"))
        c_lo = (o1 + n1) - start1
        mr = cr[o0 : o0 + n0, c_lo : c_lo + b1]
        g = _corr_into(g, mr, h, row_off=o0, col_off=o1 + n1, c_hat=_cget(cache, "frame_right_c"))
    return g


def _conv_rowlin_colcirc(slab: jax.Array, a: jax.Array, n_cols: int, a_hat=None) -> jax.Array:
    """Convolution of a thin slab with kernel ``a``: LINEAR along rows
    (zero-padded full mode), CIRCULAR along columns at period ``n_cols``.
    Output rows = slab_rows + a_rows - 1; columns = n_cols."""
    from pycsou_tpu.ops.conv import next_fast_len

    r = slab.shape[0] + a.shape[0] - 1
    s = (next_fast_len(r), n_cols)  # exact col length -> circular wrap
    S = jnp.fft.rfft2(slab, s=s)
    A = jnp.fft.rfft2(a, s=s) if a_hat is None else a_hat
    return jnp.fft.irfft2(S * A, s=s)[:r]


def _conv_collin_rowcirc(slab: jax.Array, a: jax.Array, n_rows: int, a_hat=None) -> jax.Array:
    """Transposed variant: circular along rows (period n_rows), linear along
    columns."""
    from pycsou_tpu.ops.conv import next_fast_len

    c = slab.shape[1] + a.shape[1] - 1
    s = (n_rows, next_fast_len(c))
    S = jnp.fft.rfft2(slab, s=s)
    A = jnp.fft.rfft2(a, s=s) if a_hat is None else a_hat
    return jnp.fft.irfft2(S * A, s=s)[:, :c]


def make_wrap_cache(dim_shape: Tuple[int, int], filt_np: np.ndarray) -> dict:
    """Precompute every small kernel transfer used by
    ``conv2d_gram_apply_wrap`` so each apply spends FFTs only on slabs."""
    from pycsou_tpu.ops.conv import next_fast_len

    n0, n1 = dim_shape
    filt = jnp.asarray(filt_np)
    m0, m1 = filt.shape
    p0, p1 = m0 - 1, m1 - 1
    o0, o1 = m0 // 2, m1 // 2
    b0, b1 = m0 - 1 - o0, m1 - 1 - o1
    f = filt[::-1, ::-1]
    a = conv_full_direct(filt, f)
    cache = {"a": a}

    def ft(kern, slab_shape):
        return full_transfer(kern, slab_shape)

    if p0 > 0:
        cache["band_row"] = jnp.fft.rfft2(a, s=(next_fast_len(p0 + 2 * p0), n1))
    if p1 > 0:
        cache["band_col"] = jnp.fft.rfft2(a, s=(n0, next_fast_len(p1 + 2 * p1)))
    if p0 > 0 and p1 > 0:
        cache["corner"] = ft(a, (p0, p1))
    if o0 > 0:
        cache["frame_top_h"] = ft(filt, (m0, n1))
        cache["frame_top_c"] = ft(f, (o0, n1 + m1 - 1))
    if b0 > 0:
        cache["frame_bot_h"] = ft(filt, (m0 - 1, n1))
        cache["frame_bot_c"] = ft(f, (b0, n1 + m1 - 1))
    if o1 > 0:
        cache["frame_left_h"] = ft(filt, (n0, o1))
        cache["frame_left_c"] = ft(f, (n0, o1))
    if b1 > 0:
        cache["frame_right_h"] = ft(filt, (n0, m1 - 1))
        cache["frame_right_c"] = ft(f, (n0, b1))
    # split complex transfers into re/im pairs: split-real keeps closure-jit
    # usable
    return {
        k: ((jnp.real(v), jnp.imag(v)) if jnp.iscomplexobj(v) else v)
        for k, v in cache.items()
    }


def _cget(cache: dict, key: str):
    v = cache.get(key)
    if v is None:
        return None
    if isinstance(v, tuple):
        return jax.lax.complex(v[0], v[1])
    return v


def conv2d_gram_apply_wrap(x: jax.Array, filt: jax.Array, h2_hat: jax.Array, cache: dict = None) -> jax.Array:
    """Exact ``A^H A x`` using the FFT at EXACTLY the image size (requires
    both image dims to already be fast FFT sizes, e.g. 4096).

    The circular Gram ``irfft(|rfft(h, n)|^2 rfft(x))`` equals the full-conv
    Gram plus wraparound terms confined to (m-1)-wide boundary bands; those
    are subtracted with thin-slab convolutions (circular along the
    non-wrapping axis), and the usual 'same'-crop frame corrections
    (conv2d_gram_apply) are subtracted on top.  ~21% fewer FFT points than
    the L >= n+2m-2 route at 4096^2.
    """
    n0, n1 = x.shape
    m0, m1 = filt.shape
    p0, p1 = m0 - 1, m1 - 1
    f = filt[::-1, ::-1]
    cache = cache or {}
    a = cache.get("a")
    if a is None:
        a = conv_full_direct(filt, f)  # autocorrelation, (2m0-1, 2m1-1)

    X = jnp.fft.rfft2(x)
    g = jnp.fft.irfft2(X * h2_hat, s=(n0, n1)).astype(x.dtype)

    # -- subtract row-wraparound terms (cols circular, as in g_circ) -------
    # Row algebra: slab row u = (x row) - slab offset; conv row t = u + s0
    # (s0 = d0 + p0) collapses to a d0-independent index (see each slice).
    # The CIRCULAR axis of the helper is shifted by its kernel half-width
    # (output col j1 lives at (j1 + p1) mod n1), hence the rolls.
    if p0 > 0:
        # top rows j0 in [0, p0): terms a[d0 > j0] x[j0 - d0 + n0] from the
        # bottom slab; t = (j0 - d0 + p0) + (d0 + p0) = j0 + 2 p0
        ct = _conv_rowlin_colcirc(x[n0 - p0 :], a, n1, a_hat=_cget(cache, "band_row"))
        g = g.at[:p0].add(-jnp.roll(ct[2 * p0 : 3 * p0], -p1, axis=1))
        # bottom rows j0 in [n0-p0, n0): terms a[d0 <= j0-n0] x[j0-d0-n0]
        # from the top slab; t = j0 - n0 + p0 in [0, p0)
        cb = _conv_rowlin_colcirc(x[:p0], a, n1, a_hat=_cget(cache, "band_row"))
        g = g.at[n0 - p0 :].add(-jnp.roll(cb[:p0], -p1, axis=1))
    # -- subtract col-wraparound terms (rows circular) ---------------------
    if p1 > 0:
        cl = _conv_collin_rowcirc(x[:, n1 - p1 :], a, n0, a_hat=_cget(cache, "band_col"))
        g = g.at[:, :p1].add(-jnp.roll(cl[:, 2 * p1 : 3 * p1], -p0, axis=0))
        cr = _conv_collin_rowcirc(x[:, :p1], a, n0, a_hat=_cget(cache, "band_col"))
        g = g.at[:, n1 - p1 :].add(-jnp.roll(cr[:, :p1], -p0, axis=0))
    # -- add back doubly-wrapped (corner) terms (subtracted twice) ---------
    if p0 > 0 and p1 > 0:
        for rows, r_out, r_sl in ((slice(n0 - p0, n0), slice(0, p0), slice(2 * p0, 3 * p0)),
                                  (slice(0, p0), slice(n0 - p0, n0), slice(0, p0))):
            for cols, c_out, c_sl in ((slice(n1 - p1, n1), slice(0, p1), slice(2 * p1, 3 * p1)),
                                      (slice(0, p1), slice(n1 - p1, n1), slice(0, p1))):
                cc = conv_full_direct(x[rows, cols], a, h_hat=_cget(cache, "corner"))
                g = g.at[r_out, c_out].add(cc[r_sl, c_sl])

    # -- finally subtract the 'same'-crop frame corrections ----------------
    o0, o1 = m0 // 2, m1 // 2
    b0, b1 = m0 - 1 - o0, m1 - 1 - o1
    h = filt
    if o0 > 0:
        top = conv_full_direct(x[:m0], h, h_hat=_cget(cache, "frame_top_h"))[:o0]
        g = _corr_into(g, top, h, row_off=0, col_off=0, c_hat=_cget(cache, "frame_top_c"))
    if b0 > 0:
        start0 = max(0, n0 - (m0 - 1))
        cb2 = conv_full_direct(x[start0:], h, h_hat=_cget(cache, "frame_bot_h"))
        r_lo = (o0 + n0) - start0
        bot = cb2[r_lo : r_lo + b0]
        g = _corr_into(g, bot, h, row_off=o0 + n0, col_off=0, c_hat=_cget(cache, "frame_bot_c"))
    if o1 > 0:
        ml = conv_full_direct(x[:, :o1], h, h_hat=_cget(cache, "frame_left_h"))[o0 : o0 + n0, :o1]
        g = _corr_into(g, ml, h, row_off=o0, col_off=0, c_hat=_cget(cache, "frame_left_c"))
    if b1 > 0:
        start1 = max(0, n1 - (m1 - 1))
        cr2 = conv_full_direct(x[:, start1:], h, h_hat=_cget(cache, "frame_right_h"))
        c_lo = (o1 + n1) - start1
        mr = cr2[o0 : o0 + n0, c_lo : c_lo + b1]
        g = _corr_into(g, mr, h, row_off=o0, col_off=o1 + n1, c_hat=_cget(cache, "frame_right_c"))
    return g


def make_conv2d_gram_wrap(dim_shape: Tuple[int, int], filt_np: np.ndarray):
    """Precompute |rfft2(h, n)|^2 for the exact-size (wraparound-corrected)
    Gram path."""
    H = jnp.fft.rfft2(jnp.asarray(filt_np), s=tuple(dim_shape))
    return (H * jnp.conj(H)).real


def make_conv2d_gram(dim_shape: Tuple[int, int], filt_np: np.ndarray, fft_shape: Tuple[int, int] = None):
    """Precompute (h2_hat, L) for ``conv2d_gram_apply``.  ``fft_shape`` may
    override the FFT size (must be >= n + 2m - 2 per axis)."""
    from pycsou_tpu.ops.conv import next_fast_len

    n0, n1 = dim_shape
    m0, m1 = filt_np.shape
    if fft_shape is None:
        L = (next_fast_len(n0 + 2 * m0 - 2), next_fast_len(n1 + 2 * m1 - 2))
    else:
        L = tuple(int(s) for s in fft_shape)
        if L[0] < n0 + 2 * m0 - 2 or L[1] < n1 + 2 * m1 - 2:
            raise ValueError("fft_shape must be >= n + 2m - 2 per axis")
    H = jnp.fft.rfft2(jnp.asarray(filt_np), s=L)
    h2_hat = (H * jnp.conj(H)).real
    return h2_hat, L


# ---------------------------------------------------------------------------
# N-dimensional exact fused Gram (extends conv2d_gram_apply to volumes —
# BASELINE's 3-D deconvolution config; reference has no 3-D convolution at
# all, SURVEY §2.3)
# ---------------------------------------------------------------------------


def _conv_full_nd(a: jax.Array, h: jax.Array, h_hat=None) -> jax.Array:
    """'full'-mode n-D convolution of a thin slab (FFT-based)."""
    from pycsou_tpu.ops.conv import next_fast_len

    full = tuple(sa + sh - 1 for sa, sh in zip(a.shape, h.shape))
    s = tuple(next_fast_len(f) for f in full)
    axes = tuple(range(a.ndim))
    A = jnp.fft.rfftn(a, s=s, axes=axes)
    H = jnp.fft.rfftn(h, s=s, axes=axes) if h_hat is None else h_hat
    out = jnp.fft.irfftn(A * H, s=s, axes=axes)
    return out[tuple(slice(0, f) for f in full)].astype(a.dtype)


def _corr_into_nd(out, strip, h, offs):
    """Subtract ``A_full^T`` of a slab located at full-grid offset ``offs``
    from ``out`` (n-D generalisation of ``_corr_into``)."""
    c = _conv_full_nd(strip, jnp.flip(h, tuple(range(h.ndim))))
    sl_out, sl_c = [], []
    for d in range(out.ndim):
        j_lo = offs[d] - (h.shape[d] - 1)
        q_lo = max(0, -j_lo)
        j_start = max(0, j_lo)
        q_hi = min(c.shape[d], out.shape[d] - j_lo)
        if q_hi <= q_lo:
            return out
        sl_c.append(slice(q_lo, q_hi))
        sl_out.append(slice(j_start, j_start + (q_hi - q_lo)))
    return out.at[tuple(sl_out)].add(-c[tuple(sl_c)])


def make_convnd_gram(dim_shape: Tuple[int, ...], filt_np: np.ndarray):
    """Precompute (|rfftn(h, L)|^2, L) for ``convnd_gram_apply``."""
    from pycsou_tpu.ops.conv import next_fast_len

    L = tuple(next_fast_len(n + 2 * m - 2) for n, m in zip(dim_shape, filt_np.shape))
    axes = tuple(range(len(L)))
    H = jnp.fft.rfftn(jnp.asarray(filt_np), s=L, axes=axes)
    return (H * jnp.conj(H)).real, L


def convnd_gram_apply(x: jax.Array, filt: jax.Array, h2_hat: jax.Array, L) -> jax.Array:
    """Exact ``A^H A x`` for 'same' n-D convolution: ONE rfftn/irfftn
    roundtrip (full-conv Gram) minus thin boundary-slab corrections.

    The 'same'-crop frame is decomposed axis by axis into 2d DISJOINT slabs:
    for axis j, the low/high slabs are restricted to the valid window on
    every axis < j — the n-D generalisation of ``conv2d_gram_apply``'s
    4-strip split."""
    nd = x.ndim
    n = x.shape
    m = filt.shape
    o = tuple(mk // 2 for mk in m)
    b = tuple(mk - 1 - ok for mk, ok in zip(m, o))
    axes = tuple(range(nd))

    X = jnp.fft.rfftn(x, s=L, axes=axes)
    g = jnp.fft.irfftn(X * h2_hat, s=L, axes=axes)[tuple(slice(0, nk) for nk in n)].astype(x.dtype)

    for j in range(nd):
        # thin input slabs feeding the low/high frame slabs of axis j
        for side in ("low", "high"):
            if side == "low" and o[j] == 0:
                continue
            if side == "high" and b[j] == 0:
                continue
            # input slab along axis j
            if side == "low":
                sl_in = slice(0, min(m[j], n[j]))
            else:
                sl_in = slice(max(0, n[j] - (m[j] - 1)), n[j])
            xs = x[tuple(slice(None) if d != j else sl_in for d in range(nd))]
            cs = _conv_full_nd(xs, filt)
            # full-grid offsets and restriction of the conv output:
            # axes < j: valid window [o_d, o_d + n_d); axis j: the frame
            # rows; axes > j: everything.
            sel, offs = [], []
            for d in range(nd):
                if d < j:
                    sel.append(slice(o[d], o[d] + n[d]))
                    offs.append(o[d])
                elif d > j:
                    sel.append(slice(None))
                    offs.append(0)
                elif side == "low":
                    sel.append(slice(0, o[j]))
                    offs.append(0)
                else:
                    # local row r of cs <-> global full index start_in + r
                    start_in = max(0, n[j] - (m[j] - 1))
                    lo = (o[j] + n[j]) - start_in
                    sel.append(slice(lo, lo + b[j]))
                    offs.append(o[j] + n[j])
            g = _corr_into_nd(g, cs[tuple(sel)], filt, tuple(offs))
    return g

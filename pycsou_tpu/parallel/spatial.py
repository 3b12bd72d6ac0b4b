"""Spatial domain decomposition: halo-exchanged stencils and overlap-save
convolution for row-sharded images.

This is the analogue of "scale the big dimension" (SURVEY §5):
the image/volume is partitioned across the mesh along its leading axis, and

* finite-difference stencils exchange ONE halo row with ring neighbours via
  ``lax.ppermute`` (O(W) bytes between devices per step);
* FFT convolution becomes overlap-save: exchange ``kernel//2`` halo rows,
  convolve locally, crop — bitwise equal to the global zero-boundary 'same'
  convolution;
* inner products / norms reduce with ``psum``.

All functions here run INSIDE a ``shard_map`` region (they reference a mesh
``axis_name``); the distributed solvers in ``pycsou_tpu.parallel.solvers``
wrap them into full jitted iterations.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "halo_from_prev",
    "halo_from_next",
    "sharded_fdiff_rows",
    "sharded_fdiff_rows_adjoint",
    "sharded_grad2d",
    "sharded_grad2d_adjoint",
    "sharded_conv2d",
    "sharded_conv2d_adjoint",
    "sharded_conv2d_gram",
    "sharded_sepgram_rank1",
    "halo_from_prev_cols",
    "halo_from_next_cols",
    "sharded_fdiff_cols",
    "sharded_fdiff_cols_adjoint",
    "sharded_grad2d_2d",
    "sharded_grad2d_adjoint_2d",
    "sharded_sepgram_rank1_2d",
    "sharded_sepconv2d_2d",
    "sharded_sepconv2d_adjoint_2d",
    "pdot",
    "pnorm",
]


def _axis_size(axis_name: str) -> int:
    return int(jax.lax.axis_size(axis_name))


def halo_from_prev(block: jax.Array, h: int, axis_name: str) -> jax.Array:
    """Last ``h`` rows of the previous device's block (zeros on device 0)."""
    if h == 0:
        return jnp.zeros((0,) + block.shape[1:], block.dtype)
    n = _axis_size(axis_name)
    send = block[-h:]
    if n == 1:
        return jnp.zeros_like(send)
    perm = [(i, i + 1) for i in range(n - 1)]
    return jax.lax.ppermute(send, axis_name, perm)


def halo_from_next(block: jax.Array, h: int, axis_name: str) -> jax.Array:
    """First ``h`` rows of the next device's block (zeros on the last device)."""
    if h == 0:
        return jnp.zeros((0,) + block.shape[1:], block.dtype)
    n = _axis_size(axis_name)
    send = block[:h]
    if n == 1:
        return jnp.zeros_like(send)
    perm = [(i + 1, i) for i in range(n - 1)]
    return jax.lax.ppermute(send, axis_name, perm)


def _is_last(axis_name: str) -> jax.Array:
    return jax.lax.axis_index(axis_name) == _axis_size(axis_name) - 1


def sharded_fdiff_rows(block: jax.Array, axis_name: str, step: float = 1.0) -> jax.Array:
    """Row-wise forward difference of a row-sharded array; globally identical
    to ``ops.diff.fdiff_forward(x, axis=0)`` (zero last row)."""
    nxt = halo_from_next(block, 1, axis_name)
    ext = jnp.concatenate([block, nxt], axis=0)
    d = (ext[1:] - ext[:-1]) / step
    scale = jnp.where(_is_last(axis_name), 0.0, 1.0).astype(d.dtype)
    return d.at[-1].multiply(scale)


def sharded_fdiff_rows_adjoint(y: jax.Array, axis_name: str, step: float = 1.0) -> jax.Array:
    """Adjoint: ``(D^T y)_j = (y_{j-1} - y_j)/step`` with the globally-last
    row of y treated as 0."""
    scale = jnp.where(_is_last(axis_name), 0.0, 1.0).astype(y.dtype)
    y = y.at[-1].multiply(scale)
    prev = halo_from_prev(y, 1, axis_name)
    ext = jnp.concatenate([prev, y], axis=0)
    return (ext[:-1] - ext[1:]) / step


def sharded_grad2d(block: jax.Array, axis_name: str, step: float = 1.0) -> jax.Array:
    """(2, h, W) forward-difference gradient of a row-sharded image;
    globally equals ``ops.diff.Gradient``."""
    from pycsou_tpu.ops.diff import fdiff_forward

    d0 = sharded_fdiff_rows(block, axis_name, step)
    d1 = fdiff_forward(block, 1, step)
    return jnp.stack([d0, d1], axis=0)


def sharded_grad2d_adjoint(g: jax.Array, axis_name: str, step: float = 1.0) -> jax.Array:
    from pycsou_tpu.ops.diff import fdiff_forward_adjoint

    return sharded_fdiff_rows_adjoint(g[0], axis_name, step) + fdiff_forward_adjoint(g[1], 1, step)


def conv_transfer(filt: jax.Array, ext_shape: Tuple[int, int]) -> jax.Array:
    """Precompute the rFFT transfer function of ``filt`` for a halo-extended
    local block of ``ext_shape`` (avoids one full-size FFT per matvec)."""
    from pycsou_tpu.ops.conv import next_fast_len

    n0, n1 = ext_shape
    m0, m1 = filt.shape
    s = (next_fast_len(n0 + m0 - 1), next_fast_len(n1 + m1 - 1))
    return jnp.fft.rfft2(filt, s=s)


def _local_conv_same(x: jax.Array, filt: jax.Array, o0: int, o1: int, h_hat=None) -> jax.Array:
    """'same'-size zero-boundary 2-D convolution with explicit centre offsets
    (FFT path; x is the halo-extended local block)."""
    from pycsou_tpu.ops.conv import next_fast_len

    n0, n1 = x.shape
    m0, m1 = filt.shape
    s = (next_fast_len(n0 + m0 - 1), next_fast_len(n1 + m1 - 1))
    X = jnp.fft.rfft2(x, s=s)
    H = jnp.fft.rfft2(filt, s=s) if h_hat is None else h_hat
    full = jnp.fft.irfft2(X * H, s=s)
    return full[o0 : o0 + n0, o1 : o1 + n1].astype(x.dtype)


def _os_conv(block: jax.Array, filt: jax.Array, o0: int, o1: int, axis_name: str, h_hat=None) -> jax.Array:
    """Overlap-save: exchange halo rows, convolve the extended block, crop."""
    m0 = filt.shape[0]
    halo_lo = m0 - 1 - o0  # rows needed from the previous block
    halo_hi = o0  # rows needed from the next block
    if max(halo_lo, halo_hi) > block.shape[0]:
        # block[-h:] would return FEWER than h rows and silently misalign
        # the ext crop on every device but the first
        raise ValueError(
            f"local block height {block.shape[0]} < halo width "
            f"{max(halo_lo, halo_hi)} (kernel {m0} rows over too many devices)"
        )
    parts = []
    if halo_lo:
        parts.append(halo_from_prev(block, halo_lo, axis_name))
    parts.append(block)
    if halo_hi:
        parts.append(halo_from_next(block, halo_hi, axis_name))
    ext = jnp.concatenate(parts, axis=0) if len(parts) > 1 else block
    y = _local_conv_same(ext, filt, o0, o1, h_hat=h_hat)
    return y[halo_lo : halo_lo + block.shape[0]]


def sharded_conv2d(block: jax.Array, filt: jax.Array, axis_name: str, h_hat=None) -> jax.Array:
    """Row-sharded 'same' 2-D convolution, globally equal to
    ``ops.conv.Convolve2D`` (centre offset m//2, zero boundary).  Pass
    ``h_hat = conv_transfer(filt, ext_shape)`` to amortise the filter FFT."""
    m0, m1 = filt.shape
    return _os_conv(block, filt, m0 // 2, m1 // 2, axis_name, h_hat=h_hat)


def sharded_conv2d_adjoint(block: jax.Array, filt: jax.Array, axis_name: str, h_hat=None) -> jax.Array:
    """Adjoint = correlation: convolution with the flipped kernel at the
    complementary offset.  ``h_hat`` must be the transfer of the FLIPPED
    kernel when provided."""
    m0, m1 = filt.shape
    return _os_conv(block, jnp.flip(filt, (0, 1)), m0 - 1 - m0 // 2, m1 - 1 - m1 // 2, axis_name, h_hat=h_hat)


def sharded_conv2d_gram(block: jax.Array, filt: jax.Array, axis_name: str, acorr_hat=None) -> jax.Array:
    """Row-sharded fused Gram ``A^H A x`` of the 'same' zero-boundary 2-D
    convolution — globally exact vs ``ops.conv.ConvGram2D``.

    Main term: overlap-save convolution with the kernel AUTOCORRELATION
    (support 2m-1, centre offset m-1) — one local FFT roundtrip with an
    (m-1)-row halo exchange.  Boundary-strip corrections (see ops/_gram.py)
    are computed from the same halo-extended block with small FFT convs;
    top/bottom corrections are masked onto the first/last device.

    Requires the local block height >= kernel height.
    """
    from pycsou_tpu.ops._gram import conv_full_direct

    hl, W = block.shape
    m0, m1 = filt.shape
    if hl < m0:
        raise ValueError("local block must be at least as tall as the kernel")
    if W < 2 * m1 - 1:
        # the right-strip slice ext[:, W-(m1-1):] needs the full unwrapped
        # reach; narrower images would silently select wrong columns
        raise ValueError(f"image width {W} must be >= 2*m1-1 = {2 * m1 - 1}")
    o0, o1 = m0 // 2, m1 // 2
    b0, b1 = m0 - 1 - o0, m1 - 1 - o1
    p0 = m0 - 1
    f = jnp.flip(filt, (0, 1))
    acorr = conv_full_direct(filt, f)  # (2m0-1, 2m1-1)

    g = _os_conv(block, acorr, p0, m1 - 1, axis_name, h_hat=acorr_hat)

    idx = jax.lax.axis_index(axis_name)
    n = _axis_size(axis_name)
    H = n * hl
    row0 = idx * hl
    dt = block.dtype
    first = (idx == 0).astype(dt)
    last = (idx == n - 1).astype(dt)

    # halo-extended block for the row-coupled left/right strips (dead when
    # the kernel has no column reach — skip the extra ppermutes then)
    ext = None
    if o1 > 0 or b1 > 0:
        if n > 1:
            ext = jnp.concatenate(
                [halo_from_prev(block, p0, axis_name), block, halo_from_next(block, p0, axis_name)], axis=0
            )
        else:
            ext = jnp.pad(block, ((p0, p0), (0, 0)))

    # -- top rows correction (device 0) -------------------------------------
    if o0 > 0:
        st = conv_full_direct(block[:m0], filt)[:o0]  # global full rows [0, o0)
        ct = conv_full_direct(st, f)[m0 - 1 : m0 - 1 + o0, m1 - 1 : m1 - 1 + W]
        g = g.at[:o0].add(-(ct * first))
    # -- bottom rows correction (last device) --------------------------------
    if b0 > 0:
        sbf = conv_full_direct(block[hl - (m0 - 1) :], filt)
        sb = sbf[o0 + m0 - 1 : o0 + m0 - 1 + b0]  # global full rows [o0+H, H+m0-1)
        cb = conv_full_direct(sb, f)[0:b0, m1 - 1 : m1 - 1 + W]
        g = g.at[hl - b0 :].add(-(cb * last))
    # -- middle-rows x left/right columns (every device) --------------------
    if o1 > 0 or b1 > 0:
        rows = (
            jax.lax.broadcasted_iota(jnp.int32, (hl + 2 * p0 + m0 - 1, 1), 0)
            + (row0 - p0)
        )
        midmask = ((rows >= o0) & (rows < o0 + H)).astype(dt)
    if o1 > 0:
        # keep only global full cols [0, o1) — beyond that the local conv
        # misses contributions from x cols >= o1 (and isn't in the strip)
        sl = conv_full_direct(ext[:, :o1], filt)[:, :o1] * midmask
        cl = conv_full_direct(sl, f)[2 * p0 : 2 * p0 + hl, m1 - 1 : m1 - 1 + o1]
        g = g.at[:, :o1].add(-cl)
    if b1 > 0:
        srf = conv_full_direct(ext[:, W - (m1 - 1) :], filt)
        sr = srf[:, o1 + m1 - 1 : o1 + m1 - 1 + b1] * midmask
        cr = conv_full_direct(sr, f)[2 * p0 : 2 * p0 + hl, 0:b1]
        g = g.at[:, W - b1 :].add(-cr)
    return g


def sharded_sepgram_rank1(block: jax.Array, g_rows, g_cols, axis_name: str, g_cols_chan=None) -> jax.Array:
    """Row-sharded rank-1 separable Gram ``A^H A x`` — NO FFT anywhere.

    The multi-device twin of ``ops.conv.SeparableConvGram2D._apply_fast2``:
    the column-axis 1-D Gram is purely local (``kernels.band.gram_band_cols``,
    W unsharded), the row-axis Gram is one banded pass over the
    (K-1)-row halo-extended block (same halo width as FFT overlap-save, but
    the local work is two 128x128 matmuls instead of an FFT roundtrip)
    with the thin edge-correction matmuls masked onto the first/last device.

    ``g_rows`` / ``g_cols``: ``make_gram_band`` plans of the row/col factor
    taps, as ``(plan, E_top, E_bot, L)`` with jnp block arrays.  Requires the
    local block height >= max(K-1, L=2K-2) rows (validated by callers).
    """
    from pycsou_tpu.kernels.band import gram_band_cols, gram_chanconv_cols

    # column direction: local and exact on every device (W unsharded); row
    # direction: one banded pass over the (K-1)-row halo-extended block with
    # the thin edge corrections masked onto the first/last device
    if g_cols_chan is not None:
        # channel-conv lane pass (no pad copy; kernels.band.make_chanconv)
        _, Et, Eb, L = g_cols
        E = None if Et is None else (Et, Eb)
        y = gram_chanconv_cols(block, g_cols_chan, E, L)
    else:
        y = gram_band_cols(block, g_cols)
    return _gram_band_rows_halo(y, g_rows, axis_name, row_edges=True)


# ---------------------------------------------------------------------------
# 2-D spatial decomposition (rows x cols device mesh) — for very wide meshes
# where a 1-D row split would leave blocks thinner than the kernel halo.
# Mirrors of the row-axis primitives along the column axis; a (sp0, sp1)
# shard_map composes them (parallel.solvers.Spatial2DTVDeconv2D).
# ---------------------------------------------------------------------------


def halo_from_prev_cols(block: jax.Array, h: int, axis_name: str) -> jax.Array:
    """Last ``h`` columns of the left neighbour's block (zeros on device 0)."""
    if h == 0:
        return jnp.zeros(block.shape[:-1] + (0,), block.dtype)
    n = _axis_size(axis_name)
    send = block[..., -h:]
    if n == 1:
        return jnp.zeros_like(send)
    perm = [(i, i + 1) for i in range(n - 1)]
    return jax.lax.ppermute(send, axis_name, perm)


def halo_from_next_cols(block: jax.Array, h: int, axis_name: str) -> jax.Array:
    """First ``h`` columns of the right neighbour's block (zeros on the last)."""
    if h == 0:
        return jnp.zeros(block.shape[:-1] + (0,), block.dtype)
    n = _axis_size(axis_name)
    send = block[..., :h]
    if n == 1:
        return jnp.zeros_like(send)
    perm = [(i + 1, i) for i in range(n - 1)]
    return jax.lax.ppermute(send, axis_name, perm)


def sharded_fdiff_cols(block: jax.Array, axis_name: str, step: float = 1.0) -> jax.Array:
    """Column-wise forward difference of a column-sharded array; globally
    identical to ``ops.diff.fdiff_forward(x, axis=1)`` (zero last column)."""
    nxt = halo_from_next_cols(block, 1, axis_name)
    ext = jnp.concatenate([block, nxt], axis=-1)
    d = (ext[..., 1:] - ext[..., :-1]) / step
    scale = jnp.where(_is_last(axis_name), 0.0, 1.0).astype(d.dtype)
    return d.at[..., -1].multiply(scale)


def sharded_fdiff_cols_adjoint(y: jax.Array, axis_name: str, step: float = 1.0) -> jax.Array:
    scale = jnp.where(_is_last(axis_name), 0.0, 1.0).astype(y.dtype)
    y = y.at[..., -1].multiply(scale)
    prev = halo_from_prev_cols(y, 1, axis_name)
    ext = jnp.concatenate([prev, y], axis=-1)
    return (ext[..., :-1] - ext[..., 1:]) / step


def sharded_grad2d_2d(block: jax.Array, ax_r: str, ax_c: str, step: float = 1.0) -> jax.Array:
    """(2, h, w) forward-difference gradient of a 2-D-sharded image block."""
    d0 = sharded_fdiff_rows(block, ax_r, step)
    d1 = sharded_fdiff_cols(block, ax_c, step)
    return jnp.stack([d0, d1], axis=0)


def sharded_grad2d_adjoint_2d(g: jax.Array, ax_r: str, ax_c: str, step: float = 1.0) -> jax.Array:
    return sharded_fdiff_rows_adjoint(g[0], ax_r, step) + sharded_fdiff_cols_adjoint(g[1], ax_c, step)


def _gram_band_rows_halo(y: jax.Array, g_rows, axis_name: str, row_edges: bool) -> jax.Array:
    """Row-axis banded Gram pass on a halo-extended block; edge corrections
    masked to the first/last device along ``axis_name`` (skipped when
    ``row_edges`` is False, e.g. the K==1 degenerate plan)."""
    from pycsou_tpu.kernels.band import DEFAULT_PRECISION, band_conv_rows

    plan, E_top, E_bot, L = g_rows
    h = plan[2]
    ext = jnp.concatenate(
        [halo_from_prev(y, h, axis_name), y, halo_from_next(y, h, axis_name)], axis=0
    )
    out = band_conv_rows(ext, plan)[h : h + y.shape[0]]
    if E_top is not None and row_edges:
        idx = jax.lax.axis_index(axis_name)
        n = _axis_size(axis_name)
        dt = y.dtype
        first = (idx == 0).astype(dt)
        last = (idx == n - 1).astype(dt)
        Km1 = E_top.shape[0]
        out = out.at[:Km1].add(first * jnp.matmul(E_top, y[:L], precision=DEFAULT_PRECISION))
        out = out.at[-Km1:].add(last * jnp.matmul(E_bot, y[-L:], precision=DEFAULT_PRECISION))
    return out


def _gram_band_cols_halo(x: jax.Array, g_cols, axis_name: str) -> jax.Array:
    """Column-axis banded Gram pass with column halos + masked edge fixes."""
    from pycsou_tpu.kernels.band import DEFAULT_PRECISION, band_conv_cols

    plan, E_top, E_bot, L = g_cols
    h = plan[2]
    ext = jnp.concatenate(
        [halo_from_prev_cols(x, h, axis_name), x, halo_from_next_cols(x, h, axis_name)], axis=-1
    )
    out = band_conv_cols(ext, plan)[:, h : h + x.shape[1]]
    if E_top is not None:
        idx = jax.lax.axis_index(axis_name)
        n = _axis_size(axis_name)
        dt = x.dtype
        first = (idx == 0).astype(dt)
        last = (idx == n - 1).astype(dt)
        Km1 = E_top.shape[0]
        out = out.at[:, :Km1].add(first * jnp.matmul(x[:, :L], E_top.T, precision=DEFAULT_PRECISION))
        out = out.at[:, -Km1:].add(last * jnp.matmul(x[:, -L:], E_bot.T, precision=DEFAULT_PRECISION))
    return out


def _sep_halo_pass(y: jax.Array, plan, reach_lo: int, reach_hi: int, axis_name: str, rows: bool) -> jax.Array:
    """One banded 'same' pass along a SHARDED axis: exchange ``reach_lo``
    rows/cols from the previous neighbour and ``reach_hi`` from the next,
    run the local banded matmul pass, crop.  Zero halos at the global edges
    equal the zero-boundary band clipping, so the pass is globally exact."""
    from pycsou_tpu.kernels.band import band_conv_cols, band_conv_rows

    if rows:
        parts = []
        if reach_lo:
            parts.append(halo_from_prev(y, reach_lo, axis_name))
        parts.append(y)
        if reach_hi:
            parts.append(halo_from_next(y, reach_hi, axis_name))
        ext = jnp.concatenate(parts, axis=0) if len(parts) > 1 else y
        return band_conv_rows(ext, plan)[reach_lo : reach_lo + y.shape[0]]
    parts = []
    if reach_lo:
        parts.append(halo_from_prev_cols(y, reach_lo, axis_name))
    parts.append(y)
    if reach_hi:
        parts.append(halo_from_next_cols(y, reach_hi, axis_name))
    ext = jnp.concatenate(parts, axis=-1) if len(parts) > 1 else y
    return band_conv_cols(ext, plan)[:, reach_lo : reach_lo + y.shape[1]]


def sharded_sepconv2d_2d(block, rows_plan, cols_plan, ax_r: str, ax_c: str):
    """Rank-1 separable 'same' 2-D convolution on a 2-D (rows x cols) mesh —
    globally equal to ``ops.conv.Convolve2D.apply`` for ``filt = u v^T``.

    ``rows_plan`` / ``cols_plan`` are ``(make_band_blocks(taps, offset),
    K-1)`` pairs for the per-axis factors; halo widths derive from each
    band's reach.  Zero FFTs; all traffic is nearest-neighbour ppermute."""
    (rplan, rK1), (cplan, cK1) = rows_plan, cols_plan
    y = _sep_halo_pass(block, cplan, cplan[2], cK1 - cplan[2], ax_c, rows=False)
    return _sep_halo_pass(y, rplan, rplan[2], rK1 - rplan[2], ax_r, rows=True)


def sharded_sepconv2d_adjoint_2d(block, rows_plan, cols_plan, ax_r: str, ax_c: str):
    """Adjoint of :func:`sharded_sepconv2d_2d`: callers pass the FLIPPED-tap
    complementary-offset plans (the banded Toeplitz transpose).  Used to
    compute ``A^H y`` fully sharded at solver init (VERDICT r2 task 8)."""
    return sharded_sepconv2d_2d(block, rows_plan, cols_plan, ax_r, ax_c)


def sharded_sepgram_rank1_2d(block: jax.Array, g_rows, g_cols, ax_r: str, ax_c: str) -> jax.Array:
    """Rank-1 separable Gram on a TRUE 2-D (rows x cols) device mesh.

    Column pass exchanges (K-1)-column halos along ``ax_c``; row pass
    exchanges (K-1)-row halos along ``ax_r``.  Still zero FFTs and zero
    global collectives — all traffic is nearest-neighbour ``ppermute``.
    Requires local blocks >= max(K-1, 2K-2) in each sharded direction.
    """
    y = _gram_band_cols_halo(block, g_cols, ax_c)
    return _gram_band_rows_halo(y, g_rows, ax_r, row_edges=True)


def pdot(a: jax.Array, b: jax.Array, axis_name: str) -> jax.Array:
    """Global inner product of row-sharded arrays (local dot + psum)."""
    return jax.lax.psum(jnp.vdot(a, b), axis_name)


def pnorm(a: jax.Array, axis_name: str) -> jax.Array:
    return jnp.sqrt(jnp.real(pdot(a, a, axis_name)))

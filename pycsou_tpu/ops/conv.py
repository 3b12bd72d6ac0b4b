"""Convolution operators: FFT-based and direct 1-D/2-D convolution, moving
averages.

Equivalent of the reference's pycsou/linop/conv.py (422 LoC, which delegates
to pylops/scipy.signal).  Design:

* ``method='fft'`` — linear convolution via zero-padded r/c-FFT (``jnp.fft``,
  XLA-fused); the 'same'-size centering matches the reference's even/odd
  offset convention (conv.py:159-162).
* ``method='direct'`` — ``lax.conv_general_dilated`` (best for short
  filters).
* Adjoint (= correlation) is derived by ``jax.linear_transpose`` of the pure
  ``apply`` — no hand-maintained adjoint code.
* Exact Lipschitz constant for free: ``max |FFT(h)|`` on the padded grid
  bounds the operator norm (the reference runs ARPACK svds instead).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.fft

from pycsou_tpu._module import static_field
from pycsou_tpu.core.linop import LinearOperator
from pycsou_tpu.utils.shapes import as_shape

__all__ = [
    "Convolve1D",
    "Convolve2D",
    "ConvolveND",
    "CircularConvolve",
    "MovingAverage1D",
    "MovingAverage2D",
]


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth FFT size >= n (``scipy.fft.next_fast_len``).

    Padding a linear convolution beyond n+m-1 is free (the extra tail only
    wraps zeros).  On an H100 (700 W) the 5-smooth 4320 beat the
    power-of-two-dominant 4608 (``2^a 3^b``, b <= 2) for a 4096^2 image with
    a 15x15 kernel: 0.752 vs 0.818 ms per rfft2 roundtrip (PERF.md).
    """
    return int(scipy.fft.next_fast_len(int(n), real=True))


def _fft_lipschitz(filt: np.ndarray, padded_shape: Tuple[int, ...]) -> float:
    """``||conv||_2 <= max |DFT_L(h)|`` for any ``L >= n + m - 1`` per axis:
    the size-n 'same' convolution is a submatrix of the size-L circulant
    acting on zero-padded inputs, whose norm is exactly ``max |DFT_L(h)|``
    — a RIGOROUS upper bound, no oversampling or fudge factor needed.
    (Previously a dense 2x-oversampled complex128 grid: ~1.4 GB host RAM
    at 4096^2 and ~24 GB at 512^3; rfftn at the padded size is ~8x less.)"""
    h = np.asarray(filt)
    L = tuple(next_fast_len(s) for s in padded_shape)
    axes = tuple(range(len(L)))
    if np.iscomplexobj(h):
        H = np.fft.fftn(h.astype(np.complex128), s=L, axes=axes)
    else:
        H = np.fft.rfftn(h.astype(np.float64), s=L, axes=axes)
    return float(np.max(np.abs(H)))


class Convolve1D(LinearOperator):
    """1-D convolution with a compactly supported filter
    (reference linop/conv.py:20-163).

    ``apply(x)[i] = sum_k h[k] x[i - k + offset]`` with the centre offset
    ``offset = len(h)//2`` (reference's even/odd centering), zero boundary.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.conv import Convolve1D
        >>> A = Convolve1D((4,), jnp.array([1.0, 2.0, 1.0]) / 4.0)
        >>> A(jnp.array([0.0, 4.0, 0.0, 0.0])).tolist()
        [1.0, 2.0, 1.0, 0.0]
        >>> bool(jnp.allclose(A.gram(jnp.ones(4)), A.adjoint(A(jnp.ones(4))),
        ...                   atol=1e-5))
        True
    """

    filt: jax.Array = None
    h_hat_re: jax.Array = None
    h_hat_im: jax.Array = None
    method: str = static_field(default="fft")

    def __init__(self, dim_shape, filt, method: str = "auto", dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        if len(dim_shape) != 1:
            raise ValueError("Convolve1D expects a 1-D domain")
        filt = jnp.asarray(filt, dtype=dtype)
        n, m = dim_shape[0], filt.shape[0]
        if method == "auto":
            if m <= 32:
                method = "direct"
            elif n >= 1 << 18 and m * 8 <= n:
                # very long signals: batched small FFTs beat one giant FFT
                # (reference conv.py:163 'overlap-add' switch)
                method = "overlap-add"
            else:
                method = "fft"
        if method not in ("fft", "direct", "overlap-add"):
            raise ValueError("method must be 'auto', 'fft', 'direct' or 'overlap-add'")
        lip = _fft_lipschitz(np.asarray(filt), (n + m - 1,))
        super().__init__(dim_shape, dim_shape, lipschitz=lip, dtype=dtype)
        self.filt = filt
        # precompute the transfer function once; recomputing the zero-padded
        # filter FFT per apply would cost a full-size FFT per matvec.
        # Stored as re/im pairs: split-real keeps closure-jit usable.
        if method == "fft":
            hh = jnp.fft.rfft(filt, n=next_fast_len(n + m - 1))
        elif method == "overlap-add":
            hh = jnp.fft.rfft(filt, n=self._oa_nfft())
        else:
            hh = None
        self.h_hat_re = jnp.real(hh) if hh is not None else None
        self.h_hat_im = jnp.imag(hh) if hh is not None else None
        self.method = method

    def _oa_nfft(self) -> int:
        """Chunk FFT size for overlap-add: a small fast size well above the
        kernel, so the chunk tail (m-1) always fits in the next chunk."""
        m = self.filt.shape[0]
        return next_fast_len(max(8 * m, 256))

    @property
    def h_hat(self):
        """Frequency-domain transfer function, stored as re/im pairs
        (split real pairs keep closure-jit usable)."""
        return jax.lax.complex(self.h_hat_re, self.h_hat_im)

    def apply(self, x):
        n = self.dim_shape[0]
        m = self.filt.shape[0]
        ofs = m // 2
        if self.method == "fft":
            n_fft = next_fast_len(n + m - 1)
            X = jnp.fft.rfft(x, n=n_fft)
            full = jnp.fft.irfft(X * self.h_hat, n=n_fft)
            return full[ofs : ofs + n].astype(x.dtype)
        if self.method == "overlap-add":
            # split into L-sample chunks, convolve each with a small batched
            # FFT, add the (m-1)-sample tails into the next chunk
            nfft = self._oa_nfft()
            L = nfft - (m - 1)
            nb = -(-n // L)
            xp = jnp.pad(x, (0, nb * L - n)).reshape(nb, L)
            C = jnp.fft.rfft(xp, n=nfft, axis=1)
            chunks = jnp.fft.irfft(C * self.h_hat[None, :], n=nfft, axis=1)
            main = chunks[:, :L]
            tails = chunks[:, L:]  # (nb, m-1), belongs at the head of chunk i+1
            carry = jnp.concatenate([jnp.zeros((1, m - 1), chunks.dtype), tails[:-1]], axis=0)
            full = (main.at[:, : m - 1].add(carry)).reshape(-1)
            # last tail extends past nb*L; append it so the 'same' crop is safe
            full = jnp.concatenate([full, tails[-1]])
            return full[ofs : ofs + n].astype(x.dtype)
        # direct path: lax 1-D convolution
        lhs = x[None, None, :]
        rhs = self.filt[::-1][None, None, :]
        out = jax.lax.conv_general_dilated(
            lhs, rhs, window_strides=(1,), padding=[(m - 1 - ofs, ofs)]
        )
        return out[0, 0, :]

    @property
    def gram(self):
        """Fused exact A^H A via the 2-D Gram machinery on a (1, n) view."""
        return ConvGram1D(self)


class ConvGram1D(LinearOperator):
    """Exact Gram of a 'same' 1-D convolution (one FFT roundtrip + end-strip
    corrections; reuses ops/_gram.py through a (1, n) image view)."""

    filt: jax.Array = None
    h2_hat: jax.Array = None
    cache: dict = None
    L: Tuple[int, int] = static_field(default=None)

    def __init__(self, conv: "Convolve1D"):
        from pycsou_tpu.ops._gram import make_conv2d_gram, make_pad_cache

        super().__init__(conv.dim_shape, conv.dim_shape, lipschitz=conv.lipschitz**2, dtype=conv.dtype)
        self.filt = conv.filt
        n = conv.dim_shape[0]
        self.h2_hat, self.L = make_conv2d_gram((1, n), np.asarray(conv.filt)[None, :])
        self.cache = make_pad_cache((1, n), np.asarray(conv.filt)[None, :])

    def apply(self, x):
        from pycsou_tpu.ops._gram import conv2d_gram_apply

        return conv2d_gram_apply(x[None, :], self.filt[None, :], self.h2_hat, self.L, cache=self.cache)[0]

    def adjoint(self, y):
        return self.apply(jnp.asarray(y))


class Convolve2D(LinearOperator):
    """2-D convolution with a compact kernel (reference linop/conv.py:167-295).

    ``method='auto'`` picks the faster route measured on an H100 (700 W) at
    4096^2 with 15x15 kernels (PERF.md):

    * ``'band'`` — rank-1 (separable) kernels as 2 banded matmul passes
      (kernels/band.py), no FFT: 0.63 ms per apply vs 0.93 ms for the FFT;
    * ``'fft'`` — everything else: zero-padded rFFT with cached transfer
      function (0.93 ms at any rank; rank-2 band passes took 1.25 ms).

    ``'band'`` (rank <= 4) and ``'direct'`` (``lax.conv``; 2.7 ms there)
    stay available on request.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.conv import Convolve2D
        >>> A = Convolve2D((8, 16), jnp.ones((3, 3)) / 9.0)
        >>> x = jnp.zeros((8, 16)).at[4, 8].set(9.0)
        >>> y = A(x)                       # 'same'-mode blur
        >>> float(y[4, 8]), float(y[3, 7])
        (1.0, 1.0)
        >>> g = A.gram(x)                  # fused A^H A, exact
        >>> bool(jnp.allclose(g, A.adjoint(A(x)), atol=1e-5))
        True
    """

    filt: jax.Array = None
    h_hat_re: jax.Array = None
    h_hat_im: jax.Array = None
    band_row: tuple = None
    band_col: tuple = None
    band_row_adj: tuple = None
    band_col_adj: tuple = None
    # channel-conv form of the column (lane) passes: no pad copy, matmul
    # work ~ CHAN_TILE instead of 128 (kernels/band.py make_chanconv); None when
    # the width is not tile-aligned or the band reach exceeds the window
    band_col_chan: tuple = None
    band_col_adj_chan: tuple = None
    method: str = static_field(default="fft")
    band_leads: tuple = static_field(default=None)
    band_rank: int = static_field(default=0)
    # certified operator-norm bound on the SVD-truncation error (0.0 when
    # no truncation was requested): ||A - A_trunc||_2 <= ||h - h_trunc||_1
    # (the transfer function of a zero-padded 'same' conv is bounded by the
    # kernel's l1 norm)
    svd_trunc_bound: float = static_field(default=0.0)

    def __init__(self, dim_shape, filt, method: str = "auto", dtype=np.float32, svd_tol: float = None):
        dim_shape = as_shape(dim_shape)
        if len(dim_shape) != 2:
            raise ValueError("Convolve2D expects a 2-D domain")
        filt = jnp.asarray(filt, dtype=dtype)
        if filt.ndim != 2:
            raise ValueError("filter must be 2-D")
        trunc_bound = 0.0
        if svd_tol is not None:
            # opt-in SVD truncation for approximately-low-rank PSFs: drop
            # singular components with sigma_i <= svd_tol * sigma_0 and
            # certify ||A - A_trunc||_2 <= ||h - h_trunc||_1 (see
            # svd_trunc_bound).  The operator then IS the truncated kernel —
            # Lipschitz, Gram and adjoint all consistent with it.
            if jnp.issubdtype(filt.dtype, jnp.complexfloating):
                # np.asarray(complex, float64) would silently keep only the
                # real part — a wrong operator, not an approximation
                raise ValueError("svd_tol truncation supports real filters only")
            f64 = np.asarray(filt, np.float64)
            U, S, Vt = np.linalg.svd(f64)
            keep = max(1, int(np.sum(S > float(svd_tol) * S[0])))
            f_t = (U[:, :keep] * S[:keep]) @ Vt[:keep]
            trunc_bound = float(np.abs(f64 - f_t).sum())
            filt = jnp.asarray(f_t, dtype=dtype)
        fac = None
        if method == "bandg":
            raise ValueError(
                "method='bandg' (grouped fused sweeps) was removed; use 'auto', "
                "'fft', 'direct' or 'band'"
            )
        if method in ("auto", "band"):
            fac = self._band_factors(filt)
            if method == "band" and fac is None:
                raise ValueError("kernel is not low-rank/band-eligible")
            if method == "auto":
                method = "band" if fac is not None and fac[0].shape[1] == 1 else "fft"
        if method not in ("fft", "direct", "band"):
            raise ValueError("method must be 'auto', 'fft', 'direct' or 'band'")
        padded = tuple(n + k - 1 for n, k in zip(dim_shape, filt.shape))
        lip = _fft_lipschitz(np.asarray(filt), padded)
        super().__init__(dim_shape, dim_shape, lipschitz=lip, dtype=dtype)
        self.filt = filt
        s = tuple(next_fast_len(n + k - 1) for n, k in zip(dim_shape, filt.shape))
        hh = jnp.fft.rfft2(filt, s=s) if method == "fft" else None
        self.h_hat_re = jnp.real(hh) if hh is not None else None
        self.h_hat_im = jnp.imag(hh) if hh is not None else None
        self.method = method
        self.band_row = self.band_col = self.band_row_adj = self.band_col_adj = None
        self.band_col_chan = self.band_col_adj_chan = None
        self.band_leads = None
        self.band_rank = 0
        self.svd_trunc_bound = trunc_bound
        if method == "band":
            from pycsou_tpu.kernels.band import make_band_blocks

            us, vs = fac
            m0, m1 = filt.shape
            o0, o1 = m0 // 2, m1 // 2
            r = us.shape[1]

            def blk(taps, ofs):
                b0, b1, lead = make_band_blocks(taps, ofs)
                return (jnp.asarray(b0), jnp.asarray(b1)), lead

            rc = [blk(us[:, i], o0) for i in range(r)]
            cc = [blk(vs[:, i], o1) for i in range(r)]
            ra = [blk(us[::-1, i], m0 - 1 - o0) for i in range(r)]
            ca = [blk(vs[::-1, i], m1 - 1 - o1) for i in range(r)]
            self.band_row = tuple(b for b, _ in rc)
            self.band_col = tuple(b for b, _ in cc)
            self.band_row_adj = tuple(b for b, _ in ra)
            self.band_col_adj = tuple(b for b, _ in ca)
            self.band_leads = (rc[0][1], cc[0][1], ra[0][1], ca[0][1])
            self.band_rank = r
            from pycsou_tpu.kernels.band import CHAN_TILE, make_chanconv

            vs_np = np.asarray(vs)
            if dim_shape[1] % CHAN_TILE == 0:
                cf = [make_chanconv(vs_np[:, i], o1) for i in range(r)]
                cb = [make_chanconv(vs_np[::-1, i], m1 - 1 - o1) for i in range(r)]
                if all(c is not None for c in cf + cb):
                    self.band_col_chan = tuple(jnp.asarray(c) for c in cf)
                    self.band_col_adj_chan = tuple(jnp.asarray(c) for c in cb)

    @staticmethod
    def _band_factors(filt):
        from pycsou_tpu.kernels.band import TILE

        if jnp.issubdtype(filt.dtype, jnp.complexfloating):
            return None
        m0, m1 = filt.shape
        if max(m0, m1) - 1 > TILE:
            return None
        return lowrank_factors(np.asarray(filt))

    @property
    def h_hat(self):
        """Frequency-domain transfer function, stored as re/im pairs
        (split real pairs keep closure-jit usable)."""
        return jax.lax.complex(self.h_hat_re, self.h_hat_im)

    def apply(self, x):
        (n0, n1), (m0, m1) = self.dim_shape, self.filt.shape
        o0, o1 = m0 // 2, m1 // 2
        if self.method == "band":
            from pycsou_tpu.kernels.band import band_conv_cols, band_conv_rows, chanconv_cols

            l_r, l_c = self.band_leads[0], self.band_leads[1]
            out = None
            for i in range(self.band_rank):
                rowed = band_conv_rows(x, (*self.band_row[i], l_r))
                if self.band_col_chan is not None:
                    ti = chanconv_cols(rowed, self.band_col_chan[i])
                else:
                    ti = band_conv_cols(rowed, (*self.band_col[i], l_c))
                out = ti if out is None else out + ti
            return out
        if self.method == "fft":
            s = (next_fast_len(n0 + m0 - 1), next_fast_len(n1 + m1 - 1))
            X = jnp.fft.rfft2(x, s=s)
            full = jnp.fft.irfft2(X * self.h_hat, s=s)
            return full[o0 : o0 + n0, o1 : o1 + n1].astype(x.dtype)
        lhs = x[None, None, :, :]
        rhs = self.filt[::-1, ::-1][None, None, :, :]
        out = jax.lax.conv_general_dilated(
            lhs,
            rhs,
            window_strides=(1, 1),
            padding=[(m0 - 1 - o0, o0), (m1 - 1 - o1, o1)],
        )
        return out[0, 0]

    def adjoint(self, y):
        if self.method == "band":
            from pycsou_tpu.kernels.band import band_conv_cols, band_conv_rows, chanconv_cols

            y = jnp.asarray(y)
            l_ra, l_ca = self.band_leads[2], self.band_leads[3]
            out = None
            for i in range(self.band_rank):
                rowed = band_conv_rows(y, (*self.band_row_adj[i], l_ra))
                if self.band_col_adj_chan is not None:
                    ti = chanconv_cols(rowed, self.band_col_adj_chan[i])
                else:
                    ti = band_conv_cols(rowed, (*self.band_col_adj[i], l_ca))
                out = ti if out is None else out + ti
            return out
        return super().adjoint(y)

    @property
    def gram(self):
        """Fused exact A^H A.  Dispatch, fastest first (H100, 700 W, 4096^2,
        15x15 kernels; PERF.md):

        * rank-1 (separable) kernels — banded matmul passes, no FFT at all
          (``SeparableConvGram2D``): 0.72 ms vs 1.05 ms for the FFT Gram;
        * otherwise one FFT roundtrip + thin boundary corrections
          (``ConvGram2D``, ops/_gram.py) instead of forward+adjoint — the
          rank-2 banded Gram took 2.4 ms there.
        """
        g = SeparableConvGram2D.build(self, max_rank=1)
        if g is not None:
            return g
        return ConvGram2D(self)


class ConvGram2D(LinearOperator):
    """Exact Gram of a 'same' 2-D convolution (self-adjoint PSD).

    Two equivalent paths, chosen automatically:

    * ``wrap`` — when the image dims are already fast FFT sizes (e.g. 4096):
      circular Gram at EXACTLY the image size + wraparound-band corrections
      (~21% fewer FFT points; ops/_gram.py ``conv2d_gram_apply_wrap``);
    * padded — FFT at ``next_fast_len(n + 2m - 2)`` with frame corrections.
    """

    filt: jax.Array = None
    h2_hat: jax.Array = None
    cache: dict = None
    L: Tuple[int, int] = static_field(default=None)
    wrap: bool = static_field(default=False)

    def __init__(self, conv: "Convolve2D", fft_shape=None, wrap: str = "auto"):
        from pycsou_tpu.ops._gram import make_conv2d_gram, make_conv2d_gram_wrap, make_wrap_cache

        super().__init__(conv.dim_shape, conv.dim_shape, lipschitz=conv.lipschitz**2, dtype=conv.dtype)
        self.filt = conv.filt
        n0, n1 = conv.dim_shape
        m0, m1 = conv.filt.shape
        if wrap == "auto":
            use_wrap = (
                fft_shape is None
                and next_fast_len(n0) == n0
                and next_fast_len(n1) == n1
                and n0 >= 4 * m0
                and n1 >= 4 * m1
            )
        else:
            use_wrap = bool(wrap)
            if use_wrap and (n0 < 2 * m0 - 1 or n1 < 2 * m1 - 1):
                # the wraparound band decomposition needs the image to hold
                # the full unwrapped reach; smaller images would silently
                # return a wrong Gram
                raise ValueError(
                    f"wrap=True needs n >= 2m-1 per axis; got image {conv.dim_shape} "
                    f"for kernel {conv.filt.shape}"
                )
        self.wrap = use_wrap
        if use_wrap:
            self.h2_hat = make_conv2d_gram_wrap(conv.dim_shape, np.asarray(conv.filt))
            self.cache = make_wrap_cache(conv.dim_shape, np.asarray(conv.filt))
            self.L = conv.dim_shape
        else:
            from pycsou_tpu.ops._gram import make_pad_cache

            self.h2_hat, self.L = make_conv2d_gram(conv.dim_shape, np.asarray(conv.filt), fft_shape=fft_shape)
            self.cache = make_pad_cache(conv.dim_shape, np.asarray(conv.filt))

    def apply(self, x):
        from pycsou_tpu.ops._gram import conv2d_gram_apply, conv2d_gram_apply_wrap

        if self.wrap:
            return conv2d_gram_apply_wrap(x, self.filt, self.h2_hat, cache=self.cache)
        return conv2d_gram_apply(x, self.filt, self.h2_hat, self.L, cache=self.cache)

    def adjoint(self, y):
        return self.apply(jnp.asarray(y))


def lowrank_factors(filt_np: np.ndarray, tol: float = 1e-6, max_rank: int = 4):
    """SVD factorisation ``filt = sum_i u_i v_i^T`` truncated at relative
    singular value ``tol``; None if the numerical rank exceeds ``max_rank``.

    A Gaussian PSF is exactly rank 1; most physical PSFs are rank <= 3."""
    f = np.asarray(filt_np, np.float64)
    if f.ndim != 2 or not np.isrealobj(f):
        return None
    U, S, Vt = np.linalg.svd(f)
    if S[0] == 0:
        return None
    r = int(np.sum(S > tol * S[0]))
    if r == 0 or r > max_rank:
        return None
    us = U[:, :r] * np.sqrt(S[:r])
    vs = Vt[:r].T * np.sqrt(S[:r])
    return us, vs  # (m0, r), (m1, r)


class SeparableConvGram2D(LinearOperator):
    """Exact Gram ``A^H A`` of a 'same' 2-D convolution with a LOW-RANK
    kernel, computed with ZERO FFTs.

    With ``filt = sum_i u_i v_i^T`` the operator factorises into 1-D 'same'
    convolutions along each axis (same-mode row/col convs commute and the
    'same' crop factorises for zero boundaries), so

        A x     = sum_i C(v_i) R(u_i) x
        A^H A x = sum_j R(u_j~) C(v_j~) sum_i C(v_i) R(u_i) x

    Every 1-D pass is a block-Toeplitz banded matmul (kernels/band.py) —
    4r passes in general, 2 for rank 1.  ``Convolve2D.gram`` picks it for
    rank-1 kernels only, where it beats the FFT Gram (ConvGram2D) on an
    H100 (PERF.md); exact to matmul precision (tests/test_gram.py covers
    every kernel parity).
    """

    row_conv: tuple = None
    col_conv: tuple = None
    row_corr: tuple = None
    col_corr: tuple = None
    # channel-conv form of the column (lane) passes (make_chanconv)
    g_chan_cc: tuple = None
    g_chan_ca: tuple = None
    # rank-1 fast path: A^H A = RowGram o ColGram — ONE (2m-1)-tap banded
    # pass per axis (plus thin edge corrections) instead of two m-tap passes
    g_rows_band: tuple = None
    g_rows_E: tuple = None
    g_cols_band: tuple = None
    g_cols_E: tuple = None
    rank: int = static_field(default=1)
    leads: tuple = static_field(default=None)  # (row_conv, col_conv, row_corr, col_corr)
    g_meta: tuple = static_field(default=None)  # (lead_r, L_r, lead_c, L_c) or None
    # channel-conv formulation of the lane-direction Gram band (no pad copy,
    # matmul work ~ tile instead of 128; kernels/band.py make_chanconv)
    g_cols_chan: jax.Array = None

    @staticmethod
    def build(conv: "Convolve2D", tol: float = 1e-6, max_rank: int = 4):
        from pycsou_tpu.kernels.band import TILE

        if jnp.issubdtype(conv.dtype, jnp.complexfloating):
            return None
        m0, m1 = conv.filt.shape
        # the rank-r path's m-tap banded passes need m-1 <= TILE
        if m0 - 1 > TILE or m1 - 1 > TILE:
            return None
        fac = lowrank_factors(np.asarray(conv.filt), tol=tol, max_rank=max_rank)
        if fac is None:
            return None
        return SeparableConvGram2D(conv, fac)

    def __init__(self, conv: "Convolve2D", factors):
        from pycsou_tpu.kernels.band import make_band_blocks

        super().__init__(conv.dim_shape, conv.dim_shape, lipschitz=conv.lipschitz**2, dtype=conv.dtype)
        us, vs = factors
        m0, m1 = us.shape[0], vs.shape[0]
        o0, o1 = m0 // 2, m1 // 2
        r = us.shape[1]
        self.rank = r

        def blk(taps, ofs):
            b0, b1, lead = make_band_blocks(taps, ofs)
            return (jnp.asarray(b0), jnp.asarray(b1)), lead

        # forward factors and their adjoints (correlation = flipped taps at
        # the complementary offset)
        rc = [blk(us[:, i], o0) for i in range(r)]
        cc = [blk(vs[:, i], o1) for i in range(r)]
        ra = [blk(us[::-1, i], m0 - 1 - o0) for i in range(r)]
        ca = [blk(vs[::-1, i], m1 - 1 - o1) for i in range(r)]
        self.row_conv = tuple(b for b, _ in rc)
        self.col_conv = tuple(b for b, _ in cc)
        self.row_corr = tuple(b for b, _ in ra)
        self.col_corr = tuple(b for b, _ in ca)
        self.leads = (rc[0][1], cc[0][1], ra[0][1], ca[0][1])
        from pycsou_tpu.kernels.band import CHAN_TILE, make_chanconv

        self.g_chan_cc = self.g_chan_ca = None
        W2 = conv.dim_shape[1]
        if W2 % CHAN_TILE == 0:
            vf = [make_chanconv(np.asarray(vs)[:, i], o1) for i in range(r)]
            va = [make_chanconv(np.asarray(vs)[::-1, i], m1 - 1 - o1) for i in range(r)]
            if all(c is not None for c in vf + va):
                self.g_chan_cc = tuple(jnp.asarray(c) for c in vf)
                self.g_chan_ca = tuple(jnp.asarray(c) for c in va)

        # rank-1 2-pass plan (needs room for the windowed edge corrections)
        H, W = conv.dim_shape
        self.g_rows_band = self.g_rows_E = self.g_cols_band = self.g_cols_E = None
        self.g_meta = None
        # the (2m-1)-tap autocorrelation bands need 2(m-1) <= TILE; wider
        # rank-1 kernels stay on the 4-pass rank-r path above (m-1 <= TILE)
        from pycsou_tpu.kernels.band import TILE as _TILE

        if (
            r == 1
            and H >= 3 * m0
            and W >= 3 * m1
            and 2 * (m0 - 1) <= _TILE
            and 2 * (m1 - 1) <= _TILE
        ):
            from pycsou_tpu.kernels.band import make_gram_band

            (rb0, rb1, lead_r), Etr, Ebr, L_r = make_gram_band(us[:, 0], H)
            (cb0, cb1, lead_c), Etc, Ebc, L_c = make_gram_band(vs[:, 0], W)
            self.g_rows_band = (jnp.asarray(rb0), jnp.asarray(rb1))
            self.g_cols_band = (jnp.asarray(cb0), jnp.asarray(cb1))
            self.g_rows_E = None if Etr is None else (jnp.asarray(Etr), jnp.asarray(Ebr))
            self.g_cols_E = None if Etc is None else (jnp.asarray(Etc), jnp.asarray(Ebc))
            self.g_meta = (lead_r, L_r, lead_c, L_c)
            from pycsou_tpu.kernels.band import CHAN_TILE, make_chanconv

            self.g_cols_chan = None
            if W % CHAN_TILE == 0:
                # (2m-1)-tap autocorrelation of the rank-1 lane factor
                Kc = make_chanconv(np.convolve(vs[:, 0], vs[::-1, 0]), m1 - 1)
                if Kc is not None:
                    self.g_cols_chan = jnp.asarray(Kc)

    def _apply_fast2(self, x):
        """Rank-1 2-pass Gram: RowGram then ColGram, each one banded pass."""
        from pycsou_tpu.kernels.band import DEFAULT_PRECISION, band_conv_cols, band_conv_rows

        prec = DEFAULT_PRECISION
        lead_r, L_r, lead_c, L_c = self.g_meta
        y = band_conv_rows(x, (*self.g_rows_band, lead_r))
        if self.g_rows_E is not None:
            Et, Eb = self.g_rows_E
            Km1 = Et.shape[0]
            y = y.at[:Km1].add(jnp.matmul(Et, x[:L_r], precision=prec))
            y = y.at[-Km1:].add(jnp.matmul(Eb, x[-L_r:], precision=prec))
        if self.g_cols_chan is not None:
            from pycsou_tpu.kernels.band import gram_chanconv_cols

            return gram_chanconv_cols(y, self.g_cols_chan, self.g_cols_E, L_c)
        g = band_conv_cols(y, (*self.g_cols_band, lead_c))
        if self.g_cols_E is not None:
            Et, Eb = self.g_cols_E
            Km1 = Et.shape[0]
            g = g.at[:, :Km1].add(jnp.matmul(y[:, :L_c], Et.T, precision=prec))
            g = g.at[:, -Km1:].add(jnp.matmul(y[:, -L_c:], Eb.T, precision=prec))
        return g

    def apply(self, x):
        from pycsou_tpu.kernels.band import band_conv_cols, band_conv_rows

        if self.g_meta is not None:
            return self._apply_fast2(x)
        from pycsou_tpu.kernels.band import chanconv_cols

        r = self.rank
        l_rc, l_cc, l_ra, l_ca = self.leads
        t = None
        for i in range(r):
            rowed = band_conv_rows(x, (*self.row_conv[i], l_rc))
            if self.g_chan_cc is not None:
                ti = chanconv_cols(rowed, self.g_chan_cc[i])
            else:
                ti = band_conv_cols(rowed, (*self.col_conv[i], l_cc))
            t = ti if t is None else t + ti
        g = None
        for j in range(r):
            if self.g_chan_ca is not None:
                coled = chanconv_cols(t, self.g_chan_ca[j])
            else:
                coled = band_conv_cols(t, (*self.col_corr[j], l_ca))
            gj = band_conv_rows(coled, (*self.row_corr[j], l_ra))
            g = gj if g is None else g + gj
        return g

    def adjoint(self, y):
        return self.apply(jnp.asarray(y))


def rank1_factors_nd(filt_np: np.ndarray, tol: float = 1e-6):
    """Per-axis factors ``[u_0, ..., u_{d-1}]`` with
    ``filt = u_0 (x) u_1 (x) ... (x) u_{d-1}`` (outer product), or None when
    the kernel is not rank-1 separable to relative accuracy ``tol``.

    Gaussian and most physically isotropic PSFs are exactly rank-1; this is
    the n-D extension of :func:`lowrank_factors` (rank 1 only — higher
    tensor ranks don't factor the Gram into per-axis passes)."""
    filt = np.asarray(filt_np, np.float64)
    nd = filt.ndim
    us = []
    for k in range(nd):
        unf = np.moveaxis(filt, k, 0).reshape(filt.shape[k], -1)
        U, S, Vt = np.linalg.svd(unf, full_matrices=False)
        us.append(U[:, 0])
    # scale: project filt onto the rank-1 tensor
    outer = us[0]
    for u in us[1:]:
        outer = np.multiply.outer(outer, u)
    s = float(np.vdot(outer, filt))
    approx = s * outer
    if np.linalg.norm(approx - filt) > tol * max(np.linalg.norm(filt), 1e-30):
        return None
    us[0] = us[0] * s
    return [u.astype(np.float64) for u in us]


class SeparableConvGramND(LinearOperator):
    """Exact Gram ``A^H A`` of a 'same' n-D convolution with a RANK-1
    (fully separable) kernel — ZERO FFTs, one banded matmul pass per axis.

    ``filt = u_0 (x) ... (x) u_{d-1}`` factorises the operator into 1-D
    'same' convolutions per axis, so the Gram is the composition of the
    per-axis 1-D Grams (they act on disjoint axes and commute); each is a
    (2K-1)-tap banded Toeplitz pass + thin edge corrections
    (kernels/band.py ``make_gram_band``).  The volumetric extension of
    ``SeparableConvGram2D`` — at 3-D sizes the FFT Gram (ConvGramND) pays
    3 full rfftn/irfftn axes per matvec, this pays 2d banded matmul
    streams.  Reference has no 3-D convolution at all (SURVEY §2.3)."""

    g_bands: tuple = None  # per-axis (b0, b1) jnp blocks
    g_E: tuple = None  # per-axis (E_top, E_bot) or None
    g_meta: tuple = static_field(default=None)  # per-axis (lead, L)
    # channel-conv form of the LAST-axis (lane) pass (make_chanconv)
    g_chan_last: jax.Array = None

    @staticmethod
    def build(conv: "ConvolveND", tol: float = 1e-6):
        from pycsou_tpu.kernels.band import TILE

        if jnp.issubdtype(conv.dtype, jnp.complexfloating):
            return None
        filt = np.asarray(conv.filt)
        # make_gram_band builds a (2m-1)-tap autocorrelation band, which
        # needs 2(m-1) <= TILE (ADVICE r2: a 70-tap Gaussian must fall back
        # to the FFT ConvGramND instead of raising)
        if any(2 * (m - 1) > TILE for m in filt.shape):
            return None
        if any(n < 3 * m for n, m in zip(conv.dim_shape, filt.shape)):
            return None
        us = rank1_factors_nd(filt, tol=tol)
        if us is None:
            return None
        return SeparableConvGramND(conv, us)

    def __init__(self, conv: "ConvolveND", factors):
        from pycsou_tpu.kernels.band import make_gram_band

        super().__init__(conv.dim_shape, conv.dim_shape, lipschitz=conv.lipschitz**2, dtype=conv.dtype)
        bands, Es, meta = [], [], []
        for u, n in zip(factors, conv.dim_shape):
            (b0, b1, lead), Et, Eb, L = make_gram_band(u, int(n))
            bands.append((jnp.asarray(b0), jnp.asarray(b1)))
            Es.append(None if Et is None else (jnp.asarray(Et), jnp.asarray(Eb)))
            meta.append((lead, L))
        self.g_bands = tuple(bands)
        self.g_E = tuple(Es)
        self.g_meta = tuple(meta)
        from pycsou_tpu.kernels.band import CHAN_TILE, make_chanconv

        self.g_chan_last = None
        if conv.dim_shape[-1] % CHAN_TILE == 0:
            u_last = np.asarray(factors[-1], np.float64)
            acorr = np.convolve(u_last, u_last[::-1])
            Kc = make_chanconv(acorr, u_last.size - 1)
            if Kc is not None:
                self.g_chan_last = jnp.asarray(Kc)

    def apply(self, x):
        from pycsou_tpu.kernels.band import gram_band_axis, gram_chanconv_cols

        nd = x.ndim
        for ax, ((b0, b1), E, (lead, L)) in enumerate(zip(self.g_bands, self.g_E, self.g_meta)):
            if ax == nd - 1 and self.g_chan_last is not None:
                shp = x.shape
                x = gram_chanconv_cols(x.reshape(-1, shp[-1]), self.g_chan_last, E, L).reshape(shp)
                continue
            Et, Eb = E if E is not None else (None, None)
            x = gram_band_axis(x, ((b0, b1, lead), Et, Eb, L), ax)
        return x

    def adjoint(self, y):
        return self.apply(jnp.asarray(y))


class ConvolveND(LinearOperator):
    """n-dimensional FFT convolution with 'same' centering (extends the
    reference's 1-D/2-D pair to volumes; needed for the 3-D deconvolution
    benchmark config).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.conv import ConvolveND
        >>> A = ConvolveND((4, 4, 4), jnp.ones((1, 1, 3)) / 3.0)
        >>> x = jnp.zeros((4, 4, 4)).at[2, 2, 2].set(3.0)
        >>> A(x)[2, 2, 1:4].tolist()
        [1.0, 1.0, 1.0]
    """

    filt: jax.Array = None
    h_hat_re: jax.Array = None
    h_hat_im: jax.Array = None

    def __init__(self, dim_shape, filt, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        filt = jnp.asarray(filt, dtype=dtype)
        if filt.ndim != len(dim_shape):
            raise ValueError("filter rank must match the domain rank")
        padded = tuple(n + k - 1 for n, k in zip(dim_shape, filt.shape))
        lip = _fft_lipschitz(np.asarray(filt), padded)
        super().__init__(dim_shape, dim_shape, lipschitz=lip, dtype=dtype)
        self.filt = filt
        s = tuple(next_fast_len(n + k - 1) for n, k in zip(dim_shape, filt.shape))
        hh = jnp.fft.rfftn(filt, s=s, axes=tuple(range(len(s))))
        self.h_hat_re = jnp.real(hh)
        self.h_hat_im = jnp.imag(hh)

    @property
    def h_hat(self):
        """Frequency-domain transfer function, stored as re/im pairs
        (split real pairs keep closure-jit usable)."""
        return jax.lax.complex(self.h_hat_re, self.h_hat_im)

    def apply(self, x):
        s = tuple(next_fast_len(n + k - 1) for n, k in zip(self.dim_shape, self.filt.shape))
        axes = tuple(range(len(s)))
        X = jnp.fft.rfftn(x, s=s, axes=axes)
        full = jnp.fft.irfftn(X * self.h_hat, s=s, axes=axes)
        sl = tuple(slice(k // 2, k // 2 + n) for n, k in zip(self.dim_shape, self.filt.shape))
        return full[sl].astype(x.dtype)

    @property
    def gram(self):
        """Fused exact n-D Gram.  Rank-1 (separable) kernels take the
        zero-FFT banded path (``SeparableConvGramND``, one matmul pass per
        axis); everything else gets one rfftn roundtrip + thin slab
        corrections (ops/_gram.py ``convnd_gram_apply``)."""
        g = SeparableConvGramND.build(self)
        return g if g is not None else ConvGramND(self)


class ConvGramND(LinearOperator):
    """Exact Gram of a 'same' n-D convolution (self-adjoint PSD)."""

    filt: jax.Array = None
    h2_hat: jax.Array = None
    L: Tuple[int, ...] = static_field(default=None)

    def __init__(self, conv: "ConvolveND"):
        from pycsou_tpu.ops._gram import make_convnd_gram

        super().__init__(conv.dim_shape, conv.dim_shape, lipschitz=conv.lipschitz**2, dtype=conv.dtype)
        self.filt = conv.filt
        self.h2_hat, self.L = make_convnd_gram(conv.dim_shape, np.asarray(conv.filt))

    def apply(self, x):
        from pycsou_tpu.ops._gram import convnd_gram_apply

        return convnd_gram_apply(x, self.filt, self.h2_hat, self.L)

    def adjoint(self, y):
        return self.apply(jnp.asarray(y))


class CircularConvolve(LinearOperator):
    """Circular (periodic) n-D convolution, exactly diagonalised by the DFT:
    ``A = F^H diag(H) F``.  Exact Lipschitz ``max |H|``; exact pinv/inverse in
    the Fourier domain — the natural operator model for FFT-domain ADMM
    deconvolution.

    Example — periodic wrap-around::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.conv import CircularConvolve
        >>> A = CircularConvolve((4,), jnp.array([0.25, 0.5, 0.25]))
        >>> [round(v, 5) for v in A(jnp.array([1.0, 0.0, 0.0, 0.0])).tolist()]
        [0.5, 0.25, 0.0, 0.25]
        >>> B = CircularConvolve((4,), jnp.array([1.0, 0.5]))  # H(k) never 0
        >>> x = jnp.array([1.0, -2.0, 3.0, 0.5])
        >>> bool(jnp.allclose(B.pinv(B(x)), x, atol=1e-4))  # exact Fourier pinv
        True
    """

    h_hat_re: jax.Array = None
    h_hat_im: jax.Array = None

    def __init__(self, dim_shape, filt=None, h_hat=None, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        if h_hat is None:
            filt = jnp.asarray(filt, dtype=dtype)
            pad = [(0, n - k) for n, k in zip(dim_shape, filt.shape)]
            hfull = jnp.pad(filt, pad)
            # centre the kernel so the convolution is 'same'-aligned
            shifts = tuple(-(k // 2) for k in filt.shape)
            hfull = jnp.roll(hfull, shifts, axis=tuple(range(len(dim_shape))))
            h_hat = jnp.fft.rfftn(hfull, axes=tuple(range(len(dim_shape))))
        h_hat = jnp.asarray(h_hat)
        re, im = jnp.real(h_hat), jnp.imag(h_hat)
        # host copies of the re/im parts (h_hat is stored split)
        lip = float(np.max(np.hypot(np.asarray(re), np.asarray(im))))
        super().__init__(dim_shape, dim_shape, lipschitz=lip, dtype=dtype)
        self.h_hat_re = re
        self.h_hat_im = im

    @property
    def h_hat(self):
        """Frequency-domain transfer function, stored as re/im pairs
        (split real pairs keep closure-jit usable)."""
        return jax.lax.complex(self.h_hat_re, self.h_hat_im)

    def _axes(self):
        return tuple(range(len(self.dim_shape)))

    def apply(self, x):
        X = jnp.fft.rfftn(x, axes=self._axes())
        return jnp.fft.irfftn(X * self.h_hat, s=self.dim_shape, axes=self._axes()).astype(self.dtype)

    def adjoint(self, y):
        Y = jnp.fft.rfftn(jnp.asarray(y), axes=self._axes())
        return jnp.fft.irfftn(Y * jnp.conj(self.h_hat), s=self.dim_shape, axes=self._axes()).astype(self.dtype)

    def pinv(self, y, damp: float = 0.0, **kwargs):
        """Exact (damped) inverse in the Fourier domain."""
        Y = jnp.fft.rfftn(jnp.asarray(y), axes=self._axes())
        denom = jnp.abs(self.h_hat) ** 2 + damp
        X = Y * jnp.conj(self.h_hat) / jnp.maximum(denom, 1e-30)
        return jnp.fft.irfftn(X, s=self.dim_shape, axes=self._axes()).astype(self.dtype)


def MovingAverage1D(dim_shape, window: int, dtype=np.float32) -> Convolve1D:
    """Length-``window`` box filter (reference ``MovingAverage1D``,
    conv.py:298-358).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.conv import MovingAverage1D
        >>> M = MovingAverage1D((4,), window=2)
        >>> M(jnp.array([0.0, 2.0, 4.0, 2.0])).tolist()
        [1.0, 3.0, 3.0, 1.0]
    """
    filt = jnp.ones((window,), dtype=dtype) / window
    return Convolve1D(dim_shape, filt, dtype=dtype)


def MovingAverage2D(dim_shape, window: Tuple[int, int], dtype=np.float32) -> Convolve2D:
    """2-D box filter (reference ``MovingAverage2D``, conv.py:362-417)."""
    w0, w1 = window
    filt = jnp.ones((w0, w1), dtype=dtype) / (w0 * w1)
    return Convolve2D(dim_shape, filt, dtype=dtype)

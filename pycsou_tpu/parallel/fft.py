"""Distributed FFT via pencil decomposition (all-to-all transposes).

Halo exchange (parallel/spatial.py) covers compact-support operators; for
GLOBAL transforms — circular convolution diagonalised by the DFT, Fourier
operators, very wide PSFs — a sharded image cannot be transformed locally.
The answer is the pencil decomposition: with the image
row-sharded over a mesh axis, the 2-D FFT becomes

    local rfft along the (unsharded) column axis
    -> one ``lax.all_to_all`` that re-shards columns<->rows
    -> local fft along the (now unsharded) row axis

so each device ends up holding a COLUMN pencil of the full spectrum.
Spectral multiplies then act on pencils with no further communication, and
the inverse transform mirrors the dance.  Per transform each device moves
O(H*W/n) bytes through one all-to-all — the classic FFT transpose
(reference analogue: none — pycsou's scipy FFTs are single-process;
SURVEY §2.6 names the distributed story as this framework's extension).

Everything here runs INSIDE ``shard_map`` except the
:class:`PencilCircularConv2D` operator, which wraps the shard_map and is a
drop-in distributed twin of ``ops.conv.CircularConvolve`` (conv.py:609) for
2-D row-sharded images.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pycsou_tpu._module import static_field
from pycsou_tpu.core.linop import LinearOperator
from pycsou_tpu.parallel.mesh import make_mesh
from pycsou_tpu.utils.shapes import as_shape

__all__ = [
    "pencil_rfft2",
    "pencil_irfft2",
    "pencil_cols",
    "PencilCircularConv2D",
]


def pencil_cols(W: int, n: int) -> int:
    """Columns per device of the (padded) half-spectrum pencil."""
    Wf = W // 2 + 1
    return -(-Wf // n)


def pencil_rfft2(block: jax.Array, axis_name: str) -> jax.Array:
    """Distributed 2-D real FFT of a row-sharded image.

    ``block``: this device's (H/n, W) real rows.  Returns this device's
    (H, wl) complex COLUMN pencil of the half-spectrum, where
    ``wl = pencil_cols(W, n)`` (columns beyond W//2+1 are zero padding).
    """
    n = int(jax.lax.axis_size(axis_name))
    X = jnp.fft.rfft(block, axis=1)  # (hl, Wf)
    Wf = X.shape[1]
    wl = -(-Wf // n)
    X = jnp.pad(X, ((0, 0), (0, n * wl - Wf)))
    if n > 1:
        X = jax.lax.all_to_all(X, axis_name, split_axis=1, concat_axis=0, tiled=True)
    return jnp.fft.fft(X, axis=0)  # (H, wl)


def pencil_irfft2(spec: jax.Array, axis_name: str, W: int) -> jax.Array:
    """Inverse of :func:`pencil_rfft2`: column pencil -> (H/n, W) real rows."""
    n = int(jax.lax.axis_size(axis_name))
    Y = jnp.fft.ifft(spec, axis=0)  # (H, wl)
    if n > 1:
        Y = jax.lax.all_to_all(Y, axis_name, split_axis=0, concat_axis=1, tiled=True)
    Wf = W // 2 + 1
    return jnp.fft.irfft(Y[:, :Wf], n=W, axis=1)


class PencilCircularConv2D(LinearOperator):
    """Circular 2-D convolution of a row-sharded image via pencil FFTs —
    the distributed twin of ``ops.conv.CircularConvolve`` (exactly
    ``F^H diag(H) F``; reference conv analogue /root/reference/pycsou/
    linop/conv.py:159-162 generalised to the periodic boundary).

    The transfer function is stored as column pencils sharded over the
    mesh (``PartitionSpec(None, axis)``), so a spectral multiply touches
    only device-local data; each apply/adjoint costs one pencil-FFT
    roundtrip = two ``all_to_all``s.  ``gram``/``pinv`` ride the
    same machinery with ``|H|^2`` / damped-inverse pencils.

    Inputs may carry any sharding — ``shard_map`` re-shards to rows — but
    staying row-sharded (``P(axis, None)``) end to end avoids resharding.
    Requires ``H % n == 0``.
    """

    h_re: jax.Array = None  # (H, n*wl) transfer pencils, sharded P(None, ax)
    h_im: jax.Array = None
    _mesh: Optional[Mesh] = static_field(default=None)
    _axis: str = static_field(default="sp")

    def __init__(self, dim_shape: Tuple[int, int], filt=None, h_hat=None, mesh: Optional[Mesh] = None, axis: str = "sp", dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        if len(dim_shape) != 2:
            raise ValueError("PencilCircularConv2D is 2-D; use CircularConvolve for other ranks")
        H, W = dim_shape
        mesh = mesh if mesh is not None else make_mesh(axis_names=(axis,))
        n = mesh.shape[axis]
        if H % n:
            raise ValueError(f"rows {H} must divide over {n} devices")
        if h_hat is None:
            filt = jnp.asarray(filt, dtype=dtype)
            pad = [(0, s - k) for s, k in zip(dim_shape, filt.shape)]
            hfull = jnp.pad(filt, pad)
            shifts = tuple(-(k // 2) for k in filt.shape)
            hfull = jnp.roll(hfull, shifts, axis=(0, 1))
            h_hat = jnp.fft.rfft2(hfull)
        h_hat = jnp.asarray(h_hat)
        re, im = jnp.real(h_hat), jnp.imag(h_hat)
        # host copies of the re/im parts (ops/conv.py CircularConvolve
        # convention)
        lip = float(np.max(np.hypot(np.asarray(re), np.asarray(im))))
        super().__init__(dim_shape, dim_shape, lipschitz=lip, dtype=dtype)
        wl = pencil_cols(W, n)
        real_dt = jnp.zeros((), dtype).real.dtype
        re = jnp.pad(re, ((0, 0), (0, n * wl - re.shape[1])))
        im = jnp.pad(im, ((0, 0), (0, n * wl - im.shape[1])))
        sh = NamedSharding(mesh, P(None, axis))
        self.h_re = jax.device_put(re.astype(real_dt), sh)
        self.h_im = jax.device_put(im.astype(real_dt), sh)
        self._mesh = mesh
        self._axis = axis

    @property
    def mesh(self):
        return self._mesh

    def _spectral(self, x, fn):
        """shard_map a pencil-spectrum transform ``spec' = fn(spec, h)``."""
        ax = self._axis
        W = self.dim_shape[1]

        def body(block, hre, him):
            S = pencil_rfft2(block, ax)
            S = fn(S, jax.lax.complex(hre, him))
            return pencil_irfft2(S, ax, W).astype(self.dtype)

        return shard_map(
            body,
            mesh=self._mesh,
            in_specs=(P(ax, None), P(None, ax), P(None, ax)),
            out_specs=P(ax, None),
        )(jnp.asarray(x), self.h_re, self.h_im)

    def apply(self, x):
        return self._spectral(x, lambda S, h: S * h)

    def adjoint(self, y):
        return self._spectral(y, lambda S, h: S * jnp.conj(h))

    @property
    def gram(self) -> "LinearOperator":
        return _PencilCircGram(self)

    def pinv(self, y, damp: float = 0.0, **kwargs):
        """Fourier-domain pseudo-inverse (Tikhonov-damped), one roundtrip —
        mirrors ``CircularConvolve.pinv``."""
        d = float(damp)
        return self._spectral(
            y,
            # floor like CircularConvolve.pinv: spectral zeros with damp=0
            # would give 0/0 = NaN and poison the whole irfft
            lambda S, h: S * jnp.conj(h) / jnp.maximum(jnp.abs(h) ** 2 + d, 1e-30),
        )


class _PencilCircGram(LinearOperator):
    """``A^H A`` of :class:`PencilCircularConv2D`: |H|^2 pencil multiply,
    ONE pencil-FFT roundtrip per matvec."""

    op: PencilCircularConv2D = None

    def __init__(self, op: PencilCircularConv2D):
        super().__init__(op.dim_shape, op.dim_shape, lipschitz=op.lipschitz**2, dtype=op.dtype)
        self.op = op

    def apply(self, x):
        return self.op._spectral(x, lambda S, h: S * (h * jnp.conj(h)).real)

    def adjoint(self, y):
        return self.apply(jnp.asarray(y))

"""Sampling operators: subsampling, masking, downsampling, pooling, off-grid
nearest-neighbour sampling, generalised Vandermonde, mapped distance matrices.

Equivalent of the reference's pycsou/linop/sampling.py (1,062 LoC).
Gather/scatter index sets are precomputed on host (static), applies are
``jnp.take`` / ``.at[].add`` scatters, and collision-averaging adjoints use
``segment_sum`` instead of the reference's pandas groupby (sampling.py:680-687).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from pycsou_tpu._module import static_field
from pycsou_tpu.core.linop import LinearOperator
from pycsou_tpu.ops.basic import DenseOperator
from pycsou_tpu.utils.shapes import as_shape, size_of

__all__ = [
    "SubSampling",
    "Masking",
    "DownSampling",
    "Pooling",
    "NNSampling",
    "GeneralisedVandermonde",
    "MappedDistanceMatrix",
]


class SubSampling(LinearOperator):
    """Restriction to a set of flat indices (reference sampling.py:25-121).
    Adjoint scatters back to zero-background.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.sampling import SubSampling
        >>> S = SubSampling((4,), indices=[0, 2])
        >>> S(jnp.array([1.0, 2.0, 3.0, 4.0])).tolist()
        [1.0, 3.0]
        >>> S.adjoint(jnp.array([5.0, 6.0])).tolist()
        [5.0, 0.0, 6.0, 0.0]
    """

    indices: jax.Array = None

    def __init__(self, dim_shape, indices, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        idx = np.asarray(indices).reshape(-1)
        super().__init__(dim_shape, (idx.size,), lipschitz=1.0, dtype=dtype)
        self.indices = jnp.asarray(idx, dtype=jnp.int32)

    def apply(self, x):
        return jnp.take(x.reshape(-1), self.indices)

    def adjoint(self, y):
        flat = jnp.zeros((self.dim,), dtype=jnp.asarray(y).dtype)
        return flat.at[self.indices].add(y).reshape(self.dim_shape)


class Masking(LinearOperator):
    """Boolean-mask gather with scatter adjoint (reference sampling.py:125-196).
    The mask is static (known at trace time) so the gather compiles to a fixed
    index set.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.sampling import Masking
        >>> M = Masking((2, 2), mask=[[True, False], [False, True]])
        >>> M(jnp.array([[1.0, 2.0], [3.0, 4.0]])).tolist()
        [1.0, 4.0]
    """

    indices: jax.Array = None
    _mask: np.ndarray = static_field(default=None)

    def __init__(self, dim_shape, mask, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        mask = np.asarray(mask, dtype=bool)
        if mask.shape != dim_shape:
            raise ValueError(f"mask shape {mask.shape} != dim_shape {dim_shape}")
        idx = np.flatnonzero(mask.reshape(-1))
        super().__init__(dim_shape, (idx.size,), lipschitz=1.0, dtype=dtype)
        self.indices = jnp.asarray(idx, dtype=jnp.int32)
        self._mask = mask

    @property
    def mask(self):
        """The boolean keep-mask this operator samples with."""
        return self._mask

    def apply(self, x):
        return jnp.take(x.reshape(-1), self.indices)

    def adjoint(self, y):
        flat = jnp.zeros((self.dim,), dtype=jnp.asarray(y).dtype)
        return flat.at[self.indices].set(y).reshape(self.dim_shape)


class DownSampling(LinearOperator):
    """Strided decimation per axis (reference sampling.py:199-391): keep one
    sample every ``factor`` along each axis; adjoint zero-upsamples.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.sampling import DownSampling
        >>> D = DownSampling((4,), factor=2)
        >>> D(jnp.array([1.0, 2.0, 3.0, 4.0])).tolist()
        [1.0, 3.0]
        >>> D.adjoint(jnp.array([1.0, 3.0])).tolist()
        [1.0, 0.0, 3.0, 0.0]
    """

    factors: Tuple[int, ...] = static_field(default=None)

    def __init__(self, dim_shape, factor: Union[int, Sequence[int]], axis: Optional[int] = None, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        d = len(dim_shape)
        if np.isscalar(factor):
            factors = [1] * d
            if axis is None:
                factors = [int(factor)] * d
            else:
                factors[axis] = int(factor)
        else:
            factors = [int(f) for f in factor]
        codim = tuple((n + f - 1) // f for n, f in zip(dim_shape, factors))
        super().__init__(dim_shape, codim, lipschitz=1.0, dtype=dtype)
        self.factors = tuple(factors)

    def apply(self, x):
        sl = tuple(slice(None, None, f) for f in self.factors)
        return x[sl]

    def adjoint(self, y):
        y = jnp.asarray(y)
        out = jnp.zeros(self.dim_shape, dtype=y.dtype)
        sl = tuple(slice(None, None, f) for f in self.factors)
        return out.at[sl].set(y)


class Pooling(LinearOperator):
    """Block sum/mean pooling via reshape-reduce (the reference wraps
    skimage ``block_reduce``, sampling.py:394-536); adjoint is broadcast
    unpooling (:529-536).

    Non-dividing block sizes are zero-padded at the trailing edge, exactly
    like skimage ``block_reduce`` with ``cval=0`` (sampling.py:525-527) —
    'mean' therefore averages over the FULL block volume including the pad,
    matching the reference's semantics bit-for-bit.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.sampling import Pooling
        >>> P = Pooling((2, 2), block_size=2, kind='sum')
        >>> P(jnp.array([[1.0, 2.0], [3.0, 4.0]])).tolist()
        [[10.0]]
        >>> P.adjoint(jnp.array([[1.0]])).tolist()        # broadcast unpool
        [[1.0, 1.0], [1.0, 1.0]]
    """

    block_size: Tuple[int, ...] = static_field(default=None)
    kind: str = static_field(default="mean")
    _padded: Tuple[int, ...] = static_field(default=None)

    def __init__(self, dim_shape, block_size, kind: str = "mean", dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        bs = tuple(int(b) for b in (block_size if not np.isscalar(block_size) else [block_size] * len(dim_shape)))
        if len(bs) != len(dim_shape):
            raise ValueError("block_size rank must match dim_shape")
        if kind not in ("sum", "mean"):
            raise ValueError("kind must be 'sum' or 'mean'")
        padded = tuple(-(-n // b) * b for n, b in zip(dim_shape, bs))
        codim = tuple(p // b for p, b in zip(padded, bs))
        vol = math.prod(bs)
        lip = math.sqrt(vol) if kind == "sum" else 1.0 / math.sqrt(vol)
        super().__init__(dim_shape, codim, lipschitz=lip, dtype=dtype)
        self.block_size = bs
        self.kind = kind
        self._padded = padded

    def _blocked(self, x):
        if self._padded != self.dim_shape:
            x = jnp.pad(x, [(0, p - n) for n, p in zip(self.dim_shape, self._padded)])
        shape = []
        for p, b in zip(self._padded, self.block_size):
            shape.extend([p // b, b])
        xb = x.reshape(shape)
        # move block axes to the end
        d = len(self.dim_shape)
        perm = [2 * i for i in range(d)] + [2 * i + 1 for i in range(d)]
        return jnp.transpose(xb, perm)

    def apply(self, x):
        xb = self._blocked(x)
        d = len(self.dim_shape)
        red = tuple(range(d, 2 * d))
        out = jnp.sum(xb, axis=red)
        if self.kind == "mean":
            out = out / math.prod(self.block_size)
        return out

    def adjoint(self, y):
        y = jnp.asarray(y)
        if self.kind == "mean":
            y = y / math.prod(self.block_size)
        for i, b in enumerate(self.block_size):
            y = jnp.repeat(y, b, axis=i)
        if self._padded != self.dim_shape:
            y = y[tuple(slice(0, n) for n in self.dim_shape)]
        return y


class NNSampling(LinearOperator):
    """Off-grid nearest-neighbour sampling (reference sampling.py:539-687).

    Nearest grid node per off-grid sample is precomputed on host with a
    cKDTree; ``apply`` is a static gather.  The reference's adjoint *averages*
    colliding samples per node (pandas groupby mean, sampling.py:680-687) —
    replicated here with ``segment_sum`` (``adjoint_mode='mean'``);
    ``adjoint_mode='sum'`` gives the true matrix adjoint (dot-test exact).

    Example — two samples nearest to the same grid node::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.sampling import NNSampling
        >>> S = NNSampling(grid_coords=[0.0, 1.0], sample_coords=[0.1, -0.2, 0.9])
        >>> S(jnp.array([10.0, 20.0])).tolist()
        [10.0, 10.0, 20.0]
        >>> S.adjoint(jnp.array([1.0, 3.0, 5.0])).tolist()  # mean per node
        [2.0, 5.0]
    """

    indices: jax.Array = None
    counts: jax.Array = None
    adjoint_mode: str = static_field(default="mean")

    def __init__(self, grid_coords, sample_coords, dim_shape=None, adjoint_mode: str = "mean", dtype=np.float32):
        from scipy.spatial import cKDTree

        grid = np.asarray(grid_coords, dtype=np.float64)
        samples = np.asarray(sample_coords, dtype=np.float64)
        if grid.ndim == 1:
            grid = grid[:, None]
        if samples.ndim == 1:
            samples = samples[:, None]
        tree = cKDTree(grid)
        _, idx = tree.query(samples)
        n_grid = grid.shape[0]
        dim_shape = as_shape(dim_shape) if dim_shape is not None else (n_grid,)
        if size_of(dim_shape) != n_grid:
            raise ValueError("dim_shape size must equal the number of grid nodes")
        super().__init__(dim_shape, (samples.shape[0],), lipschitz=float("inf"), dtype=dtype)
        self.indices = jnp.asarray(idx, dtype=jnp.int32)
        counts = np.bincount(idx, minlength=n_grid).astype(np.float32)
        self.counts = jnp.asarray(np.maximum(counts, 1.0))
        self.adjoint_mode = adjoint_mode

    def apply(self, x):
        return jnp.take(x.reshape(-1), self.indices)

    def adjoint(self, y):
        y = jnp.asarray(y)
        summed = jax.ops.segment_sum(y, self.indices, num_segments=self.dim)
        if self.adjoint_mode == "mean":
            summed = summed / self.counts
        return summed.reshape(self.dim_shape)


def GeneralisedVandermonde(funcs: Sequence[Callable], samples, dtype=np.float32) -> DenseOperator:
    """Dense matrix ``[phi_k(z_l)]`` evaluating a function dictionary on
    sample points (reference sampling.py:690-769).

    Example — monomial dictionary ``{1, z}``::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.sampling import GeneralisedVandermonde
        >>> V = GeneralisedVandermonde([lambda z: z**0, lambda z: z],
        ...                            samples=jnp.array([0.0, 2.0]))
        >>> V(jnp.array([1.0, 3.0])).tolist()    # 1 + 3 z at z = 0, 2
        [1.0, 7.0]
    """
    samples = jnp.asarray(samples)
    cols = [jnp.asarray(f(samples)).reshape(-1) for f in funcs]
    mat = jnp.stack(cols, axis=1).astype(dtype)
    return DenseOperator(mat)


class MappedDistanceMatrix(LinearOperator):
    """Kernel matrix operator ``y_i = sum_j phi(d(z_i, x_j)) a_j``
    (reference sampling.py:772-1058).

    Backends (the reference's three, sampling.py:928-1058):

    * ``'dense'`` — materialise the kernel matrix once (device memory m*n);
    * ``'sparse'`` — compact-support kernels (Wendland & friends): a host
      KD-tree ball query finds the <= k_max in-support neighbours per row
      once, the device applies them as a padded gather + masked contraction
      (adjoint: ``segment_sum`` scatter).  O(m * k_max) work and memory per
      matvec instead of O(m n) — the on-device redesign of the reference's
      scipy-sparse ball-query backend (sampling.py:975-1019).  Requires
      ``support=`` (or a ``function.support`` attribute, e.g.
      :class:`pycsou_tpu.math.green.Wendland`);
    * ``'matrix-free'`` — recompute kernel rows blockwise inside each matvec
      (replaces the reference's dask backend; O(m n) work, O(block * n)
      memory — for kernels with global support too large to materialise).

    ``mode='radial'`` uses Euclidean distance; ``mode='zonal'`` the great-
    circle dot product (for spherical kernels).
    """

    samples1: jax.Array = None
    samples2: jax.Array = None
    function: Callable = static_field(default=None)
    mode: str = static_field(default="radial")
    backend: str = static_field(default="dense")
    block: int = static_field(default=1024)
    _mat: Optional[jax.Array] = None
    # compact-support ('sparse') backend: padded neighbour lists + values
    _nbr_idx: Optional[jax.Array] = None
    _nbr_val: Optional[jax.Array] = None

    def __init__(self, samples1, samples2, function: Callable, mode: str = "radial", backend: str = "dense", block: int = 1024, support: Optional[float] = None, dtype=np.float32):
        s1 = jnp.asarray(samples1, dtype=dtype)
        s2 = jnp.asarray(samples2, dtype=dtype)
        if s1.ndim == 1:
            s1 = s1[:, None]
        if s2.ndim == 1:
            s2 = s2[:, None]
        super().__init__((s2.shape[0],), (s1.shape[0],), lipschitz=float("inf"), dtype=dtype)
        self.samples1, self.samples2 = s1, s2
        self.function = function
        self.mode = mode
        self.backend = backend
        self.block = int(block)
        self._nbr_idx = self._nbr_val = None
        if backend == "dense":
            self._mat = self._kernel_block(s1)
        elif backend == "sparse":
            # Compact-support backend (reference sampling.py:975-1019): the
            # reference runs cKDTree ball queries per point (joblib-parallel)
            # and assembles a scipy sparse matrix; here the host builds
            # PADDED neighbour lists once and the device applies them as a
            # gather + masked contraction (adjoint: segment_sum scatter) —
            # O(m * k_max) instead of O(m * n).
            if mode != "radial":
                raise ValueError("sparse backend requires mode='radial'")
            r = support if support is not None else getattr(function, "support", None)
            if r is None:
                raise ValueError("sparse backend needs `support` (kernel support radius)")
            from scipy.spatial import cKDTree

            s1_np = np.asarray(s1, np.float64)
            s2_np = np.asarray(s2, np.float64)
            tree = cKDTree(s2_np)
            lists = tree.query_ball_point(s1_np, r=float(r))
            m = s1_np.shape[0]
            lens = np.fromiter((len(l) for l in lists), np.int64, count=m)
            kmax = max(1, int(lens.max()) if m else 1)
            idx = np.zeros((m, kmax), np.int32)
            val = np.zeros((m, kmax), np.float32)
            if lens.sum():
                # flatten the ragged neighbour lists once: ONE vectorised
                # distance computation + ONE kernel evaluation for all nnz
                # entries (a per-row Python loop is minutes at 1e5 points)
                rows = np.repeat(np.arange(m), lens)
                cols_in_row = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
                flat_idx = np.concatenate([np.asarray(l, np.int32) for l in lists if l])
                d = np.sqrt(np.sum((s1_np[rows] - s2_np[flat_idx]) ** 2, axis=-1))
                flat_val = np.asarray(self.function(jnp.asarray(d, np.float32)), np.float32)
                idx[rows, cols_in_row] = flat_idx
                val[rows, cols_in_row] = flat_val
            self._nbr_idx = jnp.asarray(idx)
            self._nbr_val = jnp.asarray(val, dtype)
        elif backend != "matrix-free":
            raise ValueError("backend must be 'dense', 'sparse' or 'matrix-free'")

    def _kernel_block(self, pts):
        if self.mode == "radial":
            d = jnp.sqrt(jnp.maximum(jnp.sum((pts[:, None, :] - self.samples2[None, :, :]) ** 2, -1), 0.0))
        elif self.mode == "zonal":
            d = pts @ self.samples2.T
        else:
            raise ValueError("mode must be 'radial' or 'zonal'")
        return self.function(d).astype(self.dtype)

    def apply(self, x):
        if self.backend == "dense":
            return self._mat @ x
        if self.backend == "sparse":
            # gather neighbour values of x, contract against kernel values
            return jnp.sum(self._nbr_val * jnp.take(x, self._nbr_idx, axis=0), axis=1)
        m = self.samples1.shape[0]
        nb = -(-m // self.block)
        pad = nb * self.block - m
        pts = jnp.pad(self.samples1, ((0, pad), (0, 0)))
        blocks = pts.reshape(nb, self.block, -1)

        def one(b):
            return self._kernel_block(b) @ x

        out = jax.lax.map(one, blocks).reshape(-1)
        return out[:m]

    def adjoint(self, y):
        y = jnp.asarray(y)
        if self.backend == "dense":
            return self._mat.T @ y
        if self.backend == "sparse":
            n = self.samples2.shape[0]
            contrib = (self._nbr_val * y[:, None]).reshape(-1)
            return jax.ops.segment_sum(contrib, self._nbr_idx.reshape(-1), num_segments=n)
        n = self.samples2.shape[0]
        m = self.samples1.shape[0]
        nb = -(-m // self.block)
        pad = nb * self.block - m
        pts = jnp.pad(self.samples1, ((0, pad), (0, 0)))
        yp = jnp.pad(y, (0, pad)).reshape(nb, self.block)
        blocks = pts.reshape(nb, self.block, -1)

        def one(args):
            b, yb = args
            return self._kernel_block(b).T @ yb

        parts = jax.lax.map(one, (blocks, yp))
        return jnp.sum(parts, axis=0)

    def todense(self):
        if self.backend == "dense":
            return DenseOperator(self._mat)
        return DenseOperator(self._kernel_block(self.samples1))

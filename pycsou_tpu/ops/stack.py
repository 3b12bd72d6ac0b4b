"""Operator stacking: vertical/horizontal stacks, block and block-diagonal
operators.

Equivalent of the reference's pycsou/core/map.py:613-1001 and
/root/reference/pycsou/linop/base.py:159-548.  The reference fans stacked
blocks out to joblib worker processes (map.py:720-740, base.py:272-292);
here every block's apply/adjoint traces into ONE XLA computation (compiler
parallelism on a single device) and the mesh-sharded variants live in
``pycsou_tpu.parallel`` (fan-in = psum over devices, SURVEY §2.6).

Stacked outputs use the natural nd layout when all blocks agree —
``(k, *codim_shape)`` — and flat concatenation otherwise.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pycsou_tpu._module import static_field
from pycsou_tpu.core.linop import LinearOperator
from pycsou_tpu.core.map import DifferentiableMap, Map

__all__ = [
    "LinOpVStack",
    "LinOpHStack",
    "LinOpStack",
    "BlockDiagonalOperator",
    "BlockOperator",
    "MapVStack",
    "MapHStack",
    "MapStack",
]


def _stack_lip(ops) -> float:
    return math.sqrt(sum(o.lipschitz**2 for o in ops))


class LinOpVStack(LinearOperator):
    """``[A1; A2; ...]`` — shared domain, stacked ranges
    (reference linop/base.py:159-284).  Adjoint fans in by summation
    (base.py:273-284): ``A^H y = sum_i A_i^H y_i``.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import IdentityOperator
        >>> from pycsou_tpu.ops.stack import LinOpVStack
        >>> V = LinOpVStack([IdentityOperator((2,)), 2.0 * IdentityOperator((2,))])
        >>> V(jnp.array([1.0, 2.0])).tolist()
        [[1.0, 2.0], [2.0, 4.0]]
        >>> V.adjoint(jnp.ones((2, 2))).tolist()   # sum of block adjoints
        [3.0, 3.0]
    """

    ops: Tuple[LinearOperator, ...] = None
    uniform: bool = static_field(default=True)

    def __init__(self, ops: Sequence[LinearOperator]):
        ops = tuple(ops)
        dim_shape = ops[0].dim_shape
        if any(o.dim_shape != dim_shape for o in ops):
            raise ValueError("all stacked operators must share the domain")
        uniform = all(o.codim_shape == ops[0].codim_shape for o in ops)
        codim = (len(ops),) + ops[0].codim_shape if uniform else (sum(o.codim for o in ops),)
        super().__init__(dim_shape, codim, lipschitz=_stack_lip(ops), dtype=ops[0].dtype)
        self.ops = ops
        self.uniform = uniform

    def apply(self, x):
        ys = [o.apply(x) for o in self.ops]
        if self.uniform:
            return jnp.stack(ys, axis=0)
        return jnp.concatenate([y.reshape(-1) for y in ys])

    def adjoint(self, y):
        y = jnp.asarray(y)
        if self.uniform:
            return sum(o.adjoint(y[i]) for i, o in enumerate(self.ops))
        out, start = None, 0
        for o in self.ops:
            blk = y[start : start + o.codim].reshape(o.codim_shape)
            start += o.codim
            term = o.adjoint(blk)
            out = term if out is None else out + term
        return out


class LinOpHStack(LinearOperator):
    """``[A1, A2, ...]`` — split domain, shared range; forward fans in by
    summation (reference linop/base.py:286-292).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import IdentityOperator
        >>> from pycsou_tpu.ops.stack import LinOpHStack
        >>> Hs = LinOpHStack([IdentityOperator((2,)), IdentityOperator((2,))])
        >>> Hs(jnp.array([[1.0, 2.0], [10.0, 20.0]])).tolist()
        [11.0, 22.0]
    """

    ops: Tuple[LinearOperator, ...] = None
    uniform: bool = static_field(default=True)

    def __init__(self, ops: Sequence[LinearOperator]):
        ops = tuple(ops)
        codim_shape = ops[0].codim_shape
        if any(o.codim_shape != codim_shape for o in ops):
            raise ValueError("all stacked operators must share the range")
        uniform = all(o.dim_shape == ops[0].dim_shape for o in ops)
        dim = (len(ops),) + ops[0].dim_shape if uniform else (sum(o.dim for o in ops),)
        super().__init__(dim, codim_shape, lipschitz=_stack_lip(ops), dtype=ops[0].dtype)
        self.ops = ops
        self.uniform = uniform

    def apply(self, x):
        if self.uniform:
            return sum(o.apply(x[i]) for i, o in enumerate(self.ops))
        out, start = None, 0
        for o in self.ops:
            blk = x[start : start + o.dim].reshape(o.dim_shape)
            start += o.dim
            term = o.apply(blk)
            out = term if out is None else out + term
        return out

    def adjoint(self, y):
        y = jnp.asarray(y)
        xs = [o.adjoint(y) for o in self.ops]
        if self.uniform:
            return jnp.stack(xs, axis=0)
        return jnp.concatenate([x.reshape(-1) for x in xs])


def LinOpStack(ops: Sequence[LinearOperator], axis: int):
    """Reference-compatible dispatcher (linop/base.py:159): axis=0 vertical,
    axis=1 horizontal."""
    if axis == 0:
        return LinOpVStack(ops)
    if axis == 1:
        return LinOpHStack(ops)
    raise ValueError("axis must be 0 or 1")


class BlockDiagonalOperator(LinearOperator):
    """``diag(A1, ..., Ak)`` over a flat-concatenated domain/range
    (reference linop/base.py:457-548).  Each block is independent — the
    natural target for mesh sharding (see pycsou_tpu.parallel).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import DiagonalOperator
        >>> from pycsou_tpu.ops.stack import BlockDiagonalOperator
        >>> B = BlockDiagonalOperator([DiagonalOperator(jnp.array([1.0, 2.0])),
        ...                            DiagonalOperator(jnp.array([-1.0]))])
        >>> B(jnp.array([1.0, 1.0, 1.0])).tolist()
        [1.0, 2.0, -1.0]
    """

    ops: Tuple[LinearOperator, ...] = None

    def __init__(self, ops: Sequence[LinearOperator]):
        ops = tuple(ops)
        dim = sum(o.dim for o in ops)
        codim = sum(o.codim for o in ops)
        lip = max(o.lipschitz for o in ops)
        super().__init__((dim,), (codim,), lipschitz=lip, dtype=ops[0].dtype)
        self.ops = ops

    def apply(self, x):
        out, start = [], 0
        for o in self.ops:
            blk = x[start : start + o.dim].reshape(o.dim_shape)
            start += o.dim
            out.append(o.apply(blk).reshape(-1))
        return jnp.concatenate(out)

    def adjoint(self, y):
        y = jnp.asarray(y)
        out, start = [], 0
        for o in self.ops:
            blk = y[start : start + o.codim].reshape(o.codim_shape)
            start += o.codim
            out.append(o.adjoint(blk).reshape(-1))
        return jnp.concatenate(out)


class BlockOperator(LinearOperator):
    """General block operator ``[[A11, A12], [A21, A22], ...]``
    (reference linop/base.py:339-456): ``y_i = sum_j A_ij x_j`` over
    flat-concatenated domain/range."""

    grid: Tuple[Tuple[LinearOperator, ...], ...] = None

    def __init__(self, grid: Sequence[Sequence[LinearOperator]]):
        grid = tuple(tuple(row) for row in grid)
        ncols = len(grid[0])
        if any(len(row) != ncols for row in grid):
            raise ValueError("ragged block grid")
        for row in grid:
            if any(o.codim_shape != row[0].codim_shape for o in row):
                raise ValueError("blocks in a row must share the range shape")
        for j in range(ncols):
            if any(grid[i][j].dim_shape != grid[0][j].dim_shape for i in range(len(grid))):
                raise ValueError("blocks in a column must share the domain shape")
        dim = sum(grid[0][j].dim for j in range(ncols))
        codim = sum(row[0].codim for row in grid)
        # max-column-norm style bound (reference base.py:448)
        lip = math.sqrt(sum(o.lipschitz**2 for row in grid for o in row))
        super().__init__((dim,), (codim,), lipschitz=lip, dtype=grid[0][0].dtype)
        self.grid = grid

    def _split(self, v, shapes_sizes):
        out, start = [], 0
        for shape, size in shapes_sizes:
            out.append(v[start : start + size].reshape(shape))
            start += size
        return out

    def apply(self, x):
        ncols = len(self.grid[0])
        col_meta = [(self.grid[0][j].dim_shape, self.grid[0][j].dim) for j in range(ncols)]
        xs = self._split(x, col_meta)
        outs = []
        for row in self.grid:
            acc = None
            for o, xj in zip(row, xs):
                term = o.apply(xj)
                acc = term if acc is None else acc + term
            outs.append(acc.reshape(-1))
        return jnp.concatenate(outs)

    def adjoint(self, y):
        y = jnp.asarray(y)
        row_meta = [(row[0].codim_shape, row[0].codim) for row in self.grid]
        ys = self._split(y, row_meta)
        ncols = len(self.grid[0])
        outs = []
        for j in range(ncols):
            acc = None
            for i, row in enumerate(self.grid):
                term = row[j].adjoint(ys[i])
                acc = term if acc is None else acc + term
            outs.append(acc.reshape(-1))
        return jnp.concatenate(outs)


class MapVStack(Map):
    """Vertical stack of (possibly nonlinear) maps over a shared domain
    (reference ``MapVStack``, map.py:754).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import IdentityOperator
        >>> from pycsou_tpu.ops.stack import MapVStack
        >>> V = MapVStack([IdentityOperator((2,)), -1.0 * IdentityOperator((2,))])
        >>> V(jnp.array([1.0, 2.0])).tolist()
        [[1.0, 2.0], [-1.0, -2.0]]
    """

    maps: Tuple[Map, ...] = None
    uniform: bool = static_field(default=True)

    def __init__(self, maps: Sequence[Map]):
        maps = tuple(maps)
        dim_shape = maps[0].dim_shape
        if any(m.dim_shape != dim_shape for m in maps):
            raise ValueError("all stacked maps must share the domain")
        uniform = all(m.codim_shape == maps[0].codim_shape for m in maps)
        codim = (len(maps),) + maps[0].codim_shape if uniform else (sum(max(m.codim, 1) for m in maps),)
        lip = math.sqrt(sum(m.lipschitz**2 for m in maps))
        super().__init__(dim_shape, codim, lipschitz=lip)
        self.maps = maps
        self.uniform = uniform

    def apply(self, x):
        ys = [m.apply(x) for m in self.maps]
        if self.uniform:
            return jnp.stack(ys, axis=0)
        return jnp.concatenate([jnp.atleast_1d(y).reshape(-1) for y in ys])


class MapHStack(Map):
    """Horizontal stack: split input, SUM the outputs
    (reference ``MapHStack``, map.py:791, fan-in semantics map.py:729-740)."""

    maps: Tuple[Map, ...] = None
    uniform: bool = static_field(default=True)

    def __init__(self, maps: Sequence[Map]):
        maps = tuple(maps)
        codim_shape = maps[0].codim_shape
        if any(m.codim_shape != codim_shape for m in maps):
            raise ValueError("all stacked maps must share the range")
        uniform = all(m.dim_shape == maps[0].dim_shape for m in maps)
        dim = (len(maps),) + maps[0].dim_shape if uniform else (sum(m.dim for m in maps),)
        lip = math.sqrt(sum(m.lipschitz**2 for m in maps))
        super().__init__(dim, codim_shape, lipschitz=lip)
        self.maps = maps
        self.uniform = uniform

    def apply(self, x):
        if self.uniform:
            return sum(m.apply(x[i]) for i, m in enumerate(self.maps))
        out, start = None, 0
        for m in self.maps:
            blk = x[start : start + m.dim].reshape(m.dim_shape)
            start += m.dim
            term = m.apply(blk)
            out = term if out is None else out + term
        return out


def MapStack(maps: Sequence[Map], axis: int):
    """Reference-compatible dispatcher (map.py:613)."""
    if axis == 0:
        return MapVStack(maps)
    if axis == 1:
        return MapHStack(maps)
    raise ValueError("axis must be 0 or 1")


class DiffMapVStack(MapVStack, DifferentiableMap):
    """Vertical stack of differentiable maps (reference ``DiffMapStack``
    axis=0, map.py:828-1001): diff-Lipschitz bound sqrt(sum beta_i^2)
    (map.py:928-933); ``jacobianT`` stacks per-map transposed Jacobians into
    a horizontal operator stack (map.py:938-957)."""

    def __init__(self, maps: Sequence[DifferentiableMap]):
        MapVStack.__init__(self, maps)
        self._diff_lipschitz = math.sqrt(sum(m.diff_lipschitz**2 for m in self.maps))

    def jacobianT(self, x):
        x = jnp.asarray(x)
        # J^T of a v-stack is the h-stack of the J_i^T (fan-in by summation)
        return LinOpHStack([_as_linop(m.jacobianT(x), m) for m in self.maps])


class DiffMapHStack(MapHStack, DifferentiableMap):
    """Horizontal stack of differentiable maps (reference ``DiffMapStack``
    axis=1): diff-Lipschitz bound max beta_i (map.py:928-933); ``jacobianT``
    stacks the per-block J_i^T vertically."""

    def __init__(self, maps: Sequence[DifferentiableMap]):
        MapHStack.__init__(self, maps)
        self._diff_lipschitz = max(m.diff_lipschitz for m in self.maps)

    def jacobianT(self, x):
        x = jnp.asarray(x)
        if self.uniform:
            blocks = [x[i] for i in range(len(self.maps))]
        else:
            blocks, start = [], 0
            for m in self.maps:
                blocks.append(x[start : start + m.dim].reshape(m.dim_shape))
                start += m.dim
        return LinOpVStack([_as_linop(m.jacobianT(b), m) for m, b in zip(self.maps, blocks)])


def _as_linop(jac, m: Map):
    """Lift a functional's gradient *array* g to the operator
    ``alpha -> alpha * g`` (scalar domain), so Jacobian stacks stay
    operator-valued (the reference returns raw arrays for functionals)."""
    if isinstance(jac, LinearOperator):
        return jac
    from pycsou_tpu.func.base import ExplicitLinearFunctional

    return ExplicitLinearFunctional(jnp.asarray(jac)).H


def DiffMapStack(maps: Sequence[DifferentiableMap], axis: int):
    """Reference-compatible dispatcher (map.py:828)."""
    if axis == 0:
        return DiffMapVStack(maps)
    if axis == 1:
        return DiffMapHStack(maps)
    raise ValueError("axis must be 0 or 1")

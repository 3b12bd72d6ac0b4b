"""Finite-difference stencil operators: derivatives, gradient, Laplacian,
directional and generalised variants, causal integration.

Equivalent of the reference's pycsou/linop/diff.py (1,141 LoC,
which wraps pylops stencils).  Stencils are expressed as sliced vector ops
that XLA fuses into its surrounding elementwise passes (the fused TV step
is pycsou_tpu.kernels.tv); adjoints are hand-derived (divergence
forms) and dot-test verified.  Exact spectral bounds are set in closed form
instead of the reference's ARPACK estimation.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from pycsou_tpu._module import static_field
from pycsou_tpu.core.linop import LinearOperator
from pycsou_tpu.ops.basic import DiagonalOperator, HomothetyOperator, PolynomialOperator
from pycsou_tpu.utils.shapes import as_shape

__all__ = [
    "FirstDerivative",
    "SecondDerivative",
    "GeneralisedDerivative",
    "Gradient",
    "Laplacian",
    "GeneralisedLaplacian",
    "FirstDirectionalDerivative",
    "SecondDirectionalDerivative",
    "DirectionalGradient",
    "DirectionalLaplacian",
    "Integration1D",
]


def _pad_axis(x, axis, before, after):
    pads = [(0, 0)] * x.ndim
    pads[axis] = (before, after)
    return jnp.pad(x, pads)


def _slice_axis(x, axis, start, stop):
    return jax.lax.slice_in_dim(x, start, stop, axis=axis)


def fdiff_forward(x, axis, step=1.0):
    """y_i = (x_{i+1} - x_i)/step, last entry 0 (pylops 'forward' edge
    convention, reference diff.py:24-128)."""
    n = x.shape[axis]
    d = (_slice_axis(x, axis, 1, n) - _slice_axis(x, axis, 0, n - 1)) / step
    return _pad_axis(d, axis, 0, 1)


def fdiff_forward_adjoint(y, axis, step=1.0):
    """(D^T y)_j = (y_{j-1} - y_j)/step with y_{-1} = y_{n-1} = 0."""
    n = y.shape[axis]
    y = _slice_axis(y, axis, 0, n - 1)  # y_{n-1} never contributes
    ypad = _pad_axis(y, axis, 1, 1)
    return (_slice_axis(ypad, axis, 0, n) - _slice_axis(ypad, axis, 1, n + 1)) / step


def fdiff_backward(x, axis, step=1.0):
    """y_i = (x_i - x_{i-1})/step, first entry 0."""
    n = x.shape[axis]
    d = (_slice_axis(x, axis, 1, n) - _slice_axis(x, axis, 0, n - 1)) / step
    return _pad_axis(d, axis, 1, 0)


def fdiff_centered(x, axis, step=1.0):
    """y_i = (x_{i+1} - x_{i-1})/(2 step), both edges 0."""
    n = x.shape[axis]
    d = (_slice_axis(x, axis, 2, n) - _slice_axis(x, axis, 0, n - 2)) / (2 * step)
    return _pad_axis(d, axis, 1, 1)


def sdiff(x, axis, step=1.0):
    """y_i = (x_{i-1} - 2 x_i + x_{i+1})/step^2, edge outputs 0."""
    n = x.shape[axis]
    d = (
        _slice_axis(x, axis, 0, n - 2) - 2 * _slice_axis(x, axis, 1, n - 1) + _slice_axis(x, axis, 2, n)
    ) / step**2
    return _pad_axis(d, axis, 1, 1)


def sdiff_adjoint(y, axis, step=1.0):
    """Adjoint of ``sdiff``: the same stencil applied to edge-zeroed y,
    WITHOUT re-zeroing the output edges (the zero *rows* of the stencil
    matrix become zero *columns* of its transpose)."""
    n = y.shape[axis]
    yt = _pad_axis(_slice_axis(y, axis, 1, n - 1), axis, 1, 1)  # zero the edge entries
    ypad = _pad_axis(yt, axis, 1, 1)
    return (
        _slice_axis(ypad, axis, 0, n) - 2 * _slice_axis(ypad, axis, 1, n + 1) + _slice_axis(ypad, axis, 2, n + 2)
    ) / step**2


class FirstDerivative(LinearOperator):
    """First derivative along ``axis`` (reference diff.py:24-128).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.diff import FirstDerivative
        >>> D = FirstDerivative((4,))
        >>> D(jnp.array([0.0, 1.0, 3.0, 3.0])).tolist()   # forward diffs
        [1.0, 2.0, 0.0, 0.0]
        >>> x, y = jnp.arange(4.0), jnp.ones(4)
        >>> bool(jnp.isclose(jnp.vdot(D(x), y), jnp.vdot(x, D.adjoint(y))))
        True
    """

    axis: int = static_field(default=0)
    kind: str = static_field(default="forward")
    step: float = static_field(default=1.0)

    def __init__(self, dim_shape, axis: int = 0, kind: str = "forward", step: float = 1.0, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        if kind not in ("forward", "backward", "centered"):
            raise ValueError("kind must be forward/backward/centered")
        lip = (1.0 if kind == "centered" else 2.0) / step
        super().__init__(dim_shape, dim_shape, lipschitz=lip, dtype=dtype)
        self.axis = int(axis)
        self.kind = kind
        self.step = float(step)

    def apply(self, x):
        f = {"forward": fdiff_forward, "backward": fdiff_backward, "centered": fdiff_centered}[self.kind]
        return f(x, self.axis, self.step)

    def adjoint(self, y):
        y = jnp.asarray(y)
        if self.kind == "forward":
            return fdiff_forward_adjoint(y, self.axis, self.step)
        if self.kind == "backward":
            # (D^T y)_j = (y_j - y_{j+1})/step with y_0 := 0 (zero row) and y_n := 0
            n = y.shape[self.axis]
            yc = _pad_axis(_slice_axis(y, self.axis, 1, n), self.axis, 1, 1)  # [0, y_1..y_{n-1}, 0]
            return (_slice_axis(yc, self.axis, 0, n) - _slice_axis(yc, self.axis, 1, n + 1)) / self.step
        # centered: (D^T y)_j = (y_{j-1} - y_{j+1})/(2 step), edge y's are 0
        n = y.shape[self.axis]
        yc = _slice_axis(y, self.axis, 1, n - 1)
        up = _pad_axis(yc, self.axis, 2, 0)
        dn = _pad_axis(yc, self.axis, 0, 2)
        return (_slice_axis(up, self.axis, 0, n) - _slice_axis(dn, self.axis, 0, n)) / (2 * self.step)


class SecondDerivative(LinearOperator):
    """Second derivative along ``axis`` with zeroed edge rows
    (reference diff.py:133-218).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.diff import SecondDerivative
        >>> D2 = SecondDerivative((4,))
        >>> D2(jnp.array([0.0, 1.0, 4.0, 9.0])).tolist()  # x^2 -> 2, edges 0
        [0.0, 2.0, 2.0, 0.0]
    """

    axis: int = static_field(default=0)
    step: float = static_field(default=1.0)

    def __init__(self, dim_shape, axis: int = 0, step: float = 1.0, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        super().__init__(dim_shape, dim_shape, lipschitz=4.0 / step**2, dtype=dtype)
        self.axis = int(axis)
        self.step = float(step)

    def apply(self, x):
        return sdiff(x, self.axis, self.step)

    def adjoint(self, y):
        return sdiff_adjoint(jnp.asarray(y), self.axis, self.step)


def _edge_kill(dim_shape, axis, width, dtype=np.float32):
    """Diagonal mask zeroing ``width`` boundary samples along ``axis``
    (reference diff.py:357-377)."""
    n = dim_shape[axis]
    mask1d = np.ones(n, dtype=dtype)
    mask1d[:width] = 0
    mask1d[n - width :] = 0
    shape = [1] * len(dim_shape)
    shape[axis] = n
    mask = np.broadcast_to(mask1d.reshape(shape), dim_shape).copy()
    return DiagonalOperator(jnp.asarray(mask))


def GeneralisedDerivative(
    dim_shape,
    axis: int = 0,
    kind: str = "iterated",
    order: int = 1,
    alpha: float = 1.0,
    coeffs=None,
    step: float = 1.0,
    kill_edges: bool = True,
    dtype=np.float32,
) -> LinearOperator:
    """Generalised 1-D differential operator composed from the operator
    algebra (reference diff.py:222-377):

    * ``'iterated'``   : D^N
    * ``'sobolev'``    : (alpha^2 I - D2)^N
    * ``'exponential'``: (alpha I + D)^N
    * ``'polynomial'`` : sum_k c_k D^k
    """
    dim_shape = as_shape(dim_shape)
    D = FirstDerivative(dim_shape, axis=axis, kind="centered", step=step, dtype=dtype)
    if kind == "iterated":
        op = D**order
        width = order
    elif kind == "sobolev":
        D2 = SecondDerivative(dim_shape, axis=axis, step=step, dtype=dtype)
        base = HomothetyOperator(alpha**2, dim_shape, dtype=dtype) - D2
        op = base**order
        width = order
    elif kind == "exponential":
        base = HomothetyOperator(alpha, dim_shape, dtype=dtype) + D
        op = base**order
        width = order
    elif kind == "polynomial":
        if coeffs is None:
            raise ValueError("polynomial kind requires coeffs")
        op = PolynomialOperator(D, coeffs)
        width = len(np.asarray(coeffs)) - 1
    else:
        raise ValueError(f"unknown kind {kind!r}")
    if kill_edges and width > 0:
        op = _edge_kill(dim_shape, axis, width, dtype) * op
    return op


class Gradient(LinearOperator):
    """Stacked first-order differences along every axis:
    ``(d, *dim_shape)`` output — the isotropic-TV workhorse
    (reference diff.py:777-882).  Hand-fused apply/adjoint (negative
    divergence); XLA fuses the slices into elementwise passes.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.diff import Gradient
        >>> G = Gradient((2, 2))
        >>> G(jnp.array([[0.0, 1.0], [2.0, 3.0]])).shape     # (axes, H, W)
        (2, 2, 2)
        >>> G(jnp.array([[0.0, 1.0], [2.0, 3.0]]))[1].tolist()  # d/dx1
        [[1.0, 0.0], [1.0, 0.0]]
    """

    kind: str = static_field(default="forward")
    steps: Tuple[float, ...] = static_field(default=None)

    def __init__(self, dim_shape, kind: str = "forward", step: Union[float, Sequence[float]] = 1.0, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        d = len(dim_shape)
        steps = tuple([float(step)] * d) if np.isscalar(step) else tuple(float(s) for s in step)
        per_axis = [(1.0 if kind == "centered" else 2.0) / s for s in steps]
        lip = math.sqrt(sum(p**2 for p in per_axis))
        super().__init__(dim_shape, (d,) + dim_shape, lipschitz=lip, dtype=dtype)
        self.kind = kind
        self.steps = steps

    def apply(self, x):
        f = {"forward": fdiff_forward, "backward": fdiff_backward, "centered": fdiff_centered}[self.kind]
        return jnp.stack([f(x, a, s) for a, s in enumerate(self.steps)], axis=0)

    def adjoint(self, y):
        y = jnp.asarray(y)
        if self.kind == "forward":
            return sum(fdiff_forward_adjoint(y[a], a, s) for a, s in enumerate(self.steps))
        # fall back to the generic linear transpose for other kinds
        return super().adjoint(y)


class Laplacian(LinearOperator):
    """Sum of second derivatives along ``axes`` — 5-point stencil in 2-D
    (reference diff.py:885-957).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.diff import Laplacian
        >>> L = Laplacian((3, 3))
        >>> x = jnp.zeros((3, 3)).at[1, 1].set(1.0)
        >>> float(L(x)[1, 1])                                # -4 at the peak
        -4.0
    """

    axes: Tuple[int, ...] = static_field(default=None)
    steps: Tuple[float, ...] = static_field(default=None)

    def __init__(self, dim_shape, axes: Optional[Sequence[int]] = None, step: Union[float, Sequence[float]] = 1.0, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        axes = tuple(range(len(dim_shape))) if axes is None else tuple(axes)
        steps = tuple([float(step)] * len(axes)) if np.isscalar(step) else tuple(float(s) for s in step)
        lip = sum(4.0 / s**2 for s in steps)
        super().__init__(dim_shape, dim_shape, lipschitz=lip, dtype=dtype)
        self.axes = axes
        self.steps = steps

    def apply(self, x):
        return sum(sdiff(x, a, s) for a, s in zip(self.axes, self.steps))

    def adjoint(self, y):
        y = jnp.asarray(y)
        return sum(sdiff_adjoint(y, a, s) for a, s in zip(self.axes, self.steps))


def GeneralisedLaplacian(
    dim_shape,
    kind: str = "iterated",
    order: int = 1,
    alpha: float = 1.0,
    coeffs=None,
    step: float = 1.0,
    kill_edges: bool = True,
    dtype=np.float32,
) -> LinearOperator:
    """Polynomial / Sobolev / iterated operators in the Laplacian
    (reference diff.py:960-1067)."""
    dim_shape = as_shape(dim_shape)
    L = Laplacian(dim_shape, step=step, dtype=dtype)
    if kind == "iterated":
        op = L**order
        width = order
    elif kind == "sobolev":
        base = HomothetyOperator(alpha**2, dim_shape, dtype=dtype) - L
        op = base**order
        width = order
    elif kind == "polynomial":
        if coeffs is None:
            raise ValueError("polynomial kind requires coeffs")
        op = PolynomialOperator(L, coeffs)
        width = len(np.asarray(coeffs)) - 1
    else:
        raise ValueError(f"unknown kind {kind!r}")
    if kill_edges and width > 0:
        for a in range(len(dim_shape)):
            op = _edge_kill(dim_shape, a, width, dtype) * op
    return op


def _canon_directions(directions, dim_shape, dtype):
    v = jnp.asarray(directions, dtype=dtype)
    d = len(dim_shape)
    if v.ndim == 1:
        if v.shape[0] != d:
            raise ValueError("constant direction must have one entry per axis")
        v = v.reshape((d,) + (1,) * d) * jnp.ones((d,) + dim_shape, dtype=dtype)
    elif v.shape != (d,) + dim_shape:
        raise ValueError(f"directions must be shaped {(d,) + dim_shape}")
    return v


class FirstDirectionalDerivative(LinearOperator):
    """Derivative along a (possibly spatially varying) vector field:
    ``d_v x = sum_a v_a * D_a x`` (reference diff.py:380-486).

    Example — the axis-0 unit field reduces to the centered derivative::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.diff import FirstDirectionalDerivative
        >>> D = FirstDirectionalDerivative((4, 4), directions=(1.0, 0.0))
        >>> x = jnp.arange(16.0).reshape(4, 4)
        >>> D(x)[1:3, 0].tolist()                            # interior rows
        [4.0, 4.0]
    """

    directions: jax.Array = None
    step: float = static_field(default=1.0)

    def __init__(self, dim_shape, directions, step: float = 1.0, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        v = _canon_directions(directions, dim_shape, dtype)
        vmax = float(jnp.max(jnp.sqrt(jnp.sum(v**2, axis=0))))
        super().__init__(dim_shape, dim_shape, lipschitz=vmax * 2.0 * math.sqrt(len(dim_shape)) / step, dtype=dtype)
        self.directions = v
        self.step = float(step)

    def apply(self, x):
        terms = [self.directions[a] * fdiff_centered(x, a, self.step) for a in range(len(self.dim_shape))]
        return sum(terms)

    def adjoint(self, y):
        y = jnp.asarray(y)
        prim = jax.ShapeDtypeStruct(self.dim_shape, self.dtype)
        (out,) = jax.linear_transpose(self.apply, prim)(y)
        return out


def SecondDirectionalDerivative(dim_shape, directions, step: float = 1.0, kill_edges: bool = True, dtype=np.float32):
    """``-d_v^H d_v`` with optional boundary kill (reference diff.py:489-606)."""
    d1 = FirstDirectionalDerivative(dim_shape, directions, step=step, dtype=dtype)
    op = -(d1.H * d1)
    if kill_edges:
        for a in range(len(as_shape(dim_shape))):
            op = _edge_kill(as_shape(dim_shape), a, 2, dtype) * op
    return op


class DirectionalGradient(LinearOperator):
    """Stack of directional derivatives along several fields
    (reference diff.py:609-688)."""

    ops: Tuple[FirstDirectionalDerivative, ...] = None

    def __init__(self, dim_shape, directions_list, step: float = 1.0, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        ops = tuple(FirstDirectionalDerivative(dim_shape, v, step=step, dtype=dtype) for v in directions_list)
        lip = math.sqrt(sum(o.lipschitz**2 for o in ops))
        super().__init__(dim_shape, (len(ops),) + dim_shape, lipschitz=lip, dtype=dtype)
        self.ops = ops

    def apply(self, x):
        return jnp.stack([o.apply(x) for o in self.ops], axis=0)

    def adjoint(self, y):
        y = jnp.asarray(y)
        return sum(o.adjoint(y[i]) for i, o in enumerate(self.ops))


def DirectionalLaplacian(dim_shape, directions_list, weights=None, step: float = 1.0, dtype=np.float32):
    """Weighted sum of second directional derivatives
    (reference diff.py:691-774)."""
    if weights is None:
        weights = [1.0] * len(directions_list)
    op = None
    for w, v in zip(weights, directions_list):
        term = float(w) * SecondDirectionalDerivative(dim_shape, v, step=step, dtype=dtype)
        op = term if op is None else op + term
    return op


class Integration1D(LinearOperator):
    """Causal cumulative integration along ``axis``
    (reference diff.py:1071-1136); adjoint is anti-causal integration.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.diff import Integration1D
        >>> S = Integration1D((4,))
        >>> S(jnp.ones(4)).tolist()
        [1.0, 2.0, 3.0, 4.0]
        >>> S.adjoint(jnp.array([0.0, 0.0, 0.0, 1.0])).tolist()
        [1.0, 1.0, 1.0, 1.0]
    """

    axis: int = static_field(default=0)
    step: float = static_field(default=1.0)

    def __init__(self, dim_shape, axis: int = 0, step: float = 1.0, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        n = dim_shape[axis]
        lip = step / (2 * math.sin(math.pi / (4 * n + 2)))  # exact sigma_max of the cumsum matrix
        super().__init__(dim_shape, dim_shape, lipschitz=lip, dtype=dtype)
        self.axis = int(axis)
        self.step = float(step)

    def apply(self, x):
        return jnp.cumsum(x, axis=self.axis) * self.step

    def adjoint(self, y):
        y = jnp.asarray(y)
        rev = jnp.flip(jnp.cumsum(jnp.flip(y, self.axis), axis=self.axis), self.axis)
        return rev * self.step

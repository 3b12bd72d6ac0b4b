"""Nonlinear map calculus: shapes, arithmetic, Lipschitz propagation.

Re-design of the reference's ``Map`` / ``DifferentiableMap``
hierarchy (/root/reference/pycsou/core/map.py:20-610).  Differences by design:

* Maps act on nd-arrays (``dim_shape`` / ``codim_shape`` tuples) instead of
  flat vectors, so images stay 2-D and stencil/conv passes keep their
  natural layout.  ``shape == (codim_size, dim_size)`` is kept for parity.
* ``apply`` is a *pure jittable function*; arithmetic (`+ - * @ ** /`) builds
  pytree-registered wrapper nodes whose dispatch cost is paid once at trace
  time, not per iteration — the composed expression compiles to a single fused
  XLA computation.
* Jacobians default to JAX autodiff (``jax.vjp``) instead of hand-written
  chain rules; the hand-derived Lipschitz propagation rules of the reference
  (map.py:564-610) are kept verbatim because XLA cannot derive those.
"""
from __future__ import annotations

from numbers import Number
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pycsou_tpu._module import Module, static_field
from pycsou_tpu.utils.shapes import as_shape, size_of

__all__ = [
    "Map",
    "DifferentiableMap",
    "MapShifted",
    "MapSum",
    "MapComp",
    "DiffMapShifted",
    "DiffMapSum",
    "DiffMapComp",
]

_INF = float("inf")


def _is_arraylike(x) -> bool:
    return isinstance(x, (np.ndarray, jax.Array)) and not isinstance(x, Map)


class Map(Module):
    """A map ``f: R^{dim_shape} -> R^{codim_shape}``.

    Subclasses implement :meth:`apply` as a pure, jit-traceable function.
    Reference: /root/reference/pycsou/core/map.py:20.

    Example — arithmetic composes maps lazily (reference map.py:49-90)::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import DiagonalOperator, IdentityOperator
        >>> f1 = DiagonalOperator(jnp.array([1.0, 2.0]))
        >>> f2 = IdentityOperator((2,))
        >>> f3 = 2.0 * f1 + f2                    # lazy expression tree
        >>> x = jnp.array([1.0, 1.0])
        >>> bool(jnp.allclose(f3(x), 2.0 * f1(x) + f2(x)))
        True
        >>> f3.lipschitz                          # L propagates: 2*2 + 1
        5.0
    """

    dim_shape: Tuple[int, ...] = static_field(default=())
    codim_shape: Tuple[int, ...] = static_field(default=())
    _lipschitz: float = static_field(default=_INF)

    def __init__(self, dim_shape, codim_shape, lipschitz: float = _INF):
        self.dim_shape = as_shape(dim_shape)
        self.codim_shape = as_shape(codim_shape)
        self._lipschitz = float(lipschitz)

    # -- core protocol -----------------------------------------------------
    def apply(self, x: jax.Array) -> jax.Array:
        """Evaluate the map at ``x`` (pure and jittable; shape
        ``dim_shape`` -> ``codim_shape``).  Reference map.py:119."""
        raise NotImplementedError

    def __call__(self, x):
        return self.apply(jnp.asarray(x))

    # -- shapes ------------------------------------------------------------
    @property
    def dim(self) -> int:
        """Flattened input dimension (product of ``dim_shape``)."""
        return size_of(self.dim_shape)

    @property
    def codim(self) -> int:
        """Flattened output dimension (product of ``codim_shape``)."""
        return size_of(self.codim_shape)

    @property
    def shape(self) -> Tuple[int, int]:
        """Reference-style ``(codim_size, dim_size)`` matrix shape."""
        return (self.codim, self.dim)

    # -- flags -------------------------------------------------------------
    @property
    def is_linear(self) -> bool:
        """True iff this map is a :class:`LinearOperator`."""
        from pycsou_tpu.core.linop import LinearOperator

        return isinstance(self, LinearOperator)

    @property
    def is_differentiable(self) -> bool:
        """True iff this map exposes ``jacobianT``/``gradient``."""
        return isinstance(self, DifferentiableMap)

    @property
    def is_functional(self) -> bool:
        """True iff the map is scalar-valued (``codim_shape == ()``)."""
        return self.codim_shape == ()

    # -- Lipschitz bookkeeping --------------------------------------------
    @property
    def lipschitz(self) -> float:
        """Known Lipschitz constant (``inf`` when unknown; settable)."""
        return self._lipschitz

    @lipschitz.setter
    def lipschitz(self, value: float):
        self._lipschitz = float(value)

    # reference-compatible alias (pycsou/core/map.py:441)
    @property
    def lipschitz_cst(self) -> float:
        """Reference-compatible alias for :attr:`lipschitz` (map.py:441)."""
        return self._lipschitz

    @lipschitz_cst.setter
    def lipschitz_cst(self, value: float):
        self._lipschitz = float(value)

    # -- batching ----------------------------------------------------------
    def apply_batched(self, xs: jax.Array) -> jax.Array:
        """Vectorised apply over a leading batch axis (replacement
        for the reference's ``apply_along_axis``, map.py:131)."""
        return jax.vmap(self.apply)(xs)

    # reference-compatible alias (batch axis first)
    apply_along_axis = apply_batched

    # -- arithmetic --------------------------------------------------------
    def shifter(self, shift) -> "Map":
        """Return ``x -> f(x + shift)`` (reference map.py:177)."""
        from pycsou_tpu.core import arith

        return arith.shift(self, shift)

    def argscale(self, scale) -> "Map":
        """Return ``x -> f(scale * x)``."""
        from pycsou_tpu.core import arith

        return arith.scale_input(self, scale)

    def __add__(self, other):
        from pycsou_tpu.core import arith

        if isinstance(other, Map):
            return arith.add(self, other)
        return NotImplemented

    def __radd__(self, other):
        from pycsou_tpu.core import arith

        if isinstance(other, Map):
            return arith.add(other, self)
        return NotImplemented

    def __mul__(self, other):
        from pycsou_tpu.core import arith

        if isinstance(other, Number):
            # reference semantics: f * alpha == f(alpha * x)  (map.py:253)
            return arith.scale_input(self, other)
        if _is_arraylike(other):
            return self(other)
        if isinstance(other, Map):
            return arith.compose(self, other)
        return NotImplemented

    def __rmul__(self, other):
        from pycsou_tpu.core import arith

        if isinstance(other, Number):
            # alpha * f == alpha * f(x)  (output scaling, map.py:550-554)
            return arith.scale_output(self, other)
        if isinstance(other, Map):
            return arith.compose(other, self)
        return NotImplemented

    def __matmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        from pycsou_tpu.core import arith

        return arith.scale_output(self, -1)

    def __sub__(self, other):
        if isinstance(other, Map):
            return self.__add__(other.__neg__())
        return NotImplemented

    def __pow__(self, power: int):
        if not isinstance(power, int) or power < 1:
            raise NotImplementedError("power must be a positive integer")
        out = self
        for _ in range(1, power):
            out = self.__mul__(out)
        return out

    def __truediv__(self, scalar):
        if isinstance(scalar, Number):
            return self.__mul__(1 / scalar)
        return NotImplemented


class DifferentiableMap(Map):
    """Map with a Jacobian; tracks ``diff_lipschitz`` through arithmetic.

    Reference: /root/reference/pycsou/core/map.py:390.  Unlike the reference —
    where every subclass hand-writes ``jacobianT`` — the default here derives
    the transposed Jacobian from ``apply`` via ``jax.vjp``; subclasses override
    only when a closed form is cheaper.

    Example — beta propagates through composition (reference map.py:596-610)::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func.penalty import SquaredL2Norm
        >>> from pycsou_tpu.ops.basic import DiagonalOperator
        >>> F = SquaredL2Norm((2,)) * DiagonalOperator(jnp.array([1.0, 3.0]))
        >>> F.diff_lipschitz                      # beta = 2 * L_A^2
        18.0
        >>> F.gradient(jnp.array([1.0, 1.0])).tolist()   # 2 A^H A x
        [2.0, 18.0]
    """

    _diff_lipschitz: float = static_field(default=_INF)

    def __init__(self, dim_shape, codim_shape, lipschitz: float = _INF, diff_lipschitz: float = _INF):
        # explicit base call: the Functional diamond is not super()-cooperative
        Map.__init__(self, dim_shape, codim_shape, lipschitz)
        self._diff_lipschitz = float(diff_lipschitz)

    @property
    def diff_lipschitz(self) -> float:
        """Lipschitz constant of the GRADIENT (``beta``; settable)."""
        return self._diff_lipschitz

    @diff_lipschitz.setter
    def diff_lipschitz(self, value: float):
        self._diff_lipschitz = float(value)

    # reference-compatible alias (pycsou/core/map.py:457)
    @property
    def diff_lipschitz_cst(self) -> float:
        """Reference-compatible alias for :attr:`diff_lipschitz` (map.py:457)."""
        return self._diff_lipschitz

    @diff_lipschitz_cst.setter
    def diff_lipschitz_cst(self, value: float):
        self._diff_lipschitz = float(value)

    def jacobianT(self, x) -> "Map":
        """Transposed Jacobian at ``x`` as a LinearOperator (map.py:459).

        Functionals override this to return the gradient array directly,
        mirroring the reference's convention.
        """
        from pycsou_tpu.core.linop import JacobianTOperator

        return JacobianTOperator(self, jnp.asarray(x))

    def gradient(self, x):
        """Alias for :meth:`jacobianT` (reference map.py:476)."""
        return self.jacobianT(x)

    def compute_lipschitz_cst(self, **kwargs) -> float:
        """Optionally overridden; see LinearOperator for the power-iteration one."""
        return self._lipschitz

    def compute_diff_lipschitz_cst(self, **kwargs) -> float:
        """Return (and cache) the gradient's Lipschitz constant
        (reference map.py:468)."""
        return self._diff_lipschitz


# ---------------------------------------------------------------------------
# Wrapper nodes (built by pycsou_tpu.core.arith, never directly by users)
# ---------------------------------------------------------------------------


class MapShifted(Map):
    """``x -> f(x + shift)`` (reference map.py:337)."""

    base: Map = None
    shift: jax.Array = None

    def __init__(self, base: Map, shift):
        shift = jnp.asarray(shift)
        if shift.ndim > 0 and shift.shape != base.dim_shape:
            raise ValueError(f"shift shape {shift.shape} != dim_shape {base.dim_shape}")
        super().__init__(base.dim_shape, base.codim_shape, lipschitz=base.lipschitz)
        self.base = base
        self.shift = shift

    def apply(self, x):
        return self.base.apply(x + self.shift)


class MapSum(Map):
    """``f1 + f2`` with range broadcasting (reference map.py:349)."""

    m1: Map = None
    m2: Map = None

    def __init__(self, m1: Map, m2: Map):
        if m1.dim_shape != m2.dim_shape:
            raise ValueError(f"domain mismatch: {m1.dim_shape} vs {m2.dim_shape}")
        codim = _broadcast_codim(m1.codim_shape, m2.codim_shape)
        lip = m1.lipschitz + m2.lipschitz
        super().__init__(m1.dim_shape, codim, lipschitz=lip)
        self.m1, self.m2 = m1, m2

    def apply(self, x):
        return self.m1.apply(x) + self.m2.apply(x)


class MapComp(Map):
    """``f1 o f2`` (reference map.py:375)."""

    m1: Map = None
    m2: Map = None

    def __init__(self, m1: Map, m2: Map):
        if m2.codim_shape != m1.dim_shape:
            raise ValueError(
                f"cannot compose: inner codim {m2.codim_shape} != outer dim {m1.dim_shape}"
            )
        lip = m1.lipschitz * m2.lipschitz
        super().__init__(m2.dim_shape, m1.codim_shape, lipschitz=lip)
        self.m1, self.m2 = m1, m2

    def apply(self, x):
        return self.m1.apply(self.m2.apply(x))


class DiffMapShifted(MapShifted, DifferentiableMap):
    """Shifted differentiable map; L and beta carry over (map.py:564)."""

    def __init__(self, base: DifferentiableMap, shift):
        MapShifted.__init__(self, base, shift)
        self._diff_lipschitz = float(base.diff_lipschitz)

    def jacobianT(self, x):
        return self.base.jacobianT(jnp.asarray(x) + self.shift)

    def gradient(self, x):
        return self.jacobianT(x)


class DiffMapSum(MapSum, DifferentiableMap):
    """Sum rule: L = L1+L2, beta = b1+b2, J^T = J1^T + J2^T (map.py:575)."""

    def __init__(self, m1: DifferentiableMap, m2: DifferentiableMap):
        MapSum.__init__(self, m1, m2)
        self._diff_lipschitz = float(m1.diff_lipschitz + m2.diff_lipschitz)

    def jacobianT(self, x):
        x = jnp.asarray(x)
        if self.is_functional:
            # gradient of the fused scalar chain via autodiff — traces into
            # one XLA computation instead of composing wrapper operators.
            return jax.grad(self.apply)(x)
        if self.m1.is_functional or self.m2.is_functional:
            # mixed codomain-broadcast sum (functional + array-valued map):
            # a functional summand's jacobianT is a gradient *array*, which
            # cannot be added to the other operator node — derive the whole
            # J^T from the fused apply via autodiff instead.
            from pycsou_tpu.core.linop import JacobianTOperator

            return JacobianTOperator(self, x)
        return self.m1.jacobianT(x) + self.m2.jacobianT(x)


class DiffMapComp(MapComp, DifferentiableMap):
    """Chain rule node (reference map.py:596).

    L = L1*L2; beta = b1*b2*L2 in general, and b1*b2 when the outer map is a
    homothety (matching map.py:601-605 so auto step sizes agree exactly).
    jacobianT(x) = J2^T(x) o J1^T(f2(x)).
    """

    def __init__(self, m1: DifferentiableMap, m2: DifferentiableMap):
        from pycsou_tpu.ops.basic import HomothetyOperator

        MapComp.__init__(self, m1, m2)
        if isinstance(m1, HomothetyOperator):
            beta = m1.diff_lipschitz * m2.diff_lipschitz
        else:
            beta = m1.diff_lipschitz * m2.diff_lipschitz * m2.lipschitz
        self._diff_lipschitz = float(beta)

    def jacobianT(self, x):
        x = jnp.asarray(x)
        if self.is_functional:
            # gradient of the fused scalar chain via autodiff — traces into
            # one XLA computation instead of composing wrapper operators.
            return jax.grad(self.apply)(x)
        j_inner = self.m2.jacobianT(x)
        j_outer = self.m1.jacobianT(self.m2.apply(x))
        # When m1 is a functional its jacobianT is the gradient *array*; the
        # `*` below then evaluates J2^T on it (reference map.py:609 trick).
        return j_inner * j_outer


def _broadcast_codim(s1: Tuple[int, ...], s2: Tuple[int, ...]) -> Tuple[int, ...]:
    """Range broadcasting (reference util/misc.py:15-88): scalar functionals
    broadcast against any codomain; otherwise shapes must match."""
    if s1 == s2:
        return s1
    if s1 == ():
        return s2
    if s2 == ():
        return s1
    raise ValueError(f"codomains not broadcastable: {s1} vs {s2}")

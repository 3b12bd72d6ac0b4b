"""Base functionals: explicit linear functionals, indicators, nulls, Lp-norm
machinery, separable stacks.

Equivalent of the reference's pycsou/func/base.py:21-240.  The
joblib-parallel prox of ``ProxFuncHStack`` (base.py:80-89) becomes a traced
per-block prox that XLA fuses (and shards across devices via the parallel
layer); no process pools.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pycsou_tpu._module import static_field
from pycsou_tpu.core.functional import (
    DifferentiableFunctional,
    LinearFunctional,
    ProximableFunctional,
)

__all__ = [
    "ExplicitLinearFunctional",
    "IndicatorFunctional",
    "NullDifferentiableFunctional",
    "NullProximableFunctional",
    "LpNorm",
    "ProxFuncHStack",
    "DiffFuncHStack",
]

_INF = float("inf")


class ExplicitLinearFunctional(LinearFunctional):
    """``x -> <v, x>`` (reference func/base.py:124).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func.base import ExplicitLinearFunctional
        >>> f = ExplicitLinearFunctional(jnp.array([1.0, 2.0]))
        >>> float(f(jnp.array([3.0, 4.0])))
        11.0
        >>> f.adjoint(2.0).tolist()
        [2.0, 4.0]
    """

    vec: jax.Array = None

    def __init__(self, vec, dtype=None):
        vec = jnp.asarray(vec)
        dtype = np.dtype(dtype) if dtype is not None else np.dtype(vec.dtype)
        try:
            lip = float(np.linalg.norm(np.asarray(vec).ravel()))
        except Exception:
            lip = _INF
        super().__init__(vec.shape, lipschitz=lip, dtype=dtype)
        self.vec = vec

    def apply(self, x):
        return jnp.vdot(self.vec, x)

    def adjoint(self, alpha):
        return self.vec * jnp.asarray(alpha)

    def asvector(self):
        return self.vec


class IndicatorFunctional(ProximableFunctional):
    """Indicator of a set: 0 inside, +inf outside; prox = projection
    (reference func/base.py:140).  ``condition_fn``/``projection_fn`` are pure
    jittable functions."""

    condition_fn: Callable = static_field(default=None)
    projection_fn: Callable = static_field(default=None)

    # Example::
    #
    #     (see NonNegativeOrthant / Segment / L2Ball in func/penalty.py —
    #     all are IndicatorFunctional instances built from a condition and
    #     a projection)

    def __init__(self, dim_shape, condition_fn: Callable, projection_fn: Callable):
        super().__init__(dim_shape)
        self.condition_fn = condition_fn
        self.projection_fn = projection_fn

    def apply(self, x):
        inside = self.condition_fn(x)
        return jnp.where(inside, 0.0, jnp.inf)

    def prox(self, x, tau):
        del tau  # projections are scale-invariant
        return self.projection_fn(x)


class NullDifferentiableFunctional(DifferentiableFunctional):
    """Zero functional with zero gradient (reference func/base.py:171)."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape, lipschitz=0.0, diff_lipschitz=0.0)

    def apply(self, x):
        return jnp.asarray(0.0, dtype=jnp.result_type(x, jnp.float32))

    def jacobianT(self, x):
        return jnp.zeros(self.dim_shape, dtype=jnp.asarray(x).dtype)


class NullProximableFunctional(ProximableFunctional):
    """Zero functional with identity prox (reference func/base.py:192)."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape, lipschitz=0.0)

    def apply(self, x):
        return jnp.asarray(0.0, dtype=jnp.result_type(x, jnp.float32))

    def prox(self, x, tau):
        del tau
        return jnp.asarray(x)


class LpNorm(ProximableFunctional):
    """Base for Lp norms: prox via Moreau + projection onto the dual ball,
    ``prox(x, tau) = x - tau proj_{B_q}(x / tau)`` (reference func/base.py:215).
    Subclasses provide ``dual_ball_projection``.

    Example — the Moreau identity ``x = prox_f(x) + tau prox_{f*/tau}(x/tau)``
    holds for any subclass::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func.penalty import L1Norm
        >>> f = L1Norm((3,))
        >>> x, tau = jnp.array([1.0, -2.0, 0.5]), 0.7
        >>> lhs = f.prox(x, tau) + tau * f.fenchel_prox(x / tau, 1.0 / tau)
        >>> bool(jnp.allclose(lhs, x, atol=1e-6))
        True
    """

    def dual_ball_projection(self, x):
        """Projection onto the unit ball of the DUAL norm (drives
        ``prox`` via Moreau decomposition)."""
        raise NotImplementedError

    def prox(self, x, tau):
        x = jnp.asarray(x)
        return x - tau * self.dual_ball_projection(x / tau)


class ProxFuncHStack(ProximableFunctional):
    """Separable sum ``F(x1,...,xk) = sum_i f_i(x_i)`` over a partition of a
    flat vector: prox splits, proxes each block, concatenates
    (reference func/base.py:21-89).  Each block prox traces into the same XLA
    computation — the reference's joblib fan-out is replaced by compiler
    parallelism (and by mesh sharding in ``pycsou_tpu.parallel``).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func.base import ProxFuncHStack
        >>> from pycsou_tpu.func.penalty import L1Norm, NonNegativeOrthant
        >>> f = ProxFuncHStack([L1Norm((2,)), NonNegativeOrthant((2,))])
        >>> f.prox(jnp.array([2.0, -0.5, -1.0, 3.0]), tau=1.0).tolist()
        [1.0, -0.0, 0.0, 3.0]
    """

    funcs: Tuple[ProximableFunctional, ...] = None

    def __init__(self, funcs: Sequence[ProximableFunctional]):
        funcs = tuple(funcs)
        dim = sum(f.dim for f in funcs)
        super().__init__((dim,))
        self.funcs = funcs

    def _split(self, x):
        out, start = [], 0
        for f in self.funcs:
            out.append(x[start : start + f.dim].reshape(f.dim_shape))
            start += f.dim
        return out

    def apply(self, x):
        blocks = self._split(jnp.asarray(x))
        return sum(f.apply(b) for f, b in zip(self.funcs, blocks))

    def prox(self, x, tau):
        blocks = self._split(jnp.asarray(x))
        return jnp.concatenate([f.prox(b, tau).reshape(-1) for f, b in zip(self.funcs, blocks)])


class DiffFuncHStack(DifferentiableFunctional):
    """Separable sum of differentiable functionals; gradient concatenates
    per-block gradients (reference func/base.py:92-121).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func.base import DiffFuncHStack
        >>> from pycsou_tpu.func.penalty import SquaredL2Norm
        >>> f = DiffFuncHStack([SquaredL2Norm((2,)), SquaredL2Norm((1,))])
        >>> f.gradient(jnp.array([1.0, 2.0, 3.0])).tolist()
        [2.0, 4.0, 6.0]
    """

    funcs: Tuple[DifferentiableFunctional, ...] = None

    def __init__(self, funcs: Sequence[DifferentiableFunctional]):
        funcs = tuple(funcs)
        dim = sum(f.dim for f in funcs)
        lip = sum(f.lipschitz for f in funcs)
        beta = max(f.diff_lipschitz for f in funcs)
        super().__init__((dim,), lipschitz=lip, diff_lipschitz=beta)
        self.funcs = funcs

    def _split(self, x):
        out, start = [], 0
        for f in self.funcs:
            out.append(x[start : start + f.dim].reshape(f.dim_shape))
            start += f.dim
        return out

    def apply(self, x):
        blocks = self._split(jnp.asarray(x))
        return sum(f.apply(b) for f, b in zip(self.funcs, blocks))

    def jacobianT(self, x):
        blocks = self._split(jnp.asarray(x))
        return jnp.concatenate([f.gradient(b).reshape(-1) for f, b in zip(self.funcs, blocks)])

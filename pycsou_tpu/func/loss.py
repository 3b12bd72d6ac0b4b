"""Loss functionals: norms/balls precomposed with a data shift, plus KL
divergence.

Equivalent of the reference's pycsou/func/loss.py (689 LoC).
Losses are built by the shift rule ``phi(x - y)`` — the factories return
prox/grad-preserving shifted functionals (reference loss.py:20-120).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from pycsou_tpu.core.functional import (
    DifferentiableFunctional,
    ProximableFunctional,
    ProxFuncPreComp,
)
from pycsou_tpu.func.base import IndicatorFunctional
from pycsou_tpu.func.penalty import (
    L1Ball,
    L1Norm,
    L2Ball,
    L2Norm,
    LInftyBall,
    LInftyNorm,
    SquaredL1Norm,
    SquaredL2Norm,
)

__all__ = [
    "ProximableLoss",
    "DifferentiableLoss",
    "L2Loss",
    "SquaredL2Loss",
    "L2BallLoss",
    "L1Loss",
    "SquaredL1Loss",
    "L1BallLoss",
    "LInftyLoss",
    "LInftyBallLoss",
    "ConsistencyLoss",
    "KLDivergence",
    "LeastSquaresLoss",
]


def ProximableLoss(func: ProximableFunctional, data) -> ProximableFunctional:
    """``phi(x - y)`` keeping the prox (reference loss.py:20-69).

    Example — the prox shifts with the data::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func.loss import ProximableLoss
        >>> from pycsou_tpu.func.penalty import L1Norm
        >>> y = jnp.array([1.0, -1.0])
        >>> f = ProximableLoss(L1Norm((2,)), data=y)
        >>> float(f(jnp.array([3.0, -1.0])))      # ||x - y||_1
        2.0
        >>> f.prox(jnp.array([3.0, -1.0]), tau=1.0).tolist()
        [2.0, -1.0]
    """
    return ProxFuncPreComp(func, scale=1.0, shift=-jnp.asarray(data))


def DifferentiableLoss(func: DifferentiableFunctional, data):
    """``phi(x - y)`` keeping gradient and Lipschitz constants
    (reference loss.py:72-120).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func.loss import DifferentiableLoss
        >>> from pycsou_tpu.func.penalty import SquaredL2Norm
        >>> f = DifferentiableLoss(SquaredL2Norm((2,)), data=jnp.ones(2))
        >>> f.gradient(jnp.array([2.0, 1.0])).tolist()    # 2 (x - y)
        [2.0, 0.0]
        >>> f.diff_lipschitz
        2.0
    """
    return func.shifter(shift=-jnp.asarray(data))


def L2Loss(dim_shape, data) -> ProximableFunctional:
    """``||y - x||_2`` (reference loss.py:123)."""
    return ProximableLoss(L2Norm(dim_shape), data=data)


def SquaredL2Loss(dim_shape, data):
    """``||y - x||_2^2`` — the workhorse differentiable data fidelity
    (reference loss.py:165; beta = 2).

    Example — composing with a linear operator builds the Gram-routed
    :class:`LeastSquaresLoss`::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func.loss import SquaredL2Loss
        >>> from pycsou_tpu.ops.basic import DenseOperator
        >>> y = jnp.array([1.0, 0.0])
        >>> F = SquaredL2Loss((2,), data=y) * DenseOperator(2 * jnp.eye(2))
        >>> type(F).__name__
        'LeastSquaresLoss'
        >>> F.gradient(jnp.array([1.0, 0.0])).tolist()   # 2 A^H (A x - y)
        [4.0, 0.0]
    """
    return DifferentiableLoss(SquaredL2Norm(dim_shape), data=data)


def L2BallLoss(dim_shape, data, radius: float = 1.0) -> ProximableFunctional:
    """Indicator of ``||y - x||_2 <= radius`` (reference loss.py:222)."""
    return ProximableLoss(L2Ball(dim_shape, radius=radius), data=data)


def L1Loss(dim_shape, data) -> ProximableFunctional:
    """``||y - x||_1`` — robust data fidelity (reference loss.py:280)."""
    return ProximableLoss(L1Norm(dim_shape), data=data)


def SquaredL1Loss(dim_shape, data, prox_computation: str = "sort") -> ProximableFunctional:
    """``||y - x||_1^2`` (reference loss.py:329)."""
    return ProximableLoss(SquaredL1Norm(dim_shape, prox_computation=prox_computation), data=data)


def L1BallLoss(dim_shape, data, radius: float = 1.0) -> ProximableFunctional:
    """Indicator of ``||y - x||_1 <= radius`` (reference loss.py:371)."""
    return ProximableLoss(L1Ball(dim_shape, radius=radius), data=data)


def LInftyLoss(dim_shape, data) -> ProximableFunctional:
    """``||y - x||_inf`` (reference loss.py:429)."""
    return ProximableLoss(LInftyNorm(dim_shape), data=data)


def LInftyBallLoss(dim_shape, data, radius: float = 1.0) -> ProximableFunctional:
    """Indicator of ``||y - x||_inf <= radius`` (reference loss.py:478)."""
    return ProximableLoss(LInftyBall(dim_shape, radius=radius), data=data)


def ConsistencyLoss(dim_shape, data) -> IndicatorFunctional:
    """Equality indicator ``x == y`` with prox ``y`` (reference loss.py:536).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func.loss import ConsistencyLoss
        >>> f = ConsistencyLoss((2,), data=jnp.array([1.0, 2.0]))
        >>> f.prox(jnp.array([5.0, -3.0]), tau=1.0).tolist()
        [1.0, 2.0]
    """
    data = jnp.asarray(data)
    return IndicatorFunctional(
        dim_shape,
        condition_fn=lambda x: jnp.all(x == data),
        projection_fn=lambda x: jnp.broadcast_to(data, jnp.asarray(x).shape).astype(jnp.asarray(x).dtype),
    )


class LeastSquaresLoss(DifferentiableFunctional):
    """``F(x) = ||A x - y||^2`` with the gradient computed through the
    operator's (possibly fused) Gram: ``grad = 2 (A^H A x - A^H y)`` with
    ``A^H y`` precomputed.

    For FFT-convolution operators the fused Gram needs ONE large FFT
    roundtrip per gradient instead of the forward+adjoint pair the generic
    chain rule costs (see ops/_gram.py) — built automatically when composing
    ``SquaredL2Loss * A`` (core/arith.py).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func.loss import LeastSquaresLoss
        >>> from pycsou_tpu.ops.basic import DiagonalOperator
        >>> A = DiagonalOperator(jnp.array([1.0, 2.0]))
        >>> F = LeastSquaresLoss(A, data=jnp.array([1.0, 2.0]))
        >>> x = jnp.array([1.0, 2.0])
        >>> float(F(x))                          # ||A x - y||^2
        4.0
        >>> F.gradient(x).tolist()               # 2 A^H (A x - y)
        [0.0, 8.0]
    """

    op: "LinearOperator" = None
    data: jax.Array = None
    _gram: "LinearOperator" = None
    _atb: jax.Array = None

    def __init__(self, op, data):
        from pycsou_tpu.core.functional import DifferentiableFunctional as _DF

        data = jnp.asarray(data)
        _DF.__init__(self, op.dim_shape, lipschitz=float("inf"), diff_lipschitz=2.0 * op.lipschitz**2)
        self.op = op
        self.data = data
        self._gram = op.gram
        self._atb = op.adjoint(data)

    def apply(self, x):
        r = self.op.apply(x) - self.data
        return jnp.real(jnp.vdot(r, r))

    def jacobianT(self, x):
        return 2.0 * (self._gram.apply(jnp.asarray(x)) - self._atb)

    @property
    def diff_lipschitz(self):
        return 2.0 * self.op.lipschitz**2


class KLDivergence(ProximableFunctional):
    """Generalised Kullback-Leibler divergence ``D(y||x)`` — the Poisson
    noise data fidelity (reference loss.py:590).

    ``F(x) = sum y log(y/x) + x - y`` on x >= 0, with closed-form prox
    ``(x - tau + sqrt((x - tau)^2 + 4 tau y)) / 2`` (reference loss.py:666-682).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func.loss import KLDivergence
        >>> y = jnp.array([1.0, 2.0])
        >>> f = KLDivergence((2,), data=y)
        >>> float(f(y))                          # D(y||y) = 0
        0.0
        >>> f.prox(jnp.array([1.0, 2.0]), tau=0.0).tolist()   # tau -> 0: identity
        [1.0, 2.0]
    """

    data: jax.Array = None

    def __init__(self, dim_shape, data):
        super().__init__(dim_shape)
        self.data = jnp.asarray(data)

    def apply(self, x):
        x = jnp.asarray(x)
        y = self.data
        # convention: y log(y/x) = 0 where y == 0; +inf if any x < 0
        ratio = jnp.where((y > 0) & (x > 0), y / jnp.where(x > 0, x, 1.0), 1.0)
        terms = jnp.where(y > 0, y * jnp.log(ratio), 0.0) + x - y
        val = jnp.sum(terms)
        return jnp.where(jnp.any(x < 0), jnp.inf, val)

    def prox(self, x, tau):
        x = jnp.asarray(x)
        return 0.5 * (x - tau + jnp.sqrt((x - tau) ** 2 + 4 * tau * self.data))

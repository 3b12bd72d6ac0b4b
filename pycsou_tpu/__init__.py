"""pycsou_tpu — convex inverse-problem solver framework on JAX/XLA.

A JAX framework with the capabilities of the reference Pycsou library
(matrix-free operator algebra, proximable/differentiable functional
calculus, proximal-splitting solvers), re-designed for accelerators: every
matvec/prox/solver-iteration is a jitted XLA computation; stencils and hot
loops fuse into few XLA passes; multi-device scaling uses
``jax.sharding.Mesh`` + collectives.
"""

__version__ = "0.1.0"

from pycsou_tpu.core.functional import (
    DifferentiableFunctional,
    Functional,
    LinearFunctional,
    ProximableFunctional,
)
from pycsou_tpu.core.linop import LinearOperator
from pycsou_tpu.core.map import DifferentiableMap, Map

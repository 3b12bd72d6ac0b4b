"""Structural operators: dense/sparse/diagonal/identity/null/homothety/
polynomial.

Equivalents of the reference's pycsou/linop/base.py:24-712.
Dense matvecs are matmuls with ``preferred_element_type`` pinned to f32
accumulation; sparse operators use JAX BCOO instead of scipy.sparse; the
Dask-array branch of the reference's ``ExplicitLinearOperator``
(base.py:87-99) is replaced by mesh-sharded dense operators in
``pycsou_tpu.parallel``.
"""
from __future__ import annotations

from numbers import Number

import jax
import jax.numpy as jnp
import numpy as np

from pycsou_tpu._module import static_field
from pycsou_tpu.core.linop import LinearOperator, SelfAdjointMixin
from pycsou_tpu.utils.shapes import as_shape, size_of

__all__ = [
    "DenseOperator",
    "ExplicitLinearOperator",
    "SparseOperator",
    "DiagonalOperator",
    "IdentityOperator",
    "NullOperator",
    "HomothetyOperator",
    "PolynomialOperator",
]

_INF = float("inf")


class DenseOperator(LinearOperator):
    """Matrix-backed operator (reference ``DenseLinearOperator``,
    linop/base.py:102).  ``mat`` has shape ``(codim_size, dim_size)``; inputs
    are flattened, outputs reshaped, and the contraction is a matmul with
    f32 accumulation.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import DenseOperator
        >>> A = DenseOperator(jnp.array([[1.0, 2.0], [3.0, 4.0]]))
        >>> A(jnp.array([1.0, 1.0])).tolist()
        [3.0, 7.0]
        >>> A.adjoint(jnp.array([1.0, 0.0])).tolist()   # A^T e_0 = row 0 of A
        [1.0, 2.0]
    """

    mat: jax.Array = None

    def __init__(self, mat, dim_shape=None, codim_shape=None, dtype=None):
        mat = jnp.asarray(mat)
        if mat.ndim != 2:
            raise ValueError("mat must be 2-D; use dim_shape/codim_shape for nd domains")
        dim_shape = as_shape(dim_shape) if dim_shape is not None else (mat.shape[1],)
        codim_shape = as_shape(codim_shape) if codim_shape is not None else (mat.shape[0],)
        if size_of(dim_shape) != mat.shape[1] or size_of(codim_shape) != mat.shape[0]:
            raise ValueError("dim/codim shapes inconsistent with mat")
        dtype = np.dtype(dtype) if dtype is not None else np.dtype(mat.dtype)
        super().__init__(dim_shape, codim_shape, dtype=dtype)
        self.mat = mat.astype(dtype)

    @property
    def _acc_dtype(self):
        return jnp.complex64 if jnp.issubdtype(self.dtype, jnp.complexfloating) else jnp.float32

    def apply(self, x):
        y = jnp.matmul(self.mat, x.reshape(-1), preferred_element_type=self._acc_dtype)
        return y.reshape(self.codim_shape).astype(self.dtype)

    def adjoint(self, y):
        x = jnp.matmul(
            jnp.conj(self.mat).T, jnp.asarray(y).reshape(-1), preferred_element_type=self._acc_dtype
        )
        return x.reshape(self.dim_shape).astype(self.dtype)

    def todense(self):
        return self

    def opnorm(self, exact: bool = True, **kwargs) -> float:
        if exact and self.dim * self.codim <= 4_000_000:
            return float(jnp.linalg.norm(self.mat, ord=2))
        return super().opnorm(**kwargs)


#: Reference-compatible alias (linop/base.py:57)
ExplicitLinearOperator = DenseOperator


class SparseOperator(LinearOperator):
    """Sparse-matrix operator backed by JAX BCOO (replaces the reference's
    scipy.sparse branch, linop/base.py:121).

    Example::

        >>> import jax.numpy as jnp
        >>> from jax.experimental import sparse as jsparse
        >>> from pycsou_tpu.ops.basic import SparseOperator
        >>> M = jsparse.BCOO.fromdense(jnp.array([[2.0, 0.0], [0.0, 0.0]]))
        >>> A = SparseOperator(M)
        >>> A(jnp.array([1.0, 5.0])).tolist()
        [2.0, 0.0]
    """

    mat: "jax.experimental.sparse.BCOO" = None

    def __init__(self, mat, dim_shape=None, codim_shape=None):
        from jax.experimental import sparse as jsparse

        if not isinstance(mat, jsparse.BCOO):
            import scipy.sparse as sp

            if sp.issparse(mat):
                mat = jsparse.BCOO.from_scipy_sparse(mat)
            else:
                mat = jsparse.BCOO.fromdense(jnp.asarray(mat))
        dim_shape = as_shape(dim_shape) if dim_shape is not None else (mat.shape[1],)
        codim_shape = as_shape(codim_shape) if codim_shape is not None else (mat.shape[0],)
        super().__init__(dim_shape, codim_shape, dtype=np.dtype(mat.dtype))
        self.mat = mat

    def apply(self, x):
        return (self.mat @ x.reshape(-1)).reshape(self.codim_shape)

    def adjoint(self, y):
        return (self.mat.T @ jnp.conj(jnp.asarray(y).reshape(-1))).conj().reshape(self.dim_shape)


class DiagonalOperator(SelfAdjointMixin, LinearOperator):
    """Elementwise multiplication by ``diag`` (reference linop/base.py:551).

    Exact Lipschitz constant ``max|diag|`` is set for free (the reference
    uses ``max(diag)`` — a quirk, see SURVEY §7; we use the correct bound).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import DiagonalOperator
        >>> D = DiagonalOperator(jnp.array([1.0, -2.0]))
        >>> D(jnp.array([3.0, 3.0])).tolist()
        [3.0, -6.0]
        >>> D.lipschitz          # max |diag|
        2.0
    """

    diag: jax.Array = None

    def __init__(self, diag, dtype=None):
        diag = jnp.asarray(diag)
        dtype = np.dtype(dtype) if dtype is not None else np.dtype(diag.dtype)
        try:
            lip = float(np.max(np.abs(np.asarray(diag))))
        except Exception:
            lip = _INF
        super().__init__(diag.shape, diag.shape, lipschitz=lip, dtype=dtype)
        self.diag = diag

    def apply(self, x):
        return self.diag * x

    def adjoint(self, y):
        return jnp.conj(self.diag) * y


class IdentityOperator(SelfAdjointMixin, LinearOperator):
    """Identity (reference linop/base.py:582).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import IdentityOperator
        >>> IdentityOperator((2,))(jnp.array([1.0, 2.0])).tolist()
        [1.0, 2.0]
    """

    def __init__(self, dim_shape, dtype=np.float32):
        super().__init__(dim_shape, dim_shape, lipschitz=1.0, dtype=dtype)

    def apply(self, x):
        return x

    def opnorm(self, **kwargs):
        return 1.0

    def pinv(self, y, **kwargs):
        return jnp.asarray(y)


class NullOperator(LinearOperator):
    """Maps everything to zero (reference linop/base.py:601).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import NullOperator
        >>> NullOperator((2,), (3,))(jnp.array([1.0, 2.0])).tolist()
        [0.0, 0.0, 0.0]
    """

    def __init__(self, dim_shape, codim_shape=None, dtype=np.float32):
        codim_shape = codim_shape if codim_shape is not None else dim_shape
        super().__init__(dim_shape, codim_shape, lipschitz=0.0, dtype=dtype)

    def apply(self, x):
        return jnp.zeros(self.codim_shape, dtype=x.dtype)

    def adjoint(self, y):
        return jnp.zeros(self.dim_shape, dtype=jnp.asarray(y).dtype)

    def opnorm(self, **kwargs):
        return 0.0


class HomothetyOperator(SelfAdjointMixin, LinearOperator):
    """Scalar scaling ``x -> c x`` (reference ``HomothetyMap``,
    linop/base.py:625); the node injected by scalar arithmetic.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import HomothetyOperator, IdentityOperator
        >>> (3.0 * IdentityOperator((2,)))(jnp.array([1.0, 2.0])).tolist()
        [3.0, 6.0]
    """

    constant: float = static_field(default=1.0)

    def __init__(self, constant, dim_shape, dtype=np.float32):
        if not isinstance(constant, Number):
            raise TypeError("HomothetyOperator constant must be a scalar")
        super().__init__(dim_shape, dim_shape, lipschitz=abs(constant), dtype=dtype)
        self.constant = constant

    def apply(self, x):
        return self.constant * x

    def adjoint(self, y):
        return np.conj(self.constant) * jnp.asarray(y)

    def opnorm(self, **kwargs):
        return abs(self.constant)

    def pinv(self, y, **kwargs):
        return jnp.asarray(y) / self.constant


class PolynomialOperator(LinearOperator):
    """``P(L) = sum_k a_k L^k`` of a square operator, evaluated by Horner's
    scheme in one traced computation (reference linop/base.py:636-712).

    Example — ``P(D) = 1 + 2 D^2`` on a diagonal::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import DiagonalOperator, PolynomialOperator
        >>> D = DiagonalOperator(jnp.array([1.0, 2.0]))
        >>> P = PolynomialOperator(D, coeffs=[1.0, 0.0, 2.0])
        >>> P(jnp.array([1.0, 1.0])).tolist()
        [3.0, 9.0]
    """

    base: LinearOperator = None
    coeffs: jax.Array = None

    def __init__(self, base: LinearOperator, coeffs):
        if base.dim_shape != base.codim_shape:
            raise ValueError("PolynomialOperator requires a square operator")
        coeffs = jnp.asarray(coeffs)
        lip = _INF
        if base.lipschitz < _INF:
            try:
                c = np.abs(np.asarray(coeffs))
                lip = float(sum(ck * base.lipschitz**k for k, ck in enumerate(c)))
            except Exception:
                lip = _INF
        super().__init__(base.dim_shape, base.codim_shape, lipschitz=lip, dtype=base.dtype)
        self.base = base
        self.coeffs = coeffs

    def apply(self, x):
        n = self.coeffs.shape[0]
        y = self.coeffs[n - 1] * x
        for k in range(n - 2, -1, -1):
            y = self.base.apply(y) + self.coeffs[k] * x
        return y

    def adjoint(self, y):
        n = self.coeffs.shape[0]
        c = jnp.conj(self.coeffs)
        x = c[n - 1] * jnp.asarray(y)
        for k in range(n - 2, -1, -1):
            x = self.base.adjoint(x) + c[k] * y
        return x

"""Kronecker-structured operators: matrix-free Kronecker product/sum and
Khatri-Rao product.

Equivalent of the reference's pycsou/linop/base.py:715-989.
The vec-trick contractions ``(A kron B) vec(X) = vec(A X B^T)`` are expressed
with ``jax.vmap`` over the factor operators, so the factors may themselves be
matrix-free operators (the reference requires explicit pylops wrappers) and
the contraction maps onto batched matmuls for dense factors.

Convention: row-major (C-order) vec, matching ``np.kron``:
``(A kron B) x == (A @ X @ B.T).ravel()`` for ``X = x.reshape(nA, nB)``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pycsou_tpu.core.linop import LinearOperator
from pycsou_tpu.ops.basic import DenseOperator

__all__ = ["KroneckerProduct", "KroneckerSum", "KhatriRaoProduct"]


def _as_op(x) -> LinearOperator:
    if isinstance(x, LinearOperator):
        return x
    return DenseOperator(jnp.asarray(x))


def _apply_axis0(op: LinearOperator, M):
    """Apply a 1-D->1-D operator to every column of M (vmap over axis 1)."""
    return jax.vmap(lambda c: op.apply(c), in_axes=1, out_axes=1)(M)


def _apply_axis1(op: LinearOperator, M):
    """Apply a 1-D->1-D operator to every row of M (vmap over axis 0)."""
    return jax.vmap(lambda r: op.apply(r), in_axes=0, out_axes=0)(M)


def _adjoint_axis0(op: LinearOperator, M):
    return jax.vmap(lambda c: op.adjoint(c), in_axes=1, out_axes=1)(M)


def _adjoint_axis1(op: LinearOperator, M):
    return jax.vmap(lambda r: op.adjoint(r), in_axes=0, out_axes=0)(M)


class KroneckerProduct(LinearOperator):
    """``A kron B`` matrix-free via the vec trick (reference linop/
    base.py:715-803): forward ``vec(A X B^T)``, adjoint ``vec(A^H Y conj(B))``,
    ``pinv = pinv kron pinv``, ``L = L_A L_B``.

    Example — matches the dense Kronecker matrix::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import DenseOperator
        >>> from pycsou_tpu.ops.kron import KroneckerProduct
        >>> A = jnp.array([[1.0, 2.0], [0.0, 1.0]])
        >>> B = jnp.array([[0.0, 1.0], [1.0, 0.0]])
        >>> K = KroneckerProduct(DenseOperator(A), DenseOperator(B))
        >>> x = jnp.arange(4.0)
        >>> dense = jnp.kron(A, B) @ x
        >>> bool(jnp.allclose(K(x).reshape(-1), dense))
        True
    """

    A: LinearOperator = None
    B: LinearOperator = None

    def __init__(self, A, B):
        A, B = _as_op(A), _as_op(B)
        if len(A.dim_shape) != 1 or len(B.dim_shape) != 1:
            raise ValueError("Kronecker factors must be 1-D operators")
        dim = (A.dim, B.dim)
        codim = (A.codim, B.codim)
        dtype = np.result_type(A.dtype, B.dtype)
        super().__init__(dim, codim, lipschitz=A.lipschitz * B.lipschitz, dtype=dtype)
        self.A, self.B = A, B

    def apply(self, x):
        X = x.reshape(self.A.dim, self.B.dim)
        Y = _apply_axis1(self.B, X)  # X B^T : apply B to rows
        Y = _apply_axis0(self.A, Y)  # A (.) : apply A to columns
        return Y

    def adjoint(self, y):
        Y = jnp.asarray(y).reshape(self.A.codim, self.B.codim)
        X = _adjoint_axis1(self.B, Y)
        X = _adjoint_axis0(self.A, X)
        return X

    def pinv(self, y, **kwargs):
        """(A kron B)^+ = A^+ kron B^+ (reference base.py:801-803)."""
        Y = jnp.asarray(y).reshape(self.A.codim, self.B.codim)
        X = jax.vmap(lambda r: self.B.pinv(r, **kwargs), in_axes=0, out_axes=0)(Y)
        X = jax.vmap(lambda c: self.A.pinv(c, **kwargs), in_axes=1, out_axes=1)(X)
        return X


class KroneckerSum(LinearOperator):
    """``A kronsum B = A kron I + I kron B`` matrix-free
    (reference linop/base.py:806-886); requires square factors.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import DiagonalOperator
        >>> from pycsou_tpu.ops.kron import KroneckerSum
        >>> A = DiagonalOperator(jnp.array([1.0, 2.0]))
        >>> B = DiagonalOperator(jnp.array([10.0, 20.0]))
        >>> KroneckerSum(A, B)(jnp.ones(4)).reshape(-1).tolist()
        [11.0, 21.0, 12.0, 22.0]
    """

    A: LinearOperator = None
    B: LinearOperator = None

    def __init__(self, A, B):
        A, B = _as_op(A), _as_op(B)
        if A.dim != A.codim or B.dim != B.codim:
            raise ValueError("Kronecker sum requires square factors")
        dim = (A.dim, B.dim)
        dtype = np.result_type(A.dtype, B.dtype)
        super().__init__(dim, dim, lipschitz=A.lipschitz + B.lipschitz, dtype=dtype)
        self.A, self.B = A, B

    def apply(self, x):
        X = x.reshape(self.A.dim, self.B.dim)
        return _apply_axis0(self.A, X) + _apply_axis1(self.B, X)

    def adjoint(self, y):
        Y = jnp.asarray(y).reshape(self.A.dim, self.B.dim)
        return _adjoint_axis0(self.A, Y) + _adjoint_axis1(self.B, Y)


class KhatriRaoProduct(LinearOperator):
    """Column-wise Kronecker product (reference linop/base.py:889-989):
    ``(A o B) x = vec(A diag(x) B^T)`` — computed as one fused batched
    contraction on device (the reference's dense/sparse/matrix-free 3-way
    dispatch collapses to einsum).

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.kron import KhatriRaoProduct
        >>> A = jnp.array([[1.0, 2.0]])           # (1, 2)
        >>> B = jnp.array([[1.0, 0.0], [0.0, 1.0]])
        >>> KhatriRaoProduct(A, B)(jnp.array([1.0, 1.0])).reshape(-1).tolist()
        [1.0, 2.0]
    """

    A: jax.Array = None
    B: jax.Array = None

    def __init__(self, A, B):
        A = jnp.asarray(A.mat if isinstance(A, DenseOperator) else A)
        B = jnp.asarray(B.mat if isinstance(B, DenseOperator) else B)
        if A.shape[1] != B.shape[1]:
            raise ValueError("factors must share the column count")
        dtype = np.result_type(A.dtype, B.dtype)
        lip = float("inf")
        if A.shape[0] * B.shape[0] * A.shape[1] <= 4_000_000:
            try:
                full = np.einsum("ij,kj->ikj", np.asarray(A), np.asarray(B)).reshape(-1, A.shape[1])
                lip = float(np.linalg.norm(full, 2))
            except Exception:
                pass
        super().__init__((A.shape[1],), (A.shape[0], B.shape[0]), lipschitz=lip, dtype=dtype)
        self.A, self.B = A, B

    def apply(self, x):
        # y[i, k] = sum_j A[i, j] B[k, j] x[j]
        return jnp.einsum("ij,kj,j->ik", self.A, self.B, x, preferred_element_type=jnp.float32).astype(self.dtype)

    def adjoint(self, y):
        Y = jnp.asarray(y)
        return jnp.einsum("ij,kj,ik->j", jnp.conj(self.A), jnp.conj(self.B), Y, preferred_element_type=jnp.float32).astype(self.dtype)

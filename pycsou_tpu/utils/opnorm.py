"""On-device spectral estimation: power iteration and Lanczos.

Replacement for the reference's host-side ARPACK calls
(/root/reference/pycsou/core/linop.py:178-321).  The hot loop — repeated
matvec/rmatvec — runs entirely inside a jitted ``lax.while_loop`` /
``lax.fori_loop`` on device; only the tiny (m x m) tridiagonal eigenproblem is
solved on host.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["power_iteration", "lanczos_eigs", "arnoldi_eigs", "smallest_eig_psd"]


def _norm(x):
    return jnp.sqrt(jnp.real(jnp.vdot(x, x)))


def _rand_like(key, shape, dtype):
    dtype = jnp.dtype(dtype)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        real_dt = jnp.finfo(dtype).dtype.name.replace("complex", "float")
        k1, k2 = jax.random.split(key)
        re = jax.random.normal(k1, shape, dtype=jnp.float32)
        im = jax.random.normal(k2, shape, dtype=jnp.float32)
        return (re + 1j * im).astype(dtype)
    return jax.random.normal(key, shape, dtype=dtype)


@jax.jit
def _power_iter(op, x0, maxiter, tol):
    """sigma_max via power iteration on A^H A. Entirely on device."""

    def gram(v):
        return op.adjoint(op.apply(v))

    x0 = x0 / jnp.maximum(_norm(x0), jnp.finfo(x0.dtype).tiny)

    def cond(carry):
        i, _, s, ds = carry
        return jnp.logical_and(i < maxiter, ds > tol * jnp.maximum(s, 1e-30))

    def body(carry):
        i, x, s_old, _ = carry
        y = gram(x)
        s = _norm(y)  # -> sigma_max^2
        x = y / jnp.maximum(s, jnp.finfo(x0.dtype).tiny)
        return (i + 1, x, s, jnp.abs(s - s_old))

    y0 = gram(x0)
    s0 = _norm(y0)
    x1 = y0 / jnp.maximum(s0, jnp.finfo(x0.dtype).tiny)
    _, _, s, _ = jax.lax.while_loop(cond, body, (jnp.asarray(1), x1, s0, jnp.asarray(jnp.inf, s0.dtype)))
    return jnp.sqrt(s)


def power_iteration(op, maxiter: int = 128, tol: float = 1e-6, key: int = 0):
    """Estimate ``||A||_2`` (largest singular value) of a LinearOperator.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.basic import DiagonalOperator
        >>> from pycsou_tpu.utils.opnorm import power_iteration
        >>> est = power_iteration(DiagonalOperator(jnp.array([1.0, -3.0, 2.0])))
        >>> round(float(est), 3)
        3.0
    """
    k = jax.random.PRNGKey(key)
    x0 = _rand_like(k, op.dim_shape, op.dtype)
    return _power_iter(op, x0, jnp.asarray(maxiter), jnp.asarray(tol, jnp.float32))


@partial(jax.jit, static_argnums=(2,))
def _lanczos(op, v0, m: int):
    """m-step Lanczos with full reorthogonalisation for a self-adjoint op.

    Returns (alphas[m], betas[m]) of the tridiagonal T and runs fully on
    device; the caller diagonalises T on host (it is m x m, m ~ tens).
    """
    shape = v0.shape
    dtype = v0.dtype
    v0 = v0 / jnp.maximum(_norm(v0), jnp.finfo(dtype).tiny)

    V = jnp.zeros((m,) + shape, dtype=dtype).at[0].set(v0)
    alphas = jnp.zeros((m,), dtype=jnp.float32)
    betas = jnp.zeros((m,), dtype=jnp.float32)

    def body(j, carry):
        V, alphas, betas = carry
        vj = V[j]
        w = op.apply(vj)
        alpha = jnp.real(jnp.vdot(vj, w))
        w = w - alpha.astype(dtype) * vj
        # full reorthogonalisation against all previous vectors (mask j+1..m)
        coeffs = jnp.einsum("k...,...->k", jnp.conj(V), w)
        mask = (jnp.arange(m) <= j).astype(coeffs.dtype)
        w = w - jnp.einsum("k,k...->...", coeffs * mask, V)
        beta = _norm(w)
        v_next = w / jnp.maximum(beta, jnp.finfo(dtype).tiny)
        V = jax.lax.cond(
            j + 1 < m, lambda V: V.at[j + 1].set(v_next), lambda V: V, V
        )
        alphas = alphas.at[j].set(alpha.astype(jnp.float32))
        betas = betas.at[j].set(beta.astype(jnp.float32))
        return (V, alphas, betas)

    V, alphas, betas = jax.lax.fori_loop(0, m, body, (V, alphas, betas))
    return alphas, betas


@partial(jax.jit, static_argnums=(2,))
def _arnoldi(op, v0, m: int):
    """m-step Arnoldi for a (generally non-symmetric) endomorphic operator.

    The Hessenberg recurrence with full (classical, twice-applied)
    Gram-Schmidt runs entirely on device inside a ``fori_loop``; only the
    small (m x m) upper-Hessenberg eigenproblem goes to the host.  This is
    the non-symmetric sibling of :func:`_lanczos` and the on-device
    replacement for the reference's ARPACK ``eigs`` on non-symmetric
    operators (/root/reference/pycsou/core/linop.py:178-227).
    """
    shape = v0.shape
    dtype = v0.dtype
    v0 = v0 / jnp.maximum(_norm(v0), jnp.finfo(dtype).tiny)

    V = jnp.zeros((m + 1,) + shape, dtype=dtype).at[0].set(v0)
    Hm = jnp.zeros((m + 1, m), dtype=dtype)

    def body(j, carry):
        V, Hm = carry
        w = op.apply(V[j])
        mask = (jnp.arange(m + 1) <= j).astype(dtype)
        # classical Gram-Schmidt applied twice ("CGS2"): as stable as
        # modified GS in practice and batches into two einsum pairs
        c1 = jnp.einsum("k...,...->k", jnp.conj(V), w) * mask
        w = w - jnp.einsum("k,k...->...", c1, V)
        c2 = jnp.einsum("k...,...->k", jnp.conj(V), w) * mask
        w = w - jnp.einsum("k,k...->...", c2, V)
        beta = _norm(w).astype(dtype)
        v_next = w / jnp.maximum(jnp.abs(beta), jnp.finfo(jnp.float32).tiny)
        V = V.at[j + 1].set(v_next)
        col = c1 + c2 + beta * (jnp.arange(m + 1) == j + 1).astype(dtype)
        Hm = Hm.at[:, j].set(col)
        return (V, Hm)

    V, Hm = jax.lax.fori_loop(0, m, body, (V, Hm))
    return Hm


def arnoldi_eigs(op, k: int = 1, which: str = "LM", maxiter: Optional[int] = None, key: int = 0):
    """Extremal eigenvalues of a general (non-symmetric) endomorphic operator:
    on-device Arnoldi + host eigendecomposition of the small Hessenberg
    matrix.  Returns a complex array (non-symmetric real operators have
    complex spectra).  When ``m == dim`` the Krylov space is complete and the
    Ritz values are the exact eigenvalues (up to f32)."""
    n = op.dim
    m = int(min(n, maxiter if maxiter is not None else max(3 * k + 16, 32)))
    kk = jax.random.PRNGKey(key)
    v0 = _rand_like(kk, op.dim_shape, op.dtype)
    Hm = np.asarray(_arnoldi(op, v0, m), dtype=np.complex128 if jnp.issubdtype(op.dtype, jnp.complexfloating) else np.float64)
    evals = np.linalg.eigvals(Hm[:m, :m])
    if which == "LM":
        order = np.argsort(-np.abs(evals))
    elif which == "SM":
        order = np.argsort(np.abs(evals))
    elif which == "LR":
        order = np.argsort(-evals.real)
    elif which == "SR":
        order = np.argsort(evals.real)
    else:
        raise ValueError(f"unknown which={which!r}")
    return jnp.asarray(evals[order[:k]].astype(np.complex64))


from pycsou_tpu._module import Module, static_field


class _SpectralWrapOp(Module):
    """Duck-typed self-adjoint wrapper base for the spectral helpers below
    (a pytree so the jitted Lanczos can take it as an argument)."""

    base: object = None
    c: float = static_field(default=0.0)
    damp: float = static_field(default=0.0)
    tol: float = static_field(default=1e-8)
    maxiter: int = static_field(default=500)

    def __init__(self, base, c=0.0, damp=0.0, tol=1e-8, maxiter=500):
        self.base = base
        self.c = float(c)
        self.damp = float(damp)
        self.tol = float(tol)
        self.maxiter = int(maxiter)

    @property
    def dim_shape(self):
        return self.base.dim_shape

    @property
    def codim_shape(self):
        return self.base.codim_shape

    @property
    def dim(self):
        return self.base.dim

    @property
    def dtype(self):
        return self.base.dtype

    def adjoint(self, v):
        return self.apply(v)


class _FoldedOp(_SpectralWrapOp):
    """``v -> c v - A v`` for a self-adjoint PSD ``A``: its LARGEST eigenvalue
    is ``c - lambda_min(A)`` — the spectrum-fold trick that makes the
    smallest eigenvalue a *dominant* one, which Lanczos/power iteration find
    reliably (on-device stand-in for ARPACK shift-invert 'SM',
    reference linop.py:178-277)."""

    def apply(self, v):
        return self.c * v - self.base.apply(v)


class _CGInverseOp(_SpectralWrapOp):
    """``v -> (A + damp I)^{-1} v`` by jitted CG: its largest eigenvalue is
    ``1/(lambda_min(A) + damp)`` — true shift-invert for PSD operators."""

    def apply(self, v):
        def mv(w):
            out = self.base.apply(w)
            if self.damp:
                out = out + self.damp * w
            return out

        x, _ = jax.scipy.sparse.linalg.cg(mv, v, tol=self.tol, maxiter=self.maxiter)
        return x


def smallest_eig_psd(
    op,
    maxiter: Optional[int] = None,
    key: int = 0,
    method: str = "fold",
    cg_tol: float = 1e-8,
    cg_maxiter: int = 500,
) -> float:
    """Smallest eigenvalue of a self-adjoint PSD operator, reliably.

    * ``method='fold'`` (default, cheap): lambda_min = c - lambda_max(cI - A)
      with c a safe upper bound on lambda_max — two Lanczos runs, no solves.
      NOTE: the subtraction cancels in f32, so the relative accuracy of
      lambda_min degrades like ~eps_f32 * lambda_max / lambda_min — fine up
      to condition numbers ~1e3, use shift-invert beyond;
    * ``method='shift-invert'``: Lanczos on the CG-inverted operator — the
      small eigenvalue becomes DOMINANT (no cancellation), costs a CG solve
      per matvec (the reference reaches this via ARPACK ``sigma=0``
      shift-invert).
    """
    if method == "fold":
        lam_max = float(np.real(lanczos_eigs(op, 1, "LA", maxiter=maxiter, key=key)[0]))
        c = lam_max * (1.0 + 1e-3) + 1e-12
        folded = _FoldedOp(op, c)
        lam = float(np.real(lanczos_eigs(folded, 1, "LA", maxiter=maxiter, key=key + 1)[0]))
        return max(c - lam, 0.0)
    if method == "shift-invert":
        inv = _CGInverseOp(op, tol=cg_tol, maxiter=cg_maxiter)
        mu = float(np.real(lanczos_eigs(inv, 1, "LA", maxiter=maxiter, key=key)[0]))
        return 1.0 / mu if mu > 0 else 0.0
    raise ValueError("method must be 'fold' or 'shift-invert'")


def lanczos_eigs(op, k: int = 1, which: str = "LM", maxiter: Optional[int] = None, key: int = 0):
    """Extremal eigenvalues of a self-adjoint operator (on-device Lanczos +
    host eigendecomposition of the small tridiagonal)."""
    n = op.dim
    m = int(min(n, maxiter if maxiter is not None else max(2 * k + 10, 32)))
    kk = jax.random.PRNGKey(key)
    v0 = _rand_like(kk, op.dim_shape, op.dtype)
    alphas, betas = _lanczos(op, v0, m)
    alphas = np.asarray(alphas, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    T = np.diag(alphas) + np.diag(betas[: m - 1], 1) + np.diag(betas[: m - 1], -1)
    evals = np.linalg.eigvalsh(T)
    if which == "LM":
        order = np.argsort(-np.abs(evals))
    elif which == "SM":
        order = np.argsort(np.abs(evals))
    elif which == "LA":
        order = np.argsort(-evals)
    elif which == "SA":
        order = np.argsort(evals)
    else:
        raise ValueError(f"unknown which={which!r}")
    return jnp.asarray(evals[order[:k]])

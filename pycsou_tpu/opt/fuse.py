"""Expression recognition: rewrite generic solver configurations onto the
fused solvers.

The reference's product is duck-typed solver/operator composition — users
write ``PDS(F=SquaredL2Loss * Convolve2D, H=lam * L21Norm, K=Gradient, ...)``
(/root/reference/pycsou/opt/proxalgs.py:343-355) and the solver runs whatever
expression tree it is handed.  The same mathematics has a hand-fused
realisation (``opt.tv.TVDeconvolution``: the data gradient through one
fused convolution Gram, the stencil/prox/momentum chain as one XLA fusion).

This module is the bridge: a *pattern matcher* over the (F, G, H, K)
expression tree that recognises configurations with a fused realisation and
returns the specialised solver — the operator-algebra analogue of a compiler
rewrite rule.  Matching is strictly structural (exact node types, default
stencil conventions, ``tau == sigma``) so a rewrite NEVER changes the
mathematics: the fused engine computes the same Condat-Vu iterates to
floating-point tolerance (tests/test_fuse.py asserts this against the
unfused chain).  Anything unrecognised runs generically, as before.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

logger = logging.getLogger("pycsou_tpu.fuse")


# -- slot predicates (each returns None when the slot matches, else a short
# reason string — shared by the matchers and the near-miss explainers) --------


def _why_K(K, dim_shape) -> Optional[str]:
    from pycsou_tpu.ops.diff import Gradient

    if type(K) is not Gradient:
        return f"K is {type(K).__name__}, not a default forward Gradient"
    if K.kind != "forward":
        return f"K uses kind={K.kind!r} (fused engine needs 'forward')"
    if not all(s == 1.0 for s in K.steps):
        return f"K has non-unit steps {tuple(K.steps)}"
    if tuple(K.dim_shape) != dim_shape:
        return "K domain does not match the solve domain"
    return None


def _why_H(H, dim_shape):
    """(lam, iso, None) on match, (None, None, reason) otherwise.

    Both TV flavours match: ``L21Norm(axis=0)`` over the gradient field is
    ISOTROPIC TV (the flagship), a plain ``L1Norm`` over the same field is
    ANISOTROPIC TV — the reference's own PDS doc example
    (/root/reference/pycsou/opt/proxalgs.py:91-119 uses L1 o Gradient)."""
    from pycsou_tpu.core.functional import DiffProxFuncPostComp, ProxFuncPostComp
    from pycsou_tpu.func.penalty import L1Norm, L21Norm

    lam = 1.0
    h = H
    if type(h) in (ProxFuncPostComp, DiffProxFuncPostComp):
        try:
            shift = float(np.asarray(h.shift))
        except Exception:
            return None, None, "H has a non-scalar shift"
        if shift != 0.0:
            return None, None, "H has a nonzero shift"
        if not np.isscalar(h.scale) or h.scale <= 0:
            return None, None, "H has a non-scalar or non-positive scale"
        lam = float(h.scale)
        h = h.func
    if type(h) is L21Norm:
        if not (h.mode == "axis" and h.axis == 0):
            return None, None, "H's L21Norm must group over axis=0 (the gradient axis)"
        iso = True
    elif type(h) is L1Norm:
        iso = False
    else:
        return None, None, (
            f"H wraps {type(h).__name__}, not L21Norm (isotropic TV) or "
            "L1Norm (anisotropic TV)"
        )
    if tuple(h.dim_shape) != (2,) + dim_shape:
        return None, None, "H domain is not the (2, H, W) gradient field"
    return lam, iso, None


def _why_G_nonneg(G):
    """(nonneg, None) on match, (None, reason) otherwise."""
    from pycsou_tpu.func.base import IndicatorFunctional, NullProximableFunctional
    from pycsou_tpu.math.prox import proj_nonnegative_orthant

    if type(G) is IndicatorFunctional and G.projection_fn is proj_nonnegative_orthant:
        return True, None
    if type(G) is NullProximableFunctional:
        return False, None
    return None, f"G is {type(G).__name__}, not the nonnegative orthant or absent"


def _why_G_l1(G, dim_shape):
    """(lam, None) on match, (None, reason) otherwise."""
    from pycsou_tpu.core.functional import DiffProxFuncPostComp, ProxFuncPostComp
    from pycsou_tpu.func.penalty import L1Norm

    lam = 1.0
    g = G
    if type(g) in (ProxFuncPostComp, DiffProxFuncPostComp):
        try:
            shift = float(np.asarray(g.shift))
        except Exception:
            return None, "G has a non-scalar shift"
        if shift != 0.0:
            return None, "G has a nonzero shift"
        if not np.isscalar(g.scale) or g.scale <= 0:
            return None, "G has a non-scalar or non-positive scale"
        lam = float(g.scale)
        g = g.func
    if type(g) is not L1Norm:
        return None, f"G wraps {type(g).__name__}, not L1Norm"
    if tuple(g.dim_shape) != dim_shape:
        return None, "G domain does not match the solve domain"
    return lam, None


def _why_F(F, dim_shape) -> Optional[str]:
    if (
        _match_conv_least_squares(dim_shape, F) is None
        and _match_sampling_least_squares(dim_shape, F) is None
        and _match_masked_conv_least_squares(dim_shape, F) is None
    ):
        return (
            f"F is {type(F).__name__}, not SquaredL2Loss (optionally composed "
            "with an exact Convolve2D, a sampling operator "
            "(Masking/DownSampling/SubSampling), or a sampling operator "
            "after a Convolve2D)"
        )
    return None


def match_tv_deconvolution(
    dim_shape,
    F,
    G,
    H,
    K,
    tau: float,
    sigma: float,
    rho: float,
    metric_every: int = 1,
):
    """Return a :class:`~pycsou_tpu.opt.tv.TVDeconvolution` computing the
    same Condat-Vu iterates as ``PDS(dim_shape, F, G, H, K, tau, sigma,
    rho)``, or ``None`` when the expression does not match.

    Recognised pattern (the reference's flagship problem,
    /root/reference/pycsou/opt/proxalgs.py:91-119)::

        min_x ||A x - y||^2 + lam ||grad x||_{2,1} (+ i_{x>=0})

    i.e. ``F = SquaredL2Loss(y) * Convolve2D`` (or plain ``SquaredL2Loss(y)``
    for denoising), ``G = NonNegativeOrthant`` or absent, ``H = lam *
    L21Norm(axis=0)``, ``K = Gradient(kind='forward', step=1)``.  Any
    ``tau, sigma > 0`` pair is supported — the fused kernels plumb both
    scalars into the stencil.  All checks are exact node-type checks —
    subclasses with overridden behavior do not match.
    """
    from pycsou_tpu.opt.tv import TVDeconvolution

    dim_shape = tuple(dim_shape)
    if len(dim_shape) != 2:
        return None
    if not (tau > 0 and sigma > 0):
        return None

    # slot predicates (shared with explain_tv_mismatch): K, H, G, F
    if _why_K(K, dim_shape) is not None:
        return None
    lam, iso, h_reason = _why_H(H, dim_shape)
    if h_reason is not None:
        return None
    nonneg, g_reason = _why_G_nonneg(G)
    if g_reason is not None:
        return None
    # the three F flavours normalise to one (filt, mask, y) triple:
    # conv/denoise, sampling-only (inpainting), sampling-after-conv
    filt = mask = y = None
    if (fy := _match_conv_least_squares(dim_shape, F)) is not None:
        filt, y = fy
    elif (my := _match_sampling_least_squares(dim_shape, F)) is not None:
        mask, y = my
    elif (mc := _match_masked_conv_least_squares(dim_shape, F)) is not None:
        filt, mask, y = mc
    else:
        return None
    return TVDeconvolution(
        dim_shape,
        y,
        lam,
        filt=filt,
        mask=mask,
        nonneg=nonneg,
        tau=float(tau),
        sigma=float(sigma),
        rho=float(rho),
        metric_every=metric_every,
        isotropic=iso,
    )


def _match_conv_least_squares(dim_shape, F):
    """Shared F-matcher: ``||A x - y||^2`` with A a real 2-D Convolve2D
    (returns ``(filt, y)``), plain ``||x - y||^2`` (returns ``(None, y)``),
    or None when F doesn't match.  Exact node-type checks only."""
    from pycsou_tpu.core.functional import DiffProxFuncPreComp, ProxFuncPreComp
    from pycsou_tpu.func.loss import LeastSquaresLoss
    from pycsou_tpu.func.penalty import SquaredL2Norm
    from pycsou_tpu.ops.conv import Convolve2D

    if type(F) is LeastSquaresLoss and type(F.op) is Convolve2D:
        if tuple(F.op.dim_shape) != dim_shape:
            return None
        filt = np.asarray(F.op.filt)
        if not np.isrealobj(filt):
            return None
        filt, y = filt, F.data
    elif type(F) in (ProxFuncPreComp, DiffProxFuncPreComp) and type(F.func) is SquaredL2Norm:
        # SquaredL2Loss(dim, data) == SquaredL2Norm o (x - y)
        scale = np.asarray(F.scale)
        if scale.ndim != 0 or float(scale) != 1.0:
            return None
        filt, y = None, -F.shift
    else:
        return None
    if tuple(np.shape(y)) != dim_shape:
        return None
    return filt, y


def match_cps_tv_denoise(
    dim_shape,
    F,
    G,
    H,
    K,
    tau: float,
    sigma: float,
    rho: float,
    metric_every: int = 1,
):
    """Chambolle-Pock TV denoising: ``F = None``, ``G = SquaredL2Loss(y)``
    (the data term as a PROX), ``H = lam * L21Norm/L1Norm``, ``K =
    Gradient`` (reference proxalgs.py:628-716's canonical configuration).

    The prox x-update ``x+ = (x - tau div z + 2 tau y) / (1 + 2 tau)`` is
    ALGEBRAICALLY a gradient step with the effective step ``tau' =
    tau / (1 + 2 tau)`` applied to both the (identity-Gram) data gradient
    ``2(x - y)`` and the divergence::

        (x - tau*div + 2*tau*y)/(1+2*tau) = x - tau'*(2(x - y) + div)

    so the SAME fused engines compute CPS's iterates exactly — the delegate
    is a denoise :class:`~pycsou_tpu.opt.tv.TVDeconvolution` with
    ``tau = tau'``, ``sigma`` unchanged.  Returns None on mismatch."""
    from pycsou_tpu.func.base import NullDifferentiableFunctional
    from pycsou_tpu.opt.tv import TVDeconvolution

    dim_shape = tuple(dim_shape)
    if len(dim_shape) != 2:
        return None
    if not (tau > 0 and sigma > 0):
        return None
    if type(F) is not NullDifferentiableFunctional:
        return None
    gy = _match_conv_least_squares(dim_shape, G)
    if gy is None or gy[0] is not None:  # plain ||x - y||^2 only (prox form)
        return None
    y = gy[1]
    if _why_K(K, dim_shape) is not None:
        return None
    lam, iso, h_reason = _why_H(H, dim_shape)
    if h_reason is not None:
        return None
    return TVDeconvolution(
        dim_shape,
        y,
        lam,
        filt=None,
        nonneg=False,
        tau=float(tau) / (1.0 + 2.0 * float(tau)),
        sigma=float(sigma),
        rho=float(rho),
        metric_every=metric_every,
        isotropic=iso,
    )


def _match_sampling_least_squares(dim_shape, F):
    """``||A x - y||^2`` with A a sampling operator whose Gram is DIAGONAL
    (Masking / DownSampling / SubSampling: ``A^H A = diag(A^H 1)`` — gather
    adjoints scatter-accumulate, so the diagonal is the per-pixel sample
    count).  Returns ``(mask, y_img)`` with ``mask = A^H(1)`` and ``y_img =
    A^H y`` (the zero-filled back-projection), the exact inputs of
    :class:`~pycsou_tpu.opt.tv.TVDeconvolution`'s diagonal-Gram mode —
    inpainting / zero-fill super-resolution (reference sampling.py:125-196).
    None when F doesn't match.  Exact node-type checks only."""
    import jax.numpy as jnp

    from pycsou_tpu.func.loss import LeastSquaresLoss
    from pycsou_tpu.ops.sampling import DownSampling, Masking, SubSampling

    if type(F) is not LeastSquaresLoss:
        return None
    if type(F.op) not in (Masking, DownSampling, SubSampling):
        return None
    if tuple(F.op.dim_shape) != tuple(dim_shape):
        return None
    ones = jnp.ones(F.op.codim_shape, jnp.float32)
    mask = F.op.adjoint(ones)
    y_img = F.op.adjoint(F.data)
    return mask, y_img


def _match_masked_conv_least_squares(dim_shape, F):
    """``||M A x - y||^2`` with M a diagonal-Gram sampling operator composed
    AFTER a real Convolve2D (partial blurred measurements — super-resolution
    with blur).  Returns ``(filt, mask, y_img)`` with ``mask = M^H(1)`` and
    ``y_img = M^H y`` — the inputs of TVDeconvolution's COMBINED mode (the
    masked megar cascade fuses A^H diag(m) A).  None on mismatch; exact
    node-type checks only."""
    import jax.numpy as jnp

    from pycsou_tpu.core.linop import LinOpComp
    from pycsou_tpu.func.loss import LeastSquaresLoss
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.ops.sampling import DownSampling, Masking, SubSampling

    if type(F) is not LeastSquaresLoss or type(F.op) is not LinOpComp:
        return None
    M, A = F.op.m1, F.op.m2
    if type(M) not in (Masking, DownSampling, SubSampling):
        return None
    if type(A) is not Convolve2D or tuple(A.dim_shape) != tuple(dim_shape):
        return None
    filt = np.asarray(A.filt)
    if not np.isrealobj(filt):
        return None
    ones = jnp.ones(M.codim_shape, jnp.float32)
    mask = M.adjoint(ones)
    y_img = M.adjoint(F.data)
    return filt, mask, y_img


def match_lasso(
    dim_shape,
    F,
    G,
    tau: float,
    acceleration,
    d: float,
    metric_every: int = 1,
):
    """Return a :class:`~pycsou_tpu.opt.lasso.LassoDeconvolution` computing
    the same FISTA iterates as ``APGD(dim_shape, F, G, tau, acceleration,
    d)``, or ``None`` when the expression does not match.

    Recognised pattern (the reference's LASSO configuration,
    /root/reference/pycsou/opt/proxalgs.py:400-625)::

        min_x ||A x - y||^2 + lam ||x||_1

    i.e. ``F = SquaredL2Loss(y) * Convolve2D`` (or plain ``SquaredL2Loss(y)``
    for sparse denoising) and ``G = lam * L1Norm`` (or plain ``L1Norm``).
    All checks are exact node-type checks — subclasses with overridden
    behavior do not match."""
    from pycsou_tpu.opt.lasso import LassoDeconvolution

    dim_shape = tuple(dim_shape)
    if len(dim_shape) != 2:
        return None
    if not tau > 0:
        return None

    lam, g_reason = _why_G_l1(G, dim_shape)
    if g_reason is not None:
        return None
    fy = _match_conv_least_squares(dim_shape, F)
    if fy is None:
        return None
    filt, y = fy

    return LassoDeconvolution(
        dim_shape,
        y,
        lam,
        filt=filt,
        nonneg=False,
        tau=float(tau),
        acceleration=acceleration,
        d=float(d),
        metric_every=metric_every,
    )


# -- near-miss diagnostics (VERDICT r3 task 3c) --------------------------------


def explain_tv_mismatch(dim_shape, F, G, H, K) -> Optional[str]:
    """One-line "why not fused" note for a PDS configuration that ALMOST
    matches the TV pattern (at least half the expression slots match), or
    None when the configuration isn't close.  Logged by PDS at construction
    so a user one default away from the fused engine learns which knob to
    turn instead of silently running the slower generic chain."""
    dim_shape = tuple(dim_shape)
    if len(dim_shape) != 2:
        return None
    reasons = []
    if (r := _why_K(K, dim_shape)) is not None:
        reasons.append(r)
    _, _, r = _why_H(H, dim_shape)
    if r is not None:
        reasons.append(r)
    _, r = _why_G_nonneg(G)
    if r is not None:
        reasons.append(r)
    if (r := _why_F(F, dim_shape)) is not None:
        reasons.append(r)
    if not reasons or len(reasons) > 2:  # not close: most slots differ
        return None
    return (
        "PDS expression NOT fused (runs the generic chain): " + "; ".join(reasons)
    )


def explain_lasso_mismatch(dim_shape, F, G) -> Optional[str]:
    """One-line "why not fused" note for an APGD configuration that almost
    matches the LASSO pattern, or None when it isn't close."""
    dim_shape = tuple(dim_shape)
    if len(dim_shape) != 2:
        return None
    reasons = []
    _, r = _why_G_l1(G, dim_shape)
    if r is not None:
        reasons.append(r)
    if (r := _why_F(F, dim_shape)) is not None:
        reasons.append(r)
    if not reasons or len(reasons) > 1:  # close = exactly one slot off
        return None
    return (
        "APGD expression NOT fused (runs the generic chain): " + "; ".join(reasons)
    )

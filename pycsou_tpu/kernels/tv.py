"""Fused TV primal-dual stencil update.

One Condat-Vu iteration of the TV-regularised problem splits into (a) the
data-term gradient (the convolution Gram, ops/conv.py) and (b) a chain of
stencil + prox + momentum elementwise steps::

    x_t = P(x - tau*g - tau*div z)          # P = clip to >= 0 (optional)
    u   = 2 x_t - x
    v   = z + sigma * grad u
    z_t = v * lam / max(|v|_2, lam)         # per-pixel dual ball projection
    x'  = rho x_t + (1-rho) x
    z'  = rho z_t + (1-rho) z

Part (b) reads 4 full-size arrays (x, g, z0, z1) and writes 3; written as
plain jnp, XLA fuses the whole chain (and the data gradient's epilogue) into
one pass.  A hand-written Pallas (Triton) version of this pass was measured
slower than XLA's fusion on an H100 and removed (PERF.md, Findings).

Boundary conventions match ops/diff.py exactly: forward differences with a
zero last row/column, divergence ``(D^T y)_j = y_{j-1} - y_j`` with
``y_{-1} = y_{last} = 0``.
"""
from __future__ import annotations

import jax.numpy as jnp


def _dual_prox(v0, v1, lam, iso: bool):
    """Per-pixel projection onto the dual ball of the TV seminorm: the
    radius-``lam`` L2 ball JOINTLY over (v0, v1) for ISOTROPIC TV (L21 over
    the gradient axis — the flagship configuration), or the ``[-lam, lam]``
    box independently per component for ANISOTROPIC TV (``lam * L1Norm o
    Gradient``).  ``iso`` is static, so each variant compiles to its own
    fusion with zero overhead."""
    if iso:
        mag = jnp.sqrt(v0 * v0 + v1 * v1)
        scale = lam / jnp.maximum(mag, lam)
        return v0 * scale, v1 * scale
    return jnp.clip(v0, -lam, lam), jnp.clip(v1, -lam, lam)


def tv_pds_stencil_step_xla(x, z0, z1, g, *, tau, sigma, rho, lam, nonneg=True, iso=True):
    """Stencil/prox/momentum part of one TV PDS iteration.

    x, z0, z1, g: (H, W); g = grad of the data term at x.  Returns
    ``(x_new, z0_new, z1_new)``."""
    from pycsou_tpu.ops.diff import fdiff_forward, fdiff_forward_adjoint

    div = fdiff_forward_adjoint(z0, 0) + fdiff_forward_adjoint(z1, 1)
    x_t = x - tau * g - tau * div
    if nonneg:
        x_t = jnp.maximum(x_t, 0.0)
    u = 2.0 * x_t - x
    z0_t, z1_t = _dual_prox(
        z0 + sigma * fdiff_forward(u, 0), z1 + sigma * fdiff_forward(u, 1), lam, iso
    )
    return (
        rho * x_t + (1.0 - rho) * x,
        rho * z0_t + (1.0 - rho) * z0,
        rho * z1_t + (1.0 - rho) * z1,
    )

"""LASSO / sparse-deconvolution solver (FISTA through the fused Gram).

The reference's APGD on ``min ||A x - y||^2 + lam ||x||_1``
(/root/reference/pycsou/opt/proxalgs.py:400-625, conv data term
linop/conv.py:167-295) is its second flagship configuration (BASELINE
config 1).  ``LassoDeconvolution`` computes exactly the APGD iterates —
same BT/CD momentum rules, same auto ``tau = 1/beta`` — with the gradient
routed through the operator's fused Gram (one Gram apply per iteration
instead of a forward and an adjoint convolution); the soft-threshold and
momentum chain is elementwise and XLA fuses it.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pycsou_tpu._module import static_field
from pycsou_tpu.core.solver import IterativeSolver
from pycsou_tpu.ops.conv import Convolve2D
from pycsou_tpu.utils.shapes import as_shape

__all__ = ["LassoDeconvolution"]


class LassoDeconvolution(IterativeSolver):
    """``min_x ||A x - y||^2 + lam ||x||_1`` (or the nonnegative shrink when
    ``nonneg=True``) via FISTA; ``A`` a 2-D convolution (identity when
    ``filt`` is None).

    Iterate-exact with ``APGD(F=SquaredL2Loss(y) * A, G=lam * L1Norm)``
    (reference proxalgs.py:586-601; tests/test_fuse.py asserts parity).

    Example — sparse spike recovery::

        >>> import jax.numpy as jnp
        >>> import numpy as np
        >>> from pycsou_tpu.opt.lasso import LassoDeconvolution
        >>> x_true = jnp.zeros((16, 16)).at[4, 5].set(2.0).at[10, 12].set(1.5)
        >>> g = np.exp(-((np.arange(5) - 2) ** 2) / 2.0)
        >>> h = np.outer(g, g).astype(np.float32); h /= h.sum()
        >>> from pycsou_tpu.ops.conv import Convolve2D
        >>> y = Convolve2D((16, 16), h)(x_true)
        >>> info = LassoDeconvolution((16, 16), y, lam=0.01, filt=h,
        ...                           max_iter=300).solve()
        >>> bool(jnp.abs(info["x_temp"][4, 5] - 2.0) < 0.2)
        True
    """

    y: jax.Array = None
    gram: object = None
    atb: jax.Array = None
    lam: float = static_field(default=0.1)
    tau: float = static_field(default=0.1)
    beta: float = static_field(default=2.0)
    nonneg: bool = static_field(default=False)
    acceleration: Optional[str] = static_field(default="CD")
    d: float = static_field(default=75.0)

    def __init__(
        self,
        shape,
        y,
        lam: float,
        filt=None,
        nonneg: bool = False,
        tau: Optional[float] = None,
        acceleration: Optional[str] = "CD",
        d: float = 75.0,
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-4,
        verbose: Optional[int] = None,
        metric_every: int = 1,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold, verbose=verbose, metric_every=metric_every)
        shape = as_shape(shape)
        self.y = jnp.asarray(y, jnp.float32)
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        if acceleration not in ("BT", "CD", None):
            raise ValueError("acceleration must be 'BT', 'CD' or None")
        self.acceleration = acceleration
        self.d = float(d)

        if filt is None:
            filt = np.ones((1, 1), np.float32)
        A = Convolve2D(shape, filt)
        self.gram = A.gram
        self.atb = A.adjoint(self.y)
        self.beta = 2.0 * A.lipschitz**2
        self.tau = float(tau) if tau is not None else 1.0 / self.beta
        # stopping metric on the feasible iterate (reference proxalgs.py:612)
        self.primary_var = "x_temp"

    # -- iteration -----------------------------------------------------------
    def initial_state(self):
        return {
            "x": jnp.zeros(self.y.shape, jnp.float32),
            "x_temp": jnp.zeros(self.y.shape, jnp.float32),
            "t": jnp.asarray(1.0, jnp.float32),
            "n": jnp.asarray(0, jnp.int32),
        }

    def _momentum(self, t_old, n):
        if self.acceleration == "BT":
            t = (1 + jnp.sqrt(1 + 4 * t_old**2)) / 2
        elif self.acceleration == "CD":
            t = (n.astype(jnp.float32) + self.d) / self.d
        else:
            t = jnp.asarray(1.0, jnp.float32)
            t_old = t
        return (t_old - 1) / t, t

    def step(self, state):
        v, xp, t_old, n = state["x"], state["x_temp"], state["t"], state["n"]
        a, t = self._momentum(t_old, n)
        g = 2.0 * (self.gram.apply(v) - self.atb)
        u = v - self.tau * g
        thr = self.tau * self.lam
        if self.nonneg:
            x_n = jnp.maximum(u - thr, 0.0)
        else:
            x_n = jnp.sign(u) * jnp.maximum(jnp.abs(u) - thr, 0.0)
        v_n = x_n + a * (x_n - xp)
        return {"x": v_n, "x_temp": x_n, "t": t, "n": n + 1}

    def objective(self, x):
        """``||A x - y||^2 + lam ||x||_1`` via the Gram identity
        ``||Ax - y||^2 = <x, Gx> - 2 <x, atb> + ||y||^2`` (pure/jittable)."""
        quad = jnp.vdot(x, self.gram.apply(x)) - 2.0 * jnp.vdot(x, self.atb) + jnp.vdot(self.y, self.y)
        return jnp.real(quad) + self.lam * jnp.sum(jnp.abs(x))

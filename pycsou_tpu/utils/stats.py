"""Streaming statistics: fully vectorised P-Square quantile estimation.

Equivalent of the reference's pycsou/util/stats.py:6-132.  The
reference jit-compiles a per-coordinate Python loop with Numba (stats.py:97,
its only compiled kernel); here the marker update is expressed as pure
vectorised array ops over *all* coordinates at once, so it runs on the device
and can live inside the jitted MCMC sampling loop (no host round-trip per
sample).
"""
from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["p2_init", "p2_add", "p2_quantile", "P2Algorithm"]


def p2_init(pvalue: float, shape=()) -> Dict[str, jax.Array]:
    """Fresh P^2 state for per-coordinate quantile tracking on arrays of
    ``shape``.  Markers at p-values [0, p/2, p, (1+p)/2, 1]."""
    p = float(pvalue)
    shape = tuple(shape)
    return {
        "count": jnp.asarray(0, jnp.int32),
        "buffer": jnp.zeros((5,) + shape, jnp.float32),
        "q": jnp.zeros((5,) + shape, jnp.float32),
        "n": jnp.asarray([1.0, 2.0, 3.0, 4.0, 5.0], jnp.float32).reshape((5,) + (1,) * len(shape))
        * jnp.ones((5,) + shape, jnp.float32),
        "n_des": jnp.asarray([1.0, 1 + 2 * p, 1 + 4 * p, 3 + 2 * p, 5.0], jnp.float32),
        "inc": jnp.asarray([0.0, p / 2, p, (1 + p) / 2, 1.0], jnp.float32),
    }


def _p2_core(state, x):
    """One marker update for sample x (vectorised over coordinates);
    mirrors the reference's ``_p2_update`` (stats.py:97-132)."""
    q, n = state["q"], state["n"]
    n_des = state["n_des"]

    q = q.at[0].set(jnp.minimum(q[0], x))
    q = q.at[4].set(jnp.maximum(q[4], x))

    # cell index k in {0,1,2,3} per coordinate
    k = jnp.clip(sum((x >= q[i]).astype(jnp.int32) for i in range(4)) - 1, 0, 3)
    marker_idx = jnp.arange(5).reshape((5,) + (1,) * (q.ndim - 1))
    n = n + (marker_idx > k[None]).astype(n.dtype)

    nd_shape = (1,) * (q.ndim - 1)
    for i in (1, 2, 3):
        d = n_des[i].reshape(nd_shape) - n[i]
        move_up = (d >= 1) & ((n[i + 1] - n[i]) > 1)
        move_dn = (d <= -1) & ((n[i - 1] - n[i]) < -1)
        cond = move_up | move_dn
        ds = jnp.where(move_up, 1.0, -1.0)
        # parabolic (P^2) candidate
        denom_out = n[i + 1] - n[i - 1]
        qp = q[i] + (ds / denom_out) * (
            (n[i] - n[i - 1] + ds) * (q[i + 1] - q[i]) / jnp.maximum(n[i + 1] - n[i], 1e-12)
            + (n[i + 1] - n[i] - ds) * (q[i] - q[i - 1]) / jnp.maximum(n[i] - n[i - 1], 1e-12)
        )
        ok = (q[i - 1] < qp) & (qp < q[i + 1])
        # linear fallback toward the neighbour in direction ds:
        # q_i + ds (q_{i+ds} - q_i)/(n_{i+ds} - n_i)   (stats.py:126-127)
        q_up = q[i] + (q[i + 1] - q[i]) / jnp.maximum(n[i + 1] - n[i], 1e-12)
        q_dn = q[i] - (q[i - 1] - q[i]) / jnp.minimum(n[i - 1] - n[i], -1e-12)
        q_lin = jnp.where(ds > 0, q_up, q_dn)
        q_new = jnp.where(ok, qp, q_lin)
        q = q.at[i].set(jnp.where(cond, q_new, q[i]))
        n = n.at[i].set(jnp.where(cond, n[i] + ds, n[i]))

    return {**state, "q": q, "n": n}


def p2_add(state: Dict[str, jax.Array], sample) -> Dict[str, jax.Array]:
    """Add one sample (array of the tracked shape); pure and jittable."""
    x = jnp.asarray(sample, jnp.float32)
    cnt = state["count"]

    def warmup(state):
        buf = state["buffer"].at[cnt].set(x)
        q = jnp.sort(buf, axis=0)
        return {**state, "buffer": buf, "q": q}

    def update(state):
        state = {**state, "n_des": state["n_des"] + state["inc"]}
        new = _p2_core(state, x)
        return {**new, "buffer": state["buffer"]}

    new_state = jax.lax.cond(cnt < 5, warmup, update, state)
    new_state["count"] = cnt + 1
    return new_state


def p2_quantile(state: Dict[str, jax.Array]) -> jax.Array:
    """Current quantile estimate (the middle marker height)."""
    return state["q"][2]


class P2Algorithm:
    """Stateful host-side wrapper with the reference's API
    (``add_sample`` / ``.q``, stats.py:6-95); the update itself is the jitted
    vectorised kernel above.

    Example — streaming median of 0..99 (exact: the P^2 parabola degenerates
    to counting for a linear ramp)::

        >>> from pycsou_tpu.utils.stats import P2Algorithm
        >>> p2 = P2Algorithm(0.5)
        >>> for v in range(100):
        ...     p2.add_sample(float(v))
        >>> abs(float(p2.q[0]) - 49.5) < 1.5
        True
    """

    def __init__(self, pvalue: float):
        self.pvalue = float(pvalue)
        self._state = None
        self._add = jax.jit(p2_add)

    def add_sample(self, sample):
        """Fold one (vector) sample into the running P^2 quantile state."""
        x = jnp.atleast_1d(jnp.asarray(sample, jnp.float32))
        if self._state is None:
            self._state = p2_init(self.pvalue, x.shape)
        self._state = self._add(self._state, x)

    @property
    def q(self):
        """Current quantile estimate(s) (NaN until 5 samples arrive)."""
        if self._state is None:
            raise ValueError("no samples added yet")
        return np.asarray(p2_quantile(self._state))

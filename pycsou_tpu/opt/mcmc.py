"""Proximal MCMC: the PMYULA (Proximal Moreau-Yosida Unadjusted Langevin
Algorithm) sampler for Bayesian inverse problems.

Re-design of the reference's pycsou/opt/mcmc.py:14-208: the
Langevin chain, burn-in/thinning gates, online moment accumulators and the
per-tracked-operator P^2 quantile states all live in ONE jitted loop state —
no per-sample host work (the reference appends to Python lists and loops over
numba-jitted P2 objects per sample).  The reference's latent ``rng``
NameError (mcmc.py:112 — SURVEY §7) is moot here: the PRNG key is threaded
through the state explicitly.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from pycsou_tpu._module import static_field
from pycsou_tpu.core.functional import ProximableFunctional
from pycsou_tpu.core.linop import LinearOperator
from pycsou_tpu.core.map import DifferentiableMap
from pycsou_tpu.core.solver import IterativeSolver
from pycsou_tpu.func.base import NullProximableFunctional
from pycsou_tpu.utils.shapes import as_shape
from pycsou_tpu.utils.stats import p2_add, p2_init, p2_quantile

__all__ = ["PMYULA"]

_INF = float("inf")


class PMYULA(IterativeSolver):
    r"""Sample from ``exp(-F(x) - G(x))``; Langevin update (mcmc.py:113-118)::

        x+ = (1 - gamma/tau) x - gamma grad F(x)
             + (gamma/tau) prox_{tau G}(x) + sqrt(2 gamma) xi

    Auto hyper-parameters (mcmc.py:78-85): ``tau = 2/beta``,
    ``gamma = tau/(beta tau + 1)`` (or ``gamma = 1/beta`` when G is Null).
    Streams MMSE / second moment / P^2 quantiles for x and for each tracked
    linear operator output (mcmc.py:126-137).

    Example — the posterior mean of ``exp(-||x - y||^2)`` is ``y``::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.func import SquaredL2Loss
        >>> from pycsou_tpu.opt.mcmc import PMYULA
        >>> y = jnp.array([1.0, -1.0])
        >>> s = PMYULA((2,), F=SquaredL2Loss((2,), data=y), seed=0,
        ...            nb_burnin_iterations=200)
        >>> out = s.postprocess(s.run_fixed(4000))
        >>> bool(jnp.max(jnp.abs(out["mmse"] - y)) < 0.2)
        True
    """

    F: DifferentiableMap = None
    G: ProximableFunctional = None
    linops: Tuple[LinearOperator, ...] = None
    x0: jax.Array = None
    tau: float = static_field(default=1.0)
    gamma: float = static_field(default=1.0)
    beta: float = static_field(default=0.0)
    pvalues: Tuple[float, ...] = static_field(default=())
    scalar_fns: tuple = static_field(default=())
    burnin: int = static_field(default=0)
    thinning: int = static_field(default=1)
    seed: int = static_field(default=0)
    _G_null: bool = static_field(default=False)

    def __init__(
        self,
        dim_shape,
        F=None,
        G=None,
        tau: Optional[float] = None,
        gamma: Optional[float] = None,
        beta: Optional[float] = None,
        x0=None,
        linops: Optional[Sequence[LinearOperator]] = None,
        pvalues: Optional[Sequence[float]] = None,
        scalar_fns: Optional[Sequence] = None,
        nb_burnin_iterations: int = 0,
        thinning_factor: int = 1,
        seed: int = 0,
        max_iter: int = 10000,
        min_iter: int = 100,
        accuracy_threshold: float = 1e-4,
        verbose: Optional[int] = None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold, verbose=verbose)
        dim_shape = as_shape(dim_shape)

        if F is None:
            from pycsou_tpu.func.base import NullDifferentiableFunctional

            self.F = NullDifferentiableFunctional(dim_shape)
            self.beta = float(beta) if beta is not None else 1.0
        else:
            self.F = F
            b = beta if beta is not None else getattr(F, "diff_lipschitz", _INF)
            if not math.isfinite(b):
                raise ValueError("F must have a Lipschitz gradient; pass beta=...")
            self.beta = float(b)

        self._G_null = G is None
        self.G = G if G is not None else NullProximableFunctional(dim_shape)

        # auto hyper-parameters (reference mcmc.py:78-85)
        if tau is not None and gamma is not None:
            self.tau, self.gamma = float(tau), float(gamma)
        elif tau is not None:
            self.tau = float(tau)
            self.gamma = float(tau) / (self.beta * float(tau) + 1)
        else:
            if self._G_null:
                self.tau = 1.0
                self.gamma = 1.0 / self.beta
            else:
                self.tau = 2.0 / self.beta
                self.gamma = self.tau / (self.beta * self.tau + 1)

        self.linops = tuple(linops) if linops is not None else ()
        self.pvalues = tuple(float(p) for p in pvalues) if pvalues is not None else ()
        # scalar summaries x -> float tracked per collected sample; their
        # traces feed the ESS / split-R-hat convergence diagnostics
        # (utils/diagnostics.py) in postprocess.
        self.scalar_fns = tuple(scalar_fns) if scalar_fns is not None else ()
        self.burnin = int(nb_burnin_iterations)
        self.thinning = int(thinning_factor)
        self.seed = int(seed)
        self.x0 = jnp.zeros(dim_shape, dtype=jnp.float32) if x0 is None else jnp.asarray(x0)

    # -- state -------------------------------------------------------------
    def initial_state(self):
        state = {
            "x": self.x0,
            "key": jax.random.PRNGKey(self.seed),
            "n": jnp.asarray(0, jnp.int32),  # solver-owned iteration counter
            "count": jnp.asarray(0, jnp.int32),
            "mmse_raw": jnp.zeros_like(self.x0),
            "m2_raw": jnp.zeros_like(self.x0),
            "p2_raw": [p2_init(p, self.x0.shape) for p in self.pvalues],
            "mmse_ops": [jnp.zeros(op.codim_shape, jnp.float32) for op in self.linops],
            "m2_ops": [jnp.zeros(op.codim_shape, jnp.float32) for op in self.linops],
            "p2_ops": [
                [p2_init(p, op.codim_shape) for p in self.pvalues] for op in self.linops
            ],
        }
        if self.scalar_fns:
            # per-sample scalar traces, preallocated to the max sample count
            state["traces"] = jnp.zeros((len(self.scalar_fns), self.max_iter), jnp.float32)
        return state

    def step(self, state):
        x, key = state["x"], state["key"]
        key, sub = jax.random.split(key)
        xi = jax.random.normal(sub, x.shape, dtype=x.dtype)
        g = self.gamma
        if self._G_null:
            x_new = x - g * self.F.gradient(x) + jnp.sqrt(2 * g) * xi
        else:
            x_new = (
                (1 - g / self.tau) * x
                - g * self.F.gradient(x)
                + (g / self.tau) * self.G.prox(x, self.tau)
                + jnp.sqrt(2 * g) * xi
            )

        it = state["n"]  # completed iterations before this one (solver-owned)
        collect = jnp.logical_and(
            it > jnp.maximum(self.burnin, 4), (it - self.burnin) % self.thinning == 0
        )
        w = collect.astype(jnp.float32)
        count = state["count"] + collect.astype(jnp.int32)
        mmse_raw = state["mmse_raw"] + w * x_new
        m2_raw = state["m2_raw"] + w * x_new**2

        p2_raw = [
            jax.tree_util.tree_map(
                lambda new, old: jnp.where(collect, new, old), p2_add(s, x_new), s
            )
            for s in state["p2_raw"]
        ]

        mmse_ops, m2_ops, p2_ops = [], [], []
        for i, op in enumerate(self.linops):
            y = op.apply(x_new)
            mmse_ops.append(state["mmse_ops"][i] + w * y)
            m2_ops.append(state["m2_ops"][i] + w * y**2)
            p2_ops.append(
                [
                    jax.tree_util.tree_map(
                        lambda new, old: jnp.where(collect, new, old), p2_add(s, y), s
                    )
                    for s in state["p2_ops"][i]
                ]
            )

        out = {
            "x": x_new,
            "key": key,
            "n": it + 1,
            "count": count,
            "mmse_raw": mmse_raw,
            "m2_raw": m2_raw,
            "p2_raw": p2_raw,
            "mmse_ops": mmse_ops,
            "m2_ops": m2_ops,
            "p2_ops": p2_ops,
        }
        if self.scalar_fns:
            vals = jnp.stack([jnp.asarray(f(x_new), jnp.float32).reshape(()) for f in self.scalar_fns])
            traces = state["traces"]
            idx = state["count"]  # pre-increment sample index
            cur = jax.lax.dynamic_slice(traces, (0, idx), (traces.shape[0], 1))[:, 0]
            new = jnp.where(collect, vals, cur)
            out["traces"] = jax.lax.dynamic_update_slice(traces, new[:, None], (0, idx))
        return out

    def objective(self, x):
        """Negative log-posterior F(x) + G(x) (pure/jittable)."""
        return self.F.apply(x) + self.G.apply(x)

    def metric(self, old, new):
        """Relative improvement of the running MMSE estimate
        (reference mcmc.py:197-208).

        Between collected samples the running mean does not move, which
        would read as a spurious 0 (instant "convergence"); the metric holds
        its previous value on non-sample iterations instead."""
        m_old = old["mmse_raw"] / jnp.maximum(old["count"].astype(jnp.float32), 1.0)
        m_new = new["mmse_raw"] / jnp.maximum(new["count"].astype(jnp.float32), 1.0)
        n_old = jnp.sqrt(jnp.sum(m_old**2))
        n_diff = jnp.sqrt(jnp.sum((m_new - m_old) ** 2))
        rel = jnp.where(n_old == 0, jnp.inf, n_diff / jnp.where(n_old == 0, 1.0, n_old))
        collected = new["count"] > old["count"]
        return jnp.where(collected, rel, old["metric"])

    def postprocess(self, state):
        """MMSE / pointwise std / quantiles (reference mcmc.py:146-184)."""
        cnt = jnp.maximum(state["count"].astype(jnp.float32), 1.0)
        out = {
            "x": state["x"],
            "mmse": state["mmse_raw"] / cnt,
            "std": jnp.sqrt(jnp.maximum(state["m2_raw"] / cnt - (state["mmse_raw"] / cnt) ** 2, 0.0)),
            "n_samples": state["count"],
        }
        if self.pvalues:
            out["quantiles"] = {p: p2_quantile(s) for p, s in zip(self.pvalues, state["p2_raw"])}
        if self.linops:
            out["mmse_linops"] = [m / cnt for m in state["mmse_ops"]]
            out["std_linops"] = [
                jnp.sqrt(jnp.maximum(m2 / cnt - (m / cnt) ** 2, 0.0))
                for m, m2 in zip(state["mmse_ops"], state["m2_ops"])
            ]
            if self.pvalues:
                out["quantiles_linops"] = [
                    {p: p2_quantile(s) for p, s in zip(self.pvalues, states)}
                    for states in state["p2_ops"]
                ]
        if self.scalar_fns:
            # ESS / split-R-hat of the tracked scalar summaries
            # (utils/diagnostics.py; single chain -> half-split R-hat)
            from pycsou_tpu.utils.diagnostics import effective_sample_size, split_rhat

            n = int(state["count"])
            traces = state["traces"][:, :n]
            out["traces"] = traces
            if n >= 8:
                out["ess"] = jnp.stack([effective_sample_size(t) for t in traces])
                out["rhat"] = jnp.stack([split_rhat(t) for t in traces])
        return out

"""Iterative solver skeleton: fused on-device loops with chunked host sync.

Re-design of the reference ``GenericIterativeAlgorithm``
(/root/reference/pycsou/core/solver.py:17-134).  The reference's hot loop is
host Python with a per-iteration ``deepcopy`` and pandas row append
(solver.py:55-76, SURVEY §3.2); here the entire iteration body — operator
applies, proxes, momentum, stopping metric — is a pure function driven by
``lax.while_loop`` inside one jitted computation.  The host only syncs once
per *chunk* (default: the ``verbose`` stride) to print diagnostics, and the
per-iteration metric history is a fixed-size on-device buffer.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pycsou_tpu._module import Module, static_field

__all__ = ["IterativeSolver", "SolveInfo"]

_INF = float("inf")


def _rel_improvement(a_old, a_new) -> jax.Array:
    """||new - old|| / ||old||; inf from a zero iterand that moved, 0 from a
    zero iterand that stayed (reference proxalgs.py:386-394)."""
    n_old = jnp.sqrt(jnp.real(jnp.vdot(a_old, a_old)))
    n_diff = jnp.sqrt(jnp.real(jnp.vdot(a_new - a_old, a_new - a_old)))
    return jnp.where(
        n_old == 0,
        jnp.where(n_diff == 0, 0.0, jnp.inf),
        n_diff / jnp.where(n_old == 0, 1.0, n_old),
    )


def _advance(solver, s, new):
    """Shared bookkeeping after one step: metrics, histories, shardings."""
    rels = None
    if "var_history" in s:
        rels = solver.metrics(s, new)
    if (
        rels is not None
        and type(solver).metric is IterativeSolver.metric
        and type(solver).metrics is IterativeSolver.metrics
        and solver.primary_var in rels
    ):
        # the default stopping metric IS the primary entry of the default
        # per-variable diagnostics — reuse it instead of re-reducing the
        # primary iterand (a full extra HBM pass at 4096^2)
        m = rels[solver.primary_var]
    else:
        m = solver.metric(s, new)
    it = s["it"] + 1
    new["it"] = it
    new["metric"] = m
    new["history"] = s["history"].at[it - 1].set(m)
    if rels is not None:
        row = jnp.stack([rels[k] for k in sorted(rels)])
        new["var_history"] = s["var_history"].at[it - 1].set(row)
    if "obj_history" in s:
        new["obj_history"] = s["obj_history"].at[it - 1].set(
            solver.objective(new[solver.primary_var])
        )
    return solver._constrain(new)


def _raw_step(solver, st):
    """One step WITHOUT bookkeeping: bump ``it``, carry the measured-stride
    entries unchanged, re-constrain (shared by the metric_every stride loop
    and _run_fixed's remainder loop)."""
    new = solver._step(st)
    new["it"] = st["it"] + 1
    for key in ("metric", "history", "var_history", "obj_history"):
        if key in st:
            new[key] = st[key]
    return solver._constrain(new)


def _stride_body(solver, s):
    """One *measured* stride: ``metric_every - 1`` raw steps with no
    bookkeeping (the metric/diagnostic reductions are full passes over every
    iterate array) followed by one measured step.  Structured as a
    ``fori_loop`` rather than a per-iteration ``lax.cond``, so no iteration
    pays for a branch.
    Skipped history rows stay NaN ("not measured")."""
    every = int(getattr(solver, "metric_every", 1) or 1)
    if every <= 1:
        return _advance(solver, s, solver._step(s))

    s = jax.lax.fori_loop(0, every - 1, lambda _, st: _raw_step(solver, st), s)
    return _advance(solver, s, solver._step(s))


@partial(jax.jit, static_argnums=())
def _run_chunk(solver, state, it_stop):
    """Run iterations until convergence or ``it_stop``; one XLA computation."""

    def cond(s):
        it = s["it"]
        not_done = it < it_stop
        # NaN-safe: a diverged solve (metric = NaN) must keep iterating to
        # max_iter, not deadlock — `NaN > tol` is False but so is
        # `NaN <= tol`, which would spin solve()'s host loop forever
        keep_going = jnp.logical_or(
            jnp.logical_not(s["metric"] <= solver.tol), it < solver.min_iter
        )
        return jnp.logical_and(not_done, keep_going)

    def body(s):
        return _stride_body(solver, s)

    return jax.lax.while_loop(cond, body, state)


class SolveInfo:
    """Result bundle: final iterand(s), iteration count, metric history.

    ``history`` is the primal (stopping) metric per iteration; when the
    solver tracks several iterate variables, ``diagnostics`` maps each
    variable name to its per-iteration relative improvement — the on-device
    equivalent of the reference's pandas diagnostics frame
    (/root/reference/pycsou/opt/proxalgs.py:366-394, primal AND dual).
    """

    def __init__(self, iterand: Dict[str, Any], n_iter: int, history: np.ndarray, converged: bool, elapsed: float, diagnostics: Optional[Dict[str, np.ndarray]] = None):
        self.iterand = iterand
        self.n_iter = n_iter
        self.history = history
        self.converged = converged
        self.elapsed = elapsed
        self.diagnostics = diagnostics or {}

    def __getitem__(self, key):
        return self.iterand[key]

    def __repr__(self):
        return (
            f"SolveInfo(n_iter={self.n_iter}, converged={self.converged}, "
            f"final_metric={self.history[self.n_iter - 1] if self.n_iter else float('inf'):.3e}, "
            f"elapsed={self.elapsed:.3f}s)"
        )


class IterativeSolver(Module):
    """Base driver.  Subclasses implement :meth:`initial_state` (a dict
    pytree of iteration variables) and :meth:`step` (one pure iteration);
    optionally override :meth:`metric` (default: relative improvement of the
    ``'x'`` entry, the reference's stopping rule, proxalgs.py:360-364).

    Example — a 6-line custom solver (Richardson iteration for ``x = b/2``)::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.core.solver import IterativeSolver
        >>> class Richardson(IterativeSolver):
        ...     b: jnp.ndarray = None
        ...     def __init__(self, b, **kw):
        ...         super().__init__(**kw)
        ...         self.b = b
        ...     def initial_state(self):
        ...         return {"x": jnp.zeros_like(self.b)}
        ...     def step(self, state):
        ...         return {"x": state["x"] + 0.5 * (self.b - 2 * state["x"])}
        >>> info = Richardson(jnp.array([2.0, 4.0]), tol=1e-6).solve()
        >>> info["x"].tolist(), bool(info.converged)
        ([1.0, 2.0], True)
    """

    max_iter: int = static_field(default=500)
    min_iter: int = static_field(default=10)
    tol: float = static_field(default=1e-3)
    verbose: Optional[int] = static_field(default=None)
    remat: bool = static_field(default=False)
    track_objective: bool = static_field(default=False)
    # stride for the stopping-metric / diagnostics reductions (1 = every
    # iteration, the reference's semantics); >1 trades diagnostic density
    # for iteration throughput on bandwidth-bound problems
    metric_every: int = static_field(default=1)
    # name of the state entry driving the stopping metric (reference
    # proxalgs.py:360-364 stops on the primal variable)
    primary_var: str = static_field(default="x")
    # optional {state key -> jax sharding}: initial state is device_put
    # accordingly and every iteration re-constrains the state, so the whole
    # solve runs SPMD over the mesh with XLA-inserted collectives (GSPMD) —
    # works for ARBITRARY operator expressions, not just hand-sharded solvers
    state_shardings: Optional[Dict[str, Any]] = static_field(default=None)

    def __init__(self, max_iter: int = 500, min_iter: int = 10, tol: float = 1e-3, verbose: Optional[int] = None, remat: bool = False, track_objective: bool = False, metric_every: int = 1):
        self.max_iter = int(max_iter)
        self.min_iter = int(min_iter)
        self.tol = float(tol)
        self.verbose = verbose
        # rematerialise each iteration instead of keeping intermediates —
        # trades FLOPs for HBM on very large problems (jax.checkpoint)
        self.remat = bool(remat)
        # record the objective value per iteration into an on-device buffer
        # (the reference's diagnostics DataFrame role, proxalgs.py:366-394)
        self.track_objective = bool(track_objective)
        self.metric_every = int(metric_every)

    def _step(self, state):
        if self.remat:
            return jax.checkpoint(lambda s: self.step(s))(state)
        return self.step(state)

    # -- SPMD (generic sharded solve) ---------------------------------------
    def with_shardings(self, **shardings) -> "IterativeSolver":
        """Return a copy of the solver whose state entries follow the given
        shardings (jax ``NamedSharding``s keyed by state-dict entry).

        This is the *generic* multi-device path: any
        composed operator expression works — XLA's SPMD partitioner inserts
        the psum/halo collectives that the hand-written solvers in
        ``parallel/solvers.py`` spell out manually.
        """
        return self.replace(state_shardings=dict(shardings))

    def _constrain(self, state):
        sh = getattr(self, "state_shardings", None)
        if not sh:
            return state
        return {
            k: (jax.lax.with_sharding_constraint(v, sh[k]) if k in sh else v)
            for k, v in state.items()
        }

    # -- to implement ------------------------------------------------------
    def initial_state(self) -> Dict[str, Any]:
        """Dict pytree of iteration variables at iteration 0."""
        raise NotImplementedError

    def step(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """ONE pure/jittable iteration: state dict -> new state dict."""
        raise NotImplementedError

    def metric(self, old: Dict[str, Any], new: Dict[str, Any]) -> jax.Array:
        """Relative improvement of the primary iterand; +inf from a zero
        iterand (reference proxalgs.py:386-394)."""
        return _rel_improvement(old[self.primary_var], new[self.primary_var])

    def diagnostics_vars(self, state: Dict[str, Any]):
        """State entries tracked in per-variable diagnostics (override to
        restrict; the reference tracks EVERY iterate variable incl. the
        dual, proxalgs.py:366-394)."""
        reserved = {"it", "metric", "history", "var_history", "obj_history", "key"}
        return tuple(
            k
            for k, v in state.items()
            if k not in reserved
            and not k.startswith("_")  # "_"-prefixed entries are solver-internal
            and hasattr(v, "ndim")
            and getattr(v, "ndim", 0) >= 1
        )

    def metrics(self, old: Dict[str, Any], new: Dict[str, Any]) -> Dict[str, jax.Array]:
        """Per-variable relative improvements (reference's diagnostics
        frame, proxalgs.py:366-394)."""
        return {k: _rel_improvement(old[k], new[k]) for k in self.diagnostics_vars(old)}

    # -- driver ------------------------------------------------------------
    def _wrap_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        state = dict(state)
        sh = getattr(self, "state_shardings", None)
        if sh:
            state = {
                k: (jax.device_put(v, sh[k]) if k in sh else v) for k, v in state.items()
            }
        state.setdefault("it", jnp.asarray(0, dtype=jnp.int32))
        state.setdefault("metric", jnp.asarray(_INF, dtype=jnp.float32))
        # a stride can overshoot max_iter by up to eff - 1 iterations; one
        # stride of slack also covers a checkpoint-resumed solve whose
        # restored `it` is not stride-aligned (a clipped .at[] write would
        # silently corrupt the last history row otherwise)
        eff = max(1, int(getattr(self, "metric_every", 1) or 1))
        n_hist = (-(-self.max_iter // eff) + 1) * eff
        state.setdefault("history", jnp.full((n_hist,), jnp.nan, dtype=jnp.float32))
        n_vars = len(self.diagnostics_vars(state))
        if n_vars > 1:
            state.setdefault(
                "var_history", jnp.full((n_hist, n_vars), jnp.nan, dtype=jnp.float32)
            )
        if self.track_objective:
            state.setdefault("obj_history", jnp.full((n_hist,), jnp.nan, dtype=jnp.float32))
        return state

    def solve(self, checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1) -> SolveInfo:
        """Run to convergence with chunked host synchronisation.

        With ``checkpoint_dir``, the full state pytree is persisted every
        ``checkpoint_every`` chunks and automatically resumed from the latest
        checkpoint on restart (Orbax; see utils/checkpoint.py).
        """
        state = self._wrap_state(self.initial_state())
        if checkpoint_dir is not None:
            # resume from the newest LOADABLE checkpoint (a kill mid-save can
            # leave the newest step_* partial; fall back to the previous one)
            from pycsou_tpu.utils.checkpoint import load_latest_state

            resumed = load_latest_state(checkpoint_dir, template=state)
            if resumed is not None:
                sh = getattr(self, "state_shardings", None)
                if sh:
                    # restored leaves land on the default device; re-apply
                    # the GSPMD shardings before the first chunk or a
                    # mesh-sized problem OOMs device 0 on resume
                    resumed = {
                        k: (jax.device_put(v, sh[k]) if k in sh else v)
                        for k, v in resumed.items()
                    }
                state = resumed
        # host-sync stride: every chunk boundary costs one device->host
        # roundtrip, while
        # the while_loop's convergence predicate already stops mid-chunk, so
        # large chunks never overshoot.  Small chunks only pay off for
        # verbose printing or dense checkpoint cadence.
        if self.verbose:
            chunk = self.verbose
        elif checkpoint_dir is not None:
            chunk = 100
        else:
            # one dispatch end-to-end whenever max_iter allows: the
            # convergence predicate stops INSIDE the while_loop, so a large
            # chunk never overshoots, while every extra chunk boundary costs
            # a host roundtrip — the dominant term for small problems
            # (BASELINE configs 1-2).  The cap only bounds how long the host
            # goes without a progress sync.
            chunk = max(100, min(self.max_iter, 10_000))
        checkpoint_every = max(1, int(checkpoint_every))
        n_chunks = 0
        t0 = time.perf_counter()
        while True:
            it = int(state["it"])
            it_stop = min(it + chunk, self.max_iter)
            state = _run_chunk(self, state, jnp.asarray(it_stop, dtype=jnp.int32))
            it = int(state["it"])  # single host sync per chunk
            m = float(state["metric"])
            n_chunks += 1
            if self.verbose:
                print(f"iter {it:6d}   relative improvement {m:.4e}")
            converged = (m <= self.tol) and (it >= self.min_iter)
            if checkpoint_dir is not None and (
                n_chunks % checkpoint_every == 0 or converged or it >= self.max_iter
            ):
                from pycsou_tpu.utils.checkpoint import save_state

                save_state(f"{checkpoint_dir}/step_{it}", state)
            if converged or it >= self.max_iter:
                break
        elapsed = time.perf_counter() - t0
        iterand = self.postprocess(state)
        history = np.asarray(state["history"])[:it]
        diagnostics = None
        if "var_history" in state:
            names = sorted(self.diagnostics_vars(state))
            vh = np.asarray(state["var_history"])[:it]
            diagnostics = {name: vh[:, i] for i, name in enumerate(names)}
        info = SolveInfo(iterand, it, history, converged, elapsed, diagnostics=diagnostics)
        if "obj_history" in state:
            info.objective_history = np.asarray(state["obj_history"])[:it]
        return info

    # reference-compatible alias (solver.py:55)
    def iterate(self) -> SolveInfo:
        """Reference-compatible alias for :meth:`solve` (solver.py:55)."""
        return self.solve()

    def run_fixed(self, n_iter: int, state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Run exactly ``n_iter`` iterations with NO convergence predicate —
        a single ``lax.scan``-style computation for benchmarking and for
        embedding a solver inside a larger jitted program."""
        state = self._wrap_state(self.initial_state() if state is None else state)
        state = self._grow_history(state, int(state["it"]) + int(n_iter))
        return _run_fixed(self, state, n_iter)

    def _grow_history(self, state, upto: int):
        """Pad the history buffers when chained run_fixed calls exceed the
        max_iter-sized allocation (an out-of-range .at[] write is silently
        dropped under JAX scatter semantics — rows would just vanish).

        Growth is GEOMETRIC (doubling): every distinct history shape is a new
        XLA compilation of ``_run_fixed``, and linear per-call padding made a
        chain of benchmark chunks recompile on *every* call past ``max_iter``
        (the compile then landed inside every timed chunk and halved the
        measured rate).  Doubling bounds the number of shapes at
        O(log overrun): a chain that overruns by up to 2x recompiles once."""
        eff = max(1, int(getattr(self, "metric_every", 1) or 1))
        need = (-(-upto // eff) + 1) * eff
        cur = state["history"].shape[0]
        if need <= cur:
            return state
        new_size = cur
        while new_size < need:
            new_size *= 2  # cur is a multiple of eff, so doubles stay aligned
        state = dict(state)
        pad = new_size - cur
        state["history"] = jnp.pad(state["history"], (0, pad), constant_values=jnp.nan)
        if "var_history" in state:
            state["var_history"] = jnp.pad(
                state["var_history"], ((0, pad), (0, 0)), constant_values=jnp.nan
            )
        if "obj_history" in state:
            state["obj_history"] = jnp.pad(
                state["obj_history"], (0, pad), constant_values=jnp.nan
            )
        return state

    def iterates(self, n: int, stride: int = 1):
        """Generator over iterates (reference solver.py:88)."""
        state = self._wrap_state(self.initial_state())
        for _ in range(0, n, stride):
            state = _run_fixed(self, state, stride)
            yield self.postprocess(state)

    def postprocess(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Map the final state to user-facing iterand dict (override freely);
        drops histories and "_"-prefixed solver-internal entries."""
        hidden = ("history", "var_history", "obj_history")
        return {
            k: v for k, v in state.items() if k not in hidden and not k.startswith("_")
        }


@partial(jax.jit, static_argnums=(2,))
def _run_fixed(solver, state, n_iter: int):
    eff = max(1, int(getattr(solver, "metric_every", 1) or 1))  # iterations per stride

    def body(s, _):
        return _stride_body(solver, s), None

    if eff <= 1:
        state, _ = jax.lax.scan(body, state, None, length=n_iter)
        return state
    n_outer, rem = divmod(n_iter, eff)
    state, _ = jax.lax.scan(body, state, None, length=n_outer)
    if rem:
        # remainder: rem-1 raw steps + one measured step
        state = jax.lax.fori_loop(0, rem - 1, lambda _, st: _raw_step(solver, st), state)
        state = _advance(solver, state, solver._step(state))
    return state

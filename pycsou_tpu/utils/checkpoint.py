"""Checkpoint / resume of solver state pytrees via Orbax.

The reference's only 'recovery' story is warm-starting from x0 in memory
(SURVEY §5 — nothing is ever persisted).  Here any solver state — iterates,
duals, momentum terms, PRNG keys, P^2 quantile states — is a pytree and
round-trips through Orbax, so long solves on preemptible machines can
resume mid-run.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import jax
import numpy as np

__all__ = ["save_state", "load_state", "latest_checkpoint", "checkpoint_steps", "load_latest_state"]


def _checkpointer():
    import orbax.checkpoint as ocp

    return ocp.PyTreeCheckpointer()


def save_state(path: str, state: Any) -> None:
    """Persist a solver-state pytree (overwrites)."""
    path = os.path.abspath(path)
    _checkpointer().save(path, jax.device_get(state), force=True)


def load_state(path: str, template: Optional[Any] = None) -> Any:
    """Restore a solver-state pytree; with ``template`` the restored leaves
    adopt the template's structure/dtypes."""
    path = os.path.abspath(path)
    restored = _checkpointer().restore(path)
    if template is None:
        return restored

    paths_t, treedef = jax.tree_util.tree_flatten_with_path(template)
    flat_r, treedef_r = jax.tree_util.tree_flatten(restored)
    # structural validation: leaf-count alone can pair the WRONG leaves
    # positionally (dicts flatten sorted-by-key) and silently cast them
    if treedef_r != treedef:
        raise ValueError(
            f"checkpoint tree structure {treedef_r} does not match the "
            f"solver template {treedef}"
        )
    import jax.numpy as jnp

    _HISTORY_KEYS = ("history", "var_history", "obj_history")
    flat = []
    for (path, t), r in zip(paths_t, flat_r):
        t_shape = tuple(getattr(t, "shape", np.shape(t)))
        t_dtype = getattr(t, "dtype", np.asarray(t).dtype)
        r_shape = tuple(np.shape(r))
        key = getattr(path[-1], "key", None) if path else None
        if r_shape != t_shape:
            grown = (
                key in _HISTORY_KEYS
                and len(r_shape) == len(t_shape)
                and r_shape[1:] == t_shape[1:]
                and r_shape[0] <= t_shape[0]
            )
            if not grown:
                raise ValueError(
                    f"checkpoint leaf {key or path} shape {r_shape} != template "
                    f"{t_shape} (solver reconfigured? different metric_every/"
                    "history sizes?)"
                )
            # resuming with a LARGER max_iter: grow the history buffer,
            # unmeasured rows stay NaN (the buffer's "not measured" value)
            pad = [(0, t_shape[0] - r_shape[0])] + [(0, 0)] * (len(r_shape) - 1)
            r = np.pad(np.asarray(r), pad, constant_values=np.nan)
        flat.append(jnp.asarray(r, dtype=t_dtype))
    return jax.tree_util.tree_unflatten(treedef, flat)


def checkpoint_steps(directory: str) -> list:
    """COMPLETED checkpoint subdirectories of ``directory``, most recent step
    first.  Orbax stages in-progress saves in ``*.orbax-checkpoint-tmp*``
    dirs and renames on commit; anything whose suffix is not a bare integer
    (i.e. a save that was interrupted mid-write) is excluded."""
    if not os.path.isdir(directory):
        return []
    subs = []
    for d in os.listdir(directory):
        if not d.startswith("step_"):
            continue
        try:
            step = int(d.split("_", 1)[1])
        except ValueError:
            continue  # staging dir of an in-flight/killed save
        subs.append((step, d))
    subs.sort(reverse=True)
    return [os.path.join(directory, d) for _, d in subs]


def latest_checkpoint(directory: str) -> Optional[str]:
    """Most recent checkpoint subdirectory of ``directory`` (by step suffix),
    or None."""
    steps = checkpoint_steps(directory)
    return steps[0] if steps else None


def load_latest_state(directory: str, template: Optional[Any] = None) -> Optional[Any]:
    """Restore the most recent LOADABLE checkpoint, or None when the
    directory holds no checkpoints at all.

    A process killed mid-save (preemption, SIGKILL) can leave its newest
    ``step_*`` directory partially written; resume must then fall back to
    the previous complete checkpoint rather than crash — this scans newest
    to oldest, warning for each torn candidate it skips.  If EVERY candidate
    fails (e.g. the solver was reconfigured so the state structure no longer
    matches), that is a structural error, not a torn write — it raises
    instead of silently restarting the solve from iteration 0 (ADVICE r2)."""
    import warnings

    paths = checkpoint_steps(directory)
    errors = []
    for path in paths:
        try:
            state = load_state(path, template)
            if errors:
                warnings.warn(
                    f"skipped {len(errors)} unreadable newer checkpoint(s) "
                    f"({errors[-1][0]}: {errors[-1][1]!r}); resumed from {path}"
                )
            return state
        except Exception as e:  # torn write, version skew, ...
            errors.append((path, e))
    if errors:
        raise RuntimeError(
            f"all {len(errors)} checkpoint(s) in {directory} failed to load "
            f"— structural mismatch with the current solver? newest error: "
            f"{errors[0][0]}: {errors[0][1]!r}"
        )
    return None

"""Elastic recovery: fault-injected (SIGKILL) solve resumes and matches.

The reference has NO failure-detection/recovery story (SURVEY §5 — warm
starts only, nothing persisted).  This repo's story is checkpoint-based
restart of the solver-state pytree (core/solver.py solve(checkpoint_dir=),
utils/checkpoint.py).  These tests exercise it the way a preemptible
cluster would: a worker process is killed with SIGKILL mid-solve, a fresh
process resumes from the newest loadable checkpoint, and the final iterate
must equal an uninterrupted run bit-for-bit-close (pure jitted iterations
are deterministic)."""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, {repo!r})
import numpy as np
import jax.numpy as jnp
from pycsou_tpu.ops.basic import DenseOperator
from pycsou_tpu.func.loss import SquaredL2Loss
from pycsou_tpu.func.penalty import L1Norm
from pycsou_tpu.opt.proxalgs import APGD

rng = np.random.default_rng(7)
A = DenseOperator(jnp.asarray(rng.standard_normal((96, 192)).astype(np.float32)))
x_true = np.zeros(192, np.float32); x_true[rng.integers(0, 192, 12)] = 1.0
y = jnp.asarray(A.mat @ x_true + 0.01 * rng.standard_normal(96).astype(np.float32))
F = SquaredL2Loss((96,), y) * A
beta = 2.0 * float(np.linalg.norm(np.asarray(A.mat), 2)) ** 2
solver = APGD((192,), F=F, G=0.02 * L1Norm((192,)), beta=beta,
              max_iter=600, min_iter=600, accuracy_threshold=0.0, verbose={chunk})
info = solver.solve(checkpoint_dir={ckpt!r}, checkpoint_every=1)
np.save({out!r}, np.asarray(info.iterand["x"]))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in [_REPO, env.get("PYTHONPATH", "")] if p)
    return env


def _write_worker(tmp_path, name, chunk, ckpt, out):
    script = tmp_path / name
    script.write_text(
        _WORKER.format(repo=_REPO, chunk=chunk, ckpt=str(ckpt), out=str(out))
    )
    return script


def test_sigkill_resume_matches_uninterrupted(tmp_path):
    # uninterrupted reference run (its own process: identical environment)
    out_ref = tmp_path / "ref.npy"
    ref_script = _write_worker(tmp_path, "ref.py", 50, tmp_path / "ckpt_ref", out_ref)
    subprocess.run([sys.executable, str(ref_script)], check=True, env=_env(), timeout=600)

    # faulted run: kill -9 once a checkpoint exists, then restart to resume
    ckpt = tmp_path / "ckpt"
    out = tmp_path / "faulted.npy"
    script = _write_worker(tmp_path, "worker.py", 50, ckpt, out)
    proc = subprocess.Popen([sys.executable, str(script)], env=_env())
    try:
        deadline = time.time() + 300
        from pycsou_tpu.utils.checkpoint import checkpoint_steps

        while time.time() < deadline:
            if len(checkpoint_steps(str(ckpt))) >= 1 or proc.poll() is not None:
                break
            time.sleep(0.02)
        assert proc.poll() is None, "worker finished before the fault could be injected"
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert not out.exists(), "killed worker must not have produced a result"
    steps_after_kill = checkpoint_steps(str(ckpt))
    assert steps_after_kill, "no checkpoint was persisted before the kill"

    # fresh process resumes from the newest loadable checkpoint
    res = subprocess.run([sys.executable, str(script)], env=_env(), timeout=600)
    assert res.returncode == 0
    x_ref = np.load(out_ref)
    x_faulted = np.load(out)
    np.testing.assert_allclose(x_faulted, x_ref, rtol=1e-5, atol=1e-6)


def test_load_latest_skips_corrupt_checkpoint(tmp_path):
    """A partially-written newest checkpoint (kill mid-save) must not break
    resume: load_latest_state falls back to the previous complete one."""
    import jax.numpy as jnp

    from pycsou_tpu.utils.checkpoint import load_latest_state, save_state

    state = {"x": jnp.arange(8.0), "it": jnp.asarray(5, jnp.int32)}
    save_state(str(tmp_path / "step_5"), state)
    # simulate a torn write: a newer step dir with garbage contents
    bad = tmp_path / "step_10"
    bad.mkdir()
    (bad / "not_a_checkpoint").write_text("torn")
    restored = load_latest_state(str(tmp_path), template=state)
    assert restored is not None
    np.testing.assert_allclose(np.asarray(restored["x"]), np.arange(8.0))
    assert int(restored["it"]) == 5

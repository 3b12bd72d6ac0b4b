"""Multi-host bring-up smoke test: real multi-PROCESS jax.distributed.

The virtual 8-device CPU mesh used everywhere else is single-process;
this is the one test that exercises ``parallel.mesh.distributed_init``
(the jax.distributed wrapper the multi-host pod path relies on,
SURVEY §5 distributed-backend row) across two actual OS processes with a
gRPC coordinator, ending in a cross-process collective whose result every
process verifies.  Skips rather than fails if the local runtime cannot
form the distributed service (sandboxed CI without localhost sockets)."""
import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
from pycsou_tpu.parallel.mesh import distributed_init

coord, pid = sys.argv[1], int(sys.argv[2])
distributed_init(coordinator_address=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(4), ("d",))
data = np.arange(8.0, dtype=np.float32)
arr = jax.make_array_from_callback(
    (8,), NamedSharding(mesh, P("d")), lambda idx: data[idx]
)
total = jax.jit(jnp.sum, out_shardings=NamedSharding(mesh, P()))(arr)
assert float(total) == 28.0, float(total)
print(f"proc {pid} OK", flush=True)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_psum(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in [_REPO, env.get("PYTHONPATH", "")] if p)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed service did not come up within the timeout")
    if any(p.returncode != 0 for p in procs):
        joined = "\n".join(outs)
        if "UNAVAILABLE" in joined or "DEADLINE" in joined or "failed to connect" in joined.lower():
            pytest.skip(f"distributed service unavailable in this sandbox:\n{joined[-500:]}")
        raise AssertionError(f"worker failed:\n{joined}")
    assert all("OK" in o for o in outs)

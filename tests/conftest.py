"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding correctness is validated on ``xla_force_host_platform_device_count=8``
CPU devices (``__graft_entry__.dryrun_multichip`` dry-run-compiles the
multi-device path the same way).  The GPU runs are ``chip_smoke.py``.
"""
import os

# PYCSOU_TEST_GPU=1 keeps JAX's default platform, for the ``gpu``-marked
# tests (tests/test_gpu.py) on a machine with a card; otherwise every test
# runs on the virtual CPU mesh
ON_GPU = os.environ.get("PYCSOU_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

if not ON_GPU:
    assert jax.device_count() == 8, f"expected 8 virtual CPU devices, got {jax.devices()}"


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: PYCSOU_TEST_GPU=1 python -m pytest -m gpu tests/test_gpu.py")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(17)


def assert_dot_test(op, rng, rtol=1e-4, n_trials=3):
    """Adjoint consistency: <A x, y> == <x, A^H y> (the reference's
    correctness oracle, SURVEY §4)."""
    import jax.numpy as jnp

    for _ in range(n_trials):
        x = jnp.asarray(rng.standard_normal(op.dim_shape), dtype=op.dtype)
        y = jnp.asarray(rng.standard_normal(op.codim_shape), dtype=op.dtype)
        if jnp.issubdtype(jnp.dtype(op.dtype), jnp.complexfloating):
            x = x + 1j * jnp.asarray(rng.standard_normal(op.dim_shape), dtype=jnp.float32)
            y = y + 1j * jnp.asarray(rng.standard_normal(op.codim_shape), dtype=jnp.float32)
        lhs = jnp.vdot(y, op.apply(x))
        rhs = jnp.vdot(op.adjoint(y), x)
        np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs), rtol=rtol, atol=1e-4)


@pytest.fixture
def dot_test(rng):
    def check(op, rtol=1e-4, n_trials=3):
        assert_dot_test(op, rng, rtol=rtol, n_trials=n_trials)

    return check

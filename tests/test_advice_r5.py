"""Regression tests for the round-4 ADVICE findings (ADVICE.md).

Each test pins a fixed bug:
* generic PDS/APGD states written BEFORE the in-step ``_gstats`` partial
  sums existed (old checkpoints, hand-built states) resume instead of
  raising a while_loop carry-structure mismatch,
* the per-shard engine switch ``use_pallas`` is gone: passing it fails at
  construction instead of being silently ignored.
"""
import jax.numpy as jnp
import numpy as np
import pytest


def _tiny_pds(metric_every=1):
    from pycsou_tpu.func import SquaredL2Loss
    from pycsou_tpu.func.penalty import L21Norm
    from pycsou_tpu.ops.diff import Gradient
    from pycsou_tpu.opt import PDS

    shape = (8, 8)
    y = jnp.ones(shape)
    return PDS(
        shape,
        F=SquaredL2Loss(shape, data=y),
        H=0.1 * L21Norm((2,) + shape, axis=0),
        K=Gradient(shape),
        max_iter=20,
        fuse=False,
        metric_every=metric_every,
    )


def test_pds_resumes_pre_gstats_state():
    """A hand-built {x, z} state (the pre-_gstats checkpoint layout) must
    run through run_fixed with metric_every=1 — _wrap_state defaults the
    missing ``_gstats`` entry (ADVICE r4)."""
    solver = _tiny_pds()
    assert solver._instats
    old_layout = {
        "x": jnp.zeros((8, 8), jnp.float32),
        "z": jnp.zeros((2, 8, 8), jnp.float32),
    }
    state = solver.run_fixed(5, state=old_layout)  # must not raise
    ref = solver.run_fixed(5)
    np.testing.assert_allclose(np.asarray(state["x"]), np.asarray(ref["x"]), atol=1e-6)


def test_apgd_resumes_pre_gstats_state():
    from pycsou_tpu.func import SquaredL2Loss
    from pycsou_tpu.func.penalty import L1Norm
    from pycsou_tpu.opt import APGD

    shape = (16,)
    y = jnp.linspace(-1.0, 1.0, 16)
    solver = APGD(
        shape,
        F=SquaredL2Loss(shape, data=y),
        G=0.05 * L1Norm(shape),
        max_iter=20,
        fuse=False,
    )
    assert solver._instats
    old_layout = {
        "x": jnp.zeros(shape, jnp.float32),
        "x_temp": jnp.zeros(shape, jnp.float32),
        "t": jnp.asarray(1.0, jnp.float32),
        "n": jnp.asarray(0, jnp.int32),
    }
    state = solver.run_fixed(5, state=old_layout)  # must not raise
    ref = solver.run_fixed(5)
    np.testing.assert_allclose(
        np.asarray(state["x_temp"]), np.asarray(ref["x_temp"]), atol=1e-6
    )


def test_spatial2d_use_pallas_true_on_cpu_raises():
    """The per-shard fused engines (and their ``use_pallas`` switch) were
    removed: the 2-D-mesh solver always runs the XLA halo chain, and a
    caller still passing the switch is told so at construction."""
    from pycsou_tpu.parallel.mesh import make_mesh
    from pycsou_tpu.parallel.solvers import Spatial2DTVDeconv2D

    mesh = make_mesh((1, 1), axis_names=("sp0", "sp1"))
    h = np.ones((3, 3), np.float32) / 9.0
    y = jnp.ones((64, 128))
    with pytest.raises(TypeError, match="use_pallas"):
        Spatial2DTVDeconv2D((64, 128), h, y, 0.05, mesh=mesh, use_pallas=True)

"""Regression tests for the round-1 ADVICE findings (ADVICE.md).

Each test pins a fixed bug:
* LinOpSum / DiffMapSum adjoints under codomain broadcasting,
* ProxFuncPreComp with zero entries in an elementwise scale,
* the complex soft-threshold phase convention,
* ShardedDenseOperator mesh metadata surviving pytree round-trips,
* DistributedTVDeconv2D halo-width validation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import assert_dot_test


def _dense(rng, m, n):
    from pycsou_tpu.ops.basic import DenseOperator

    return DenseOperator(jnp.asarray(rng.standard_normal((m, n)), jnp.float32))


def test_linop_sum_codomain_broadcast_adjoint(rng, dot_test):
    """functional + operator sum: the scalar summand's adjoint must see
    sum(y), not the raw array (ADVICE r1, medium)."""
    from pycsou_tpu.func.base import ExplicitLinearFunctional

    A = _dense(rng, 6, 6)
    v = jnp.asarray(rng.standard_normal(6), jnp.float32)
    lf = ExplicitLinearFunctional(v)
    s = lf + A  # LinOpSum with codim broadcast () + (6,)
    assert s.codim_shape == (6,)
    dot_test(s)
    # explicit check: adjoint(y) == A^H y + v * sum(y)
    y = jnp.asarray(rng.standard_normal(6), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(s.adjoint(y)),
        np.asarray(A.adjoint(y) + v * jnp.sum(y)),
        rtol=1e-5,
    )
    # gram built on the sum must now be consistent too
    assert_dot_test(s.gram, np.random.default_rng(3))


def test_diffmap_sum_codomain_broadcast_jacobian(rng):
    """nonlinear functional + operator: jacobianT must not try to add a
    gradient array to an operator node (ADVICE r1)."""
    from pycsou_tpu.func.penalty import SquaredL2Norm

    A = _dense(rng, 5, 5)
    f = SquaredL2Norm((5,))
    s = f + A
    x = jnp.asarray(rng.standard_normal(5), jnp.float32)
    v = jnp.asarray(rng.standard_normal(5), jnp.float32)
    jt = s.jacobianT(x)
    got = jt.apply(v)
    _, vjp = jax.vjp(s.apply, x)
    (want,) = vjp(v)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)


def test_precomp_elementwise_scale_with_zeros(rng):
    """A masked (zero-containing) elementwise weight must not produce NaNs;
    the prox is the identity on masked coordinates (ADVICE/VERDICT weak #5)."""
    from pycsou_tpu.func.penalty import L1Norm

    f = L1Norm((8,))
    w = jnp.asarray([0.0, 1.0, 2.0, 0.0, 0.5, 1.0, 0.0, 3.0], jnp.float32)
    g = f * w  # f(w * x)
    x = jnp.asarray(rng.standard_normal(8), jnp.float32)
    tau = 0.4
    p = g.prox(x, tau)
    assert not np.any(np.isnan(np.asarray(p)))
    # masked coords: identity
    np.testing.assert_allclose(np.asarray(p)[w == 0], np.asarray(x)[w == 0], rtol=1e-6)
    # active coords: match the scalar rule applied per-coordinate
    for i in np.nonzero(np.asarray(w))[0]:
        wi = float(w[i])
        want = float(f.prox(jnp.full((8,), wi * x[i]), tau * wi * wi)[0]) / wi
        np.testing.assert_allclose(float(p[i]), want, rtol=1e-5)
    # prox must still be the minimiser of tau*f(w.) + 0.5||.-x||^2
    def obj(z):
        return tau * float(g(z)) + 0.5 * float(jnp.vdot(z - x, z - x))

    base = obj(p)
    for _ in range(20):
        z = p + 0.1 * jnp.asarray(rng.standard_normal(8), jnp.float32)
        assert obj(z) >= base - 1e-5


def test_complex_soft_threshold_convention(rng):
    """prox of |.| must SHRINK the modulus and PRESERVE the phase
    (x/|x| convention; the reference conjugates — deliberate fix)."""
    from pycsou_tpu.math.prox import sign, soft

    x = jnp.asarray(rng.standard_normal(12) + 1j * rng.standard_normal(12), jnp.complex64)
    tau = 0.3
    s = soft(x, tau)
    want = jnp.maximum(jnp.abs(x) - tau, 0.0) * x / jnp.abs(x)
    np.testing.assert_allclose(np.asarray(s), np.asarray(want), rtol=1e-5, atol=1e-6)
    # phase preserved where not killed
    alive = np.abs(np.asarray(x)) > tau
    np.testing.assert_allclose(
        np.angle(np.asarray(s)[alive]), np.angle(np.asarray(x)[alive]), rtol=1e-4
    )
    # sign(x) * |x| == x
    np.testing.assert_allclose(np.asarray(sign(x) * jnp.abs(x)), np.asarray(x), rtol=1e-5, atol=1e-6)
    # complex prox via L1Norm agrees
    from pycsou_tpu.func.penalty import L1Norm

    f = L1Norm((12,))
    np.testing.assert_allclose(np.asarray(f.prox(x, tau)), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_sharded_dense_mesh_survives_pytree(rng):
    from pycsou_tpu.parallel import ShardedDenseOperator, make_mesh

    mesh = make_mesh(axis_names=("sp",))
    M = jnp.asarray(rng.standard_normal((16, 8)), jnp.float32)
    op = ShardedDenseOperator(M, mesh=mesh, row_axis="sp")
    leaves, treedef = jax.tree_util.tree_flatten(op)
    op2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert op2.mesh is mesh
    assert op2.row_axis == "sp" and op2.col_axis is None
    # and through an actual jit round-trip
    @jax.jit
    def run(o, x):
        return o.apply(x)

    x = jnp.asarray(rng.standard_normal(8), jnp.float32)
    np.testing.assert_allclose(np.asarray(run(op, x)), np.asarray(M @ x), rtol=1e-5)


def test_distributed_tv_halo_validation():
    from pycsou_tpu.parallel.solvers import DistributedTVDeconv2D

    filt = jnp.ones((15, 15), jnp.float32) / 225.0
    y = jnp.zeros((16, 64), jnp.float32)  # 2 rows/device on 8 devices < 7 needed
    with pytest.raises(ValueError, match="rows per device"):
        DistributedTVDeconv2D((16, 64), filt, y, lam=0.1)


def test_pallas_availability_flag():
    """No Pallas kernel remains on any path: importing the whole package
    loads no Pallas module and the TV kernel module exposes only the XLA
    stencil (the availability flag went with the kernels)."""
    import sys

    import pycsou_tpu  # noqa: F401
    import pycsou_tpu.kernels.tv as ktv

    assert not hasattr(ktv, "pallas_available")
    assert callable(ktv.tv_pds_stencil_step_xla)
    assert not any(m.startswith("jax.experimental.pallas") for m in sys.modules)

"""Coverage batch: nonlinear stacks, functional stacks, misc operator APIs,
determinism, remat."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest


def jarr(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)


def test_nonlinear_map_stacks(rng):
    from pycsou_tpu.core.map import Map
    from pycsou_tpu.ops.stack import MapHStack, MapVStack

    class Sq(Map):
        def __init__(self, n):
            super().__init__((n,), (n,), lipschitz=float("inf"))

        def apply(self, x):
            return x**2

    class Cube(Map):
        def __init__(self, n):
            super().__init__((n,), (n,), lipschitz=float("inf"))

        def apply(self, x):
            return x**3

    v = MapVStack([Sq(4), Cube(4)])
    x = jarr(rng, 4)
    np.testing.assert_allclose(v(x), jnp.stack([x**2, x**3]), rtol=1e-5)
    h = MapHStack([Sq(4), Cube(4)])
    x2 = jarr(rng, 2, 4)
    np.testing.assert_allclose(h(x2), x2[0] ** 2 + x2[1] ** 3, rtol=1e-5)


def test_map_shift_comp_pow(rng):
    from pycsou_tpu.core.map import Map

    class Exp(Map):
        def __init__(self, n):
            super().__init__((n,), (n,))

        def apply(self, x):
            return jnp.tanh(x)

    f = Exp(5)
    x = jarr(rng, 5)
    s = jarr(rng, 5)
    np.testing.assert_allclose(f.shifter(s)(x), jnp.tanh(x + s), rtol=1e-5)
    np.testing.assert_allclose((f * f)(x), jnp.tanh(jnp.tanh(x)), rtol=1e-5)
    np.testing.assert_allclose((f**2)(x), jnp.tanh(jnp.tanh(x)), rtol=1e-5)


def test_prox_func_hstack(rng):
    from pycsou_tpu.func import L1Norm, ProxFuncHStack
    from pycsou_tpu.func.penalty import L2Norm

    f = ProxFuncHStack([L1Norm((4,)), L2Norm((6,))])
    x = jarr(rng, 10)
    tau = 0.4
    expected = jnp.concatenate([L1Norm((4,)).prox(x[:4], tau), L2Norm((6,)).prox(x[4:], tau)])
    np.testing.assert_allclose(f.prox(x, tau), expected, rtol=1e-5)
    np.testing.assert_allclose(
        float(f(x)), float(L1Norm((4,))(x[:4]) + L2Norm((6,))(x[4:])), rtol=1e-5
    )


def test_diff_func_hstack(rng):
    from pycsou_tpu.func import DiffFuncHStack
    from pycsou_tpu.func.penalty import SquaredL2Norm

    f = DiffFuncHStack([SquaredL2Norm((3,)), SquaredL2Norm((5,))])
    x = jarr(rng, 8)
    np.testing.assert_allclose(f.gradient(x), 2 * x, rtol=1e-5)
    assert f.diff_lipschitz == 2.0


def test_indicator_apply_values(rng):
    from pycsou_tpu.func import NonNegativeOrthant

    f = NonNegativeOrthant((4,))
    assert float(f(jnp.asarray([1.0, 2.0, 0.0, 3.0]))) == 0.0
    assert np.isinf(float(f(jnp.asarray([1.0, -2.0, 0.0, 3.0]))))


def test_fenchel_prox_chain(rng):
    """fenchel_prox of a scaled functional via Moreau (reference doctest
    functional.py:122-132 style identity)."""
    from pycsou_tpu.func import L1Norm

    f = 2.0 * L1Norm((6,))
    z = jarr(rng, 6)
    sigma = 0.7
    expected = z - sigma * f.prox(z / sigma, 1 / sigma)
    np.testing.assert_allclose(f.fenchel_prox(z, sigma), expected, rtol=1e-5)
    # prox identity: (2f).prox(x, tau) == f.prox(x, 2 tau)
    base = L1Norm((6,))
    np.testing.assert_allclose(f.prox(z, 0.3), base.prox(z, 0.6), rtol=1e-6)


def test_kronecker_pinv(rng):
    from pycsou_tpu.ops.kron import KroneckerProduct

    A = rng.standard_normal((4, 4)).astype(np.float32) + 2 * np.eye(4, dtype=np.float32)
    B = rng.standard_normal((3, 3)).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)
    op = KroneckerProduct(A, B)
    x = jarr(rng, 4, 3)
    y = op(x)
    x_rec = op.pinv(y, tol=1e-10, maxiter=300)
    np.testing.assert_allclose(np.asarray(x_rec), np.asarray(x), rtol=1e-2, atol=1e-3)


def test_transpose_complex(rng, dot_test):
    from pycsou_tpu.ops.basic import DenseOperator

    M = (rng.standard_normal((5, 4)) + 1j * rng.standard_normal((5, 4))).astype(np.complex64)
    op = DenseOperator(jnp.asarray(M))
    x = jnp.asarray(rng.standard_normal(5) + 1j * rng.standard_normal(5), dtype=jnp.complex64)
    np.testing.assert_allclose(np.asarray(op.T.apply(x)), M.T @ np.asarray(x), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(op.H.apply(x)), M.conj().T @ np.asarray(x), rtol=1e-4)


def test_pinv_operator_adjoint(rng, dot_test):
    from pycsou_tpu.ops.basic import DenseOperator

    A = DenseOperator(jarr(rng, 6, 4))
    dag = A.PinvOp
    dot_test(dag, rtol=1e-2)


def test_circular_conv_damped_pinv(rng):
    from pycsou_tpu.ops.conv import CircularConvolve

    h = rng.standard_normal((3, 3)).astype(np.float32) * 0.1
    h[1, 1] += 1.0
    op = CircularConvolve((8, 8), h)
    x = jarr(rng, 8, 8)
    x_rec = op.pinv(op(x), damp=1e-6)
    np.testing.assert_allclose(np.asarray(x_rec), np.asarray(x), rtol=1e-2, atol=1e-3)


def test_solver_determinism(rng):
    """Two identical runs produce bitwise-identical iterates (the on-device
    stand-in for the reference's serial==parallel checks, SURVEY §5)."""
    from pycsou_tpu.func import L1Norm, SquaredL2Loss
    from pycsou_tpu.ops.basic import DenseOperator
    from pycsou_tpu.opt import APGD

    A = DenseOperator(jarr(rng, 12, 8))
    A.compute_lipschitz_cst()
    y = jarr(rng, 12)
    F = SquaredL2Loss((12,), data=y) * A
    runs = []
    for _ in range(2):
        s = APGD((8,), F=F, G=0.1 * L1Norm((8,)), max_iter=200)
        runs.append(np.asarray(s.run_fixed(150)["x"]))
    np.testing.assert_array_equal(runs[0], runs[1])


def test_remat_solver_matches(rng):
    from pycsou_tpu.func import L1Norm, SquaredL2Loss
    from pycsou_tpu.ops.basic import DenseOperator
    from pycsou_tpu.opt import APGD

    A = DenseOperator(jarr(rng, 12, 8))
    A.compute_lipschitz_cst()
    y = jarr(rng, 12)
    F = SquaredL2Loss((12,), data=y) * A
    plain = APGD((8,), F=F, G=0.1 * L1Norm((8,)), max_iter=100).run_fixed(80)
    r = APGD((8,), F=F, G=0.1 * L1Norm((8,)), max_iter=100, remat=True).run_fixed(80)
    np.testing.assert_allclose(np.asarray(plain["x"]), np.asarray(r["x"]), rtol=1e-6)


def test_mcmc_determinism(rng):
    from pycsou_tpu.func import SquaredL2Loss
    from pycsou_tpu.opt.mcmc import PMYULA

    y = jarr(rng, 6)
    F = 0.5 * SquaredL2Loss((6,), data=y)
    outs = []
    for _ in range(2):
        s = PMYULA((6,), F=F, gamma=0.1, tau=1.0, max_iter=200, min_iter=200,
                   accuracy_threshold=0.0, seed=7)
        outs.append(np.asarray(s.solve()["mmse"]))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_to_scipy_operator_interop(rng):
    import scipy.sparse.linalg as spla

    from pycsou_tpu.ops.basic import DenseOperator

    R = rng.standard_normal((8, 8)).astype(np.float32)
    A = DenseOperator(jnp.asarray(R @ R.T + 2 * np.eye(8, dtype=np.float32)))  # SPD for CG
    sci = A.to_scipy_operator()
    b = rng.standard_normal(8).astype(np.float32)
    x, info = spla.cg(sci, b, rtol=1e-8)
    assert info == 0
    np.testing.assert_allclose(np.asarray(A(jnp.asarray(x))), b, atol=1e-4)


def test_objective_tracking(rng):
    from pycsou_tpu.func import L1Norm, SquaredL2Loss
    from pycsou_tpu.ops.basic import DenseOperator
    from pycsou_tpu.opt import APGD

    A = DenseOperator(jarr(rng, 12, 8))
    A.compute_lipschitz_cst()
    y = jarr(rng, 12)
    F = SquaredL2Loss((12,), data=y) * A
    s = APGD((8,), F=F, G=0.1 * L1Norm((8,)), max_iter=300, accuracy_threshold=1e-8)
    s.track_objective = True
    info = s.solve()
    obj = info.objective_history
    assert obj.shape[0] == info.n_iter
    # objective decreases overall (FISTA is not monotone, compare ends)
    assert obj[-1] < obj[2]


def test_tv_solver_objective_tracking(rng):
    from pycsou_tpu.opt import TVDeconvolution

    H, W = 16, 16
    h = jnp.asarray(rng.standard_normal((3, 3)) / 3, jnp.float32)
    from pycsou_tpu.ops.conv import Convolve2D

    A = Convolve2D((H, W), h)
    y = A(jnp.abs(jarr(rng, H, W)))
    s = TVDeconvolution((H, W), y, 0.01, filt=h, max_iter=150, min_iter=150,
                        accuracy_threshold=0.0)
    s.track_objective = True
    info = s.solve()
    obj = info.objective_history
    assert obj[-1] < obj[0]
    # gram-identity objective == direct evaluation
    x = info["x"]
    direct = float(jnp.sum((A(x) - y) ** 2))
    from pycsou_tpu.ops.diff import fdiff_forward

    tv = float(jnp.sum(jnp.sqrt(fdiff_forward(x, 0) ** 2 + fdiff_forward(x, 1) ** 2)))
    np.testing.assert_allclose(float(s.objective(x)), direct + 0.01 * tv, rtol=1e-3)


def test_warm_starts(rng):
    """x0/z0 warm starting (reference proxalgs.py:129, 230-238)."""
    from pycsou_tpu.func import L1Norm, SquaredL2Loss
    from pycsou_tpu.ops.basic import DenseOperator
    from pycsou_tpu.opt import APGD, PDS

    A = DenseOperator(jarr(rng, 12, 8))
    A.compute_lipschitz_cst()
    y = jarr(rng, 12)
    F = SquaredL2Loss((12,), data=y) * A
    x0 = jarr(rng, 8)
    s = APGD((8,), F=F, G=0.1 * L1Norm((8,)), x0=x0, max_iter=10, min_iter=10)
    st = s.run_fixed(0)
    np.testing.assert_allclose(np.asarray(st["x"]), np.asarray(x0))
    p = PDS((8,), F=F, H=0.1 * L1Norm((8,)), x0=x0, z0=jnp.ones(8), max_iter=10)
    st = p.run_fixed(0)
    np.testing.assert_allclose(np.asarray(st["z"]), 1.0)


def test_unitary_identities(rng):
    from pycsou_tpu.ops.basic import IdentityOperator
    from pycsou_tpu.ops.transform import DCTOperator

    U = DCTOperator((12,))
    assert isinstance(U.gram, IdentityOperator)
    x = jarr(rng, 12)
    np.testing.assert_allclose(np.asarray(U.pinv(U(x))), np.asarray(x), rtol=1e-4, atol=1e-5)
    assert U.opnorm() == 1.0


def test_directional_varying_field(rng, dot_test):
    from pycsou_tpu.ops.diff import FirstDirectionalDerivative

    v = jnp.asarray(rng.standard_normal((2, 8, 8)), jnp.float32)
    d = FirstDirectionalDerivative((8, 8), v)
    dot_test(d)
    # pure-row field reduces to the centered row derivative
    vr = np.zeros((2, 8, 8), np.float32)
    vr[0] = 1.0
    dr = FirstDirectionalDerivative((8, 8), jnp.asarray(vr))
    from pycsou_tpu.ops.diff import fdiff_centered

    x = jarr(rng, 8, 8)
    np.testing.assert_allclose(np.asarray(dr(x)), np.asarray(fdiff_centered(x, 0)), rtol=1e-5)


def test_generalised_laplacian_polynomial(rng, dot_test):
    from pycsou_tpu.ops.diff import GeneralisedLaplacian, Laplacian

    op = GeneralisedLaplacian((10, 10), kind="polynomial", coeffs=[0.5, 1.0], kill_edges=False)
    L = Laplacian((10, 10))
    x = jarr(rng, 10, 10)
    np.testing.assert_allclose(np.asarray(op(x)), np.asarray(0.5 * x + L(x)), rtol=1e-4)
    dot_test(op)


def test_block_operator_validation(rng):
    from pycsou_tpu.ops.basic import DenseOperator
    from pycsou_tpu.ops.stack import BlockOperator

    A = DenseOperator(jarr(rng, 4, 6))
    B = DenseOperator(jarr(rng, 3, 6))
    with pytest.raises(ValueError):
        BlockOperator([[A, B]])  # inconsistent row ranges


def test_solver_verbose_prints(rng, capsys):
    from pycsou_tpu.func import SquaredL2Loss
    from pycsou_tpu.opt import APGD

    y = jarr(rng, 6)
    s = APGD((6,), F=SquaredL2Loss((6,), data=y), max_iter=30, min_iter=30, verbose=10)
    s.solve()
    out = capsys.readouterr().out
    assert "relative improvement" in out

"""Core calculus tests: operator arithmetic, adjoints, Lipschitz propagation,
prox rules — the reference's doctest identities as property tests (SURVEY §4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pycsou_tpu.core.functional import (
    DifferentiableFunctional,
    ProximableFunctional,
)
from pycsou_tpu.core.linop import LinearOperator, LinOpComp, LinOpSum
from pycsou_tpu.ops.basic import (
    DenseOperator,
    DiagonalOperator,
    HomothetyOperator,
    IdentityOperator,
    NullOperator,
    PolynomialOperator,
    SparseOperator,
)


def make_dense(rng, m=7, n=5):
    return DenseOperator(jnp.asarray(rng.standard_normal((m, n)), dtype=jnp.float32))


class _SqL2(DifferentiableFunctional):
    """||x||^2 test functional (beta=2)."""

    def __init__(self, dim_shape):
        super().__init__(dim_shape, diff_lipschitz=2.0)

    def apply(self, x):
        return jnp.sum(x**2)


class _L1(ProximableFunctional):
    def __init__(self, dim_shape):
        super().__init__(dim_shape)

    def apply(self, x):
        return jnp.sum(jnp.abs(x))

    def prox(self, x, tau):
        return jnp.sign(x) * jnp.maximum(jnp.abs(x) - tau, 0.0)


# -------------------- operator algebra --------------------


def test_dense_dot(rng, dot_test):
    dot_test(make_dense(rng))


def test_default_adjoint_via_linear_transpose(rng, dot_test):
    class Weird(LinearOperator):
        w: jax.Array = None

        def __init__(self, w):
            super().__init__(w.shape, w.shape, dtype=np.float32)
            self.w = w

        def apply(self, x):
            return jnp.flip(x) * self.w + jnp.roll(x, 2)

    op = Weird(jnp.asarray(rng.standard_normal(6), dtype=jnp.float32))
    dot_test(op)


def test_sum_comp_adjoints(rng, dot_test):
    A = make_dense(rng, 7, 5)
    B = make_dense(rng, 7, 5)
    C = make_dense(rng, 5, 7)
    dot_test(A + B)
    dot_test(A * C)
    x = jnp.asarray(rng.standard_normal(5), dtype=jnp.float32)
    np.testing.assert_allclose((A + B)(x), A(x) + B(x), rtol=1e-5)
    np.testing.assert_allclose((A @ C)(jnp.ones(7)), A(C(jnp.ones(7))), rtol=1e-5)


def test_scalar_arithmetic(rng):
    A = make_dense(rng)
    x = jnp.asarray(rng.standard_normal(5), dtype=jnp.float32)
    np.testing.assert_allclose((2 * A)(x), 2 * A(x), rtol=1e-5)
    np.testing.assert_allclose((A / 4)(x), A(x) / 4, rtol=1e-5)
    np.testing.assert_allclose((-A)(x), -A(x), rtol=1e-5)
    np.testing.assert_allclose((A - A)(x), jnp.zeros(7), atol=1e-5)


def test_lipschitz_propagation(rng):
    A = make_dense(rng)
    B = make_dense(rng)
    A.lipschitz = 2.0
    B.lipschitz = 3.0
    assert (A + B).lipschitz == 5.0
    C = make_dense(rng, 5, 7)
    C.lipschitz = 4.0
    assert (A * C).lipschitz == 8.0
    assert (2 * A).lipschitz == 4.0
    assert (A + B).diff_lipschitz == 5.0  # linear convention


def test_diff_chain_rule_grad(rng):
    f = _SqL2(7)
    A = make_dense(rng, 7, 5)
    A.lipschitz = float(A.opnorm())
    g = f * A  # x -> ||Ax||^2
    x = jnp.asarray(rng.standard_normal(5), dtype=jnp.float32)
    grad = g.gradient(x)
    expected = 2 * A.adjoint(A(x))
    np.testing.assert_allclose(grad, expected, rtol=1e-4)
    assert np.isclose(g.diff_lipschitz, 2 * A.lipschitz**2, rtol=1e-5)


def test_functional_scale_and_shift(rng):
    f = _SqL2(5)
    x = jnp.asarray(rng.standard_normal(5), dtype=jnp.float32)
    g = 3 * f
    np.testing.assert_allclose(g(x), 3 * f(x), rtol=1e-5)
    np.testing.assert_allclose(g.gradient(x), 3 * f.gradient(x), rtol=1e-5)
    s = jnp.ones(5)
    h = f.shifter(s)
    np.testing.assert_allclose(h(x), f(x + s), rtol=1e-5)


def test_homothety_diag_identity_null(rng, dot_test):
    dot_test(HomothetyOperator(3.5, (4,)))
    d = DiagonalOperator(jnp.asarray(rng.standard_normal(6), dtype=jnp.float32))
    dot_test(d)
    assert np.isclose(d.lipschitz, float(jnp.max(jnp.abs(d.diag))))
    dot_test(IdentityOperator((3, 4)))
    dot_test(NullOperator((5,), (3,)))


def test_polynomial(rng, dot_test):
    L = DenseOperator(jnp.asarray(rng.standard_normal((5, 5)), dtype=jnp.float32))
    P = PolynomialOperator(L, [1.0, 2.0, 3.0])
    x = jnp.asarray(rng.standard_normal(5), dtype=jnp.float32)
    expected = x + 2 * L(x) + 3 * L(L(x))
    np.testing.assert_allclose(P(x), expected, rtol=1e-4)
    dot_test(P)


def test_sparse(rng, dot_test):
    import scipy.sparse as sp

    m = sp.random(8, 6, density=0.3, random_state=1, dtype=np.float32)
    op = SparseOperator(m)
    dot_test(op)
    x = jnp.asarray(rng.standard_normal(6), dtype=jnp.float32)
    np.testing.assert_allclose(op(x), m @ np.asarray(x), rtol=1e-4)


def test_opnorm_power_iteration(rng):
    A = make_dense(rng, 9, 6)
    est = A.opnorm(exact=False)
    exact = float(np.linalg.norm(np.asarray(A.mat), 2))
    assert np.isclose(est, exact, rtol=1e-3)


def test_lanczos_eigs(rng):
    M = rng.standard_normal((8, 8)).astype(np.float32)
    S = DenseOperator(jnp.asarray(M + M.T))
    ev = np.asarray(S.eigenvals(k=3))
    expected = np.linalg.eigvalsh(np.asarray(M + M.T))
    top3 = expected[np.argsort(-np.abs(expected))[:3]]
    np.testing.assert_allclose(np.sort(ev), np.sort(top3), rtol=1e-3)


def test_singularvals(rng):
    A = make_dense(rng, 9, 6)
    sv = np.asarray(A.singularvals(k=2))
    expected = np.linalg.svd(np.asarray(A.mat), compute_uv=False)[:2]
    np.testing.assert_allclose(np.sort(sv), np.sort(expected), rtol=1e-3)


def test_pinv_and_dagger(rng):
    A = make_dense(rng, 8, 5)
    x_true = jnp.asarray(rng.standard_normal(5), dtype=jnp.float32)
    y = A(x_true)
    x_rec = A.pinv(y, tol=1e-10, maxiter=500)
    np.testing.assert_allclose(x_rec, x_true, rtol=1e-3, atol=1e-4)
    x_rec2 = A.PinvOp(y)
    np.testing.assert_allclose(x_rec2, x_true, rtol=1e-3, atol=1e-4)


def test_todense_roundtrip(rng):
    A = make_dense(rng, 7, 5)
    D = A.todense()
    np.testing.assert_allclose(np.asarray(D.mat), np.asarray(A.mat), rtol=1e-5)


def test_gram(rng, dot_test):
    A = make_dense(rng, 7, 5)
    g = A.gram
    x = jnp.asarray(rng.standard_normal(5), dtype=jnp.float32)
    np.testing.assert_allclose(g(x), A.adjoint(A(x)), rtol=1e-5)
    dot_test(g)


# -------------------- prox rules --------------------


def test_prox_postcomp_identity(rng):
    f = _L1(6)
    x = jnp.asarray(rng.standard_normal(6), dtype=jnp.float32)
    g = 2 * f
    np.testing.assert_allclose(g.prox(x, 0.5), f.prox(x, 1.0), rtol=1e-6)


def test_prox_precomp_identity(rng):
    f = _L1(6)
    x = jnp.asarray(rng.standard_normal(6), dtype=jnp.float32)
    g = f * 2.0  # f(2x)
    tau = 0.3
    np.testing.assert_allclose(g.prox(x, tau), f.prox(2 * x, tau * 4) / 2, rtol=1e-6)
    np.testing.assert_allclose(g(x), f(2 * x), rtol=1e-6)


def test_prox_affine_sum(rng):
    from pycsou_tpu.func.base import ExplicitLinearFunctional

    f = _L1(6)
    v = jnp.asarray(rng.standard_normal(6), dtype=jnp.float32)
    lf = ExplicitLinearFunctional(v)
    g = f + lf
    x = jnp.asarray(rng.standard_normal(6), dtype=jnp.float32)
    tau = 0.7
    np.testing.assert_allclose(g.prox(x, tau), f.prox(x - tau * v, tau), rtol=1e-5)


def test_moreau_identity(rng):
    f = _L1(6)
    x = jnp.asarray(rng.standard_normal(6), dtype=jnp.float32)
    tau = 0.8
    # Moreau decomposition: x = prox_{tau f}(x) + tau * prox_{f*/tau}(x/tau)
    decomp = f.prox(x, tau) + f.fenchel_prox(x, 1 / tau) * tau / tau
    lhs = f.prox(x, tau) + tau * (x / tau - (1 / tau) * f.prox(x, tau))
    np.testing.assert_allclose(lhs, x, rtol=1e-5)
    # fenchel_prox of L1 is projection onto Linf ball
    fp = f.fenchel_prox(x, 0.5)
    np.testing.assert_allclose(fp, jnp.clip(x, -1, 1), rtol=1e-5)


def test_jit_through_composed_operator(rng):
    """A composed operator expression is a pytree: jit once, call many."""
    A = make_dense(rng, 7, 5)
    B = make_dense(rng, 7, 5)
    op = 2 * A + B

    @jax.jit
    def run(op, x):
        return op.apply(x)

    x = jnp.asarray(rng.standard_normal(5), dtype=jnp.float32)
    np.testing.assert_allclose(run(op, x), 2 * A(x) + B(x), rtol=1e-5)


def test_diverged_solve_terminates():
    """A NaN stopping metric must run to max_iter and return converged=False
    — not deadlock solve()'s host loop (NaN > tol and NaN <= tol are both
    False)."""
    import jax.numpy as jnp

    from pycsou_tpu.core.solver import IterativeSolver

    class Diverges(IterativeSolver):
        def initial_state(self):
            return {"x": jnp.ones(4)}

        def step(self, state):
            return {"x": state["x"] * jnp.inf}  # -> NaN rel improvement

    info = Diverges(max_iter=20, min_iter=1, tol=1e-6).solve()
    assert info.n_iter == 20 and not info.converged


def test_run_fixed_grows_history():
    """Chained run_fixed beyond max_iter must keep recording history (the
    buffer is re-padded; OOB scatters would silently drop rows)."""
    import jax.numpy as jnp
    import numpy as np

    from pycsou_tpu.core.solver import IterativeSolver

    class Halve(IterativeSolver):
        def initial_state(self):
            return {"x": jnp.ones(4)}

        def step(self, state):
            return {"x": 0.5 * state["x"]}

    s = Halve(max_iter=10)
    st = s.run_fixed(8)
    st = s.run_fixed(8, state=st)
    assert int(st["it"]) == 16
    hist = np.asarray(st["history"])[:16]
    assert np.isfinite(hist).all() and hist.shape[0] == 16


def test_run_fixed_growth_recompiles_at_most_once():
    """Chained run_fixed calls past max_iter must trigger at most ONE
    recompile (geometric history growth).  Round 3 regression: linear
    per-call padding produced a fresh history SHAPE on every call, so the
    benchmark recompiled _run_fixed inside every timed chunk and the
    measured headline rate halved."""
    import jax.numpy as jnp

    from pycsou_tpu.core.solver import IterativeSolver, _run_fixed

    class Halve(IterativeSolver):
        def initial_state(self):
            return {"x": jnp.ones(4)}

        def step(self, state):
            return {"x": 0.5 * state["x"]}

    s = Halve(max_iter=100)
    before = _run_fixed._cache_size()
    st = s.run_fixed(60)          # compile 1 (initial 101-row history)
    for _ in range(2):            # crosses the allocation once; doubling
        st = s.run_fixed(60, state=st)  # (101 -> 202) covers both calls
    assert int(st["it"]) == 180
    compiles = _run_fixed._cache_size() - before
    assert compiles <= 2, f"history growth recompiled {compiles - 1} times"


def test_checkpoint_rejects_shape_mismatch(tmp_path):
    """A checkpoint whose leaves have different shapes (solver reconfigured)
    must be rejected, not silently loaded positionally."""
    import jax.numpy as jnp
    import pytest as _pytest

    from pycsou_tpu.utils.checkpoint import load_state, save_state

    good = {"x": jnp.ones((4, 4)), "it": jnp.asarray(3, jnp.int32)}
    save_state(str(tmp_path / "step_3"), good)
    bad_template = {"x": jnp.ones((8, 8)), "it": jnp.asarray(0, jnp.int32)}
    with _pytest.raises(ValueError, match="shape"):
        load_state(str(tmp_path / "step_3"), template=bad_template)
    # different key set -> structural error
    bad_keys = {"y": jnp.ones((4, 4)), "it": jnp.asarray(0, jnp.int32)}
    with _pytest.raises(ValueError, match="structure"):
        load_state(str(tmp_path / "step_3"), template=bad_keys)

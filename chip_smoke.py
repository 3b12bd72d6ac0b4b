#!/usr/bin/env python
"""Smoke test of the solver stack on one NVIDIA GPU (or four, ``--four``).

    python chip_smoke.py          # one card: phases (a), (b), (d), (e)
    python chip_smoke.py --four   # four cards: the sharded solvers only

Phases (one card):

(a) device — exits non-zero unless JAX's first device is a GPU; prints the
    card's name and power limit (nvidia-smi) and ``XLA_FLAGS``.
(b) flagship — the user expression ``PDS(SquaredL2Loss * Convolve2D,
    NonNegativeOrthant, lam * L21Norm, Gradient)`` at 4096^2 (15x15
    Gaussian PSF, lam = 0.05, as in bench.py), fused and unfused, each
    compared after 100 iterations with a plain float32 Condat-Vu reference
    written here (FFT 'same' convolution); then ``solve()`` to the default
    tolerance, the step's ``memory_analysis()`` and the peak device memory.
(d) every other pattern the PDS/APGD matcher rewrites — anisotropic TV,
    inpainting, 4096^2 denoising, blur + mask, a rank-2 PSF, LASSO — a few
    iterations each against its unfused generic chain; PMYULA at 2048^2
    against a plain Langevin loop; ``Convolve2D`` apply/adjoint/Gram for
    rank 1, 2, 6 and full-rank kernels against the FFT reference; the DCT
    against scipy.
(e) timings of the convolution routes, the TV stencil and the flagship.

``--four`` runs only the sharded path on four cards — DistributedTVDeconv2D
(rows over 4 devices), Spatial2DTVDeconv2D (2x2 mesh), the generic PDS
``with_shardings`` re-dispatch and ConsensusADMM (psum) — each against its
single-device result.

Any failed check raises, so the exit code is non-zero and the result line
is not printed.  The last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from pycsou_tpu.utils.compile_cache import enable_compile_cache

SHAPE = (4096, 4096)
KSIZE = 15
LAM = 0.05
# float32 iterates of two different convolution algorithms (banded matmuls
# at HIGHEST precision or FFTs vs the reference's FFT): each Gram apply
# agrees to ~1e-6 relative, and 100 iterations of the (nonexpansive) PDS map
# accumulate at most about 100x that
ITER_RTOL = 1e-4
# one convolution apply: float32 FFT / matmul rounding at 4096^2
OP_RTOL = 1e-5


def log(*a):
    print(*a, flush=True)


def check(name, err, tol):
    ok = bool(np.isfinite(err)) and err <= tol
    log(f"  {name}: rel err {err:.3e} (tol {tol:.0e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise RuntimeError(f"{name}: relative error {err:.3e} exceeds {tol:.0e}")


def rel(a, b):
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    return float(jnp.linalg.norm(a - b) / jnp.maximum(jnp.linalg.norm(b), 1e-30))


class phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"[phase {self.name}]")

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[phase {self.name}] done in {time.perf_counter() - self.t0:.1f} s")
        return False


# --------------------------- problem and reference ---------------------------


def gaussian_kernel(k=KSIZE, sigma=2.0):
    ax = np.arange(k) - k // 2
    g = np.exp(-(ax**2) / (2 * sigma**2))
    g2 = np.outer(g, g)
    return (g2 / g2.sum()).astype(np.float32)


def rank2_kernel(k=KSIZE):
    ax = np.arange(k) - k // 2
    g = lambda s: np.exp(-(ax**2) / (2 * s**2))
    h2 = np.outer(g(2.0), g(2.0)) + 0.35 * np.outer(g(0.8), g(4.0))
    return (h2 / h2.sum()).astype(np.float32)


def rank6_kernel(k=KSIZE):
    r = np.random.default_rng(11)
    h = (r.standard_normal((k, 6)) @ r.standard_normal((k, 6)).T).astype(np.float32)
    return h / np.abs(h).sum()


def fullrank_kernel(k=KSIZE):
    h = np.abs(np.random.default_rng(7).standard_normal((k, k))).astype(np.float32)
    return h / h.sum()


class FFTConv:
    """Plain 'same' convolution with the centre offset m // 2 and its
    adjoint, by zero-padded FFTs — the reference every route is held to."""

    def __init__(self, shape, h):
        self.shape = shape
        m0, m1 = h.shape
        self.o = (m0 // 2, m1 // 2)
        self.s = (shape[0] + m0 - 1, shape[1] + m1 - 1)
        self.hf = jnp.fft.rfft2(jnp.asarray(h, jnp.float32), s=self.s)

    def apply(self, x):
        (o0, o1), (H, W) = self.o, self.shape
        full = jnp.fft.irfft2(jnp.fft.rfft2(x, s=self.s) * self.hf, s=self.s)
        return full[o0 : o0 + H, o1 : o1 + W]

    def adjoint(self, r):
        (o0, o1), (H, W) = self.o, self.shape
        full = jnp.zeros(self.s, jnp.float32).at[o0 : o0 + H, o1 : o1 + W].set(r)
        return jnp.fft.irfft2(jnp.fft.rfft2(full) * jnp.conj(self.hf), s=self.s)[:H, :W]


def _grad(u):
    return (
        jnp.pad(u[1:] - u[:-1], ((0, 1), (0, 0))),
        jnp.pad(u[:, 1:] - u[:, :-1], ((0, 0), (0, 1))),
    )


def _div_t(z0, z1):
    z0 = z0.at[-1].set(0.0)
    z1 = z1.at[:, -1].set(0.0)
    return (jnp.pad(z0[:-1], ((1, 0), (0, 0))) - z0) + (jnp.pad(z1[:, :-1], ((0, 0), (1, 0))) - z1)


def reference_condat_vu(y, h, lam, tau, sigma, rho, n):
    """Plain float32 Condat-Vu for ``||h * x - y||^2 + lam ||grad x||_{2,1}
    + i_{x >= 0}`` (reference update rule proxalgs.py:343-355)."""
    A = FFTConv(y.shape, h)

    @jax.jit
    def run(y):
        def body(_, s):
            x, z0, z1 = s
            g = 2.0 * A.adjoint(A.apply(x) - y)
            xt = jnp.maximum(x - tau * g - tau * _div_t(z0, z1), 0.0)
            d0, d1 = _grad(2.0 * xt - x)
            v0, v1 = z0 + sigma * d0, z1 + sigma * d1
            sc = lam / jnp.maximum(jnp.sqrt(v0 * v0 + v1 * v1), lam)
            return (
                rho * xt + (1 - rho) * x,
                rho * v0 * sc + (1 - rho) * z0,
                rho * v1 * sc + (1 - rho) * z1,
            )

        zero = jnp.zeros(y.shape, jnp.float32)
        return jax.lax.fori_loop(0, n, body, (zero, zero, zero))[0]

    with jax.default_matmul_precision("highest"):
        return run(y)


def make_problem(shape=SHAPE, seed=0):
    from scipy.signal import fftconvolve

    rng = np.random.default_rng(seed)
    h = gaussian_kernel()
    x_true = np.abs(rng.standard_normal(shape)).astype(np.float32)
    y = fftconvolve(x_true, h, mode="same").astype(np.float32)
    y += 0.01 * rng.standard_normal(shape).astype(np.float32)
    return h, jnp.asarray(y)


def tv_pds(shape, F, lam, iso=True, nonneg=True, fuse=True, **kw):
    from pycsou_tpu.func import NonNegativeOrthant
    from pycsou_tpu.func.penalty import L1Norm, L21Norm
    from pycsou_tpu.ops.diff import Gradient
    from pycsou_tpu.opt import PDS

    H, W = shape
    pen = L21Norm((2, H, W), axis=0) if iso else L1Norm((2, H, W))
    return PDS(
        shape, F=F, G=NonNegativeOrthant(shape) if nonneg else None,
        H=lam * pen, K=Gradient(shape), fuse=fuse, **kw,
    )


def engine(solver):
    f = getattr(solver, "_fused", None)
    if f is None:
        return "generic chain"
    gram = getattr(f, "gram", None)
    conv = getattr(f, "conv", None)
    route = type(gram).__name__ if gram is not None else (
        f"conv {conv.method} + mask" if conv is not None else
        ("diagonal mask" if getattr(f, "mask", None) is not None else "identity")
    )
    return f"{type(f).__name__} (data gradient: {route})"


def time_loop(f, v, n=50, reps=3):
    """ms per application of ``f`` chained ``n`` times, best of ``reps``."""
    damp = lambda a: jax.tree_util.tree_map(lambda t: t * 0.999, a)
    fl = jax.jit(lambda v: jax.lax.fori_loop(0, n, lambda i, a: damp(f(a)), v))
    jax.block_until_ready(fl(v))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fl(v))
        best = min(best, time.perf_counter() - t0)
    return best / n * 1e3


def time_solver(solver, n=100, reps=3):
    st = solver.run_fixed(n)
    jax.block_until_ready(st["x"])
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        st = solver.run_fixed(n, state=st)
        jax.block_until_ready(st["x"])
        best = min(best, (time.perf_counter() - t0) / n)
    return best


# --------------------------- phases ------------------------------------------


def phase_device(n_expected):
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        print(f"no GPU: JAX's first device is {d.platform!r} ({d.device_kind})", file=sys.stderr)
        sys.exit(2)
    if len(devs) < n_expected:
        print(f"need {n_expected} GPUs, JAX sees {len(devs)}", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    for line in smi.splitlines():
        log(line)
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"jax {jax.__version__}, {len(devs)} x {d.device_kind}, compile cache {enable_compile_cache()}")
    return d


def phase_flagship(h, y):
    from pycsou_tpu.func import SquaredL2Loss
    from pycsou_tpu.ops.conv import Convolve2D

    A = Convolve2D(SHAPE, h)
    F = SquaredL2Loss(SHAPE, data=y) * A
    fused = tv_pds(SHAPE, F, LAM)
    log(f"  fusion chose: {engine(fused)}; conv route {A.method}")
    ref = reference_condat_vu(y, h, LAM, fused.tau, fused.sigma, fused.rho, 100)
    check("fused PDS x after 100 its vs reference", rel(fused.run_fixed(100)["x"], ref), ITER_RTOL)
    generic = tv_pds(SHAPE, F, LAM, fuse=False)
    check("unfused PDS x after 100 its vs reference", rel(generic.run_fixed(100)["x"], ref), ITER_RTOL)
    del generic
    info = fused.solve()
    log(f"  solve(): {info.n_iter} iterations, converged={info.converged}, "
        f"{info.elapsed:.2f} s (compile included), tol {fused.tol:g}")
    if not np.all(np.isfinite(np.asarray(info["x"]))):
        raise RuntimeError("solve() returned non-finite values")
    st = fused._wrap_state(fused.initial_state())
    compiled = jax.jit(fused.step).lower(st).compile()
    log(f"  step memory_analysis: {compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    return fused


def phase_patterns(h, y):
    from pycsou_tpu.func import SquaredL2Loss
    from pycsou_tpu.func.penalty import L1Norm
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.ops.sampling import Masking
    from pycsou_tpu.opt import APGD

    n = 20
    A = Convolve2D(SHAPE, h)
    keep = np.random.default_rng(13).random(SHAPE) < 0.7
    M = Masking(SHAPE, keep)
    cases = {
        "anisotropic TV": lambda fuse: tv_pds(SHAPE, SquaredL2Loss(SHAPE, data=y) * A, LAM, iso=False, fuse=fuse),
        "inpainting (mask)": lambda fuse: tv_pds(SHAPE, SquaredL2Loss(M.codim_shape, data=M(y)) * M, LAM, fuse=fuse),
        "denoise 4096^2": lambda fuse: tv_pds(SHAPE, SquaredL2Loss(SHAPE, data=y), LAM, fuse=fuse),
        "blur + mask": lambda fuse: tv_pds(SHAPE, SquaredL2Loss(M.codim_shape, data=M(y)) * (M * A), LAM, fuse=fuse),
        "rank-2 PSF": lambda fuse: tv_pds(SHAPE, SquaredL2Loss(SHAPE, data=y) * Convolve2D(SHAPE, rank2_kernel()), LAM, fuse=fuse),
        "LASSO (FISTA)": lambda fuse: APGD(SHAPE, F=SquaredL2Loss(SHAPE, data=y) * A, G=0.01 * L1Norm(SHAPE), fuse=fuse),
    }
    for name, mk in cases.items():
        fused = mk(True)
        if fused._fused is None:
            raise RuntimeError(f"{name}: the matcher did not fuse")
        log(f"  {name}: fusion chose {engine(fused)}")
        a = fused.run_fixed(n)["x"]
        del fused
        b = mk(False).run_fixed(n)["x"]
        check(f"{name} fused vs generic, {n} its", rel(a, b), ITER_RTOL)

    phase_pmyula(h, m=SHAPE[0] // 2)

    x = jnp.asarray(np.random.default_rng(21).standard_normal(SHAPE), jnp.float32)
    for name, k in (("rank 1", h), ("rank 2", rank2_kernel()), ("rank 6", rank6_kernel()), ("full rank", fullrank_kernel())):
        op = Convolve2D(SHAPE, k)
        R = FFTConv(SHAPE, k)
        log(f"  Convolve2D {name}: route {op.method}, Gram {type(op.gram).__name__}")
        with jax.default_matmul_precision("highest"):
            ra, rt = R.apply(x), R.adjoint(x)
            rg = R.adjoint(ra)
        check(f"Convolve2D {name} apply", rel(op.apply(x), ra), OP_RTOL)
        check(f"Convolve2D {name} adjoint", rel(op.adjoint(x), rt), OP_RTOL)
        check(f"Convolve2D {name} gram", rel(op.gram.apply(x), rg), OP_RTOL)

    import scipy.fft

    from pycsou_tpu.ops.transform import DCTOperator

    v = np.random.default_rng(4).standard_normal((512, 512)).astype(np.float32)
    D = DCTOperator((512, 512))
    check("DCT-II 512^2 vs scipy (float64)", rel(D.apply(jnp.asarray(v)), scipy.fft.dctn(v.astype(np.float64), norm="ortho")), OP_RTOL)
    check("DCT-III 512^2 vs scipy (float64)", rel(D.adjoint(jnp.asarray(v)), scipy.fft.idctn(v.astype(np.float64), norm="ortho")), OP_RTOL)


def phase_pmyula(h, m, n=20):
    """PMYULA's Langevin chain against a plain loop with the same keys."""
    from scipy.signal import fftconvolve

    from pycsou_tpu.func import SquaredL2Loss
    from pycsou_tpu.func.penalty import L1Norm
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.opt.mcmc import PMYULA

    rng = np.random.default_rng(6)
    x_true = np.abs(rng.standard_normal((m, m))).astype(np.float32)
    ym = jnp.asarray(fftconvolve(x_true, h, mode="same").astype(np.float32))
    A = Convolve2D((m, m), h)
    s = PMYULA((m, m), F=SquaredL2Loss((m, m), data=ym) * A, G=0.01 * L1Norm((m, m)),
               seed=3, nb_burnin_iterations=5, max_iter=200)
    got = s.run_fixed(n)
    R = FFTConv((m, m), h)
    g, t = s.gamma, s.tau

    @jax.jit
    def ref(x, key):
        def body(_, c):
            x, key = c
            key, sub = jax.random.split(key)
            xi = jax.random.normal(sub, x.shape, dtype=x.dtype)
            grad = 2.0 * R.adjoint(R.apply(x) - ym)
            prox = jnp.sign(x) * jnp.maximum(jnp.abs(x) - 0.01 * t, 0.0)
            return (1 - g / t) * x - g * grad + (g / t) * prox + jnp.sqrt(2 * g) * xi, key
        return jax.lax.fori_loop(0, n, body, (x, key))[0]

    with jax.default_matmul_precision("highest"):
        want = ref(jnp.zeros((m, m), jnp.float32), jax.random.PRNGKey(3))
    log(f"  PMYULA {m}^2: generic Langevin chain, {int(got['count'])} samples collected")
    check(f"PMYULA {m}^2 x after {n} steps vs plain Langevin loop", rel(got["x"], want), ITER_RTOL)


def phase_timings(h, y, fused):
    from pycsou_tpu.kernels.tv import tv_pds_stencil_step_xla
    from pycsou_tpu.ops.conv import Convolve2D

    x = jnp.asarray(np.random.default_rng(22).random(SHAPE), jnp.float32)
    log("  route timings at 4096^2 (ms per op, chained, best of 3):")
    for name, k in (("rank 1", h), ("rank 2", rank2_kernel()), ("rank 6", rank6_kernel()), ("full rank", fullrank_kernel())):
        for method in ("band", "fft", "direct"):
            try:
                op = Convolve2D(SHAPE, k, method=method)
            except ValueError:
                continue
            log(f"    {name:9s} {method:6s} apply {time_loop(op.apply, x):.3f}  adjoint {time_loop(op.adjoint, x):.3f}")
        op = Convolve2D(SHAPE, k)
        log(f"    {name:9s} auto={op.method}: gram ({type(op.gram).__name__}) {time_loop(op.gram.apply, x):.3f}")
    kw = dict(tau=0.1, sigma=0.1, rho=0.9, lam=LAM, nonneg=True, iso=True)
    g = 0.1 * jnp.asarray(np.random.default_rng(23).standard_normal(SHAPE), jnp.float32)
    step = lambda s: tv_pds_stencil_step_xla(s[0], s[1], s[2], g, **kw)
    z = jnp.zeros(SHAPE, jnp.float32)
    log(f"    TV stencil step (XLA fusion, 4 reads + 3 writes): {time_loop(step, (x, z, z)):.3f}")
    t = time_solver(fused._fused)
    log(f"    flagship TVDeconvolution run_fixed: {t * 1e3:.4f} ms/iter -> {1 / t:.1f} iters/s")


def phase_four(h, y):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pycsou_tpu.func import SquaredL2Loss
    from pycsou_tpu.ops.conv import Convolve2D
    from pycsou_tpu.opt import TVDeconvolution
    from pycsou_tpu.opt.admm import ConsensusADMM
    from pycsou_tpu.parallel import make_mesh
    from pycsou_tpu.parallel.solvers import DistributedTVDeconv2D, Spatial2DTVDeconv2D

    n = 50
    devs = set(jax.devices()[:4])

    def spread(name, x):
        shards = x.addressable_shards
        where = {s.device for s in shards}
        log(f"  {name}: {len(shards)} shards of {shards[0].data.shape} on {len(where)} devices")
        if where != devs:
            raise RuntimeError(f"{name}: state is not spread over the 4 devices")

    mesh1 = make_mesh((4,), ("sp",))
    dist = DistributedTVDeconv2D(SHAPE, h, y, LAM, mesh=mesh1, max_iter=1000)
    xd, _ = dist.run(n)
    spread("DistributedTVDeconv2D x", xd)
    mesh2 = make_mesh((2, 2), ("sp0", "sp1"))
    sp2 = Spatial2DTVDeconv2D(SHAPE, h, y, LAM, mesh=mesh2, max_iter=1000)
    xs, _ = sp2.run(n)
    spread("Spatial2DTVDeconv2D x", xs)
    F = SquaredL2Loss(SHAPE, data=y) * Convolve2D(SHAPE, h)
    gp = tv_pds(SHAPE, F, LAM, max_iter=1000).with_shardings(x=NamedSharding(mesh1, P("sp", None)))
    log(f"  generic PDS with_shardings re-dispatched to: {type(gp._fused).__name__}")
    xg = gp.run_fixed(n)["x"]
    spread("PDS.with_shardings x", xg)
    for i, d in enumerate(jax.devices()[:4]):
        log(f"  device {i} peak_bytes_in_use after the sharded phases: {(d.memory_stats() or {}).get('peak_bytes_in_use')}")

    single = TVDeconvolution(SHAPE, y, LAM, filt=h, tau=dist.tau, max_iter=1000).run_fixed(n)["x"]
    check(f"DistributedTVDeconv2D 4 devices vs single device, {n} its", rel(xd, single), ITER_RTOL)
    check(f"Spatial2DTVDeconv2D 2x2 vs single device, {n} its", rel(xs, single), ITER_RTOL)
    check(f"PDS.with_shardings vs single device, {n} its", rel(xg, single), ITER_RTOL)
    for name, solver in (("DistributedTVDeconv2D 4 devices", dist), ("Spatial2DTVDeconv2D 2x2", sp2),
                         ("TVDeconvolution 1 device", TVDeconvolution(SHAPE, y, LAM, filt=h, max_iter=1000))):
        t = time_solver(solver)
        log(f"  {name}: {t * 1e3:.4f} ms/iter -> {1 / t:.1f} iters/s")

    # consensus ADMM over 4 scenario shards (BASELINE config 5 geometry)
    d, S = 64, 8
    rng = np.random.default_rng(5)
    x3 = np.abs(rng.standard_normal((d, d, d))).astype(np.float32)
    h_hats, data = [], []
    for _ in range(S):
        psf = np.zeros((d, d, d), np.float32)
        psf[:3, :3, :3] = rng.random((3, 3, 3)).astype(np.float32)
        psf /= psf.sum()
        H3 = np.fft.rfftn(psf)
        h_hats.append(H3)
        blur = np.fft.irfftn(np.fft.rfftn(x3) * H3, s=(d, d, d)).astype(np.float32)
        data.append(blur + 0.01 * rng.standard_normal((d, d, d)).astype(np.float32))
    admm = ConsensusADMM((d, d, d), h_hats=np.stack(h_hats), data=np.stack(data), rho=1.0,
                         mesh=make_mesh((4,), ("dp",)), max_iter=1000)
    zc = admm.run(n)
    spread("ConsensusADMM u", admm.run_fixed(1)["u"])
    Hs = np.stack(h_hats).astype(np.complex128)
    Ys = np.stack([np.fft.rfftn(v) for v in data])
    z = np.zeros((d, d, d))
    u = np.zeros((S, d, d, d))
    for _ in range(n):
        V = np.fft.rfftn(z[None] - u, axes=(1, 2, 3))
        X = (2 * np.conj(Hs) * Ys + V) / (2 * np.abs(Hs) ** 2 + 1.0)
        xs_ = np.fft.irfftn(X, s=(d, d, d), axes=(1, 2, 3))
        z = (xs_ + u).mean(axis=0)
        u = u + xs_ - z[None]
    check(f"ConsensusADMM (psum over 4 devices) vs float64 numpy, {n} its", rel(zc, z), ITER_RTOL)


def main():
    four = "--four" in sys.argv[1:]
    n_dev = 4 if four else 1
    dev = phase_device(n_dev)
    h, y = make_problem()
    if four:
        with phase("four-card sharded solvers"):
            phase_four(h, y)
    else:
        with phase("b flagship 4096^2"):
            fused = phase_flagship(h, y)
        with phase("d other fused patterns"):
            phase_patterns(h, y)
        with phase("e timings"):
            phase_timings(h, y, fused)
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()

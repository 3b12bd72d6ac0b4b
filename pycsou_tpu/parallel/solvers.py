"""Distributed solvers: mesh-sharded PDS for TV-regularised deconvolution.

The flagship multi-device path (BASELINE configs 3/5): the image, measurement
and dual variables are row-sharded over a 1-D mesh; one PDS iteration is a
single ``shard_map``-ped XLA computation in which

* the blur and its adjoint run as overlap-save FFT convolutions with
  ``ppermute`` halo exchange (spatial.py),
* the TV gradient/divergence exchange one halo row,
* the L21 fenchel-prox and the nonnegativity prox are purely local,
* no collective other than the halos is needed inside an iteration.

Both solvers are first-class :class:`~pycsou_tpu.core.solver.IterativeSolver`
subclasses (VERDICT r1 task 3): the state lives as GLOBAL sharded
``jax.Array``s, so the base driver's stopping metric (a ``jnp.vdot`` that
GSPMD all-reduces over the mesh), on-device history, per-variable
diagnostics, checkpoint/resume and ``SolveInfo`` all apply unchanged — a
distributed solve can assert "converged to 1e-6".

The reference has no distributed solver at all (SURVEY §2.6); this replaces
its joblib/Dask story.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from pycsou_tpu._module import static_field
from pycsou_tpu.core.solver import IterativeSolver
from pycsou_tpu.parallel.mesh import make_mesh
from pycsou_tpu.parallel.spatial import (
    conv_transfer,
    sharded_conv2d,
    sharded_conv2d_adjoint,
    sharded_conv2d_gram,
    sharded_grad2d,
    sharded_grad2d_adjoint,
    sharded_sepgram_rank1,
)

__all__ = ["DistributedTVDeconv2D", "BatchedDistributedTVDeconv2D", "Spatial2DTVDeconv2D"]


def _split(c):
    return (jnp.real(c), jnp.imag(c))


def _join(pair):
    return jax.lax.complex(pair[0], pair[1])


class DistributedTVDeconv2D(IterativeSolver):
    r"""Condat-Vu PDS for ``min_x ||h * x - y||^2 + lam ||grad x||_{2,1}
    (+ nonnegativity)`` on an image row-sharded over a device mesh.

    Mathematics identical to ``opt.proxalgs.PrimalDualSplitting`` with
    F = SquaredL2Loss o Convolve2D, H = lam * L21Norm(axis=0), K = Gradient,
    G = NonNegativeOrthant (reference update rule proxalgs.py:343-355);
    auto step sizes from the same formulas (proxalgs.py:246-316).

    Example — deconvolve on whatever mesh the host exposes::

        >>> import jax, jax.numpy as jnp
        >>> from pycsou_tpu.parallel import DistributedTVDeconv2D, make_mesh
        >>> H = 8 * jax.device_count()
        >>> h = jnp.ones((3, 3)) / 9.0
        >>> y = jnp.zeros((H, 16)).at[H // 2, 8].set(1.0)
        >>> solver = DistributedTVDeconv2D((H, 16), h, y, lam=0.01,
        ...                                max_iter=50, min_iter=5,
        ...                                accuracy_threshold=1e-4)
        >>> info = solver.solve()   # state stays sharded over the mesh
        >>> info["x"].shape == (H, 16) and info.n_iter > 0
        True
    """

    y: jax.Array = None
    filt: jax.Array = None
    atb: jax.Array = None
    # diagonal-Gram (sampling-operator) mode: A^H A = diag(mask) — the
    # distributed realisation of opt/tv.py's inpainting/superres mode.
    # grad is elementwise per shard.
    mask: jax.Array = None
    # rFFT transfer functions, split re/im (split-real keeps closure-jit
    # usable)
    _h_hat_fwd: tuple = None
    _h_hat_adj: tuple = None
    _acorr_hat: tuple = None
    # rank-1 banded Gram plans (no FFT in the hot loop when set): arrays
    # (b0, b1, E_top, E_bot) per axis from kernels.band.make_gram_band; the
    # static ints (lead, L) live in _band_meta so slice bounds stay static
    _band_rows: tuple = None
    _band_cols: tuple = None
    # channel-conv form of the LOCAL column-Gram pass (lane axis unsharded;
    # kernels.band.make_chanconv) — no pad copy, matmul work ~ CHAN_TILE/128
    _band_cols_chan: jax.Array = None
    lam: float = static_field(default=0.1)
    tau: float = static_field(default=0.1)
    sigma: float = static_field(default=0.1)
    rho: float = static_field(default=0.9)
    beta: float = static_field(default=2.0)
    nonneg: bool = static_field(default=True)
    # isotropic (L21) vs anisotropic (L1 o Gradient) TV: the engines only
    # differ in the per-pixel dual projection (kernels/tv.py _dual_prox)
    iso: bool = static_field(default=True)
    mesh: Mesh = static_field(default=None)
    axis_name: str = static_field(default="sp")
    shape: Tuple[int, int] = static_field(default=None)
    _use_gram: bool = static_field(default=True)
    _use_band: bool = static_field(default=False)
    _band_meta: tuple = static_field(default=None)  # (lead_r, L_r, lead_c, L_c)
    def __init__(
        self,
        shape: Tuple[int, int],
        filt,
        y,
        lam: float,
        nonneg: bool = True,
        mesh: Optional[Mesh] = None,
        axis_name: str = "sp",
        tau: Optional[float] = None,
        rho: float = 0.9,
        dtype=jnp.float32,
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-6,
        verbose: Optional[int] = None,
        isotropic: bool = True,
        mask=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold, verbose=verbose)
        self.iso = bool(isotropic)
        H, W = shape
        self.mesh = mesh if mesh is not None else make_mesh(axis_names=(axis_name,))
        if len(self.mesh.axis_names) != 1:
            raise ValueError(
                "DistributedTVDeconv2D shards rows over a 1-D mesh; got axes "
                f"{self.mesh.axis_names} (use BatchedDistributedTVDeconv2D / "
                "Spatial2DTVDeconv2D for 2-D meshes)"
            )
        self.axis_name = self.mesh.axis_names[0]
        n_dev = self.mesh.devices.size
        if H % n_dev:
            raise ValueError(f"image height {H} must divide over {n_dev} devices")
        self.shape = (H, W)
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        self.rho = float(rho)

        self.mask = None
        if mask is not None:
            # diagonal-Gram (sampling-operator) mode, the distributed twin
            # of opt/tv.py's inpainting mode: ``y`` is the back-projected
            # data A^H y, grad = 2 (mask * x - atb) elementwise per shard.
            if filt is not None:
                raise ValueError(
                    "mask mode models a diagonal sampling forward operator; "
                    "pass filt=None"
                )
            m = jnp.asarray(mask, dtype)
            if m.shape != (H, W):
                raise ValueError(f"mask shape {m.shape} != image shape {(H, W)}")
            self.filt = None
            beta = 2.0 * float(jnp.max(m))
            L_K = math.sqrt(8.0)
            if tau is None:
                tau = (1.0 / L_K**2) * (-beta / 4 + math.sqrt(beta**2 / 16 + L_K**2))
            self.tau = self.sigma = float(tau)
            self.beta = beta
            spec_x = NamedSharding(self.mesh, PartitionSpec(self.axis_name, None))
            self.y = jax.device_put(jnp.asarray(y, dtype), spec_x)
            self.atb = self.y
            self.mask = jax.device_put(m, spec_x)
            self._h_hat_fwd = self._h_hat_adj = self._acorr_hat = None
            self._use_gram = self._use_band = False
            self._band_rows = self._band_cols = None
            return

        self.filt = jnp.asarray(filt, dtype)

        # Lipschitz constants, closed form (no ARPACK):
        pad = (H + self.filt.shape[0] - 1, W + self.filt.shape[1] - 1)
        Hf = np.fft.fftn(np.asarray(self.filt, np.float64), s=pad, axes=(0, 1))
        L_A = float(np.max(np.abs(Hf)))
        beta = 2.0 * L_A**2
        L_K = math.sqrt(8.0)  # ||Gradient||_2 <= sqrt(sum_axis (2/step)^2)
        if tau is None:
            tau = (1.0 / L_K**2) * (-beta / 4 + math.sqrt(beta**2 / 16 + L_K**2))
        self.tau = self.sigma = float(tau)
        self.beta = beta

        # precomputed transfer functions for the halo-extended local blocks
        h_local = H // n_dev
        m0 = self.filt.shape[0]
        # halo widths: forward conv needs (m0-1-m0//2) rows from the previous
        # neighbour and m0//2 from the next (adjoint: the complements).  A
        # ppermute halo only reaches ONE neighbour, so the local block must
        # hold the widest halo we ever send (ADVICE r1: validate explicitly
        # instead of failing with an FFT shape mismatch).
        min_rows = max(1, m0 // 2, m0 - 1 - m0 // 2)
        if h_local < min_rows:
            raise ValueError(
                f"local block of {h_local} rows is too short for a "
                f"{m0}-row kernel: need at least {min_rows} rows per device "
                f"(H={H} over {n_dev} devices; use fewer devices or a taller image)"
            )
        ext_shape = (h_local + m0 - 1, W)
        self._h_hat_fwd = _split(conv_transfer(self.filt, ext_shape))
        self._h_hat_adj = _split(conv_transfer(jnp.flip(self.filt, (0, 1)), ext_shape))
        # fused-Gram path: autocorrelation transfer for the (m-1)-halo block
        from pycsou_tpu.ops._gram import conv_full_direct

        acorr = conv_full_direct(self.filt, jnp.flip(self.filt, (0, 1)))
        self._acorr_hat = _split(conv_transfer(acorr, (h_local + 2 * (m0 - 1), W)))
        self._use_gram = h_local >= m0  # gram strips need block >= kernel

        # rank-1 banded Gram (kernels/band.py): same (m0-1)-row halo as the
        # FFT overlap-save path, but the local work per iteration is banded
        # matmul passes instead of an FFT roundtrip (the faster rank-1 Gram
        # on one H100, PERF.md)
        m1 = self.filt.shape[1]
        self._band_rows = self._band_cols = None
        self._use_band = False
        from pycsou_tpu.ops.conv import lowrank_factors

        fac = lowrank_factors(np.asarray(self.filt))
        if (
            fac is not None
            and fac[0].shape[1] == 1
            and not jnp.issubdtype(self.filt.dtype, jnp.complexfloating)
            and H >= 3 * m0
            and W >= 3 * m1
            and h_local >= max(m0 - 1, 2 * m0 - 2)  # halo + local edge window
        ):
            from pycsou_tpu.kernels.band import make_gram_band

            us, vs = fac

            def _jn(gp):
                (b0, b1, lead), Et, Eb, L = gp
                Et = None if Et is None else jnp.asarray(Et)
                Eb = None if Eb is None else jnp.asarray(Eb)
                return (jnp.asarray(b0), jnp.asarray(b1), Et, Eb), lead, L

            self._band_rows, lead_r, L_r = _jn(make_gram_band(us[:, 0], H))
            self._band_cols, lead_c, L_c = _jn(make_gram_band(vs[:, 0], W))
            self._band_meta = (lead_r, L_r, lead_c, L_c)
            self._use_band = True
            from pycsou_tpu.kernels.band import CHAN_TILE, make_chanconv

            if W % CHAN_TILE == 0:
                v1 = np.asarray(vs[:, 0], np.float64)
                Kc = make_chanconv(np.convolve(v1, v1[::-1]), v1.size - 1)
                if Kc is not None:
                    self._band_cols_chan = jnp.asarray(Kc)

        spec_x = NamedSharding(self.mesh, PartitionSpec(self.axis_name, None))
        self.y = jax.device_put(jnp.asarray(y, dtype), spec_x)
        # A^H y, precomputed once with the same sharded adjoint
        ax = self.axis_name
        atb = jax.jit(
            jax.shard_map(
                lambda yb: sharded_conv2d_adjoint(yb, self.filt, ax, h_hat=_join(self._h_hat_adj)),
                mesh=self.mesh,
                in_specs=PartitionSpec(ax, None),
                out_specs=PartitionSpec(ax, None),
            )
        )(self.y)
        self.atb = atb

    # legacy attribute API (round-1 callers)
    @property
    def x0(self):
        """Initial (zero) primal iterand, sharded over the mesh."""
        return self.initial_state()["x"]

    @property
    def z0(self):
        """Initial (zero) stacked dual iterand, sharded over the mesh."""
        init = self.initial_state()
        if "z" in init:
            return init["z"]
        return jnp.stack([init["z0"], init["z1"]], axis=0)

    # -- sharding specs ------------------------------------------------------
    def _spec_x(self):
        return PartitionSpec(self.axis_name, None)

    def _spec_z(self):
        return PartitionSpec(None, self.axis_name, None)

    # -- one PDS iteration on LOCAL blocks (inside shard_map) --------------
    def _data_grad(self, x, atb_loc, y_loc=None):
        """Per-shard data-term gradient ``2 (A^H A x - A^H y)`` on the
        fastest available route (band > fused FFT Gram > forward+adjoint)."""
        ax = self.axis_name
        filt = self.filt
        if self._use_band:
            # rank-1 banded Gram: four matmul passes, NO FFT (fastest)
            lead_r, L_r, lead_c, L_c = self._band_meta
            rb0, rb1, rEt, rEb = self._band_rows
            cb0, cb1, cEt, cEb = self._band_cols
            g_rows = ((rb0, rb1, lead_r), rEt, rEb, L_r)
            g_cols = ((cb0, cb1, lead_c), cEt, cEb, L_c)
            return 2.0 * (
                sharded_sepgram_rank1(
                    x, g_rows, g_cols, ax, g_cols_chan=self._band_cols_chan
                )
                - atb_loc
            )
        if self._use_gram:
            # fused Gram: grad = 2 (A^H A x - A^H y); ONE local FFT roundtrip
            return 2.0 * (
                sharded_conv2d_gram(x, filt, ax, acorr_hat=_join(self._acorr_hat)) - atb_loc
            )
        # grad F = 2 A^H (A x - y): forward + adjoint (two roundtrips)
        r = sharded_conv2d(x, filt, ax, h_hat=_join(self._h_hat_fwd)) - y_loc
        return 2.0 * sharded_conv2d_adjoint(r, filt, ax, h_hat=_join(self._h_hat_adj))

    def _local_step(self, x, z, atb_loc, y_loc=None, m_loc=None):
        ax = self.axis_name
        tau, sigma, rho, lam = self.tau, self.sigma, self.rho, self.lam

        if m_loc is not None:  # diagonal (sampling) Gram: elementwise
            grad = 2.0 * (m_loc * x - atb_loc)
        else:
            grad = self._data_grad(x, atb_loc, y_loc)

        # x+ = prox_G(x - tau grad - tau K^H z)
        x_temp = x - tau * grad - tau * sharded_grad2d_adjoint(z, ax)
        if self.nonneg:
            x_temp = jnp.maximum(x_temp, 0.0)

        # z+ = prox_{sigma H*}(z + sigma K (2 x+ - x)):
        # (lam ||.||_{2,1})* = indicator of the per-pixel l2 ball of radius
        # lam -> fenchel prox is the per-pixel ball projection (fused, local)
        v = z + sigma * sharded_grad2d(2.0 * x_temp - x, ax)
        if self.iso:
            mag = jnp.sqrt(jnp.sum(v * v, axis=0, keepdims=True))
            z_temp = v * (lam / jnp.maximum(mag, lam))
        else:  # anisotropic: per-component box projection
            z_temp = jnp.clip(v, -lam, lam)

        x_new = rho * x_temp + (1 - rho) * x
        z_new = rho * z_temp + (1 - rho) * z
        return x_new, z_new

    # -- IterativeSolver protocol -------------------------------------------
    def initial_state(self):
        H, W = self.shape
        x0 = jax.device_put(jnp.zeros((H, W), jnp.float32), NamedSharding(self.mesh, self._spec_x()))
        z0 = jax.device_put(jnp.zeros((2, H, W), jnp.float32), NamedSharding(self.mesh, self._spec_z()))
        return {"x": x0, "z": z0}

    def step(self, state):
        if self.mask is not None:  # diagonal-Gram XLA chain
            smapped = jax.shard_map(
                lambda x, z, m, t: self._local_step(x, z, t, m_loc=m),
                mesh=self.mesh,
                in_specs=(self._spec_x(), self._spec_z(), self._spec_x(), self._spec_x()),
                out_specs=(self._spec_x(), self._spec_z()),
            )
            x, z = smapped(state["x"], state["z"], self.mask, self.atb)
            return {"x": x, "z": z}
        # same predicate _data_grad keys on: atb is consumed iff the band
        # OR fused-Gram route runs (today band implies gram-eligible, but
        # the dispatch must not rely on that coupling)
        if self._use_band or self._use_gram:
            smapped = jax.shard_map(
                lambda x, z, atb: self._local_step(x, z, atb),
                mesh=self.mesh,
                in_specs=(self._spec_x(), self._spec_z(), self._spec_x()),
                out_specs=(self._spec_x(), self._spec_z()),
            )
            x, z = smapped(state["x"], state["z"], self.atb)
        else:
            smapped = jax.shard_map(
                lambda x, z, y: self._local_step(x, z, None, y_loc=y),
                mesh=self.mesh,
                in_specs=(self._spec_x(), self._spec_z(), self._spec_x()),
                out_specs=(self._spec_x(), self._spec_z()),
            )
            x, z = smapped(state["x"], state["z"], self.y)
        return {"x": x, "z": z}

    # -- legacy fixed-iteration API (benchmarks) ------------------------------
    def run(self, n_iters: int, x=None, z=None):
        """Run ``n_iters`` iterations; returns (x, z) still sharded."""
        state = None
        if x is not None or z is not None:
            init = self.initial_state()
            state = self._wrap_state(
                {
                    "x": x if x is not None else init["x"],
                    "z": z if z is not None else init["z"],
                }
            )
        state = self.run_fixed(n_iters, state=state)
        return state["x"], state["z"]

    def objective(self, x) -> jax.Array:
        """Global objective (pure/jittable; GSPMD reduces over the mesh).
        Mask mode scores observed pixels only (see opt/tv.py objective)."""
        from pycsou_tpu.ops.diff import fdiff_forward

        g0 = fdiff_forward(x, 0)
        g1 = fdiff_forward(x, 1)
        if self.iso:
            tv = jnp.sum(jnp.sqrt(g0 * g0 + g1 * g1))
        else:
            tv = jnp.sum(jnp.abs(g0)) + jnp.sum(jnp.abs(g1))
        if self.mask is not None:
            yc = self.atb / jnp.maximum(self.mask, 1.0)
            return jnp.sum(self.mask * (x - yc) ** 2) + self.lam * tv
        ax = self.axis_name
        P = PartitionSpec
        smapped = jax.shard_map(
            lambda xb: sharded_conv2d(xb, self.filt, ax, h_hat=_join(self._h_hat_fwd)),
            mesh=self.mesh,
            in_specs=P(ax, None),
            out_specs=P(ax, None),
        )
        r = smapped(x) - self.y
        return jnp.sum(r * r) + self.lam * tv


class BatchedDistributedTVDeconv2D(IterativeSolver):
    r"""Batched TV deconvolution on a TRUE 2-D device mesh ``(dp, sp)``:
    a batch of B images is data-parallel over ``dp`` while each image is
    row-sharded over ``sp`` — the dp x sp composition a cluster-scale
    deployment uses (scenario batches x spatial decomposition).

    Per iteration each device touches only its (B/dp, H/sp, W) brick; spatial
    halos ride ``ppermute`` along ``sp`` (vmapped over the local batch) and
    there is NO collective along ``dp`` at all (problems are independent).
    First-class ``IterativeSolver``: metric/history/checkpoint included.
    """

    y: jax.Array = None
    atb: jax.Array = None
    _inner: DistributedTVDeconv2D = None
    mesh: Mesh = static_field(default=None)
    dp: str = static_field(default="dp")
    sp: str = static_field(default="sp")
    batch: int = static_field(default=1)
    shape: Tuple[int, int] = static_field(default=None)
    tau: float = static_field(default=0.1)
    sigma: float = static_field(default=0.1)
    rho: float = static_field(default=0.9)

    def __init__(
        self,
        shape: Tuple[int, int],
        filt,
        y,
        lam: float,
        nonneg: bool = True,
        mesh: Optional[Mesh] = None,
        tau: Optional[float] = None,
        rho: float = 0.9,
        dtype=jnp.float32,
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-6,
        verbose: Optional[int] = None,
        isotropic: bool = True,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold, verbose=verbose)
        y = jnp.asarray(y, dtype)
        if y.ndim != 3:
            raise ValueError("y must be (batch, H, W)")
        B = y.shape[0]
        self.mesh = mesh if mesh is not None else make_mesh((1, jax.device_count()), ("dp", "sp"))
        if len(self.mesh.axis_names) != 2:
            raise ValueError("mesh must be 2-D (dp, sp)")
        self.dp, self.sp = self.mesh.axis_names
        n_dp, n_sp = self.mesh.devices.shape
        H, W = shape
        if B % n_dp or H % n_sp:
            raise ValueError(f"batch {B} must divide over {n_dp} and height {H} over {n_sp}")
        self.batch = B
        self.shape = (H, W)

        # one per-image solver supplies the step math and precomputed
        # transfers; build it on a 1-D view of the sp axis
        sp_mesh = Mesh(self.mesh.devices.reshape(-1)[:n_sp], (self.sp,))
        inner = DistributedTVDeconv2D(
            shape,
            filt,
            jnp.zeros(shape, dtype),
            lam,
            nonneg=nonneg,
            mesh=sp_mesh,
            tau=tau,
            rho=rho,
            dtype=dtype,
            max_iter=max_iter,
            isotropic=isotropic,
        )
        self._inner = inner
        self.tau, self.sigma, self.rho = inner.tau, inner.sigma, inner.rho

        P = PartitionSpec
        self.y = jax.device_put(y, NamedSharding(self.mesh, P(self.dp, self.sp, None)))
        # per-image A^H y (vmapped sharded adjoint over the local batch)
        smapped = jax.shard_map(
            lambda yb: jax.vmap(
                lambda img: sharded_conv2d_adjoint(
                    img, inner.filt, self.sp, h_hat=_join(inner._h_hat_adj)
                )
            )(yb),
            mesh=self.mesh,
            in_specs=P(self.dp, self.sp, None),
            out_specs=P(self.dp, self.sp, None),
        )
        self.atb = jax.jit(smapped)(self.y)

    def initial_state(self):
        P = PartitionSpec
        B, (H, W) = self.batch, self.shape
        x0 = jax.device_put(
            jnp.zeros((B, H, W), jnp.float32), NamedSharding(self.mesh, P(self.dp, self.sp, None))
        )
        z0 = jax.device_put(
            jnp.zeros((B, 2, H, W), jnp.float32),
            NamedSharding(self.mesh, P(self.dp, None, self.sp, None)),
        )
        return {"x": x0, "z": z0}

    def step(self, state):
        P = PartitionSpec
        inner = self._inner

        if inner._use_gram:
            def local(x, z, atb):
                return jax.vmap(lambda xi, zi, ai: inner._local_step(xi, zi, ai))(x, z, atb)
            third = self.atb
        else:
            def local(x, z, y):
                return jax.vmap(lambda xi, zi, yi: inner._local_step(xi, zi, None, y_loc=yi))(x, z, y)
            third = self.y

        # the inner solver's halo exchanges name the sp axis; rebind by
        # constructing the shard_map over the 2-D mesh with the same name
        inner_ax = inner.axis_name
        assert inner_ax == self.sp
        smapped = jax.shard_map(
            local,
            mesh=self.mesh,
            in_specs=(P(self.dp, self.sp, None), P(self.dp, None, self.sp, None), P(self.dp, self.sp, None)),
            out_specs=(P(self.dp, self.sp, None), P(self.dp, None, self.sp, None)),
        )
        x, z = smapped(state["x"], state["z"], third)
        return {"x": x, "z": z}

    def run(self, n_iters: int, x=None, z=None):
        """Run ``n_iters`` fused iterations on the 2-D mesh."""
        state = None
        if x is not None or z is not None:
            init = self.initial_state()
            state = self._wrap_state(
                {"x": x if x is not None else init["x"], "z": z if z is not None else init["z"]}
            )
        state = self.run_fixed(n_iters, state=state)
        return state["x"], state["z"]


class Spatial2DTVDeconv2D(IterativeSolver):
    r"""TV deconvolution with ONE image sharded over a TRUE 2-D spatial mesh
    ``(sp0, sp1)``: rows over ``sp0``, columns over ``sp1``.

    For very wide meshes a 1-D row split leaves blocks thinner than the
    kernel halo; the 2-D split keeps blocks square-ish so halo traffic per
    device scales as the block *perimeter*.  The data term runs as
    per-axis banded Gram passes with (K-1)-wide ``ppermute`` halos along
    BOTH mesh axes: the rank-1 autocorrelation band, or for rank 2-4 PSFs
    the per-rank forward-then-adjoint composition.

    Zero FFTs, zero global collectives inside an iteration.
    Same mathematics as :class:`DistributedTVDeconv2D` (Condat-Vu PDS,
    reference update rule /root/reference/pycsou/opt/proxalgs.py:343-355);
    first-class ``IterativeSolver`` (stopping metric, history, checkpoint).
    """

    y: jax.Array = None
    atb: jax.Array = None
    # diagonal-Gram (sampling) mode on the 2-D mesh: grad is elementwise
    # per shard; only the gradient-stencil halos ride ppermute
    mask: jax.Array = None
    _band_rows: tuple = None
    _band_cols: tuple = None
    lam: float = static_field(default=0.1)
    tau: float = static_field(default=0.1)
    sigma: float = static_field(default=0.1)
    rho: float = static_field(default=0.9)
    beta: float = static_field(default=2.0)
    nonneg: bool = static_field(default=True)
    iso: bool = static_field(default=True)
    mesh: Mesh = static_field(default=None)
    ax_r: str = static_field(default="sp0")
    ax_c: str = static_field(default="sp1")
    shape: Tuple[int, int] = static_field(default=None)
    _band_meta: tuple = static_field(default=None)  # (lead_r, L_r, lead_c, L_c)
    _y2: float = static_field(default=0.0)
    rank: int = static_field(default=1)
    # per-rank forward/adjoint band plans (atb init + rank >= 2 objective)
    _rank_plans: tuple = static_field(default=None)

    def __init__(
        self,
        shape: Tuple[int, int],
        filt,
        y,
        lam: float,
        nonneg: bool = True,
        mesh: Optional[Mesh] = None,
        tau: Optional[float] = None,
        rho: float = 0.9,
        dtype=jnp.float32,
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-6,
        verbose: Optional[int] = None,
        isotropic: bool = True,
        mask=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold, verbose=verbose)
        self.iso = bool(isotropic)
        H, W = shape
        if mesh is None:
            n = jax.device_count()
            n0 = int(math.isqrt(n))
            while n % n0:
                n0 -= 1
            mesh = make_mesh((n0, n // n0), ("sp0", "sp1"))
        if len(mesh.axis_names) != 2:
            raise ValueError("Spatial2DTVDeconv2D needs a 2-D (rows, cols) mesh")
        self.mesh = mesh
        self.ax_r, self.ax_c = mesh.axis_names
        n0, n1 = mesh.devices.shape
        if H % n0 or W % n1:
            raise ValueError(f"image {H}x{W} must divide over the {n0}x{n1} mesh")
        self.shape = (H, W)
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        self.rho = float(rho)

        self.mask = None
        if mask is not None:
            # diagonal-Gram (sampling) mode — the 2-D-mesh twin of
            # DistributedTVDeconv2D's mask mode.  grad = 2(mask*x - atb) is
            # elementwise per shard (no Gram halos at all); the gradient
            # stencil's 1-pixel halos ride the existing sharded_grad2d_2d.
            if filt is not None:
                raise ValueError(
                    "mask mode models a diagonal sampling forward operator; "
                    "pass filt=None"
                )
            m = jnp.asarray(mask, dtype)
            if m.shape != (H, W):
                raise ValueError(f"mask shape {m.shape} != image shape {(H, W)}")
            beta = 2.0 * float(jnp.max(m))
            L_K = math.sqrt(8.0)
            if tau is None:
                tau = (1.0 / L_K**2) * (-beta / 4 + math.sqrt(beta**2 / 16 + L_K**2))
            self.tau = self.sigma = float(tau)
            self.beta = beta
            spec_x = NamedSharding(self.mesh, self._spec_x())
            self.y = jax.device_put(jnp.asarray(y, dtype), spec_x)
            self.atb = self.y
            self.mask = jax.device_put(m, spec_x)
            self.rank = 0
            self._band_rows = self._band_cols = None
            self._rank_plans = None
            self._y2 = 0.0
            return

        filt = jnp.asarray(filt, dtype)
        m0, m1 = filt.shape
        from pycsou_tpu.ops.conv import lowrank_factors

        fac = lowrank_factors(np.asarray(filt))
        if fac is None:
            raise ValueError(
                "Spatial2DTVDeconv2D requires a rank <= 4 (sum-separable) "
                "PSF; use DistributedTVDeconv2D (1-D row sharding, FFT Gram) "
                "otherwise"
            )
        rank = fac[0].shape[1]
        self.rank = rank
        h_loc, w_loc = H // n0, W // n1
        need_r, need_c = max(m0 - 1, 2 * m0 - 2), max(m1 - 1, 2 * m1 - 2)
        if h_loc < need_r or w_loc < need_c or H < 3 * m0 or W < 3 * m1:
            raise ValueError(
                f"local blocks {h_loc}x{w_loc} too small for a {m0}x{m1} kernel: "
                f"need >= {need_r} rows and >= {need_c} cols per device"
            )

        # auto step sizes (exact reference formulas, proxalgs.py:246-316)
        pad = (H + m0 - 1, W + m1 - 1)
        Hf = np.fft.fftn(np.asarray(filt, np.float64), s=pad, axes=(0, 1))
        L_A = float(np.max(np.abs(Hf)))
        beta = 2.0 * L_A**2
        L_K = math.sqrt(8.0)
        if tau is None:
            tau = (1.0 / L_K**2) * (-beta / 4 + math.sqrt(beta**2 / 16 + L_K**2))
        self.tau = self.sigma = float(tau)
        self.beta = beta

        from pycsou_tpu.kernels.band import make_gram_band

        us, vs = fac

        def _jn(gp):
            (b0, b1, lead), Et, Eb, L = gp
            Et = None if Et is None else jnp.asarray(Et)
            Eb = None if Eb is None else jnp.asarray(Eb)
            return (jnp.asarray(b0), jnp.asarray(b1), Et, Eb), lead, L

        self._band_rows = self._band_cols = None
        if rank == 1:
            self._band_rows, lead_r, L_r = _jn(make_gram_band(us[:, 0], H))
            self._band_cols, lead_c, L_c = _jn(make_gram_band(vs[:, 0], W))
            self._band_meta = (lead_r, L_r, lead_c, L_c)

        spec_x = NamedSharding(self.mesh, PartitionSpec(self.ax_r, self.ax_c))
        self.y = jax.device_put(jnp.asarray(y, dtype), spec_x)
        # A^H y once at init, with the SAME sharded banded halo passes the
        # iteration uses — no step ever materialises a full image on one
        # device (VERDICT r2 task 8).  Adjoint of the separable 'same' conv =
        # per-axis banded Toeplitz transposes: flipped taps at the
        # complementary offset, exactly (no edge corrections); rank >= 2
        # sums the per-rank separable adjoints.
        from pycsou_tpu.kernels.band import make_band_blocks
        from pycsou_tpu.parallel.spatial import sharded_sepconv2d_adjoint_2d

        rank_plans = []
        for i in range(rank):
            ui = np.asarray(us[:, i], np.float64)
            vi = np.asarray(vs[:, i], np.float64)
            # forward plans feed only the rank >= 2 Gram composition
            # (_gram_local); rank-1 rides the banded _band_rows path
            fwd = (
                (
                    (make_band_blocks(ui, m0 // 2), m0 - 1),
                    (make_band_blocks(vi, m1 // 2), m1 - 1),
                )
                if rank > 1
                else None
            )
            adj = (
                (make_band_blocks(ui[::-1], m0 - 1 - m0 // 2), m0 - 1),
                (make_band_blocks(vi[::-1], m1 - 1 - m1 // 2), m1 - 1),
            )
            rank_plans.append((fwd, adj))
        self._rank_plans = tuple(rank_plans)
        P = PartitionSpec

        def _atb_local(yb):
            out = None
            for (_, (rp, cp)) in self._rank_plans:
                g = sharded_sepconv2d_adjoint_2d(yb, rp, cp, self.ax_r, self.ax_c)
                out = g if out is None else out + g
            return out

        atb_fn = jax.jit(
            jax.shard_map(
                _atb_local,
                mesh=self.mesh,
                in_specs=P(self.ax_r, self.ax_c),
                out_specs=P(self.ax_r, self.ax_c),
            )
        )
        self.atb = atb_fn(self.y)
        self._y2 = float(jnp.vdot(self.y, self.y))

    # -- sharding specs ------------------------------------------------------
    def _spec_x(self):
        return PartitionSpec(self.ax_r, self.ax_c)

    def _spec_z(self):
        return PartitionSpec(None, self.ax_r, self.ax_c)

    def _gplans(self):
        lead_r, L_r, lead_c, L_c = self._band_meta
        rb0, rb1, rEt, rEb = self._band_rows
        cb0, cb1, cEt, cEb = self._band_cols
        g_rows = ((rb0, rb1, lead_r), rEt, rEb, L_r)
        g_cols = ((cb0, cb1, lead_c), cEt, cEb, L_c)
        return g_rows, g_cols

    # -- one PDS iteration on LOCAL blocks (inside a 2-D shard_map) ---------
    def _local_step(self, x, z, atb_loc, m_loc=None):
        from pycsou_tpu.parallel.spatial import sharded_grad2d_2d, sharded_grad2d_adjoint_2d

        tau, sigma, rho, lam = self.tau, self.sigma, self.rho, self.lam
        ar, ac = self.ax_r, self.ax_c

        if m_loc is not None:  # diagonal (sampling) Gram: elementwise
            grad = 2.0 * (m_loc * x - atb_loc)
        else:
            grad = 2.0 * (self._gram_local(x) - atb_loc)
        x_temp = x - tau * grad - tau * sharded_grad2d_adjoint_2d(z, ar, ac)
        if self.nonneg:
            x_temp = jnp.maximum(x_temp, 0.0)
        v = z + sigma * sharded_grad2d_2d(2.0 * x_temp - x, ar, ac)
        if self.iso:
            mag = jnp.sqrt(jnp.sum(v * v, axis=0, keepdims=True))
            z_temp = v * (lam / jnp.maximum(mag, lam))
        else:  # anisotropic: per-component box projection
            z_temp = jnp.clip(v, -lam, lam)
        return rho * x_temp + (1 - rho) * x, rho * z_temp + (1 - rho) * z

    # -- IterativeSolver protocol -------------------------------------------
    def initial_state(self):
        H, W = self.shape
        x0 = jax.device_put(jnp.zeros((H, W), jnp.float32), NamedSharding(self.mesh, self._spec_x()))
        z0 = jax.device_put(jnp.zeros((2, H, W), jnp.float32), NamedSharding(self.mesh, self._spec_z()))
        return {"x": x0, "z": z0}

    def step(self, state):
        if self.mask is not None:  # diagonal-Gram (sampling) chain
            smapped = jax.shard_map(
                lambda x, z, m, t: self._local_step(x, z, t, m_loc=m),
                mesh=self.mesh,
                in_specs=(self._spec_x(), self._spec_z(), self._spec_x(), self._spec_x()),
                out_specs=(self._spec_x(), self._spec_z()),
            )
            x, z = smapped(state["x"], state["z"], self.mask, self.atb)
            return {"x": x, "z": z}
        smapped = jax.shard_map(
            self._local_step,
            mesh=self.mesh,
            in_specs=(self._spec_x(), self._spec_z(), self._spec_x()),
            out_specs=(self._spec_x(), self._spec_z()),
        )
        x, z = smapped(state["x"], state["z"], self.atb)
        return {"x": x, "z": z}

    def run(self, n_iters: int, x=None, z=None):
        """Fixed-iteration API (benchmarks); returns (x, z) still sharded."""
        state = None
        if x is not None or z is not None:
            init = self.initial_state()
            state = self._wrap_state(
                {"x": x if x is not None else init["x"], "z": z if z is not None else init["z"]}
            )
        state = self.run_fixed(n_iters, state=state)
        return state["x"], state["z"]

    def _gram_local(self, b):
        """Per-shard ``A^H A`` block: the rank-1 banded Gram when available,
        else the per-rank forward-then-adjoint composition (exact for any
        rank — the sweeps are exact 'same' convolutions)."""
        from pycsou_tpu.parallel.spatial import (
            sharded_sepconv2d_2d,
            sharded_sepconv2d_adjoint_2d,
            sharded_sepgram_rank1_2d,
        )

        if self._band_rows is not None:
            g_rows, g_cols = self._gplans()
            return sharded_sepgram_rank1_2d(b, g_rows, g_cols, self.ax_r, self.ax_c)
        t = None
        for ((rp, cp), _) in self._rank_plans:
            ti = sharded_sepconv2d_2d(b, rp, cp, self.ax_r, self.ax_c)
            t = ti if t is None else t + ti
        g = None
        for (_, (rp, cp)) in self._rank_plans:
            gi = sharded_sepconv2d_adjoint_2d(t, rp, cp, self.ax_r, self.ax_c)
            g = gi if g is None else g + gi
        return g

    def objective(self, x) -> jax.Array:
        """Global objective via the Gram identity
        ``||Ax-y||^2 = <x, A^H A x> - 2 <x, A^H y> + ||y||^2`` (pure/jittable;
        GSPMD reduces over the mesh)."""
        from pycsou_tpu.ops.diff import fdiff_forward

        if self.mask is not None:  # observed pixels only (see opt/tv.py)
            yc = self.atb / jnp.maximum(self.mask, 1.0)
            data = jnp.sum(self.mask * (x - yc) ** 2)
        else:
            smapped = jax.shard_map(
                self._gram_local,
                mesh=self.mesh,
                in_specs=(self._spec_x(),),
                out_specs=self._spec_x(),
            )
            data = jnp.vdot(x, smapped(x)) - 2.0 * jnp.vdot(x, self.atb) + self._y2
        g0 = fdiff_forward(x, 0)
        g1 = fdiff_forward(x, 1)
        if self.iso:
            tv = jnp.sum(jnp.sqrt(g0 * g0 + g1 * g1))
        else:
            tv = jnp.sum(jnp.abs(g0)) + jnp.sum(jnp.abs(g1))
        return data + self.lam * tv

"""Tuned flagship solver: TV-regularised 2-D deconvolution/denoising.

Mathematically identical to the generic ``PrimalDualSplitting`` configured
with ``F = SquaredL2Loss o Convolve2D``, ``H = lam L21(axis=0)``,
``K = Gradient``, ``G = NonNegativeOrthant`` — but with the flagship
optimisations applied:

* data-term gradient through the fused convolution Gram (one Gram apply per
  iteration instead of a forward and an adjoint convolution; ops/_gram.py);
* the whole stencil/prox/momentum chain as one XLA fusion (kernels/tv.py).

This is the benchmark path (bench.py) and the recommended API for production
TV deconvolution on one device; the multi-device version is
``parallel.solvers.DistributedTVDeconv2D``.
"""
from __future__ import annotations

import math

from typing import Optional

import jax
import jax.numpy as jnp

from pycsou_tpu._module import static_field
from pycsou_tpu.core.solver import IterativeSolver
from pycsou_tpu.kernels.tv import tv_pds_stencil_step_xla
from pycsou_tpu.ops.conv import Convolve2D
from pycsou_tpu.utils.shapes import as_shape

__all__ = ["TVDeconvolution"]

# hand-written stencil engines of earlier releases; naming one raises
# instead of silently running the XLA stencil
REMOVED_STENCILS = (
    "mega3", "mega2", "megar", "megarm", "mega", "sweep", "sweepm", "sweepm2", "element",
)


class TVDeconvolution(IterativeSolver):
    """``min_x ||A x - y||^2 + lam ||grad x||_{2,1} (+ i_{x>=0})`` with
    Condat-Vu PDS; ``A`` is a 2-D convolution (or identity for denoising).
    ``isotropic=False`` swaps the L21 group norm for the ANISOTROPIC
    ``lam * ||grad x||_1`` (the reference's own PDS doc example,
    pycsou/opt/proxalgs.py:91-119) — same fused stencil,
    per-component box projection instead of the L2-ball dual prox.

    Example — denoise a piecewise-constant image::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.opt.tv import TVDeconvolution
        >>> x_true = jnp.zeros((16, 16)).at[4:12, 4:12].set(1.0)
        >>> ij = jnp.arange(16)[:, None] + jnp.arange(16)[None, :]
        >>> y = x_true + 0.2 * (-1.0) ** ij      # checkerboard "noise"
        >>> solver = TVDeconvolution((16, 16), y, lam=0.3, nonneg=True,
        ...                          max_iter=300)
        >>> info = solver.solve()
        >>> bool(jnp.linalg.norm(info["x"] - x_true)
        ...      < 0.5 * jnp.linalg.norm(y - x_true))
        True
    """

    y: jax.Array = None
    gram: object = None
    atb: jax.Array = None
    # diagonal-Gram mode (``mask`` given): A is a sampling operator whose
    # Gram is diag(mask) — inpainting / zero-fill super-resolution
    mask: jax.Array = None
    # the raw PSF (conv mode; ones((1, 1)) for denoising): kept so a sharded
    # PDS can re-dispatch this problem onto parallel.solvers
    # (opt/proxalgs.py PrimalDualSplitting.with_shardings)
    filt: jax.Array = None
    # combined (blur + mask) mode: the forward operator M o A — the Gram is
    # A^H diag(mask) A
    conv: object = None
    lam: float = static_field(default=0.1)
    tau: float = static_field(default=0.1)
    sigma: float = static_field(default=0.1)
    rho: float = static_field(default=0.9)
    beta: float = static_field(default=2.0)
    nonneg: bool = static_field(default=True)
    # isotropic (L21 o Gradient, the flagship) vs anisotropic (L1 o Gradient
    # — the reference's own PDS doc example, proxalgs.py:91-119) TV: the two
    # differ only in the per-pixel dual projection (kernels/tv.py _dual_prox)
    iso: bool = static_field(default=True)

    def __init__(
        self,
        shape,
        y,
        lam: float,
        filt=None,
        nonneg: bool = True,
        tau: Optional[float] = None,
        sigma: Optional[float] = None,
        rho: float = 0.9,
        stencil: str = "auto",
        max_iter: int = 500,
        min_iter: int = 10,
        accuracy_threshold: float = 1e-6,
        verbose: Optional[int] = None,
        metric_every: int = 1,
        isotropic: bool = True,
        mask=None,
    ):
        super().__init__(max_iter=max_iter, min_iter=min_iter, tol=accuracy_threshold, verbose=verbose, metric_every=metric_every)
        shape = as_shape(shape)
        self.y = jnp.asarray(y, jnp.float32)
        self.lam = float(lam)
        self.nonneg = bool(nonneg)
        self.iso = bool(isotropic)
        self.rho = float(rho)

        self.mask = None
        self.filt = None
        self.conv = None
        if mask is not None and filt is not None:
            # COMBINED (blur + mask) mode: forward operator M o A — partial
            # blurred measurements (super-resolution with blur).  ``y`` is
            # the back-projection M^H y_obs; Gram = A^H diag(mask) A.
            m = jnp.asarray(mask, jnp.float32)
            if m.shape != tuple(shape):
                raise ValueError(f"mask shape {m.shape} != image shape {tuple(shape)}")
            A = Convolve2D(shape, filt)
            self.mask = m
            self.filt = jnp.asarray(filt, jnp.float32)
            self.conv = A
            self.gram = None
            self.atb = A.adjoint(self.y)
            self.beta = 2.0 * float(jnp.max(m)) * A.lipschitz**2
        elif mask is not None:
            # diagonal-Gram (sampling forward operator) mode: A^H A =
            # diag(mask) with mask = A^H(1) — Masking/DownSampling/
            # SubSampling data terms (inpainting, zero-fill superres;
            # reference sampling.py:125-196).  ``y`` here is the
            # BACK-PROJECTED data A^H y (the zero-filled observed image).
            m = jnp.asarray(mask, jnp.float32)
            if m.shape != tuple(shape):
                raise ValueError(f"mask shape {m.shape} != image shape {tuple(shape)}")
            self.mask = m
            self.gram = None
            self.atb = self.y
            self.beta = 2.0 * float(jnp.max(m))
        elif filt is None:
            # denoising (A = I): the data gradient is elementwise,
            # 2 (x - y).  ``filt`` marks the identity convolution so a
            # sharded PDS can still re-dispatch the problem
            self.filt = jnp.ones((1, 1), jnp.float32)
            self.gram = None
            self.atb = self.y
            self.beta = 2.0
        else:
            A = Convolve2D(shape, filt)
            self.filt = jnp.asarray(filt, jnp.float32)
            self.gram = A.gram
            self.atb = A.adjoint(self.y)
            self.beta = 2.0 * A.lipschitz**2

        L_K = math.sqrt(8.0)
        if tau is None:
            b = self.beta
            tau = (1.0 / L_K**2) * (-b / 4 + math.sqrt(b**2 / 16 + L_K**2))
        # the stencil takes tau and sigma independently — the auto rule
        # keeps the reference's balanced tau = sigma, an explicit sigma
        # overrides it
        self.tau = float(tau)
        self.sigma = float(tau) if sigma is None else float(sigma)

        if stencil in REMOVED_STENCILS:
            raise ValueError(f"stencil={stencil!r} was removed; expected 'auto' or 'xla'")
        if stencil not in ("auto", "xla"):
            raise ValueError(f"unknown stencil {stencil!r}; expected 'auto' or 'xla'")

    # -- iteration ---------------------------------------------------------
    def _grad(self, x):
        if self.conv is not None:  # combined blur + mask: A^H diag(m) A
            return 2.0 * (self.conv.adjoint(self.mask * self.conv.apply(x)) - self.atb)
        if self.mask is not None:
            return 2.0 * (self.mask * x - self.atb)
        if self.gram is None:
            return 2.0 * (x - self.y)
        return 2.0 * (self.gram.apply(x) - self.atb)

    def initial_state(self):
        shape = self.y.shape
        # duals as separate arrays in place of a stacked (2, H, W) dual that
        # every step would slice and restack
        return {
            "x": jnp.zeros(shape, jnp.float32),
            "z0": jnp.zeros(shape, jnp.float32),
            "z1": jnp.zeros(shape, jnp.float32),
        }

    def step(self, state):
        x, z0, z1 = state["x"], state["z0"], state["z1"]
        kw = dict(tau=self.tau, sigma=self.sigma, rho=self.rho, lam=self.lam, nonneg=self.nonneg, iso=self.iso)
        x, z0, z1 = tv_pds_stencil_step_xla(x, z0, z1, self._grad(x), **kw)
        return {"x": x, "z0": z0, "z1": z1}

    @staticmethod
    def _rel_from_stats(d2, o2):
        """||new-old|| / ||old|| from partial sums, with the reference's
        0/inf conventions (core/solver.py _rel_improvement)."""
        nd = jnp.sqrt(d2)
        no = jnp.sqrt(o2)
        return jnp.where(
            no == 0.0,
            jnp.where(nd == 0.0, 0.0, jnp.inf),
            nd / jnp.where(no == 0.0, 1.0, no),
        )

    def objective(self, x):
        """Objective value (pure/jittable; usable with track_objective).

        With a blur, the data term is evaluated through the Gram identity
        ``||Ax-y||^2 = <x, A^H A x> - 2 <x, A^H y> + ||y||^2``.  In mask
        mode ``||Ax-y||^2 = sum_i c_i (x_i - atb_i/c_i)^2`` over observed
        pixels (c = sample counts; exact for 0/1 masks, and correct up to
        the constant within-pixel variance of repeated observations for
        SubSampling counts > 1 — the back-projection atb cannot recover
        ``||y||^2`` then).  ``isotropic=False`` scores the anisotropic
        ``sum |dx| + |dy|`` TV term the engines actually minimise."""
        from pycsou_tpu.ops.diff import fdiff_forward

        x = jnp.asarray(x)
        if self.conv is not None:  # combined blur + mask: ||M A x - y||^2
            t = self.conv.apply(x)
            yc = self.y / jnp.maximum(self.mask, 1.0)
            data = jnp.sum(self.mask * (t - yc) ** 2)
        elif self.mask is not None:
            yc = self.atb / jnp.maximum(self.mask, 1.0)
            data = jnp.sum(self.mask * (x - yc) ** 2)
        elif self.gram is None:
            data = jnp.sum((x - self.y) ** 2)
        else:
            data = (
                jnp.vdot(x, self.gram.apply(x))
                - 2.0 * jnp.vdot(x, self.atb)
                + jnp.vdot(self.y, self.y)
            ).real
        dx, dy = fdiff_forward(x, 0), fdiff_forward(x, 1)
        if self.iso:
            tv = jnp.sum(jnp.sqrt(dx**2 + dy**2))
        else:
            tv = jnp.sum(jnp.abs(dx)) + jnp.sum(jnp.abs(dy))
        return data + self.lam * tv

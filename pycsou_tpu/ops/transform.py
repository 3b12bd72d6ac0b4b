"""Spectral transform operators: FFT, DCT.

The reference left this module EMPTY (/root/reference/pycsou/linop/
transform.py, 0 LoC) but its benchmark configs require DCT/FFT operators
(BASELINE config 4).  All transforms here are orthonormal (norm='ortho'), so
they are ``UnitaryMixin`` operators: Lipschitz constant 1, Gram = Identity,
``pinv = adjoint`` — and composing a proximable functional with them keeps
the prox via the unitary precomposition rule
(/root/reference/pycsou/core/functional.py:302-313).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import jax.scipy.fft as jfft
import numpy as np

from pycsou_tpu._module import static_field
from pycsou_tpu.core.linop import LinearOperator, UnitaryMixin
from pycsou_tpu.utils.shapes import as_shape

__all__ = ["FFTOperator", "DCTOperator", "IDCTOperator"]


def _dctn_ortho(x, axes: Optional[Tuple[int, ...]]):
    """Orthonormal DCT-II over ``axes`` (all axes when None)."""
    return jfft.dctn(x, type=2, axes=axes, norm="ortho")


def _idctn_ortho(y, axes: Optional[Tuple[int, ...]]):
    """Orthonormal inverse DCT (DCT-III) over ``axes``."""
    return jfft.idctn(y, type=2, axes=axes, norm="ortho")


class FFTOperator(UnitaryMixin, LinearOperator):
    """Orthonormal n-dimensional discrete Fourier transform
    (complex-to-complex, ``norm='ortho'``).

    Example — unitary round trip::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.transform import FFTOperator
        >>> F = FFTOperator((4,))
        >>> x = jnp.array([1.0, 2.0, 3.0, 4.0]).astype(jnp.complex64)
        >>> bool(jnp.allclose(F.adjoint(F(x)), x, atol=1e-6))
        True
    """

    axes: Optional[Tuple[int, ...]] = static_field(default=None)

    def __init__(self, dim_shape, axes: Optional[Sequence[int]] = None, dtype=np.complex64):
        dim_shape = as_shape(dim_shape)
        super().__init__(dim_shape, dim_shape, lipschitz=1.0, dtype=dtype)
        self.axes = tuple(axes) if axes is not None else None

    def apply(self, x):
        return jnp.fft.fftn(x, axes=self.axes, norm="ortho").astype(self.dtype)

    def adjoint(self, y):
        return jnp.fft.ifftn(jnp.asarray(y), axes=self.axes, norm="ortho").astype(self.dtype)


class DCTOperator(UnitaryMixin, LinearOperator):
    """Orthonormal DCT-II over ``axes`` (real-to-real); adjoint is the
    inverse DCT (= DCT-III).

    Example — a constant signal concentrates in the DC coefficient::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.transform import DCTOperator
        >>> D = DCTOperator((4,))
        >>> D(jnp.ones(4)).tolist()
        [2.0, 0.0, 0.0, 0.0]
    """

    axes: Optional[Tuple[int, ...]] = static_field(default=None)

    def __init__(self, dim_shape, axes: Optional[Sequence[int]] = None, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        super().__init__(dim_shape, dim_shape, lipschitz=1.0, dtype=dtype)
        self.axes = tuple(axes) if axes is not None else None

    def apply(self, x):
        return _dctn_ortho(x, self.axes).astype(self.dtype)

    def adjoint(self, y):
        return _idctn_ortho(jnp.asarray(y), self.axes).astype(self.dtype)


class IDCTOperator(UnitaryMixin, LinearOperator):
    """Orthonormal inverse DCT (synthesis operator): maps DCT coefficients to
    signal — useful as a sparsifying dictionary in stacked recovery problems.

    Example::

        >>> import jax.numpy as jnp
        >>> from pycsou_tpu.ops.transform import IDCTOperator
        >>> S = IDCTOperator((4,))
        >>> S(jnp.array([2.0, 0.0, 0.0, 0.0])).tolist()   # DC -> constant
        [1.0, 1.0, 1.0, 1.0]
    """

    axes: Optional[Tuple[int, ...]] = static_field(default=None)

    def __init__(self, dim_shape, axes: Optional[Sequence[int]] = None, dtype=np.float32):
        dim_shape = as_shape(dim_shape)
        super().__init__(dim_shape, dim_shape, lipschitz=1.0, dtype=dtype)
        self.axes = tuple(axes) if axes is not None else None

    def apply(self, x):
        return _idctn_ortho(x, self.axes).astype(self.dtype)

    def adjoint(self, y):
        return _dctn_ortho(jnp.asarray(y), self.axes).astype(self.dtype)

"""Shape utilities for operators on arbitrary nd-array domains.

The reference flattens everything to 1-D vectors of length ``dim``
(reference pycsou/core/map.py:20).  Here we keep natural array shapes
(images stay 2-D so stencil/conv passes keep their layout); ``dim_shape``
/ ``codim_shape`` are nd tuples and ``shape`` exposes the reference's
``(codim_size, dim_size)`` view for familiarity.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

ShapeLike = Union[int, Sequence[int], Tuple[int, ...]]


def as_shape(s: ShapeLike) -> Tuple[int, ...]:
    """Canonicalise an int / sequence into a shape tuple. ``()`` = scalar."""
    if s is None:
        return ()
    if isinstance(s, (int,)):
        return (int(s),)
    return tuple(int(d) for d in s)


def size_of(shape: Tuple[int, ...]) -> int:
    return int(math.prod(shape)) if shape else 1

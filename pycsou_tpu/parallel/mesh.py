"""Device mesh utilities: mesh construction, sharding helpers, multi-host
init.

The reference has no distributed backend at all (SURVEY §2.6/§5 — its only
parallelism is joblib process pools and optional Dask graphs).  Here the
equivalents are ``jax.sharding.Mesh`` + collectives between devices:

* stacked-operator fan-in  -> psum            (joblib V-stack adjoint sum)
* block-diagonal blocks    -> per-shard independence
* chunked explicit matrices-> 2-D sharded jax.Array (Dask replacement)
* spatial stencils/conv    -> halo exchange via ppermute (see spatial.py)
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "replicated", "shard_along", "distributed_init"]


def make_mesh(shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = ("sp",)) -> Mesh:
    """Build a mesh over the available devices.

    ``make_mesh()``            -> 1-D mesh over all devices, axis 'sp'
    ``make_mesh((2, 4), ('dp', 'sp'))`` -> 2-D mesh

    Example::

        >>> from pycsou_tpu.parallel import make_mesh
        >>> mesh = make_mesh()                  # all devices, axis 'sp'
        >>> mesh.axis_names
        ('sp',)
        >>> make_mesh((2, 4), ('dp', 'sp')).shape  # doctest: +SKIP
        OrderedDict([('dp', 2), ('sp', 4)])
    """
    devices = jax.devices()
    if shape is None:
        shape = (len(devices),)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, only {len(devices)} available")
    dev_array = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_array, tuple(axis_names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_along(mesh: Mesh, axis_name: str, ndim: int, array_axis: int = 0) -> NamedSharding:
    """NamedSharding partitioning ``array_axis`` of an ndim array over
    ``axis_name``."""
    spec = [None] * ndim
    spec[array_axis] = axis_name
    return NamedSharding(mesh, PartitionSpec(*spec))


def distributed_init(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None, process_id: Optional[int] = None):
    """Multi-host bring-up: thin wrapper over ``jax.distributed.initialize``
    (one process per host).  No-op when single-process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )

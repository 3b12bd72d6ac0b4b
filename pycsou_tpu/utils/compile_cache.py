"""Persistent XLA compilation cache for the repository's scripts.

Scripts (``chip_smoke.py``, ``bench.py``) call :func:`enable_compile_cache`
before their first compile; importing the package never touches the cache.
"""
from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here.  Otherwise the cache lives at
    ``<repo>/.jax_cache`` (git-ignored) — a fixed path, since the path is
    part of each entry's key."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path

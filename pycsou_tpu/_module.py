"""Pytree module system.

Every operator / functional / solver in pycsou_tpu is a :class:`Module`: a
dataclass automatically registered as a JAX pytree.  Array-valued fields are
pytree *children* (traced through ``jit`` / ``grad`` / ``lax`` control flow),
while fields declared with :func:`static_field` are *auxiliary data* (shapes,
dtypes, Lipschitz constants, algorithm flags) that participate in the
compilation cache key.

This replaces the reference's runtime Python-dispatch wrapper objects
(/root/reference/pycsou/core/map.py:337-388) with objects whose entire call
graph is traced once by XLA: a composed operator flattens into a single jitted
computation instead of a chain of Python ``__call__`` hops per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax

__all__ = ["Module", "static_field", "field"]

_STATIC_MARK = "pycsou_tpu_static"

field = dataclasses.field


def static_field(default=dataclasses.MISSING, *, default_factory=dataclasses.MISSING, **kwargs):
    """Declare a dataclass field stored as static pytree aux data (hashable)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata[_STATIC_MARK] = True
    if default_factory is not dataclasses.MISSING:
        return dataclasses.field(default_factory=default_factory, metadata=metadata, **kwargs)
    if default is not dataclasses.MISSING:
        return dataclasses.field(default=default, metadata=metadata, **kwargs)
    return dataclasses.field(metadata=metadata, **kwargs)


class _Hashed:
    """Hashable-by-identity wrapper for unhashable static values (lists, arrays)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __hash__(self):
        return id(self.value)

    def __eq__(self, other):
        return isinstance(other, _Hashed) and other.value is self.value


def _wrap_aux(v):
    try:
        hash(v)
        return v
    except TypeError:
        return _Hashed(v)


def _unwrap_aux(v):
    return v.value if isinstance(v, _Hashed) else v


class Module:
    """Base class: subclassing auto-applies ``@dataclass`` and pytree registration.

    Subclasses may freely define a custom ``__init__`` (the dataclass decorator
    never overwrites methods defined in the class body).  Generated ``__init__``
    is disabled by default; pass ``gen_init=True`` in the class statement to get
    a keyword-only generated constructor.
    """

    _dyn_fields: Tuple[str, ...] = ()
    _static_fields: Tuple[str, ...] = ()

    def __init_subclass__(cls, gen_init: bool = False, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, init=gen_init, eq=False, repr=False, kw_only=True)
        dyn, stat = [], []
        for f in dataclasses.fields(cls):
            (stat if f.metadata.get(_STATIC_MARK) else dyn).append(f.name)
        cls._dyn_fields = tuple(dyn)
        cls._static_fields = tuple(stat)
        jax.tree_util.register_pytree_with_keys(
            cls,
            flatten_with_keys=cls._tree_flatten_with_keys,
            flatten_func=cls._tree_flatten,
            unflatten_func=cls._tree_unflatten,
        )

    # -- pytree protocol ---------------------------------------------------
    def _tree_flatten(self):
        children = tuple(getattr(self, n) for n in self._dyn_fields)
        aux = tuple(_wrap_aux(getattr(self, n, None)) for n in self._static_fields)
        return children, aux

    def _tree_flatten_with_keys(self):
        children = tuple(
            (jax.tree_util.GetAttrKey(n), getattr(self, n)) for n in self._dyn_fields
        )
        aux = tuple(_wrap_aux(getattr(self, n, None)) for n in self._static_fields)
        return children, aux

    @classmethod
    def _tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        for n, v in zip(cls._dyn_fields, children):
            object.__setattr__(obj, n, v)
        for n, v in zip(cls._static_fields, aux):
            object.__setattr__(obj, n, _unwrap_aux(v))
        return obj

    # -- conveniences ------------------------------------------------------
    def replace(self, **changes: Any):
        """Functional update: return a copy with the given fields replaced."""
        obj = object.__new__(type(self))
        for n in self._dyn_fields + self._static_fields:
            object.__setattr__(obj, n, getattr(self, n, None))
        for k, v in changes.items():
            if k not in self._dyn_fields and k not in self._static_fields:
                raise AttributeError(f"{type(self).__name__} has no field {k!r}")
            object.__setattr__(obj, k, v)
        return obj

    def __repr__(self):
        cls = type(self).__name__
        parts = []
        for n in self._static_fields:
            v = getattr(self, n, None)
            if v is not None and not callable(v):
                parts.append(f"{n}={v!r}")
        return f"{cls}({', '.join(parts)})"

"""Frozen dataclasses that are JAX pytrees.

`pytree_dataclass` registers a frozen dataclass with
`jax.tree_util.register_dataclass`: ordinary fields are pytree children
(arrays, None, nested pytrees), fields made with `static_field` are
metadata (hashable Python values that select trace-time code paths, so a
change of value retraces a jitted caller). Instances get a `replace`
method, as `dataclasses.replace`.
"""
from __future__ import annotations

import dataclasses

import jax

_STATIC = "pytree_static"


def static_field(default=dataclasses.MISSING):
    """A field kept out of the pytree's leaves (part of its treedef)."""
    return dataclasses.field(default=default, metadata={_STATIC: True})


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    """Class decorator: frozen dataclass + pytree registration."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    meta = [f.name for f in fields if f.metadata.get(_STATIC)]
    data = [f.name for f in fields if not f.metadata.get(_STATIC)]
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)

"""Frozen dataclasses that are JAX pytrees (every field a data leaf)."""

from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    """``@dataclass`` for state and scene records: frozen, registered with
    jax.tree_util so instances pass through jit, donate and shard_map, and
    given ``.replace(**changes)``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[])
    return cls

"""Pytree helpers.

``dataclass``: a frozen dataclass registered as a JAX pytree. Every field
is a data field (a pytree child, traced under ``jit``); there are no static
fields. ``.replace(**kw)`` returns an updated copy.

``unflatten``: nested dicts from flat ``/``-joined keys (the layout of the
model files, train/checkpoint.py).
"""

from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return jax.tree_util.register_dataclass(cls)


def unflatten(flat):
    """{"a/b/c": leaf, ...} → nested dicts {"a": {"b": {"c": leaf}}}."""
    out = {}
    for k, leaf in flat.items():
        *parents, name = k.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out

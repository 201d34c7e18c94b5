"""Memos keyed weakly on a tensor (the reference keeps its densified-form
memo this way, ``repro.sparse.matrix``).

An entry is keyed on the id of a key tensor and dropped by a finalizer
when that tensor dies, so the memo never keeps the key alive.  A hit also
needs ``check`` to match: the caller puts there what else the value
depends on (other tensors' identities, version counters: torch tensors,
unlike jax arrays, can change in place).
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Hashable, Tuple

import torch

Table = Dict[int, Tuple[Hashable, Any]]


def memoized(table: Table, key: torch.Tensor, check: Hashable,
             build: Callable[[], Any],
             keep: Callable[[Any], bool] = lambda value: True) -> Any:
    """``table``'s value for ``key`` and ``check``, else ``build()``, kept
    in ``table`` where ``keep(value)`` holds."""
    hit = table.get(id(key))
    if hit is not None and hit[0] == check:
        return hit[1]
    value = build()
    if keep(value):
        if hit is None:
            weakref.finalize(key, table.pop, id(key), None)
        table[id(key)] = (check, value)
    return value

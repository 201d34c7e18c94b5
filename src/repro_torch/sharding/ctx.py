"""Logical-axis sharding context, MaxText-style logical axis rules (the
port of ``repro.sharding.ctx``).

Model code annotates activations with *logical* axes (``shard_hint(x,
"batch", "seq", "embed")``); the launcher installs a mesh plus a
logical -> mesh translation table.  Without a mesh (unit tests, one card)
hints are no-ops, so models stay mesh agnostic.

In the port a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
(``repro_torch.sharding.specs.make_mesh``) and the model code is per-rank
code on plain tensors, whose layout is the caller's: ``shard_hint`` is a
layout constraint with no numerical effect, so it returns its input
unchanged, mesh or not.  The call sites are the reference's, in place for
a port that gives them an effect.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

from repro_torch.sharding.specs import PartitionSpec as P
from repro_torch.sharding.specs import axis_names

_state = threading.local()

# Default logical->mesh translation. "dp" axes join pod+data for batch;
# "fsdp" = data; "tensor" = model.
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "seq": None,
    "kv_seq": None,
    "stage": None,
}


def set_mesh(mesh, rules: Optional[dict] = None):
    _state.mesh = mesh
    base = dict(DEFAULT_RULES)
    if rules:
        base.update(rules)
    # Drop rules referencing axes the mesh doesn't have (e.g. single-pod).
    names = set(axis_names(mesh))

    def _filter(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        vv = tuple(a for a in v if a in names)
        return vv if vv else None

    _state.rules = {k: _filter(v) for k, v in base.items()}


def clear_mesh():
    _state.mesh = None
    _state.rules = None


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    prev = (getattr(_state, "mesh", None), getattr(_state, "rules", None))
    set_mesh(mesh, rules)
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def current_mesh():
    return getattr(_state, "mesh", None)


def axis_rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def logical_to_spec(logical: Tuple[Optional[str], ...]) -> P:
    """Translate logical axes to a PartitionSpec, dropping duplicate mesh
    axes (first occurrence wins) — a spec may not reuse a mesh axis."""
    rules = axis_rules() or {}
    used = set()
    entries = []
    for ax in logical:
        v = rules.get(ax) if ax else None
        axes = (v,) if isinstance(v, str) else tuple(v or ())
        if any(a in used for a in axes):
            v = None
            axes = ()
        used.update(axes)
        entries.append(v)
    return P(*entries)


def shard_hint(x, *logical: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical axis names:
    the identity (see the module's docstring)."""
    return x

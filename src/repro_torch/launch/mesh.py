"""The production mesh (the port of ``repro.launch.mesh``).

Functions, so importing this module starts no process group.  A mesh is
a ``DeviceMesh`` over the ranks of the process group
(``sharding.specs.make_mesh``); ``launch.dryrun`` builds one on a fake
world of 256 or 512 ranks.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.sharding.specs import make_mesh


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """Single pod: 16x16 = 256 ranks (data, model).
    Multi-pod: 2 pods x 256 = 512 ranks (pod, data, model).

    Uses the first ``n`` ranks, so a 512-rank dry-run world can build the
    single-pod mesh too; a smaller world raises.  The mesh's tensors live
    on ``device`` (the card unless the caller asks for the CPU)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if _world_size() < n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; "
                         f"the world has {_world_size()}")
    return make_mesh(shape, axes, devices=list(range(n)), device=device)


def make_local_mesh(shape=(1, 1), axes=("data", "model"), device="cuda"):
    """Degenerate mesh over however many ranks exist (tests/smoke)."""
    if shape[0] * shape[1] > _world_size():
        shape = (1, 1)
    return make_mesh(shape, axes, device=device)

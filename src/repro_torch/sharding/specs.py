"""Parameter / cache / batch PartitionSpec policies and the mesh (the
port of ``repro.sharding.specs``).

FSDP+TP ("2D") scheme in MaxText style:
  * every weight matrix shards its input-ish dim over `data` (FSDP) and its
    output-ish dim over `model` (TP); optimizer moments inherit => ZeRO.
  * experts shard over `model` (EP), their inner dims over `data`.
  * the `pod` axis is pure DP/2.5D-replication: parameters are replicated
    across pods, gradients cross pods once per step.

Axes are applied only when they divide the dim (``_fit``): vocab sizes
like 51865 or 92553 fall back to replication for that dim instead of
uneven shards.

The spec functions are pure functions of a leaf's path and shape and of
the mesh's axis names and sizes, and return the reference's specs.  A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (``make_mesh``);
the spec functions also take any object with ``axis_names`` and a
``shape`` mapping, as the reference's tests' fake meshes have.  A
:class:`NamedSharding` turns a spec into DTensor placements
(``Shard(d)`` / ``Replicate()`` per mesh dim).
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.tree import DictKey, tree_map, tree_map_with_path


class PartitionSpec(tuple):
    """The port's ``PartitionSpec``: one entry per tensor dim, each None,
    a mesh axis name or a tuple of them.  Compares equal, entry for
    entry, with the reference's specs (a one-axis tuple equals the axis
    and an empty one None, as ``jax.sharding.PartitionSpec`` has it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"

    @staticmethod
    def _norm(spec):
        return tuple((e[0] if len(e) == 1 else e or None)
                     if isinstance(e, tuple) else e for e in spec)

    def __eq__(self, other):
        try:
            return self._norm(self) == self._norm(tuple(other))
        except TypeError:
            return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self._norm(self))


P = PartitionSpec


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` in the mesh's axis order."""
    names = axis_names(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in names}


def make_mesh(shape, axes, *, devices=None, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    process group: ``devices`` (a list of ranks, e.g. a surviving
    sub-mesh), else every rank.  Every rank of the group calls it (it
    creates process groups); a rank outside ``devices`` gets a mesh it is
    not in.  The mesh's tensors live on ``device``: the card (an nccl
    group) unless the caller asks for the CPU (a gloo group).  With no
    process group, a mesh of size 1 starts a one-rank group of that
    backend in this process (an in-memory store; the caller destroys it)
    and a larger one raises, as does a group whose backend does not carry
    ``device``'s tensors (a ``fake`` group, which moves no data, carries
    any)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs a process group "
                             "(torch.distributed.init_process_group)")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif backend not in dist.get_backend() \
            and dist.get_backend() != "fake":  # launch.dryrun's fake world
        raise ValueError(f"a mesh on {dev.type} needs a {backend} process "
                         f"group, not {dist.get_backend()}")
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    if len(ranks) != n:
        raise ValueError(f"a {shape} mesh over {len(ranks)} ranks")
    mesh = DeviceMesh(dev.type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=axes)
    # a group for every set of two or more axes (the batch axes together,
    # the whole mesh), made now because every rank of the process group
    # takes part in making each
    grid = torch.tensor(ranks).reshape(shape)
    groups = {}
    for k in range(2, len(axes) + 1):
        for combo in itertools.combinations(range(len(axes)), k):
            rest = [d for d in range(len(axes)) if d not in combo]
            lists = grid.permute(rest + list(combo)).reshape(
                -1, math.prod(shape[d] for d in combo)).tolist()
            groups[tuple(axes[d] for d in combo)], _ = \
                dist.new_subgroups_by_enumeration(lists)
    mesh._repro_axis_groups = groups
    return mesh


def axis_group(mesh, axes):
    """The process group of this rank and the ranks that differ from it
    only along ``axes`` (one axis name or several, in mesh order)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    order = axis_names(mesh)
    return mesh._repro_axis_groups[tuple(a for a in order if a in axes)]


def axis_index(mesh, axes) -> int:
    """This rank's position along ``axes`` (several: major to minor in
    mesh order, as a spec entry ``("pod", "data")`` splits a dim)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = axis_sizes(mesh)
    idx = 0
    for a in (a for a in axis_names(mesh) if a in axes):
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


class NamedSharding:
    """A spec on a mesh: the DTensor placements it means
    (``placements``) and the placing of a whole tensor (``place``)."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for name in axis_names(self.mesh):
            dim = next((d for d, e in enumerate(self.spec)
                        if e == name or (isinstance(e, tuple)
                                         and name in e)), None)
            out.append(Replicate() if dim is None else Shard(dim))
        return tuple(out)

    def place(self, x: torch.Tensor):
        """A ``DTensor`` of the whole tensor ``x`` (the same on every rank)
        split as the spec says; its local tensor is a copy (a replicated
        one would otherwise alias ``x``, and the sharded step writes its
        shards in place)."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x.detach().clone(), self.mesh,
                                 self.placements)

    def __repr__(self):
        return f"NamedSharding({axis_sizes(self.mesh)}, {self.spec!r})"


def whole(x):
    """A leaf as one whole tensor: a ``DTensor`` gathered (a collective:
    every rank of its mesh calls), anything else as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def local(x):
    """A leaf's part on this rank: a ``DTensor``'s local tensor (a view of
    its storage), anything else as it is."""
    return x.to_local() if hasattr(x, "to_local") else x


def local_shard(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's part of the whole tensor ``x`` under ``placements`` (a
    view): the mesh dims in order, each splitting its tensor dim evenly,
    as DTensor splits it."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            x = x.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return x


# key -> (logical spec per trailing dims of the UNSTACKED param)
_PARAM_RULES = {
    # projections [in, out]
    "wq": ("fsdp", "tensor"), "wk": ("fsdp", "tensor"),
    "wv": ("fsdp", "tensor"), "wi": ("fsdp", "tensor"),
    "wg": ("fsdp", "tensor"), "wx": ("fsdp", "tensor"),
    "in_proj": ("fsdp", "tensor"),
    "vision_proj": ("fsdp", "tensor"),
    "lm_head": ("fsdp", "tensor"),
    "router": ("fsdp", None),
    # output projections [in, d]
    "wo": ("tensor", "fsdp"), "out": ("tensor", "fsdp"),
    "out_proj": ("tensor", "fsdp"),
    # embedding [V, d]
    "embed": ("tensor", "fsdp"),
    # experts
    "w_in": ("expert", "fsdp", None), "w_gate": ("expert", "fsdp", None),
    "w_out": ("expert", None, "fsdp"),
    # biases / vectors
    "bq": ("tensor",), "bk": ("tensor",), "bv": ("tensor",),
    "conv_w": (None, "tensor"), "conv_b": ("tensor",),
    "A_log": ("tensor",), "D": ("tensor",), "dt_bias": ("tensor",),
    "lam": ("tensor",), "ga_b": ("tensor",), "gi_b": ("tensor",),
    "ga_w": ("tensor", None), "gi_w": ("tensor", None),
    "norm": ("tensor",),
    # norms (replicated)
    "ln1": (None,), "ln2": (None,), "lnx": (None,), "final_ln": (None,),
    "ba": ("tensor",), "bi": ("tensor",),
    "wa": ("tensor", None),
}

_LOGICAL = {
    "fsdp": ("data",),
    "tensor": ("model",),
    "expert": ("model",),
    "dp": ("pod", "data"),
}


def _fit(dim: int, axes: Optional[Tuple[str, ...]], mesh):
    """Return axes (possibly trimmed) only if their product divides dim."""
    if axes is None:
        return None
    sizes = axis_sizes(mesh)
    names = [a for a in axes if a in sizes]
    while names:
        prod = math.prod(sizes[a] for a in names)
        if dim % prod == 0:
            return tuple(names) if len(names) > 1 else names[0]
        names = names[:-1]
    return None


def _resolve(logical: Optional[str], mesh):
    if logical is None:
        return None
    return _LOGICAL.get(logical, (logical,))


def param_spec(path, leaf, mesh) -> P:
    keys = [p.key for p in path if isinstance(p, DictKey)]
    key = keys[-1] if keys else None
    rule = _PARAM_RULES.get(key)
    if rule is None:
        return P()
    # ZeRO-1 across pods: optimizer moments (under opt/m, opt/v) addition-
    # ally shard their fsdp dim over `pod` — parameters stay pod-replicated
    # (cheap to read every step), moments are touched once per step so the
    # cross-pod gather/scatter is amortizable.
    zero1 = any(k in ("m", "v") for k in keys[:-1]) or key in ("m", "v")
    fsdp_axes = ("pod", "data") if zero1 else ("data",)
    shape = tuple(leaf.shape)
    ndim = len(shape)
    pad = ndim - len(rule)
    entries = [None] * pad
    for i, logical in enumerate(rule):
        axes = _resolve(logical, mesh)
        if logical == "fsdp":
            axes = fsdp_axes
        entries.append(_fit(shape[pad + i], axes, mesh))
    return P(*entries)


def param_sharding_tree(params, mesh):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(path, leaf, mesh)),
        params)


# ---------------------------------------------------------------------------
# Batch / cache shardings per shape kind
# ---------------------------------------------------------------------------


def batch_axes(mesh) -> Tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def kv_seq_axes(mesh, shape: ShapeConfig) -> Optional[Tuple[str, ...]]:
    if shape.name == "long_500k":
        # batch=1: spread the 500k cache over every axis available
        return tuple(axis_names(mesh))
    return ("model",)


def batch_spec(mesh, ndim: int, *, batch_divisible=True) -> P:
    ax = batch_axes(mesh)
    first = ax if batch_divisible else None
    return P(first, *([None] * (ndim - 1)))


def batch_divides(mesh, global_batch: int) -> bool:
    """Whether the batch axes split a batch of ``global_batch`` rows."""
    sizes = axis_sizes(mesh)
    n = math.prod(sizes[a] for a in batch_axes(mesh))
    return global_batch % n == 0 and global_batch >= n


def data_sharding_tree(batch, mesh, global_batch: int):
    ok = batch_divides(mesh, global_batch)
    return tree_map(lambda leaf: NamedSharding(
        mesh, batch_spec(mesh, len(leaf.shape), batch_divisible=ok)), batch)


def cache_spec(path, leaf, mesh, cfg: ModelConfig,
               shape: ShapeConfig) -> P:
    """Sharding for KV / state caches (decode cells)."""
    key = None
    for p in reversed(path):
        if isinstance(p, DictKey):
            key = p.key
            break
    nd = len(leaf.shape)
    bax = batch_axes(mesh)
    b_ok = batch_divides(mesh, shape.global_batch)
    b_entry = bax if b_ok else None
    stacked = nd >= 1 and any(
        isinstance(p, DictKey) and p.key == "periods" for p in path)
    pad = (None,) if stacked else ()

    kvax = kv_seq_axes(mesh, shape)

    if key in ("k", "v"):  # [B, S, hkv, hd]
        s_dim = leaf.shape[-3]
        return P(*pad, b_entry, _fit(s_dim, kvax, mesh), None, None)
    if key == "kpos":  # [B, S]
        s_dim = leaf.shape[-1]
        return P(*pad, b_entry, _fit(s_dim, kvax, mesh))
    if key in ("enc_k", "enc_v"):  # [B, Se, hkv, hd]
        return P(*pad, b_entry, None, None, None)
    if key == "state":  # [B, nh, hd, ds]
        return P(*pad, b_entry, _fit(leaf.shape[-3], ("model",), mesh),
                 None, None)
    if key == "conv":  # [B, cw-1, C]
        return P(*pad, b_entry, None,
                 _fit(leaf.shape[-1], ("model",), mesh))
    if key == "h":  # [B, w]
        return P(*pad, b_entry, _fit(leaf.shape[-1], ("model",), mesh))
    return P()


def cache_sharding_tree(cache, mesh, cfg: ModelConfig, shape: ShapeConfig):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, cache_spec(path, leaf, mesh, cfg, shape)), cache)

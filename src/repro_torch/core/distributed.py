"""Distributed SpMM decompositions (paper §2.4) on a device mesh (the
port of ``repro.core.distributed``).

The paper frames CS-3 SpMM as a distributed matmul: A streamed (not
resident), H partitioned over the PE grid => a 1.5D decomposition; H
replicated across sub-grids => 2.5D.  Across cards the same taxonomy maps
onto per-rank programs over the mesh's process groups (the reference's
``shard_map`` bodies, each written out as one rank's work with explicit
collectives):

  1.5D  A block-rows sharded over `data`; H row-sharded over `data`;
        each rank all-gathers H (N*D/p per rank per step — exactly the
        1.5D cost), then runs the local Block-ELL SpMM.
  2D    A block-rows sharded over `data`; H column-sharded over `model`;
        zero communication — each rank owns a (M/p_d, D/p_m) output tile.
  2.5D  multi-pod: H replicated across the `pod` axis so the 1.5D
        all-gather stays inside a pod; A sharded over (pod, data).

The local product is ``kernels.spmm.ops.spmm_blockell``: K1 for CUDA
tensors, its plain version for CPU tensors.  ``use_kernel`` is kept for
the reference's signature and routes nothing: a CUDA shard always runs
K1.  A's Block-ELL is cut by block rows (``indices``, ``blocks``,
``nblocks``, as the reference's ``_ell_specs``); K1 does not read
``nblocks``.

Every rank of the mesh calls each function with the same whole operands
(or with ``DTensor``s already placed as the reference's ``in_specs``); the
result is a ``DTensor`` placed as its ``out_specs`` (``full_tensor()``
gives the whole product).

`allgather_matmul_overlap` is the collective-matmul trick (a ring of
point-to-point sends) that hides the 1.5D all-gather behind the local
product — compute/comm overlap, the cross-chip version of the paper's
accumulator-row buffering (§3.1.3).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core.formats import BlockELL
from repro_torch.kernels.spmm.ops import spmm_blockell
from repro_torch.sharding.specs import (NamedSharding, PartitionSpec as P,
                                        axis_group, axis_index, axis_sizes,
                                        local, local_shard, whole)


def _as_blockell(a) -> BlockELL:
    """Accept a BlockELL or a ``repro_torch.sparse.SparseMatrix``, which
    is unwrapped to its ``"ell"`` form (converted host-side if it carries
    only other forms)."""
    from repro_torch.sparse.matrix import SparseMatrix

    if isinstance(a, SparseMatrix):
        if "ell" not in a.formats:
            a = a.to("ell")
        return a.form("ell")
    return a


def _ell_rows(ell: BlockELL, mesh, row_axes) -> BlockELL:
    """This rank's block rows of A (the reference's ``_ell_specs``: block
    rows split over ``row_axes``, major to minor)."""
    sizes = axis_sizes(mesh)
    axes = (row_axes,) if isinstance(row_axes, str) else tuple(row_axes)
    n = 1
    for a in axes:
        n *= sizes[a]
    nbr = ell.n_block_rows
    if nbr % n:
        raise ValueError(f"{nbr} block rows do not split over {axes} "
                         f"({n} ranks)")
    per = nbr // n
    i = axis_index(mesh, axes)
    sl = slice(i * per, (i + 1) * per)
    return dataclasses.replace(
        ell, indices=ell.indices[sl], blocks=ell.blocks[sl],
        nblocks=ell.nblocks[sl], shape=(per * ell.bm, ell.shape[1]))


def _part(x, mesh, spec: P) -> torch.Tensor:
    """This rank's part of an operand placed as ``spec``: a ``DTensor``'s
    local tensor, or the matching slice of a whole tensor."""
    if hasattr(x, "to_local"):
        return local(x)
    return local_shard(x, mesh, NamedSharding(mesh, spec).placements)


def _result(y: torch.Tensor, mesh, spec: P):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(y, mesh, NamedSharding(mesh, spec).placements,
                              run_check=False)


def _all_gather_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The rows of ``x`` from every rank along ``axis``, in axis order."""
    group = axis_group(mesh, axis)
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def spmm_1p5d(ell, h, mesh, *, row_axis: str = "data",
              use_kernel: bool = False):
    """1.5D: A row-sharded, H row-sharded + all-gathered per step.

    ``ell``: BlockELL or ``repro_torch.sparse.SparseMatrix``.
    """
    del use_kernel  # a CUDA shard always runs K1
    ell = _ell_rows(_as_blockell(ell), mesh, row_axis)
    h_full = _all_gather_rows(_part(h, mesh, P(row_axis, None)), mesh,
                              row_axis)
    return _result(spmm_blockell(ell, h_full), mesh, P(row_axis, None))


def spmm_2d(ell, h, mesh, *, row_axis: str = "data",
            col_axis: str = "model", use_kernel: bool = False):
    """2D: A row-sharded over data, H column-sharded over model; no comm.

    ``ell``: BlockELL or ``repro_torch.sparse.SparseMatrix``.
    """
    del use_kernel
    ell = _ell_rows(_as_blockell(ell), mesh, row_axis)
    h_local = _part(h, mesh, P(None, col_axis)).contiguous()
    return _result(spmm_blockell(ell, h_local), mesh, P(row_axis, col_axis))


def spmm_2p5d(ell, h, mesh, *, pod_axis: str = "pod",
              row_axis: str = "data", use_kernel: bool = False):
    """2.5D multi-pod: H replicated across pods; all-gather intra-pod only.

    A's block-rows are sharded over (pod, data) jointly; each pod computes
    its row stripe of Y independently — no inter-pod traffic.
    ``ell``: BlockELL or ``repro_torch.sparse.SparseMatrix``.
    """
    del use_kernel
    ell = _ell_rows(_as_blockell(ell), mesh, (pod_axis, row_axis))
    # H row-sharded over data, replicated on pod
    h_full = _all_gather_rows(_part(h, mesh, P(row_axis, None)), mesh,
                              row_axis)
    return _result(spmm_blockell(ell, h_full), mesh,
                   P((pod_axis, row_axis), None))


# ---------------------------------------------------------------------------
# Collective matmul: all-gather overlapped with compute via a ring
# ---------------------------------------------------------------------------


def allgather_matmul_overlap(x, w, mesh, *, axis: str = "model"):
    """y = x @ w_full where w is row-sharded over `axis`.

    Instead of all-gather(w) then matmul (serializing comm before
    compute), runs a ring: at step t each rank multiplies the w shard it
    holds against the matching x column slice while sending the shard to
    its neighbour — the send hidden behind the per-step matmul.
    x: [..., K] (replicated on `axis`); w: [K, N] sharded on rows (K).
    Returns a replicated ``DTensor``.
    """
    group = axis_group(mesh, axis)
    n = dist.get_world_size(group)
    idx = axis_index(mesh, axis)
    x_local = whole(x)
    w_cur = _part(w, mesh, P(axis, None))
    dtype = torch.promote_types(x_local.dtype, w_cur.dtype)
    x_local, w_cur = x_local.to(dtype), w_cur.to(dtype).contiguous()
    k_shard = w_cur.shape[0]
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    acc = None
    for t in range(n):
        reqs, w_next = [], None
        if t < n - 1:  # the last hop would only bring the shard home
            w_next = torch.empty_like(w_cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, w_cur, nxt, group),
                dist.P2POp(dist.irecv, w_next, prv, group)])
        # the shard held at step t originated at rank (idx - t) mod n
        src = (idx - t) % n
        part = torch.matmul(x_local[..., src * k_shard:(src + 1) * k_shard],
                            w_cur)
        acc = part if acc is None else acc + part
        for r in reqs:
            r.wait()
        if w_next is not None:
            w_cur = w_next
    return _result(acc, mesh, P())

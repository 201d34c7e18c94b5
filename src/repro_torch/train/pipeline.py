"""GPipe-style pipeline parallelism over a mesh axis (the port of
``repro.train.pipeline``).

Each rank along ``axis`` owns one contiguous stage of layer periods;
microbatches stream through with point-to-point handoffs to the next
stage (forward fill, steady state, drain).  The reference's ``shard_map``
body is written out as one rank's work: every rank of the mesh calls
:func:`pipeline_apply` with the same arguments.

Gradients flow through it: the handoff's backward sends each
activation's gradient back to the stage it came from, and the final
gathering passes the (replicated) output's gradient to the last stage
once.  Every rank runs ``stage_fn`` at every tick, as the reference does
(a tick with no microbatch computes on its register and discards the
result), so every rank's autograd graph has the same handoffs in the same
order.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.sharding.specs import axis_group, axis_index, axis_sizes
from repro_torch.tree import tree_map


def _exchange(x: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(), to, group),
        dist.P2POp(dist.irecv, out, frm, group)])
    for r in reqs:
        r.wait()
    return out


class _Handoff(torch.autograd.Function):
    """Send ``y`` to the next stage and take the previous stage's (the
    reference's ``ppermute`` ring); the backward sends the gradient the
    other way round."""

    @staticmethod
    def forward(ctx, y, group, nxt, prv):
        ctx.group, ctx.nxt, ctx.prv = group, nxt, prv
        return _exchange(y.detach(), nxt, prv, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.prv, ctx.nxt, ctx.group), None, None, None


class _Gather(torch.autograd.Function):
    """Sum over the stages (the reference's ``psum``: only the last stage
    holds nonzero outputs).  The output is replicated, and each rank's
    copy has the same gradient, which goes back once, unsummed.  ``tail``
    (the last tick's activation) gets a zero gradient: it ties every
    handoff of this rank into the graph, so every rank runs every
    handoff's backward, in the same order."""

    @staticmethod
    def forward(ctx, x, tail, group):
        ctx.tail_shape = (tail.shape, tail.dtype, tail.device)
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.tail_shape
        return g, torch.zeros(shape, dtype=dtype, device=device), None


def _own_stage(a, sid: int):
    """This rank's stage of a leaf with a leading ``[n_stages]`` axis: a
    ``DTensor`` sharded over the axis holds it as its local ``[1, ...]``;
    a whole tensor is indexed."""
    if hasattr(a, "to_local"):
        return a.to_local()[0]
    return a[sid]


def pipeline_apply(stage_fn: Callable, stage_params, x_micro, mesh,
                   *, axis: str = "pod"):
    """Run microbatches through pipeline stages laid out along ``axis``.

    stage_fn(params, x) -> x          (one stage's computation)
    stage_params: tree with a leading [n_stages] axis (each rank uses its
        own stage's params).
    x_micro: [n_micro, mb, ...] microbatched input (the same on every
        rank).
    Returns [n_micro, mb, ...] outputs (on every rank), computed as
    stage_{S-1}(... stage_0(x)).

    Schedule: n_micro + n_stages - 1 ticks.  At tick t, stage s processes
    microbatch (t - s) if 0 <= t - s < n_micro; activations pass to s+1
    between ticks.  Bubble fraction = (S-1)/(n_micro + S - 1).
    """
    n_stages = axis_sizes(mesh)[axis]
    n_micro = x_micro.shape[0]
    group = axis_group(mesh, axis)
    sid = axis_index(mesh, axis)
    nxt = dist.get_global_rank(group, (sid + 1) % n_stages)
    prv = dist.get_global_rank(group, (sid - 1) % n_stages)
    params = tree_map(lambda a: _own_stage(a, sid), stage_params)
    first = torch.tensor(sid == 0, device=x_micro.device)
    last = sid == n_stages - 1

    buf = x_micro.new_zeros(x_micro.shape[1:])  # activation register
    outs = [None] * n_micro
    n_ticks = n_micro + n_stages - 1
    for t in range(n_ticks):
        mb_idx = t - sid
        active = 0 <= mb_idx < n_micro
        # stage 0 ingests a fresh microbatch
        feed = x_micro[min(t, n_micro - 1)]
        y = stage_fn(params, torch.where(first, feed, buf))
        y = torch.where(torch.tensor(active, device=y.device), y, buf)
        if active and last:  # the last stage records finished microbatches
            outs[mb_idx] = y
        # hand activations to the next stage (after the last tick nobody
        # reads them)
        if t < n_ticks - 1:
            buf = _Handoff.apply(y, group, nxt, prv) if n_stages > 1 else y
    mine = torch.stack(outs) if last else torch.zeros_like(x_micro)
    return _Gather.apply(mine, y, group)

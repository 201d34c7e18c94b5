"""Mixture-of-Experts FFN with sort-based capacity dispatch (the port of
``repro.models.moe``).

Top-1 routing *is* the paper's SpMM with a one-nonzero-per-row dispatch
matrix A (tokens x expert-slots), the hyper-sparse regime.  Its realization
here is the reference's: group tokens by expert with a sort, truncate each
expert's group to its capacity, and run one batched matmul over the
experts.

Expert parallelism: with a mesh installed (``repro_torch.sharding``)
whose ``model`` axis divides the experts, each model-rank runs the
dispatch on ITS experts for its slice of the batch (split over
``pod`` / ``data`` when that divides it), and the partial outputs fold
with one sum over the ``model`` group, in ``x.dtype`` as the reference
sums on the wire: with top-1 routing each token has exactly one nonzero
contribution across ranks.  The reference's ``shard_map`` body is written
out as one rank's work; every rank of the mesh calls ``moe_ffn`` with the
same whole ``x`` and params and gets the whole output back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _he, activation, init_mlp, mlp
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding.specs import (axis_group, axis_index, axis_names,
                                        axis_sizes)


def init_moe(gen, cfg: ModelConfig, *, lead=()):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": _he(gen, (d, e), lead=lead),
        "w_in": _he(gen, (e, d, f), scale_dim=d, lead=lead),
        "w_out": _he(gen, (e, f, d), scale_dim=f, lead=lead),
    }
    if cfg.gated_mlp:
        p["w_gate"] = _he(gen, (e, d, f), scale_dim=d, lead=lead)
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, f=cfg.d_ff * cfg.n_shared_experts,
                               lead=lead)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = int(np.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)  # round up to 8 for layout friendliness


def top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no tie
    order on CUDA)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_compute(p_router, w_in, w_gate, w_out, xf, cfg: ModelConfig,
                      e_offset: int, e_local: int, cap: int):
    """Local sort-based dispatch over xf [T,d] for experts
    [e_offset, e_offset + e_local).  Returns (y [T,d] f32, aux scalar)."""
    t, d = xf.shape
    e = cfg.n_experts
    dev = xf.device
    router_logits = xf.float() @ p_router.float()  # [T, E]
    probs = torch.softmax(router_logits, dim=-1)
    gate_all, eid_all = top_k(probs, cfg.top_k)
    one_hot = torch.nn.functional.one_hot(eid_all[:, 0], e).float()
    aux = e * e * torch.mean(one_hot.mean(0) * probs.mean(0))

    ar = torch.arange(t, device=dev)
    y = torch.zeros((t, d), dtype=torch.float32, device=dev)
    for slot in range(cfg.top_k):
        eid = eid_all[:, slot] - e_offset  # local expert id (may be OOR)
        gate = gate_all[:, slot]
        mine = (eid >= 0) & (eid < e_local)
        eid_c = torch.where(mine, eid, e_local)  # OOR -> overflow bin
        # --- local sort-based grouping (the router's re-bucketing) --------
        order = torch.sort(eid_c * t + ar, stable=True).indices
        eid_s = eid_c[order]
        counts = torch.bincount(eid_c, minlength=e_local + 1)
        starts = torch.cumsum(counts, 0) - counts
        rank = ar - starts[eid_s]
        keep = (eid_s < e_local) & (rank < cap)
        # every dropped token writes the one overflow row, which is cut
        # off: the order of those writes cannot matter
        dest = torch.where(keep, eid_s * cap + rank, e_local * cap)
        buf = xf.new_zeros((e_local * cap + 1, d))
        buf[dest] = xf[order]
        buf = buf[: e_local * cap].reshape(e_local, cap, d)
        # --- expert compute (batched over local experts) -------------------
        h = torch.bmm(buf, w_in.to(buf.dtype))
        h = activation(h, cfg.act)
        if w_gate is not None:
            h = h * torch.bmm(buf, w_gate.to(buf.dtype))
        out = torch.bmm(h, w_out.to(buf.dtype))
        # --- combine (inverse scatter, gate-weighted) -----------------------
        flat = out.reshape(e_local * cap, d)
        src = torch.where(keep, eid_s * cap + rank, 0)
        ys = torch.where(keep[:, None], flat[src], 0).float()
        inv = torch.empty_like(order)
        inv[order] = ar
        y = y + (ys * gate[order][:, None])[inv]
    return y, aux


def _expert_parallel(p, x, cfg: ModelConfig, mesh):
    """One rank's share of ``moe_ffn`` on a mesh (the reference's
    ``shard_map`` branch); returns the whole ``(y [B*S, d] in x.dtype,
    aux)``."""
    from torch.distributed.nn import functional as dist_fn

    b, s, d = x.shape
    sizes = axis_sizes(mesh)
    tp = sizes["model"]
    e_local = cfg.n_experts // tp
    batch_ax = tuple(a for a in ("pod", "data") if a in sizes)
    nb = int(np.prod([sizes[a] for a in batch_ax])) if batch_ax else 1
    b_ok = b % nb == 0 and b >= nb
    split = b_ok and nb > 1
    x_local = x.reshape((nb, b // nb, s, d))[axis_index(mesh, batch_ax)] \
        if split else x
    cap = _capacity(x_local.shape[0] * s, cfg)
    rank = axis_index(mesh, "model")
    mine = slice(rank * e_local, (rank + 1) * e_local)
    w_gate = p["w_gate"][mine] if "w_gate" in p else None
    yl, aux = _dispatch_compute(
        p["router"], p["w_in"][mine], w_gate, p["w_out"][mine],
        x_local.reshape(-1, d), cfg, e_offset=rank * e_local,
        e_local=e_local, cap=cap)
    # fold the partial expert outputs in x.dtype (one rounding: one
    # nonzero contribution a token)
    yl = dist_fn.all_reduce(yl.to(x.dtype), group=axis_group(mesh, "model"))
    everyone = axis_group(mesh, axis_names(mesh))
    aux = dist_fn.all_reduce(aux, group=everyone) \
        / torch.distributed.get_world_size(everyone)
    if split:
        yl = torch.cat(dist_fn.all_gather(
            yl.contiguous(), group=axis_group(mesh, batch_ax)))
    return yl, aux


def moe_ffn(p, x, cfg: ModelConfig):
    """x: [B, S, d] -> ([B, S, d], aux load-balance loss)."""
    b, s, d = x.shape
    mesh = shard_ctx.current_mesh()
    ep_ok = (mesh is not None and "model" in axis_names(mesh)
             and cfg.n_experts % axis_sizes(mesh)["model"] == 0)
    xf = x.reshape(-1, d)
    if not ep_ok:
        cap = _capacity(xf.shape[0], cfg)
        y, aux = _dispatch_compute(
            p["router"], p["w_in"], p.get("w_gate"), p["w_out"], xf, cfg,
            e_offset=0, e_local=cfg.n_experts, cap=cap)
    else:
        y, aux = _expert_parallel(p, x, cfg, mesh)
    y = y.to(x.dtype)  # (already x.dtype on the EP path)
    if "shared" in p:
        y = y + mlp(p["shared"], xf, cfg)
    return y.reshape(b, s, d), aux

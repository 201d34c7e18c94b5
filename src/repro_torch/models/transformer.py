"""Config-driven LM: dense / MoE / SSM / hybrid / enc-dec / VLM (the port
of ``repro.models.transformer``).

Layer stacking: the layer pattern (``cfg.layer_pattern``) repeats down the
stack; the params stack whole periods on a leading axis (the reference's
tree, leaf for leaf), and the port loops over the periods; a partial
trailing period ("remainder") is applied after them.  Every block kind
threads an optional cache entry, so the same code serves train (no
cache), prefill (build cache) and decode (consume and update the cache).

The port runs eagerly.  ``decode_step`` reads ``cache["pos"]`` (a 0-d
int32 tensor, as in the reference's tree) to the host once a step and
writes the cache's tensors in place; it returns the same tree with
``pos`` advanced.  The reference's ``shard_hint`` constraints are no-ops
without a mesh and ``runtime.unrolled()`` is a cost mode of its dry run:
a cost mode of its dry run that waits for the port's ``runtime`` module:
the port always loops.  The reference's ``shard_hint`` calls are in place
(``repro_torch.sharding.shard_hint``: the identity on per-rank tensors).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_ffn
from repro_torch.models.rglru import (init_rglru, init_rglru_cache,
                                      rglru_decode_step, rglru_forward)
from repro_torch.models.ssm import (init_ssm, init_ssm_cache, ssm_decode_step,
                                    ssm_forward)
from repro_torch.sharding import shard_hint
from repro_torch.tree import tree_leaves, tree_map  # noqa: F401 (public)

ATTN_KINDS = ("attn", "local", "moe")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def compute_dtype(dtype) -> torch.dtype:
    """A torch dtype from the reference's spelling (``cfg.dtype``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return DTYPES[str(dtype)]


# ---------------------------------------------------------------------------
# Param trees (nested dicts / tuples / lists of leaves)
# ---------------------------------------------------------------------------


def lm_params_from_numpy(tree, device="cuda"):
    """The reference's params with numpy leaves (``np.asarray`` of each)
    as the same tree of f32 tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(dev), tree)


# leaves read in f32 (or both ways): norm scales, the embedding (gathered,
# then cast; a tied head reads it in f32), the untied head, the MoE router,
# the SSM's and RG-LRU's constants and convolution.  Every other dense leaf
# is only ever read as ``w.to(x.dtype)``.
_F32_LEAVES = frozenset((
    "ln1", "ln2", "lnx", "final_ln", "norm",  # norms
    "embed", "lm_head", "router",
    "A_log", "D", "dt_bias", "conv_w", "conv_b",  # SSM (conv: RG-LRU too)
    "lam"))  # RG-LRU


def cast_weights(params, cfg: ModelConfig):
    """A copy of the params in which every dense leaf that the model only
    ever reads cast to the compute dtype (all but ``_F32_LEAVES``) is cast
    once, here.  The model's ``w.to(x.dtype)`` is then a no-op, and every
    output is the same bits as casting at each use.  Sparse weights stay
    as they are.  At f32 the params are returned as they are."""
    dtype = compute_dtype(cfg.dtype)
    if dtype == torch.float32:
        return params

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, key) for v in node)
        if isinstance(node, torch.Tensor) and key not in _F32_LEAVES:
            return node.to(dtype)
        return node

    return walk(params)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(gen, kind: str, cfg: ModelConfig, cross: bool = False, *,
                lead=()):
    d = cfg.d_model
    p: Dict[str, Any] = {"ln1": L._zeros(gen, (d,), lead=lead)}
    if kind in ATTN_KINDS:
        p["attn"] = L.init_attn(gen, cfg, lead=lead)
        p["ln2"] = L._zeros(gen, (d,), lead=lead)
        if kind == "moe":
            p["moe"] = init_moe(gen, cfg, lead=lead)
        else:
            p["mlp"] = L.init_mlp(gen, cfg, lead=lead)
    elif kind == "ssm":
        p["ssm"] = init_ssm(gen, cfg, lead=lead)
    elif kind == "rglru":
        p["rec"] = init_rglru(gen, cfg, lead=lead)
        p["ln2"] = L._zeros(gen, (d,), lead=lead)
        p["mlp"] = L.init_mlp(gen, cfg, lead=lead)
    else:
        raise ValueError(kind)
    if cross:
        p["lnx"] = L._zeros(gen, (d,), lead=lead)
        p["xattn"] = L.init_attn(gen, cfg, cross=True, lead=lead)
    return p


def _unstacked_periods(periods) -> bool:
    """True when ``params["periods"]`` is a tuple of per-period block
    tuples rather than stacked leaves (``models.pruning.sparsify_lm``'s
    layout: each pruned weight has its own structure)."""
    return bool(periods) and isinstance(periods[0], tuple)


def init_lm(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """He-scaled f32 weights drawn from a ``torch.Generator`` on
    ``device`` (seeded with ``seed``), in the reference's tree: period
    blocks stacked on a leading ``n_periods`` axis.  The draws differ from
    ``jax.random``'s; weights cross between the packages only through
    ``lm_params_from_numpy``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cross = cfg.encoder_layers > 0
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": L._he(gen, (cfg.vocab_size, d), scale_dim=d),
        "periods": tuple(
            _init_block(gen, kind, cfg, cross=cross, lead=(cfg.n_periods,))
            for kind in cfg.layer_pattern) if cfg.n_periods else (),
        "remainder": tuple(_init_block(gen, kind, cfg, cross=cross)
                           for kind in cfg.remainder_kinds),
        "final_ln": L._zeros(gen, (d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._he(gen, (d, cfg.vocab_size))
    if cfg.vision_tokens:
        params["vision_proj"] = L._he(gen, (d, d))
    if cfg.encoder_layers:
        params["encoder"] = {
            "blocks": _init_block(gen, "attn", cfg,
                                  lead=(cfg.encoder_layers,)),
            "final_ln": L._zeros(gen, (d,)),
        }
    return params


# ---------------------------------------------------------------------------
# Block application (full sequence: train / prefill)
# ---------------------------------------------------------------------------


def _apply_block(p, x, kind: str, cfg: ModelConfig, *, positions,
                 enc_out=None, mode: str = "train",
                 max_len: Optional[int] = None):
    """Returns (x, cache_entry_or_None, aux_loss)."""
    aux = x.new_zeros((), dtype=torch.float32)
    cache_entry = None
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        if mode == "prefill":
            y, cache_entry = _prefill_self_attention(
                p["attn"], h, cfg, kind=kind, positions=positions,
                max_len=max_len)
        else:
            y = L.self_attention(p["attn"], h, cfg, kind=kind,
                                 positions=positions)
        x = x + y
        if enc_out is not None:
            hx = L.rms_norm(x, p["lnx"], cfg.norm_eps)
            enc_kv = L.encode_cross_kv(p["xattn"], enc_out, cfg)
            x = x + L.cross_attention(p["xattn"], hx, enc_kv, cfg)
            if mode == "prefill":
                cache_entry = {"self": cache_entry, "enc_k": enc_kv[0],
                               "enc_v": enc_kv[1]}
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind == "moe":
            y2, aux = moe_ffn(p["moe"], h2, cfg)
        else:
            y2 = L.mlp(p["mlp"], h2, cfg)
        x = x + y2
    elif kind == "ssm":
        if mode == "prefill":
            y, cache_entry = ssm_forward(p["ssm"], h, cfg, return_state=True)
        else:
            y = ssm_forward(p["ssm"], h, cfg)
        x = x + y
    elif kind == "rglru":
        if mode == "prefill":
            y, cache_entry = rglru_forward(p["rec"], h, cfg,
                                           return_state=True)
        else:
            y = rglru_forward(p["rec"], h, cfg)
        x = x + y
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h2, cfg)
    x = shard_hint(x, "batch", "seq", "embed")
    return x, cache_entry, aux


def _prefill_self_attention(p, x, cfg: ModelConfig, *, kind: str, positions,
                            max_len: int):
    """Full-sequence attention that also materializes the decode cache."""
    b, s, _ = x.shape
    q, k, v = L._qkv(p, x, x, cfg)
    if cfg.family != "audio":
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    # prefill is forward-only: the flash loop skips the masked blocks
    out = L.attend(q, k, v, cfg, kind=kind, causal=True,
                   skip_masked_blocks=True)
    y = out.reshape(b, s, -1) @ p["wo"].to(x.dtype)

    size = min(max_len, cfg.window) if kind == "local" else max_len
    take = min(s, size)
    # the tail's slots, from the sequence positions 0..s-1 on the host (no
    # sync); the reference's scatter drops slots past the cache (a global
    # layer whose max_len is below the prompt)
    tail = np.arange(s - take, s)
    slots = tail % size if kind == "local" else tail
    keep = np.nonzero(slots < size)[0] + (s - take)
    dev = x.device
    src = torch.as_tensor(keep, device=dev)
    dst = torch.as_tensor(slots[slots < size], device=dev)
    kc = k.new_zeros((b, size) + k.shape[2:])
    vc = v.new_zeros((b, size) + v.shape[2:])
    kpos = torch.full((b, size), -1, dtype=torch.int32, device=dev)
    kc[:, dst] = k[:, src]
    vc[:, dst] = v[:, src]
    kpos[:, dst] = positions[:, src].to(torch.int32)
    return y, {"k": kc, "v": vc, "kpos": kpos}


# ---------------------------------------------------------------------------
# Decode block application
# ---------------------------------------------------------------------------


def _decode_block(p, x, cache_entry, kind: str, cfg: ModelConfig, *, pos):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        self_cache = cache_entry["self"] if "enc_k" in cache_entry \
            else cache_entry
        y, new_self = L.decode_self_attention(p["attn"], h, self_cache, cfg,
                                              kind=kind, pos=pos)
        x = x + y
        if "enc_k" in cache_entry:
            hx = L.rms_norm(x, p["lnx"], cfg.norm_eps)
            x = x + L.cross_attention(
                p["xattn"], hx, (cache_entry["enc_k"], cache_entry["enc_v"]),
                cfg)
            new_cache = dict(cache_entry)
            new_cache["self"] = new_self
        else:
            new_cache = new_self
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if kind == "moe":
            y2, _ = moe_ffn(p["moe"], h2, cfg)
        else:
            y2 = L.mlp(p["mlp"], h2, cfg)
        x = x + y2
    elif kind == "ssm":
        y, new_cache = ssm_decode_step(p["ssm"], h, cache_entry, cfg)
        x = x + y
    elif kind == "rglru":
        y, new_cache = rglru_decode_step(p["rec"], h, cache_entry, cfg)
        x = x + y
        h2 = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h2, cfg)
    return x, new_cache


# ---------------------------------------------------------------------------
# Full forward (train / prefill)
# ---------------------------------------------------------------------------


class _EmbedRows(torch.autograd.Function):
    """``table[ids]``, whose backward sums each row's gradients in f32 in
    one fixed order (the ids sorted stably, one ``segment_reduce``):
    the plain gather's backward (``index_put_`` with accumulate) adds a
    repeated token's gradients with atomics on CUDA."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        return table[ids]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        rows, perm = torch.sort(flat, stable=True)
        bounds = torch.searchsorted(
            rows, torch.arange(ctx.rows + 1, device=rows.device))
        terms = g.reshape((flat.shape[0],) + g.shape[ids.dim():])[perm]
        sums = torch.segment_reduce(terms.float(), "sum",
                                    lengths=bounds.diff(), axis=0,
                                    unsafe=True)
        return sums.to(ctx.dtype), None


def _embed_inputs(params, cfg: ModelConfig, tokens, vision_embeds=None,
                  dtype=None):
    dtype = compute_dtype(dtype or cfg.dtype)
    # gather, then cast: the same bits as the reference's cast-then-gather
    x = _EmbedRows.apply(params["embed"], tokens.long()).to(dtype)
    if cfg.vision_tokens and vision_embeds is not None:
        vproj = vision_embeds.to(dtype) @ params["vision_proj"].to(dtype)
        x = torch.cat([vproj, x], dim=1)
    if cfg.family == "audio":
        x = x + L.sinusoid_positions(x.shape[1], cfg.d_model,
                                     device=x.device).to(dtype)
    return shard_hint(x, "batch", "seq", "embed")


def _index(tree, i):
    return tree_map(lambda a: a[i], tree)


def _run_encoder(params, cfg: ModelConfig, enc_embeds):
    """Whisper encoder over (stubbed) frame embeddings [B, Se, d]."""
    dtype = compute_dtype(cfg.dtype)
    x = enc_embeds.to(dtype)
    x = x + L.sinusoid_positions(x.shape[1], cfg.d_model,
                                 device=x.device).to(dtype)
    b, se, _ = x.shape
    positions = torch.arange(se, device=x.device)[None].expand(b, se)

    def body(x, blk_p):
        h = L.rms_norm(x, blk_p["ln1"], cfg.norm_eps)
        y = L.self_attention(blk_p["attn"], h, cfg, kind="attn",
                             positions=positions, causal=False)
        x = x + y
        h2 = L.rms_norm(x, blk_p["ln2"], cfg.norm_eps)
        return x + L.mlp(blk_p["mlp"], h2, cfg)

    for i in range(cfg.encoder_layers):
        blk_p = _index(params["encoder"]["blocks"], i)
        if torch.is_grad_enabled():
            x = checkpoint(body, x, blk_p, use_reentrant=False)
        else:
            x = body(x, blk_p)
    return L.rms_norm(x, params["encoder"]["final_ln"], cfg.norm_eps)


def _stack_caches(pcs):
    return tree_map(lambda *xs: torch.stack(xs), pcs[0], *pcs[1:])


def forward_hidden(params, cfg: ModelConfig, tokens, *, vision_embeds=None,
                   enc_embeds=None, mode: str = "train",
                   max_len: Optional[int] = None, remat: bool = True,
                   remat_policy: str = "nothing"):
    """Returns (hidden [B,S,d], cache_or_None, aux_loss).

    ``remat`` (train mode, gradients on): each period runs under
    ``torch.utils.checkpoint`` (activations recomputed in the backward;
    the values do not change).  ``remat_policy``: "nothing" saves no
    activation of a period; "dots" saves the outputs of its matrix
    products (the reference's ``dots_saveable``), a selective checkpoint
    that recomputes only the rest."""
    x = _embed_inputs(params, cfg, tokens, vision_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    enc_out = None
    if cfg.encoder_layers and enc_embeds is not None:
        enc_out = _run_encoder(params, cfg, enc_embeds)

    def period_body(x, aux, period_p):
        caches = []
        for j, kind in enumerate(cfg.layer_pattern):
            x, ce, a = _apply_block(period_p[j], x, kind, cfg,
                                    positions=positions, enc_out=enc_out,
                                    mode=mode, max_len=max_len)
            aux = aux + a
            caches.append(ce)
        return x, aux, tuple(caches)

    def remat_body(x, aux, period_p):
        x, aux, _ = period_body(x, aux, period_p)
        return x, aux

    aux = x.new_zeros((), dtype=torch.float32)
    unstacked = _unstacked_periods(params["periods"])
    pcs = []
    for i in range(cfg.n_periods):
        period_p = params["periods"][i] if unstacked else \
            _index(params["periods"], i)
        if remat and mode == "train" and torch.is_grad_enabled():
            kw = {"context_fn": _SAVE_DOTS} if remat_policy == "dots" \
                else {}
            x, aux = checkpoint(remat_body, x, aux, period_p,
                                use_reentrant=False, **kw)
        else:
            x, aux, pc = period_body(x, aux, period_p)
            pcs.append(pc)
    period_caches = _stack_caches(pcs) if pcs and mode == "prefill" else ()

    rem_caches = []
    for j, kind in enumerate(cfg.remainder_kinds):
        x, ce, a = _apply_block(params["remainder"][j], x, kind, cfg,
                                positions=positions, enc_out=enc_out,
                                mode=mode, max_len=max_len)
        aux = aux + a
        rem_caches.append(ce)

    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    cache = None
    if mode == "prefill":
        cache = {"periods": period_caches, "remainder": tuple(rem_caches),
                 "pos": torch.tensor(s, dtype=torch.int32, device=x.device)}
    return x, cache, aux


# the ops whose outputs ``remat_policy="dots"`` keeps (JAX's dot_general:
# every matrix product as autograd's dispatcher sees it)
_DOTS = frozenset(getattr(torch.ops.aten, name).default for name in (
    "mm", "bmm", "addmm", "baddbmm", "mv", "dot"))


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


_SAVE_DOTS = functools.partial(create_selective_checkpoint_contexts,
                               _dots_policy)


def _lm_head(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def chunked_ce_loss(hidden, head_w, targets, mask, *, chunk: int = 1024):
    """Cross-entropy computed per sequence chunk so [B,S,V] logits are
    never materialized (V can be 262k); each chunk is recomputed in the
    backward.  hidden: [B,S,d]."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    head32 = head_w.float()

    def one(h, t, m):
        logits = h.float() @ head32  # [B,chunk,V]
        logits = shard_hint(logits, "batch", None, "vocab")
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t[..., None].long())[..., 0]
        return ((lse - gold) * m).sum()

    nll = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, s, chunk):
        args = (hidden[:, i:i + chunk], targets[:, i:i + chunk],
                mask[:, i:i + chunk])
        if torch.is_grad_enabled():
            nll = nll + checkpoint(one, *args, use_reentrant=False)
        else:
            nll = nll + one(*args)
    return nll / torch.clamp(mask.sum(), min=1.0)


def lm_loss(params, cfg: ModelConfig, batch, *, aux_weight: float = 0.01,
            remat: bool = True, remat_policy: str = "nothing"):
    """batch: dict(tokens[B,S], targets[B,S], mask[B,S], vision_embeds?,
    enc_embeds?)."""
    hidden, _, aux = forward_hidden(
        params, cfg, batch["tokens"],
        vision_embeds=batch.get("vision_embeds"),
        enc_embeds=batch.get("enc_embeds"), mode="train", remat=remat,
        remat_policy=remat_policy)
    if cfg.vision_tokens:
        hidden = hidden[:, cfg.vision_tokens:]
    loss = chunked_ce_loss(hidden, _lm_head(params, cfg), batch["targets"],
                           batch["mask"].float())
    return loss + aux_weight * aux


# ---------------------------------------------------------------------------
# Serving entry points
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """An empty decode cache on ``device`` (period entries stacked on a
    leading ``n_periods`` axis, as the reference's)."""
    dtype = compute_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)

    def entry(kind, lead=()):
        if kind in ATTN_KINDS:
            c = L.init_attn_cache(cfg, batch, max_len, kind, dtype, dev,
                                  lead=lead)
            if cfg.encoder_layers:
                hkv, hd = cfg.n_kv_heads, cfg.head_dim
                shape = tuple(lead) + (batch, cfg.encoder_seq, hkv, hd)
                c = {"self": c,
                     "enc_k": torch.zeros(shape, dtype=dtype, device=dev),
                     "enc_v": torch.zeros(shape, dtype=dtype, device=dev)}
            return c
        if kind == "ssm":
            return init_ssm_cache(cfg, batch, dtype, dev, lead=lead)
        if kind == "rglru":
            return init_rglru_cache(cfg, batch, dtype, dev, lead=lead)
        raise ValueError(kind)

    periods = tuple(entry(k, (cfg.n_periods,)) for k in cfg.layer_pattern) \
        if cfg.n_periods else ()
    remainder = tuple(entry(k) for k in cfg.remainder_kinds)
    return {"periods": periods, "remainder": remainder,
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def prefill(params, cfg: ModelConfig, tokens, max_len: int, *,
            vision_embeds=None, enc_embeds=None):
    """Returns (last-token logits [B,V] f32, cache)."""
    with torch.no_grad():
        hidden, cache, _ = forward_hidden(
            params, cfg, tokens, vision_embeds=vision_embeds,
            enc_embeds=enc_embeds, mode="prefill", max_len=max_len,
            remat=False)
        last = hidden[:, -1]
        logits = last.float() @ _lm_head(params, cfg).float()
    return logits, cache


def _write_back(old, new):
    """Copy a block's new cache entry into the cache's tensors (a no-op
    for tensors it updated in place)."""
    def put(o, n):
        if n is not o:
            o.copy_(n)
    tree_map(put, old, new)


def decode_step(params, cfg: ModelConfig, token, cache):
    """token: [B,1] int.  Returns (logits [B,V] f32, cache): the cache's
    tensors are updated in place and ``pos`` advanced."""
    dtype = compute_dtype(cfg.dtype)
    pos_t = cache["pos"]
    pos = int(pos_t)  # the step's one read of the position to the host
    with torch.no_grad():
        x = params["embed"][token.long()].to(dtype)
        if cfg.family == "audio":
            half = np.arange(0, cfg.d_model, 2) / cfg.d_model
            ang = pos_t.float() / (10000.0 ** torch.as_tensor(
                half, dtype=torch.float32, device=x.device))
            pe = torch.zeros((cfg.d_model,), dtype=torch.float32,
                             device=x.device)
            pe[0::2] = torch.sin(ang)
            pe[1::2] = torch.cos(ang)
            x = x + pe.to(dtype)

        unstacked = _unstacked_periods(params["periods"])
        for i in range(cfg.n_periods):
            period_p = params["periods"][i] if unstacked else \
                _index(params["periods"], i)
            period_c = _index(cache["periods"], i)
            for j, kind in enumerate(cfg.layer_pattern):
                x, nc = _decode_block(period_p[j], x, period_c[j], kind, cfg,
                                      pos=pos)
                _write_back(period_c[j], nc)

        for j, kind in enumerate(cfg.remainder_kinds):
            x, nc = _decode_block(params["remainder"][j], x,
                                  cache["remainder"][j], kind, cfg, pos=pos)
            _write_back(cache["remainder"][j], nc)

        x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
        logits = x[:, 0].float() @ _lm_head(params, cfg).float()
        logits = shard_hint(logits, "batch", "vocab")
    new_cache = {"periods": cache["periods"], "remainder": cache["remainder"],
                 "pos": pos_t + 1}
    return logits, new_cache

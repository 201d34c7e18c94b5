"""Shared LM building blocks (the port of ``repro.models.layers``):
plain functions on tensors, params as the reference's tree of dicts.

Weights are f32 and are read cast to the activations' dtype at each
product (``w.to(x.dtype)``, a no-op when they already are: see
``transformer.cast_weights``).  Norm scales, the router and the SSM's and
RG-LRU's recurrence constants stay f32, as in the reference.

Cached decode updates the cache's tensors in place (the reference's
``dynamic_update_slice`` on a donated buffer) and returns them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as attn_lib


def _he(gen: torch.Generator, shape: Tuple[int, ...], scale_dim=None, *,
        lead: Tuple[int, ...] = ()):
    """He-scaled normal draw on ``gen``'s device; ``lead`` stacks that many
    layers' draws on leading axes (scaled by the per-layer fan-in)."""
    scale_dim = scale_dim if scale_dim is not None else shape[0]
    out = torch.randn(tuple(lead) + tuple(shape), generator=gen,
                      device=gen.device, dtype=torch.float32)
    return out.div_(math.sqrt(scale_dim))


def _zeros(gen: torch.Generator, shape, *, lead=()):
    return torch.zeros(tuple(lead) + tuple(shape), dtype=torch.float32,
                       device=gen.device)


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + w)).to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation (torch's default
    is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def activation(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return gelu(x)
    if kind == "relu2":  # nemotron squared-ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


_FREQS: Dict[Tuple[float, int, torch.device], torch.Tensor] = {}


def _rope_freqs(theta: float, half: int, device) -> torch.Tensor:
    """The reference's numpy f32 frequencies, bit for bit, copied to
    ``device`` once (a copy from pageable host memory at every call would
    stall the host behind the card)."""
    key = (float(theta), half, device)
    if key not in _FREQS:
        _FREQS[key] = torch.as_tensor(
            1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half)),
            device=device)
    return _FREQS[key]


def rope(x, positions, theta: float):
    """Rotary embedding. x: [B, S, H, D]; positions: [B, S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = _rope_freqs(theta, half, x.device)
    angles = positions[..., None].float() * freqs  # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def sinusoid_positions(s: int, d: int, device=None):
    pos = np.arange(s)[:, None]
    dim = np.arange(0, d, 2)[None, :] / d
    ang = pos / (10000.0 ** dim)
    out = np.zeros((s, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.as_tensor(out, device=device)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, d: Optional[int] = None,
             f: Optional[int] = None, *, lead=()):
    d = d or cfg.d_model
    f = f or cfg.d_ff
    p = {"wi": _he(gen, (d, f), lead=lead), "wo": _he(gen, (f, d), lead=lead)}
    if cfg.gated_mlp:
        p["wg"] = _he(gen, (d, f), lead=lead)
    return p


def _wmat(x, w):
    """x @ w where w may be a pruned ``SparseMatrix`` weight.

    Sparse weights (see ``models.pruning``) go through the planned sparse
    front-end via ``__rmatmul__`` — [B, S, d] collapses to one [B*S, d]
    operand, so the whole batch rides one plan: ``(Wᵀ xᵀ)ᵀ``, which on an
    ell plan is N1 at D = B*S — and come back in x's compute dtype like a
    dense weight would.  ``xᵀ`` is a strided view, which the front-end
    makes contiguous (a copy), and N1's wrapper promotes a bf16 ``xᵀ`` to
    the f32 weights' type (one more pass over the activations a call).
    """
    from repro_torch.sparse.matrix import SparseMatrix

    if isinstance(w, SparseMatrix):
        lead = x.shape[:-1]
        y = w.__rmatmul__(x.reshape(-1, x.shape[-1]))
        return y.reshape(lead + (w.shape[1],)).to(x.dtype)
    return x @ w.to(x.dtype)


def mlp(p, x, cfg: ModelConfig):
    h = _wmat(x, p["wi"])
    h = activation(h, cfg.act)
    if cfg.gated_mlp:
        h = h * _wmat(x, p["wg"])
    return _wmat(h, p["wo"])


# ---------------------------------------------------------------------------
# Attention (self + cross), GQA, RoPE, cached decode
# ---------------------------------------------------------------------------


def init_attn(gen, cfg: ModelConfig, cross: bool = False, *, lead=()):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _he(gen, (d, hq * hd), lead=lead),
        "wk": _he(gen, (d, hkv * hd), lead=lead),
        "wv": _he(gen, (d, hkv * hd), lead=lead),
        "wo": _he(gen, (hq * hd, d), scale_dim=hq * hd, lead=lead),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = _zeros(gen, (hq * hd,), lead=lead)
        p["bk"] = _zeros(gen, (hkv * hd,), lead=lead)
        p["bv"] = _zeros(gen, (hkv * hd,), lead=lead)
    return p


def _qkv(p, x, kv_src, cfg: ModelConfig):
    b, s, _ = x.shape
    skv = kv_src.shape[1]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"].to(x.dtype)
    k = kv_src @ p["wk"].to(x.dtype)
    v = kv_src @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return (q.reshape(b, s, hq, hd), k.reshape(b, skv, hkv, hd),
            v.reshape(b, skv, hkv, hd))


def attend(q, k, v, cfg: ModelConfig, *, kind: str, causal: bool = True,
           skip_masked_blocks: bool = False):
    """The reference's choice of attention route for a full sequence:
    the banded block gather on a local layer longer than its window, the
    chunked flash loop where S x S scores would be large, else the plain
    masked softmax."""
    s = q.shape[1]
    blk = min(cfg.attn_block, s)
    lblk = min(blk, cfg.window) if cfg.window else blk
    if kind == "local" and s > cfg.window and s % lblk == 0 \
            and cfg.window % lblk == 0:
        return attn_lib.local_block_attention(q, k, v, window=cfg.window,
                                              block=lblk)
    if s % blk == 0 and s > max(blk, 2048):
        # flash chunking only where the S^2 buffer actually threatens
        # memory; short sequences take the loop-free dense path
        return attn_lib.flash_attention(
            q, k, v, causal=causal, q_chunk=blk, kv_chunk=blk,
            skip_masked_blocks=skip_masked_blocks)
    window = cfg.window if kind == "local" else None
    return attn_lib.mha_reference(q, k, v, causal=causal, window=window)


def self_attention(p, x, cfg: ModelConfig, *, kind: str, positions,
                   causal: bool = True, dynamic_skip: bool = False):
    """Full-sequence self attention (train / prefill).

    ``dynamic_skip``: the flash loop skips the causal kv blocks above the
    diagonal (used by prefill; no value changes)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, x, cfg)
    if cfg.family != "audio":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = attend(q, k, v, cfg, kind=kind, causal=causal,
                 skip_masked_blocks=dynamic_skip)
    return out.reshape(b, s, -1) @ p["wo"].to(x.dtype)


def cross_attention(p, x, enc_kv, cfg: ModelConfig):
    """Decoder->encoder attention; enc_kv = (k, v) precomputed
    [B,Se,Hkv,D].  Chunked over decoder positions (``attn_block``) so the
    [B, S_dec, S_enc] score tensor never fully materializes."""
    b, s, _ = x.shape
    hq, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"].to(x.dtype)).reshape(b, s, hq, hd)
    k, v = enc_kv
    n_kv = k.shape[2]
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, s, n_kv, hq // n_kv, hd)
    kf, vf = k.float(), v.float()

    def one(q_blk):  # [B, c, Hkv, G, D]
        logits = torch.einsum("bqhgd,bkhd->bhgqk", q_blk.float(), kf) * scale
        pr = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", pr, vf)
        return o.reshape(o.shape[:2] + (hq * hd,)).to(x.dtype)

    chunk = min(cfg.attn_block, s)
    if s % chunk or s == chunk:
        out = one(qg)
    else:
        out = torch.cat([one(qg[:, i:i + chunk])
                         for i in range(0, s, chunk)], dim=1)
    return out @ p["wo"].to(x.dtype)


def encode_cross_kv(p, enc_states, cfg: ModelConfig):
    b, se, _ = enc_states.shape
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    dt = enc_states.dtype
    k = (enc_states @ p["wk"].to(dt)).reshape(b, se, hkv, hd)
    v = (enc_states @ p["wv"].to(dt)).reshape(b, se, hkv, hd)
    return (k, v)


# -- cached decode -----------------------------------------------------------


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int, kind: str,
                    dtype, device="cuda", *, lead=()):
    """KV cache for one attention layer (``lead``: stacked layers).

    Local layers keep a ring buffer of ``window`` entries (cache ∝ window,
    not sequence); ``kpos`` holds each slot's absolute position, -1 where
    empty."""
    size = min(max_len, cfg.window) if kind == "local" else max_len
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    lead = tuple(lead)
    return {
        "k": torch.zeros(lead + (batch, size, hkv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros(lead + (batch, size, hkv, hd), dtype=dtype,
                         device=device),
        "kpos": torch.full(lead + (batch, size), -1, dtype=torch.int32,
                           device=device),
    }


def decode_self_attention(p, x, cache, cfg: ModelConfig, *, kind: str, pos):
    """One-token decode with cache update. x: [B,1,d]; pos: int (a 0-d
    tensor is read to the host).  The cache's tensors are written in place
    and returned."""
    b = x.shape[0]
    pos = int(pos)
    q, k, v = _qkv(p, x, x, cfg)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    if cfg.family != "audio":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    k_cache, v_cache, kpos = cache["k"], cache["v"], cache["kpos"]
    size = k_cache.shape[1]
    # a global layer's slot is clamped into the cache, as the reference's
    # dynamic_update_slice clamps its start
    slot = pos % size if kind == "local" else min(pos, size - 1)
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    kpos[:, slot] = pos
    # validity mask from stored absolute positions
    valid = kpos >= 0
    if kind == "local":
        valid &= kpos > pos - cfg.window
    scale = 1.0 / np.sqrt(cfg.head_dim)
    n_kv = k_cache.shape[2]
    hq = cfg.n_heads
    qg = q.reshape(b, n_kv, hq // n_kv, cfg.head_dim).float()
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    logits = torch.where(valid[:, None, None, :], logits, attn_lib.NEG_INF)
    pr = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", pr, v_cache.float())
    out = out.reshape(b, 1, hq * cfg.head_dim).to(x.dtype)
    y = out @ p["wo"].to(x.dtype)
    return y, {"k": k_cache, "v": v_cache, "kpos": kpos}

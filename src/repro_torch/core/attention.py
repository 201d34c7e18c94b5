"""Attention built on the paper's sparse primitives (the port of
``repro.core.attention``), as plain PyTorch functions.

An attention layer with a block-sparse mask is SDDMM -> masked softmax
-> SpMM:

    S = M ⊙ (Q Kᵀ)        (SDDMM with sampling mask M)
    P = softmax(S)         (only over sampled blocks)
    O = P V                (SpMM with P in Block-ELL layout)

``local_block_attention`` is the banded case (sliding window): the
kv-block index list per q-block is a constant-width band, so the gather
is uniform.  ``flash_attention`` is the dense/causal path (chunked online
softmax, memory O(q_chunk x kv_chunk)).  The fused kernel of the same
banded mask is ``kernels.bsattn`` (K9).

All functions take q:[B,S,Hq,D], k/v:[B,S,Hkv,D] (GQA: Hq % Hkv == 0) and
return [B,S,Hq,D] in q's dtype; scores, statistics and sums are f32.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def _split_gqa(q, n_kv: int):
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _default_scale(scale: Optional[float], d: int) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(d)


# ---------------------------------------------------------------------------
# Dense reference (oracle for tests)
# ---------------------------------------------------------------------------


def mha_reference(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, scale: Optional[float] = None):
    """Plain O(S^2) masked attention — the test oracle."""
    b, s, hq, d = q.shape
    n_kv = k.shape[2]
    scale = _default_scale(scale, d)
    qg = _split_gqa(q, n_kv)  # [B,S,Hkv,G,D]
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Chunked flash attention (dense or causal)
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                    kv_chunk: int = 1024, scale: Optional[float] = None,
                    skip_masked_blocks: bool = False):
    """Online-softmax attention, O(q_chunk*kv_chunk) live scores; a
    Python loop over q chunks, and in each over kv chunks.

    ``skip_masked_blocks``: with causal=True and square chunks, kv chunks
    strictly above the diagonal are not visited (q chunk i scans chunks
    0..i), which halves the score FLOPs and changes no value.
    """
    b, s, hq, d = q.shape
    n_kv = k.shape[2]
    g = hq // n_kv
    scale = _default_scale(scale, d)
    assert s % q_chunk == 0 and s % kv_chunk == 0, (s, q_chunk, kv_chunk)
    nq, nk = s // q_chunk, s // kv_chunk

    qg = _split_gqa(q, n_kv).float()
    kf, vf = k.float(), v.float()
    qpos_in = torch.arange(q_chunk, device=q.device)
    kpos_in = torch.arange(kv_chunk, device=q.device)
    skip = causal and skip_masked_blocks and nk == nq and q_chunk == kv_chunk
    out = torch.empty((b, s, hq, d), dtype=torch.float32, device=q.device)
    for qi in range(nq):
        q_blk = qg[:, qi * q_chunk:(qi + 1) * q_chunk]  # [B,qc,Hkv,G,D]
        acc = q.new_zeros((b, n_kv, g, q_chunk, d), dtype=torch.float32)
        m = q.new_full((b, n_kv, g, q_chunk), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, n_kv, g, q_chunk), dtype=torch.float32)
        for ki in range(qi + 1 if skip else nk):
            k_blk = kf[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            v_blk = vf[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            logits = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
            if causal:
                mask = (ki * kv_chunk + kpos_in)[None, :] \
                    <= (qi * q_chunk + qpos_in)[:, None]
                logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_blk)
            m = m_new
        blk = acc / l.clamp_min(1e-30)[..., None]  # [B,Hkv,G,qc,D]
        out[:, qi * q_chunk:(qi + 1) * q_chunk] = blk.permute(
            0, 3, 1, 2, 4).reshape(b, q_chunk, hq, d)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Banded block-sparse attention (sliding window) — the paper's technique
# ---------------------------------------------------------------------------


def local_block_attention(q, k, v, *, window: int, block: int = 512,
                          scale: Optional[float] = None):
    """Sliding-window causal attention as banded Block-ELL gather.

    Each q block attends to a constant-width band of kv blocks
    [i - w_blocks + 1, i]: the ELL index list per block-row has uniform
    width, so the whole computation is one uniform gather + batched
    matmul — SDDMM/softmax/SpMM fused.  Memory/compute: O(S * window).
    """
    b, s, hq, d = q.shape
    n_kv = k.shape[2]
    dev = q.device
    scale = _default_scale(scale, d)
    assert s % block == 0, (s, block)
    assert window % block == 0, (window, block)
    nq = s // block
    w_blocks = window // block + 1  # +1: the diagonal (causal partial) block

    qg = _split_gqa(q, n_kv).float()
    g = hq // n_kv
    q_blocks = qg.reshape(b, nq, block, n_kv, g, d)

    # Banded ELL indices: block-row i gathers kv blocks [i-w+1 .. i], clipped.
    rows = np.arange(nq)[:, None]
    ell = rows - np.arange(w_blocks - 1, -1, -1)[None, :]  # ascending kv idx
    valid_np = ell >= 0
    ell_idx = torch.as_tensor(np.where(valid_np, ell, 0), device=dev)
    valid = torch.as_tensor(valid_np, device=dev)

    k_blocks = k.float().reshape(b, nq, block, n_kv, d)
    v_blocks = v.float().reshape(b, nq, block, n_kv, d)
    k_g = k_blocks[:, ell_idx]  # [B, nq, w, block, Hkv, D]
    v_g = v_blocks[:, ell_idx]

    logits = torch.einsum("bnqhgd,bnwkhd->bnhgqwk", q_blocks, k_g) * scale

    qpos = torch.arange(block, device=dev)[:, None, None]  # within-block
    kpos = torch.arange(block, device=dev)[None, None, :]
    # absolute positions: q = i*block + qpos ; k = ell[i,w]*block + kpos
    block_off = (ell_idx - torch.as_tensor(rows, device=dev))[
        ..., None, :, None] * block  # [nq,1,w,1]
    rel = kpos + block_off - qpos  # k_abs - q_abs
    mask = (rel <= 0) & (rel > -window) & valid[:, None, :, None]
    logits = torch.where(mask[None, :, None, None], logits, NEG_INF)

    flat = logits.reshape(*logits.shape[:-2], w_blocks * block)
    p = torch.softmax(flat, dim=-1).reshape(logits.shape)
    out = torch.einsum("bnhgqwk,bnwkhd->bnqhgd", p, v_g)
    return out.reshape(b, s, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention (single new token against a KV cache)
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, *, length=None,
                     window: Optional[int] = None,
                     scale: Optional[float] = None):
    """q: [B,1,Hq,D] against k/v cache [B,S,Hkv,D]; O(S) per token.

    ``length``: number of valid cache positions (int or [B] tensor).
    ``window``: restrict to the last ``window`` positions (local layers).
    """
    b, s, n_kv, d = k_cache.shape
    hq = q.shape[2]
    dev = q.device
    scale = _default_scale(scale, d)
    qg = _split_gqa(q, n_kv).float()[:, 0]  # [B,Hkv,G,D]
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    kpos = torch.arange(s, device=dev)
    if length is None:
        length = s
    length = torch.as_tensor(length, device=dev)
    if length.ndim == 0:
        length = length.expand(b)
    mask = kpos[None, :] < length[:, None]  # [B,S]
    if window is not None:
        mask &= kpos[None, :] >= (length[:, None] - window)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def decode_attention_partial(q, k_shard, v_shard, mask_shard, *,
                             scale=None):
    """Per-shard flash-decode partial for sequence-parallel decode.

    Returns (numerator [B,Hq,D], denominator [B,Hq], running max [B,Hq]).
    Partials from sequence shards merge with ``merge_partials``.
    """
    b, s, n_kv, d = k_shard.shape
    hq = q.shape[2]
    scale = _default_scale(scale, d)
    qg = _split_gqa(q, n_kv).float()[:, 0]
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k_shard.float()) * scale
    logits = torch.where(mask_shard[:, None, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    num = torch.einsum("bhgk,bkhd->bhgd", p, v_shard.float())
    return (num.reshape(b, hq, d), l.reshape(b, hq), m.reshape(b, hq))


def merge_partials(p1, p2):
    """Associative merge of two flash-decode partials."""
    n1, l1, m1 = p1
    n2, l2, m2 = p2
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return (n1 * a1[..., None] + n2 * a2[..., None], l1 * a1 + l2 * a2, m)

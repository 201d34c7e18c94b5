"""Fused block-sparse flash attention: the wrapper of kernel K9.

K9 replaces the Pallas kernel ``bsattn_kernel`` of
``repro.kernels.bsattn.kernel``: SDDMM (scores only at the listed kv
blocks), softmax and SpMM (scores x V) in one pass, so the sampled score
matrix never reaches device memory.  The mask is a fixed-width (ELL) list
of kv block ids per q block-row, padded with invalid slots; inside a
block the causal/window predicate is evaluated from absolute positions.
The CUDA source is ``csrc/bsattn.cu``; its note says what bounds it on an
H100 and how its design answers that.

  q:   [BH, S, D]    f32 or bf16
  k/v: [BHkv, S, D]  (GQA: q head bh reads kv head bh // (BH / BHkv))
  ell_idx, valid: int32 [S / block_q, W]
  out: [BH, S, D] in q's dtype; scores, m, l and the accumulator in f32;
       for bf16 inputs p is rounded to bf16 before P·V, as the reference's
       ``p.astype(v.dtype)`` does.

``bsattn_kernel`` runs the plain version (``bsattn_ref``) for CPU tensors
and the kernel for CUDA tensors; there is no fallback between the two.
``bsattn_kernel.launches`` counts kernel launches.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmm.kernel import check_operand, require_cuda

NEG_INF = -1e30
MAX_HEAD_DIM = 256  # both designs keep a 64 x D q tile on chip
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bsattn_ref(ell_idx, valid, q, k, v, *, block_q: int, block_kv: int,
               causal: bool, window: int, scale: float) -> torch.Tensor:
    """Plain version of K9: the reference's blocked online softmax with
    torch ops, one q block-row (all heads at once) at a time, so memory
    stays at one [BH, block_q, block_kv] score tile.  An invalid slot is
    not visited: it would leave m unchanged (alpha = 1) and add p = 0."""
    bh, s, d = q.shape
    bkv = k.shape[0]
    g = bh // bkv
    nq, n_slots = ell_idx.shape
    ell, val = ell_idx.tolist(), valid.tolist()
    qg = q.reshape(bkv, g, s, d)
    out = torch.empty_like(qg)
    qpos_in = torch.arange(block_q, device=q.device)
    kpos_in = torch.arange(block_kv, device=q.device)
    for qi in range(nq):
        rows = slice(qi * block_q, (qi + 1) * block_q)
        q_blk = qg[:, :, rows].float()  # [BHkv, G, bq, D]
        qpos = qi * block_q + qpos_in
        acc = q_blk.new_zeros((bkv, g, block_q, d))
        m = q_blk.new_full((bkv, g, block_q), NEG_INF)
        l = q_blk.new_zeros((bkv, g, block_q))
        for w in range(n_slots):
            if not val[qi][w]:
                continue
            ki = ell[qi][w]
            keys = slice(ki * block_kv, (ki + 1) * block_kv)
            sc = torch.einsum("hgqd,hkd->hgqk", q_blk,
                              k[:, keys].float()) * scale
            kpos = ki * block_kv + kpos_in
            mask = torch.ones((block_q, block_kv), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(sc - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "hgqk,hkd->hgqd", p.to(v.dtype).float(), v[:, keys].float())
            m = m_new
        out[:, :, rows] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out.reshape(bh, s, d)


def launch_bsattn(ell_idx, valid, q, k, v, *, block_q: int, block_kv: int,
                  causal: bool, window: int, scale: float) -> torch.Tensor:
    """Check the operands and launch ``csrc/bsattn.cu`` on the current
    stream; returns out [BH, S, D] in q's dtype."""
    dev = q.device
    bh, s, d = q.shape
    bkv = k.shape[0]
    nq, n_slots = ell_idx.shape
    if q.dtype not in DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; K9 takes float32 or "
                        "bfloat16")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside 1..{MAX_HEAD_DIM}")
    if bkv == 0 or bh % bkv:
        raise ValueError(f"{bh} q heads are not a multiple of {bkv} kv "
                         "heads")
    check_operand(q, "q", None, (bh, s, d), dev)
    check_operand(k, "k", q.dtype, (bkv, s, d), dev)
    check_operand(v, "v", q.dtype, (bkv, s, d), dev)
    check_operand(ell_idx, "ell_idx", torch.int32, (nq, n_slots), dev)
    check_operand(valid, "valid", torch.int32, (nq, n_slots), dev)
    if n_slots and bool(((ell_idx < 0) | (ell_idx >= s // block_kv)).any()):
        raise ValueError(f"ell_idx holds a kv block outside "
                         f"0..{s // block_kv - 1}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = _build.entry("bsattn")(
            ell_idx.data_ptr(), valid.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, bkv, s, d,
            n_slots, block_q, block_kv, int(causal), int(window),
            float(scale), DTYPES[q.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K9 bsattn")
    return out


def bsattn_kernel(ell_idx: torch.Tensor, valid: torch.Tensor,
                  q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  block_q: int = 512, block_kv: int = 512,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """K9: block-sparse flash attention over the ELL kv-block lists
    ``ell_idx`` / ``valid`` [S / block_q, W], intersected with the causal
    and window (``window > 0``) predicates."""
    bh, s, d = q.shape
    nq, _ = ell_idx.shape
    assert s % block_q == 0 and s % block_kv == 0
    assert nq == s // block_q
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kw = dict(block_q=block_q, block_kv=block_kv, causal=causal,
              window=window, scale=scale)
    if q.device.type == "cpu":
        return bsattn_ref(ell_idx, valid, q, k, v, **kw)
    require_cuda(q, "bsattn_kernel")
    out = launch_bsattn(ell_idx, valid, q, k, v, **kw)
    bsattn_kernel.launches += 1
    return out


bsattn_kernel.launches = 0

"""Dense oracle for block-sparse flash attention (the port of
``repro.kernels.bsattn.ref``).

Dense masked attention where the mask is the union of the Block-ELL
kv-block lists intersected with the causal/window predicate — what the
fused kernel K9 computes blockwise.
"""
from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


def dense_mask_from_ell(ell_idx: np.ndarray, valid: np.ndarray, s: int,
                        block_q: int, block_kv: int,
                        causal: bool = True,
                        window: int | None = None) -> np.ndarray:
    """bool[s, s] mask implied by (ell_idx, valid) + causal/window."""
    nq, w = ell_idx.shape
    mask = np.zeros((s, s), bool)
    for qi in range(nq):
        for sl in range(w):
            if not valid[qi, sl]:
                continue
            ki = int(ell_idx[qi, sl])
            mask[qi * block_q:(qi + 1) * block_q,
                 ki * block_kv:(ki + 1) * block_kv] = True
    qpos = np.arange(s)[:, None]
    kpos = np.arange(s)[None, :]
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def block_sparse_attention_ref(q, k, v, mask, *, scale=None):
    """q: [BH, S, D]; k/v: [BHkv, S, D]; mask: bool[S, S] (array or
    tensor).  Fully masked rows come out 0."""
    bh, s, d = q.shape
    bkv = k.shape[0]
    g = bh // bkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    mask = torch.as_tensor(mask, device=q.device)
    qg = q.reshape(bkv, g, s, d).float()
    logits = torch.einsum("hgqd,hkd->hgqk", qg, k.float()) * scale
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    # fully-masked rows produce uniform p over NEG_INF logits; zero them
    any_valid = mask.any(dim=1)[None, None, :, None]
    p = torch.where(any_valid, p, 0.0)
    out = torch.einsum("hgqk,hkd->hgqd", p, v.float())
    return out.reshape(bh, s, d).to(q.dtype)

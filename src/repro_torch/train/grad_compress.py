"""Gradient compression for cross-pod reduction (the port of
``repro.train.grad_compress``).

Two compressors, both with an exact shape-preserving decompress, so they
drop into the train step between the gradients and the optimizer:

  * int8 symmetric per-tensor quantization, without stochastic rounding
    (8x fewer bytes on the wire; here a quantize -> dequantize round
    trip).
  * top-k with error feedback: only the largest k-fraction of entries
    are sent; the residual is fed back next step, so the compressor is
    contractive (EF-SGD / Deep Gradient Compression).
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def int8_roundtrip(g):
    """Symmetric per-tensor int8 quantize -> dequantize (f32 out)."""
    a = torch.max(torch.abs(g))
    scale = torch.clamp(a, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def compress_int8(grads):
    return tree_map(int8_roundtrip, grads)


def _topk_one(g, residual, k_frac: float):
    acc = g.float() + residual
    flat = acc.reshape(-1)
    k = max(1, int(flat.shape[0] * k_frac))
    # the k-th largest |acc| is the threshold, and every entry at or above
    # it is sent, ties included; torch.topk orders ties otherwise than
    # jax.lax.top_k, so only the threshold's value is read from it
    mag = torch.abs(flat)
    thresh = torch.topk(mag, k, sorted=True).values[-1]
    mask = (mag >= thresh).float()
    sent = flat * mask
    new_residual = (flat - sent).reshape(g.shape)
    return sent.reshape(g.shape), new_residual


def init_residual(params):
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                    params)


def compress_topk_ef(grads, residual, k_frac: float = 0.05):
    """Top-k sparsification with error feedback.

    Returns (compressed grads, new residual).  The compressed tensor is
    dense-shaped but k-sparse: on the wire it would ship (indices,
    values), about 2 * k_frac of the dense volume.
    """
    outs = [_topk_one(g, r, k_frac)
            for g, r in zip(tree_leaves(grads), tree_leaves(residual))]
    sent, new_res = iter([o[0] for o in outs]), iter([o[1] for o in outs])
    return (tree_map(lambda _: next(sent), grads),
            tree_map(lambda _: next(new_res), grads))

"""Plain PyTorch version of Block-COO SDDMM: Y = A ⊙ (B @ C) at A's
nonzero blocks (kernel K3's counterpart, following
``repro.kernels.sddmm.ref``)."""
from __future__ import annotations

import torch


def masked_tile_products(rows: torch.Tensor, cols: torch.Tensor,
                         mask_blocks: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
    """``mask[t] * (B[rows[t]-block] @ C[:, cols[t]-block])`` for every
    tile t, f32 [T, bm, bn]: the function kernels K3 and K4 compute.

    ``b`` [M, K] with M a multiple of bm; ``c`` [K, N] with N a multiple
    of bn.
    """
    _, bm, bn = mask_blocks.shape
    m, k = b.shape
    k2, n = c.shape
    if k != k2:
        raise ValueError(f"inner dims disagree: B {tuple(b.shape)} vs C "
                         f"{tuple(c.shape)}")
    if m % bm or n % bn:
        raise ValueError(f"B rows {m} / C columns {n} are not multiples of "
                         f"the block ({bm}, {bn})")
    b_blocks = b.reshape(m // bm, bm, k)[rows].float()  # [T, bm, K]
    c_blocks = c.reshape(k, n // bn, bn).permute(1, 0, 2)[cols].float()
    prod = torch.einsum("tmk,tkn->tmn", b_blocks, c_blocks)
    return mask_blocks.float() * prod


def sddmm_blockcoo_ref(rows: torch.Tensor, cols: torch.Tensor,
                       mask_blocks: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: [nnzb, bm, bn] output blocks, summed in f32,
    in ``result_type(mask_blocks, b)`` (the reference's default).

    ``mask_blocks`` are A's values at its nonzero blocks (a 0/1 mask gives
    the sampled product; weighted A gives A ⊙ (B C)); padded entries carry
    zero blocks, so their output is zero.
    """
    return masked_tile_products(rows, cols, mask_blocks, b, c).to(
        torch.promote_types(mask_blocks.dtype, b.dtype))

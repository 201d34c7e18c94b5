"""Plain PyTorch version of Block-COO SDDMM: Y = A ⊙ (B @ C) at A's
nonzero blocks (kernel K3's counterpart, following
``repro.kernels.sddmm.ref``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def tile_products(rows: torch.Tensor, cols: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """``B[rows[t]-block] @ C[:, cols[t]-block]`` for every tile t, summed
    in f32, f32 [T, bm, bn].

    ``b`` [M, K] with M a multiple of bm; ``c`` [K, N] with N a multiple
    of bn.
    """
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
    return torch.einsum("tmk,tkn->tmn", b_blocks, c_blocks)


def masked_tile_products(rows: torch.Tensor, cols: torch.Tensor,
                         mask_blocks: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor) -> torch.Tensor:
    """``mask[t] * (B[rows[t]-block] @ C[:, cols[t]-block])`` for every
    tile t, f32 [T, bm, bn]: the function of the reference's SELL tile
    kernel (K4's tile-granular plain version)."""
    _, bm, bn = mask_blocks.shape
    return mask_blocks.float() * tile_products(rows, cols, b, c, bm, bn)


def sddmm_blockcoo_ref(rows: torch.Tensor, cols: torch.Tensor,
                       mask_blocks: Optional[torch.Tensor], b: torch.Tensor,
                       c: torch.Tensor, *,
                       block: Optional[Tuple[int, int]] = None,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Plain version of K3: [nnzb, bm, bn] output blocks.

    ``mask_blocks`` are A's values at its nonzero blocks (a 0/1 mask gives
    the sampled product; weighted A gives A ⊙ (B C)); padded entries carry
    zero blocks, so their output is zero.  The output dtype is
    ``result_type(mask_blocks, b)`` (the reference's default).  Each dot is
    summed in f32 and rounded to that dtype before the mask multiplies it
    in f32, then rounded once more: the unweighted dots times the values,
    as the ELL path composed them before the kernel took the values.  The
    reference's K3 rounds mask x dot once; for f32, or a 0/1 mask, the two
    are the same (ROADMAP section 3).

    ``mask_blocks`` None samples every cell of each tile: ``block`` gives
    the tile shape (bm, bn) and ``out_dtype`` the output dtype.
    """
    if mask_blocks is None:
        bm, bn = block
        return tile_products(rows, cols, b, c, bm, bn).to(out_dtype)
    _, bm, bn = mask_blocks.shape
    out = torch.promote_types(mask_blocks.dtype, b.dtype)
    dots = tile_products(rows, cols, b, c, bm, bn).to(out)
    return (mask_blocks.float() * dots.float()).to(out)

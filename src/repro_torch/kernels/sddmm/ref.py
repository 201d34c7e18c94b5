"""Plain PyTorch version of Block-COO SDDMM: Y = A ⊙ (B @ C) at A's
nonzero blocks (kernel K3's counterpart, following
``repro.kernels.sddmm.ref``), and of K3 at a pattern, with the bit words
of a tile pattern it reads."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

WORD_BITS = 32
# each bit's value in an int32 word (bit 31 is the sign)
_BIT_VALUES = [1 << i for i in range(WORD_BITS - 1)] + [-(1 << 31)]
# tiles packed at a time, so the packing's scratch stays small
_PACK_TILES = 4096


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


def pack_occupancy(blocks: torch.Tensor) -> torch.Tensor:
    """The nonzero cells of each tile row as bit words: int32 [T, bm,
    ceil(bn / 32)] for ``blocks`` [..., bm, bn] (T tiles); bit i of word w
    of tile t's row r is set where ``blocks[t, r, 32 w + i] != 0``, bits
    past bn are 0."""
    bm, bn = blocks.shape[-2:]
    tiles = blocks.reshape(-1, bm, bn)
    words = -(-bn // WORD_BITS)
    values = torch.tensor(_BIT_VALUES, dtype=torch.int32,
                          device=tiles.device)
    out = torch.empty((tiles.shape[0], bm, words), dtype=torch.int32,
                      device=tiles.device)
    for t in range(0, tiles.shape[0], _PACK_TILES):
        bits = (tiles[t:t + _PACK_TILES] != 0).to(torch.int32)
        bits = F.pad(bits, (0, words * WORD_BITS - bn))
        # distinct bits: the sum is their OR, and fits an int32
        out[t:t + _PACK_TILES] = (bits.view(-1, bm, words, WORD_BITS)
                                  * values).sum(-1)
    return out


def unpack_occupancy(occupancy: torch.Tensor, bn: int) -> torch.Tensor:
    """Bool [T, bm, bn]: the cells whose bit ``occupancy`` sets."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32,
                          device=occupancy.device)
    bits = (occupancy[..., None] >> shifts) & 1
    return bits.reshape(*occupancy.shape[:-1], -1)[..., :bn] != 0


def sddmm_pattern_ref(rows: torch.Tensor, cols: torch.Tensor,
                      occupancy: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, *, block: Tuple[int, int],
                      out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K3 at a pattern: ``tile_products`` in
    ``out_dtype`` at the cells whose ``occupancy`` bit is set
    (``pack_occupancy``), exact 0 elsewhere; [T, bm, bn] with (bm, bn) =
    ``block``."""
    bm, bn = block
    keep = unpack_occupancy(occupancy, bn)
    return torch.where(keep, tile_products(rows, cols, b, c, bm, bn),
                       0.0).to(out_dtype)

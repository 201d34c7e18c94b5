"""Tile-pruned SELL-C-σ SDDMM: the wrapper of kernel K4, its plain version
and the plumbing around it (the port of ``repro.kernels.sddmm.sell``).

K4 replaces the Pallas kernel ``sddmm_sell_kernel``.  The CUDA source is
``csrc/sddmm.cu``, shared with K3: both mask one (bm x bn) tile product
per listed tile, K4 over the live tiles of a SELL packing with B already
gathered into packed row order.  ``sddmm_sell_kernel.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import SellCS
from repro_torch.kernels.sddmm.kernel import launch_tiles
from repro_torch.kernels.sddmm.ref import masked_tile_products
from repro_torch.kernels.spmm.kernel import require_cuda


def sddmm_sell_tiles_ref(tile_rows, tile_cols, mask_blocks, b_perm,
                         c) -> torch.Tensor:
    """Plain version of K4's masked tile output, f32 [T, bm, bn]."""
    return masked_tile_products(tile_rows, tile_cols, mask_blocks, b_perm, c)


def sddmm_sell_kernel(tile_rows: torch.Tensor, tile_cols: torch.Tensor,
                      mask_blocks: torch.Tensor, b_perm: torch.Tensor,
                      c: torch.Tensor) -> torch.Tensor:
    """K4: mask[t] ⊙ (B_perm[tile_rows[t]-block] @ C[:, tile_cols[t]-
    block]) over the live tiles; ``b_perm`` [n_live*bm, K], ``c``
    [K, Np]."""
    if b_perm.device.type == "cpu":
        return sddmm_sell_tiles_ref(tile_rows, tile_cols, mask_blocks,
                                    b_perm, c)
    require_cuda(b_perm, "sddmm_sell_kernel")
    y = launch_tiles(tile_rows, tile_cols, mask_blocks, b_perm, c,
                     "K4 sddmm_sell")
    sddmm_sell_kernel.launches += 1
    return y


sddmm_sell_kernel.launches = 0


def sample_sell_blocked(sell: SellCS, b: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """Raw dots (B @ C) at the live structural slots, in slot order.

    ``b``: [M, K] logical rows; ``c``: [K, N] logical columns.  Output:
    f32 [n_slots]; padding slots read the appended zero cell.
    """
    _, n = sell.shape
    k = b.shape[1]
    n_slots = sell.n_slots
    if sell.n_tiles == 0:
        return b.new_zeros((n_slots,), dtype=torch.float32)
    n_pad = -(-n // sell.bn) * sell.bn
    b_ext = torch.cat([b, b.new_zeros((1, k))])
    b_perm = b_ext[sell.perm]  # [n_live*bm, K]; padding rows are zero
    if c.shape[1] != n_pad:
        c = torch.nn.functional.pad(c, (0, n_pad - c.shape[1]))
    mask = (sell.tile_slot_map < n_slots).to(torch.float32)
    tiles = sddmm_sell_kernel(sell.tile_rows, sell.tile_cols, mask,
                              b_perm.contiguous(), c.contiguous())
    flat = torch.cat([tiles.reshape(-1), tiles.new_zeros(1)])
    return flat[sell.slot_tile_pos]

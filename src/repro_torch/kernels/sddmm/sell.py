"""SELL-C-σ SDDMM: the wrapper of kernel K4, its plain versions and the
plumbing around it (the port of ``repro.kernels.sddmm.sell``).

K4 replaces the Pallas kernel ``sddmm_sell_kernel``.  The CUDA source is
``csrc/sddmm.cu`` (beside K3's tile kernel).  The Pallas kernel
multiplied a dense tile per live tile behind a 0/1 tile mask; K4 computes
one dot per structural nonzero, found through the row view built once at
packing (``SellCS.tile_row_slot`` / ``tile_row_nnz``, with ``perm`` for
each compact row's logical row of B and ``slot_cols`` for each
nonzero's column of C), so no tile mask, tile output or slot gather is
made per call.  ``sddmm_sell_kernel.launches`` counts kernel launches.

``sddmm_sell_tiles_ref`` stays: it is the tile-granular plain version the
tests hold to the Pallas kernel, and a second check of the slot version.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.formats import SellCS
from repro_torch.kernels import _build
from repro_torch.kernels.sddmm.ref import masked_tile_products
from repro_torch.kernels.spmm.kernel import (check_operand, require_cuda,
                                             result_dtype)


def sddmm_sell_tiles_ref(tile_rows, tile_cols, mask_blocks, b_perm,
                         c) -> torch.Tensor:
    """Tile-granular plain version (the Pallas kernel's function):
    ``mask[t] ⊙ (B_perm[tile_rows[t]-block] @ C[:, tile_cols[t]-
    block])``, [T, bm, bn] in ``result_type(mask_blocks, b_perm)``;
    ``b_perm`` [n_live*bm, K], ``c`` [K, Np]."""
    return masked_tile_products(tile_rows, tile_cols, mask_blocks, b_perm,
                                c).to(torch.promote_types(mask_blocks.dtype,
                                                          b_perm.dtype))


def sddmm_sell_operands(sell: SellCS) -> Tuple[torch.Tensor, ...]:
    """K4's topology operands: (``tile_row_slot``, ``tile_row_nnz``,
    ``perm``, ``slot_cols``)."""
    return sell.tile_row_slot, sell.tile_row_nnz, sell.perm, sell.slot_cols


def sddmm_sell_slots_ref(row_slot, row_nnz, perm, slot_cols, b,
                         c) -> torch.Tensor:
    """Plain version of K4: y[row_slot[r] + j] = B[perm[r]] ·
    C[:, slot_cols[row_slot[r] + j]] for j < row_nnz[r]; every other slot
    0.  [n_slots], summed in f32 and returned in f32."""
    counts = row_nnz.long()
    rows = torch.repeat_interleave(
        torch.arange(row_slot.shape[0], device=b.device), counts)
    first = torch.cumsum(counts, 0) - counts  # row -> its first nonzero
    slots = torch.arange(rows.shape[0], device=b.device) \
        + (row_slot.long() - first)[rows]
    dots = (b[perm[rows].long()].float()
            * c.T[slot_cols[slots].long()].float()).sum(dim=-1)
    y = torch.zeros(slot_cols.shape, dtype=torch.float32, device=b.device)
    y[slots] = dots
    return y


def launch_sell_slots(row_slot, row_nnz, perm, slot_cols, b,
                      c) -> torch.Tensor:
    """Check the operands and launch K4 (``csrc/sddmm.cu``) on the current
    stream; returns y [n_slots] in f32.  Every ``perm`` entry of a row
    with nonzeros must be below ``b``'s row count and every column it
    reads below ``c``'s (``SellCS`` guarantees both; checking them here
    would cost a host sync).  The kernel loads f32: narrower B and C are
    promoted to f32 here (exact for bf16 and f16), which gives what a
    kernel loading them natively and summing in f32 gives."""
    dev = b.device
    n_rows, n_slots = row_slot.shape[0], slot_cols.shape[0]
    m, k = b.shape
    n = c.shape[1]
    result_dtype(b, c)  # raises on a dtype the kernels do not take
    check_operand(row_slot, "row_slot", torch.int32, (n_rows,), dev)
    check_operand(row_nnz, "row_nnz", torch.int32, (n_rows,), dev)
    check_operand(perm, "perm", torch.int32, (n_rows,), dev)
    check_operand(slot_cols, "slot_cols", torch.int32, (n_slots,), dev)
    check_operand(b, "b", None, (m, k), dev)
    check_operand(c, "c", None, (k, n), dev)
    b, c = b.float(), c.float()
    y = torch.zeros((n_slots,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry("sddmm_sell_slots")(
            row_slot.data_ptr(), row_nnz.data_ptr(), perm.data_ptr(),
            slot_cols.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            n_rows, k, n, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K4 sddmm_sell")
    return y


def sddmm_sell_kernel(row_slot: torch.Tensor, row_nnz: torch.Tensor,
                      perm: torch.Tensor, slot_cols: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """K4: the raw dots B[perm[r]] · C[:, col] at every structural nonzero
    of every compact row r, in slot order, 0 elsewhere; ``b`` [M, K]
    logical rows, ``c`` [K, N] logical columns; [n_slots] in f32 whatever
    B and C are, as the reference's tile route returns them
    (``repro.kernels.sddmm.sell.sample_sell_blocked``)."""
    if b.device.type == "cpu":
        return sddmm_sell_slots_ref(row_slot, row_nnz, perm, slot_cols, b, c)
    require_cuda(b, "sddmm_sell_kernel")
    y = launch_sell_slots(row_slot, row_nnz, perm, slot_cols, b, c)
    sddmm_sell_kernel.launches += 1
    return y


sddmm_sell_kernel.launches = 0


def sample_sell_blocked(sell: SellCS, b: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """Raw dots (B @ C) at the live structural slots, in slot order.

    ``b``: [M, K] logical rows; ``c``: [K, N] logical columns.  Output:
    float32[n_slots]; padding slots (and those of a matrix with no live
    tile) are 0.
    """
    if sell.n_tiles == 0:
        return b.new_zeros((sell.n_slots,), dtype=torch.float32)
    return sddmm_sell_kernel(*sddmm_sell_operands(sell), b.contiguous(),
                             c.contiguous())

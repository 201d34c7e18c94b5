"""SELL-C-σ SpMM: the wrapper of kernel K2, its plain versions and the
plumbing around it (the port of ``repro.kernels.spmm.sell``).

K2 replaces the Pallas kernel ``spmm_sell_kernel``.  The CUDA source is
``csrc/spmm_sell.cu`` (shared with K6, which adds the epilogue).  The
Pallas kernel multiplied dense live tiles; K2 reads the nonzeros
themselves: each row of the compact output [n_live*bm, D] sums its packed
row's nonzeros, found through ``SellCS.tile_row_slot`` /
``tile_row_nnz`` (built once at packing), so no tile data, row pointer
or host sync is made per call.  The kernel also takes
``SellCS.tile_heavy_rows``, the rows with more than
``SELL_HEAVY_ROW_NNZ`` nonzeros, which it gives a CTA each; that list
schedules the work and does not change the function, so the plain
versions do not take it.  ``spmm_sell_kernel.launches`` counts kernel
launches.

The tile-granular pieces stay: ``spmm_sell_tiles_ref`` (the reference's
oracle, a second check of the nonzero-granular plain version),
``sell_tile_blocks`` (K8 builds its mask from it) and ``sell_row_ptr``
(K8's row pointer).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.formats import SELL_HEAVY_ROW_NNZ, SellCS
from repro_torch.kernels import _build
from repro_torch.kernels.fused.epilogue import IDENTITY, Epilogue
from repro_torch.kernels.spmm.kernel import (ACT_CODES, check_operand,
                                             require_cuda)


def spmm_sell_tiles_ref(tile_rows, tile_cols, tile_blocks, h, *,
                        n_live_block_rows: int) -> torch.Tensor:
    """Tile-granular plain version of K2's compact output [n_live*bm, D]
    (``index_add_`` takes the place of ``segment_sum``); ``h`` padded to
    the block-column grid."""
    t_count, bm, bn = tile_blocks.shape
    n, d = h.shape
    if n % bn:
        raise ValueError(f"H has {n} rows, not a multiple of bn={bn}")
    prods = torch.einsum("tmn,tnd->tmd", tile_blocks.float(),
                         h.reshape(n // bn, bn, d)[tile_cols].float())
    out = torch.zeros((n_live_block_rows, bm, d), dtype=torch.float32,
                      device=h.device)
    out.index_add_(0, tile_rows, prods)
    return out.reshape(n_live_block_rows * bm, d)


def sell_row_operands(sell: SellCS) -> Tuple[torch.Tensor, ...]:
    """K2's and K6's topology operands: (``tile_row_slot``,
    ``tile_row_nnz``, ``slot_cols``, ``slot_vals``)."""
    return sell.tile_row_slot, sell.tile_row_nnz, sell.slot_cols, \
        sell.slot_vals


def spmm_sell_slots_ref(row_slot, row_nnz, slot_cols, slot_vals,
                        h) -> torch.Tensor:
    """Plain version of K2: Y[r] = sum over row r's nonzeros (slots
    ``row_slot[r]`` .. ``+ row_nnz[r]``) of val · H[col]; [R, D]."""
    n_rows, d = row_slot.shape[0], h.shape[1]
    counts = row_nnz.long()
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=h.device), counts)
    first = torch.cumsum(counts, 0) - counts  # row -> its first nonzero
    slots = torch.arange(rows.shape[0], device=h.device) \
        + (row_slot.long() - first)[rows]
    terms = slot_vals[slots, None].float() * h[slot_cols[slots].long()] \
        .float()
    out = torch.zeros((n_rows, d), dtype=torch.float32, device=h.device)
    out.index_add_(0, rows, terms)
    return out


def launch_sell(row_slot, row_nnz, slot_cols, slot_vals, h, bias, res_perm,
                epi: Epilogue, heavy_rows, what: str) -> torch.Tensor:
    """Check the operands and launch ``csrc/spmm_sell.cu`` on the current
    stream; returns the compact Y [R, D].  Every ``slot_cols`` entry a
    row reads must be below ``h``'s row count, and ``heavy_rows`` must
    list exactly the rows with more than ``SELL_HEAVY_ROW_NNZ`` nonzeros
    (``SellCS`` guarantees both; checking them here would cost a host
    sync)."""
    dev = h.device
    n_rows, s_count = row_slot.shape[0], slot_cols.shape[0]
    n, d = h.shape
    check_operand(row_slot, "row_slot", torch.int32, (n_rows,), dev)
    check_operand(row_nnz, "row_nnz", torch.int32, (n_rows,), dev)
    check_operand(heavy_rows, "heavy_rows", torch.int32,
                  (heavy_rows.shape[0],), dev)
    check_operand(slot_cols, "slot_cols", torch.int32, (s_count,), dev)
    check_operand(slot_vals, "slot_vals", torch.float32, (s_count,), dev)
    check_operand(h, "h", torch.float32, (n, d), dev)
    if epi.has_bias:
        check_operand(bias, "bias", torch.float32, (d,), dev)
    if epi.has_residual:
        check_operand(res_perm, "residual", torch.float32, (n_rows, d), dev)
    y = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry("spmm_sell")(
            row_slot.data_ptr(), row_nnz.data_ptr(), heavy_rows.data_ptr(),
            slot_cols.data_ptr(), slot_vals.data_ptr(), h.data_ptr(),
            bias.data_ptr() if epi.has_bias else None,
            res_perm.data_ptr() if epi.has_residual else None,
            y.data_ptr(), n_rows, heavy_rows.shape[0], SELL_HEAVY_ROW_NNZ,
            d, ACT_CODES[epi.act], float(epi.negative_slope),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    return y


def spmm_sell_kernel(row_slot, row_nnz, slot_cols, slot_vals, h, *,
                     heavy_rows) -> torch.Tensor:
    """K2: compact Y [R, D], one row per entry of ``row_slot``
    (``heavy_rows``: ``SellCS.tile_heavy_rows``, read by the kernel
    only)."""
    if h.device.type == "cpu":
        return spmm_sell_slots_ref(row_slot, row_nnz, slot_cols, slot_vals,
                                   h)
    require_cuda(h, "spmm_sell_kernel")
    y = launch_sell(row_slot, row_nnz, slot_cols, slot_vals, h, None, None,
                    IDENTITY, heavy_rows, "K2 spmm_sell")
    spmm_sell_kernel.launches += 1
    return y


spmm_sell_kernel.launches = 0


def sell_row_ptr(tile_rows: torch.Tensor, n_live: int) -> torch.Tensor:
    """First tile of each live block-row, int32[n_live + 1] (K8's).

    Raises unless ``tile_rows`` is non-decreasing and within
    [0, n_live): K8's one-CTA-per-row split relies on it.
    """
    t_count = tile_rows.shape[0]
    if t_count:
        bad = (tile_rows[0] < 0) | (tile_rows[-1] >= n_live)
        if t_count > 1:
            bad = bad | (tile_rows[1:] < tile_rows[:-1]).any()
        if bool(bad):
            raise ValueError("tile_rows must be non-decreasing and lie in "
                             f"[0, {n_live})")
    rows = torch.arange(n_live + 1, dtype=torch.int32,
                        device=tile_rows.device)
    return torch.searchsorted(tile_rows, rows).to(torch.int32)


def sell_tile_blocks(sell: SellCS) -> torch.Tensor:
    """The live-tile data [T, bm, bn], gathered from the slot values
    (values live once, in ``slot_vals``; dead cells read an appended
    zero)."""
    vals_ext = torch.cat([sell.slot_vals, sell.slot_vals.new_zeros(1)])
    return vals_ext.index_select(0, sell.tile_slot_map.reshape(-1)) \
        .reshape(sell.tile_slot_map.shape)


def spmm_sell_blocked(sell: SellCS, h: torch.Tensor) -> torch.Tensor:
    """Y [M, D] = A @ H through the nonzero-granular kernel (K2 on CUDA).

    ``h`` carries the logical N rows.  The final gather un-permutes rows,
    re-inserts the pruned all-zero rows and trims to M rows.
    """
    m, _ = sell.shape
    d = h.shape[1]
    if sell.n_live_block_rows == 0:
        return h.new_zeros((m, d), dtype=torch.float32)
    y = spmm_sell_kernel(*sell_row_operands(sell), h.contiguous(),
                         heavy_rows=sell.tile_heavy_rows)
    y_ext = torch.cat([y, y.new_zeros((1, d))])
    return y_ext[sell.tile_out_gather]

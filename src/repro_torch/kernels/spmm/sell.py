"""Tile-pruned SELL-C-σ SpMM: the wrapper of kernel K2, its plain version
and the plumbing around it (the port of ``repro.kernels.spmm.sell``).

K2 replaces the Pallas kernel ``spmm_sell_kernel``.  The CUDA source is
``csrc/spmm_sell.cu`` (shared with K6, which adds the epilogue).  The
Pallas kernel flushed its output tile when the sequential grid walked
onto a new ``tile_rows`` value; CTAs run in no order, so the launcher
derives a row pointer over the ascending ``tile_rows`` and each CTA owns
one live block-row.  ``spmm_sell_kernel.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.formats import SellCS
from repro_torch.kernels import _build
from repro_torch.kernels.fused.epilogue import IDENTITY, Epilogue
from repro_torch.kernels.spmm.kernel import (ACT_CODES, check_geometry,
                                             check_operand, require_cuda)


def spmm_sell_tiles_ref(tile_rows, tile_cols, tile_blocks, h, *,
                        n_live_block_rows: int) -> torch.Tensor:
    """Plain version of K2's compact output [n_live*bm, D] (tile
    granular; ``index_add_`` takes the place of ``segment_sum``)."""
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


def sell_row_ptr(tile_rows: torch.Tensor, n_live: int) -> torch.Tensor:
    """First tile of each live block-row, int32[n_live + 1].

    Raises unless ``tile_rows`` is non-decreasing and within
    [0, n_live): the kernel's one-CTA-per-row split relies on it.
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


def launch_sell(tile_rows, tile_cols, tile_blocks, h, bias, res_perm,
                epi: Epilogue, n_live: int, what: str) -> torch.Tensor:
    """Check the operands and launch ``csrc/spmm_sell.cu`` on the current
    stream; returns the compact Y [n_live*bm, D]."""
    dev = h.device
    t_count, bm, bn = tile_blocks.shape
    n, d = h.shape
    check_geometry(bm, bn, n)
    check_operand(tile_rows, "tile_rows", torch.int32, (t_count,), dev)
    check_operand(tile_cols, "tile_cols", torch.int32, (t_count,), dev)
    check_operand(tile_blocks, "tile_blocks", torch.float32,
                  (t_count, bm, bn), dev)
    check_operand(h, "h", torch.float32, (n, d), dev)
    if epi.has_bias:
        check_operand(bias, "bias", torch.float32, (d,), dev)
    if epi.has_residual:
        check_operand(res_perm, "residual", torch.float32, (n_live * bm, d),
                      dev)
    row_ptr = sell_row_ptr(tile_rows, n_live)
    y = torch.empty((n_live * bm, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry("spmm_sell")(
            row_ptr.data_ptr(), tile_cols.data_ptr(), tile_blocks.data_ptr(),
            h.data_ptr(), bias.data_ptr() if epi.has_bias else None,
            res_perm.data_ptr() if epi.has_residual else None,
            y.data_ptr(), n_live, bm, bn, d, ACT_CODES[epi.act],
            float(epi.negative_slope),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    return y


def spmm_sell_kernel(tile_rows, tile_cols, tile_blocks, h, *,
                     n_live_block_rows: int) -> torch.Tensor:
    """K2: compact Y [n_live*bm, D] for the live block-rows only."""
    if h.device.type == "cpu":
        return spmm_sell_tiles_ref(tile_rows, tile_cols, tile_blocks, h,
                                   n_live_block_rows=n_live_block_rows)
    require_cuda(h, "spmm_sell_kernel")
    y = launch_sell(tile_rows, tile_cols, tile_blocks, h, None, None,
                    IDENTITY, n_live_block_rows, "K2 spmm_sell")
    spmm_sell_kernel.launches += 1
    return y


spmm_sell_kernel.launches = 0


def sell_tile_blocks(sell: SellCS) -> torch.Tensor:
    """The live-tile data [T, bm, bn], gathered from the slot values
    (values live once, in ``slot_vals``; dead cells read an appended
    zero)."""
    vals_ext = torch.cat([sell.slot_vals, sell.slot_vals.new_zeros(1)])
    return vals_ext.index_select(0, sell.tile_slot_map.reshape(-1)) \
        .reshape(sell.tile_slot_map.shape)


def pad_h(sell: SellCS, h: torch.Tensor) -> torch.Tensor:
    """``h`` [N, D] zero-padded to the block-column grid."""
    n_pad = -(-sell.shape[1] // sell.bn) * sell.bn
    return F.pad(h, (0, 0, 0, n_pad - h.shape[0]))


def spmm_sell_blocked(sell: SellCS, h: torch.Tensor) -> torch.Tensor:
    """Y [M, D] = A @ H through the tile-pruned kernel (K2 on CUDA).

    ``h`` carries the logical N rows.  The final gather un-permutes rows,
    re-inserts the pruned all-zero rows and trims to M rows.
    """
    m, _ = sell.shape
    d = h.shape[1]
    if sell.n_live_block_rows == 0:
        return h.new_zeros((m, d), dtype=torch.float32)
    y = spmm_sell_kernel(sell.tile_rows, sell.tile_cols,
                         sell_tile_blocks(sell), pad_h(sell, h),
                         n_live_block_rows=sell.n_live_block_rows)
    y_ext = torch.cat([y, y.new_zeros((1, d))])
    return y_ext[sell.tile_out_gather]

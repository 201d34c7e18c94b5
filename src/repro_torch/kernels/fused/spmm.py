"""SpMM with a fused epilogue, Block-ELL and SELL-C-σ: the wrappers of
kernels K5 and K6 (the port of ``repro.kernels.fused.spmm``).

K5 replaces the Pallas kernel ``spmm_blockell_epilogue_kernel`` and K6
replaces ``spmm_sell_epilogue_kernel``.  They are the CUDA sources of K1
and K2 (``csrc/spmm_blockell.cu``, ``csrc/spmm_sell.cu``) with
``act(y + bias + residual)`` applied in registers before the only store,
so the raw product never makes a round trip through device memory.  K6,
like K2, reads the nonzeros through the row view of ``SellCS``, not
dense tiles.

Each wrapper runs its plain version (K1's or K2's plain version, then
``apply_epilogue``) for CPU tensors and its kernel for CUDA tensors, and
counts launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.formats import BlockELL, SellCS
from repro_torch.kernels.fused.epilogue import Epilogue, apply_epilogue
from repro_torch.kernels.spmm.kernel import launch_blockell, require_cuda
from repro_torch.kernels.spmm.ref import spmm_blockell_ref
from repro_torch.kernels.spmm.sell import (launch_sell, sell_row_operands,
                                           spmm_sell_slots_ref,
                                           spmm_sell_tiles_ref)


def _check_spec(epi: Epilogue, bias, res) -> None:
    if epi.has_bias != (bias is not None) \
            or epi.has_residual != (res is not None):
        raise ValueError(f"epilogue {epi.describe()!r} disagrees with the "
                         "bias/residual operands given")


# ---------------------------------------------------------------------------
# Block-ELL SpMM + epilogue (K5)
# ---------------------------------------------------------------------------


def spmm_blockell_epilogue_ref(indices, blocks, h, bias, res, *,
                               epi: Epilogue) -> torch.Tensor:
    """Plain version of K5: act(A @ H + bias + res), [nbr*bm, D]."""
    return apply_epilogue(spmm_blockell_ref(indices, blocks, h), epi, bias,
                          res)


def spmm_blockell_epilogue_kernel(indices, blocks, h, bias, res, *,
                                  epi: Epilogue) -> torch.Tensor:
    """K5: act(A @ H + bias + res) with A in Block-ELL; ``res`` has the
    padded nbr*bm rows."""
    _check_spec(epi, bias, res)
    if h.device.type == "cpu":
        return spmm_blockell_epilogue_ref(indices, blocks, h, bias, res,
                                          epi=epi)
    require_cuda(h, "spmm_blockell_epilogue_kernel")
    y = launch_blockell(indices, blocks, h, bias, res, epi,
                        "K5 spmm_blockell_epilogue")
    spmm_blockell_epilogue_kernel.launches += 1
    return y


spmm_blockell_epilogue_kernel.launches = 0


def spmm_blockell_fused(ell: BlockELL, h: torch.Tensor, epi: Epilogue,
                        bias: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Y = act(A @ H + bias + residual) with A in Block-ELL.

    ``h`` is already padded to ``ell.shape[1]`` rows; the output carries
    the padded ``nbr*bm`` rows (callers trim).  ``residual`` carries
    logical rows and is zero-padded here.
    """
    if h.shape[0] != ell.shape[1]:
        raise ValueError(f"H has {h.shape[0]} rows, Block-ELL A has "
                         f"{ell.shape[1]} (padded) columns")
    res = residual
    if res is not None:
        res = F.pad(res, (0, 0, 0, ell.n_block_rows * ell.bm - res.shape[0]))
    return spmm_blockell_epilogue_kernel(ell.indices, ell.blocks, h, bias,
                                         res, epi=epi)


# ---------------------------------------------------------------------------
# SELL-C-σ SpMM + epilogue (K6)
# ---------------------------------------------------------------------------


def spmm_sell_epilogue_ref(tile_rows, tile_cols, tile_blocks, h, bias,
                           res_perm, *, epi: Epilogue,
                           n_live_block_rows: int) -> torch.Tensor:
    """Tile-granular plain version of K6 (over ``sell_tile_blocks``): the
    compact act(A @ H + bias + res_perm)."""
    y = spmm_sell_tiles_ref(tile_rows, tile_cols, tile_blocks, h,
                            n_live_block_rows=n_live_block_rows)
    return apply_epilogue(y, epi, bias, res_perm)


def spmm_sell_epilogue_slots_ref(row_slot, row_nnz, slot_cols, slot_vals,
                                 h, bias, res_perm, *,
                                 epi: Epilogue) -> torch.Tensor:
    """Plain version of K6 over its own operands: the compact
    act(A @ H + bias + res_perm), [R, D]."""
    y = spmm_sell_slots_ref(row_slot, row_nnz, slot_cols, slot_vals, h)
    return apply_epilogue(y, epi, bias, res_perm)


def spmm_sell_epilogue_kernel(row_slot, row_nnz, slot_cols, slot_vals, h,
                              bias, res_perm, *, epi: Epilogue,
                              heavy_rows) -> torch.Tensor:
    """K6: compact act(A @ H + bias + res_perm), one row per entry of
    ``row_slot`` (rows without nonzeros get act(bias + res_perm));
    ``res_perm`` is the residual in packed row order [R, D];
    ``heavy_rows`` as for K2."""
    _check_spec(epi, bias, res_perm)
    if h.device.type == "cpu":
        return spmm_sell_epilogue_slots_ref(row_slot, row_nnz, slot_cols,
                                            slot_vals, h, bias, res_perm,
                                            epi=epi)
    require_cuda(h, "spmm_sell_epilogue_kernel")
    y = launch_sell(row_slot, row_nnz, slot_cols, slot_vals, h, bias,
                    res_perm, epi, heavy_rows, "K6 spmm_sell_epilogue")
    spmm_sell_epilogue_kernel.launches += 1
    return y


spmm_sell_epilogue_kernel.launches = 0


def spmm_sell_fused(sell: SellCS, h: torch.Tensor, epi: Epilogue,
                    bias: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Y [M, D] = act(A @ H + bias + residual) with A in SELL-C-σ.

    ``h`` carries the logical N rows.  Rows outside the live block-rows
    (all-zero rows in pruned slices) still owe their background
    ``act(bias + residual)``, which the final gather re-inserts; with no
    bias or residual that background is zero.
    """
    m, _ = sell.shape
    d = h.shape[1]
    if sell.n_live_block_rows == 0:
        return apply_epilogue(h.new_zeros((m, d), dtype=torch.float32), epi,
                              bias, residual)
    res_perm = None
    if epi.has_residual:
        res_ext = torch.cat([residual, residual.new_zeros((1, d))])
        res_perm = res_ext[sell.perm]  # packed row order; pad rows zero
    y = spmm_sell_epilogue_kernel(*sell_row_operands(sell), h.contiguous(),
                                  bias, res_perm, epi=epi,
                                  heavy_rows=sell.tile_heavy_rows)
    y_ext = torch.cat([y, y.new_zeros((1, d))])
    out = y_ext[sell.tile_out_gather]
    if epi.has_bias or epi.has_residual:
        # pruned rows (A row all-zero): out = act(bias + residual[row])
        bg = apply_epilogue(out.new_zeros((m, d)), epi, bias, residual)
        live = sell.tile_out_gather < sell.n_live_block_rows * sell.bm
        out = torch.where(live[:, None], out, bg)
    return out

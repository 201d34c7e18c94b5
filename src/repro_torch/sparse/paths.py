"""Execution paths of the sparse front-end (the port of
``repro.sparse.paths``: the SpMM and SDDMM executors).

Planning (which path runs) lives in ``repro_torch.sparse.ops``; these
functions only execute.  The ``ell`` and ``sell`` paths go through the
kernel wrappers, which launch the CUDA kernels for CUDA tensors and run
their plain versions for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.formats import BlockCOO, BlockELL, SellCS
from repro_torch.kernels.sddmm.ops import sddmm_blockcoo
from repro_torch.kernels.sddmm.sell import sample_sell_blocked
from repro_torch.kernels.spmm.ops import spmm_blockell
from repro_torch.kernels.spmm.sell import spmm_sell_blocked
from repro_torch.kernels.spmm import transposed


# ---------------------------------------------------------------------------
# Element-granular ("csr") paths
# ---------------------------------------------------------------------------


def spmm_elements(row_ids, col_ids, values, h, num_rows: int):
    """Y = A @ H via gather + ``index_add_`` (element-granular, f32)."""
    gathered = values[:, None].float() * h[col_ids].float()
    out = torch.zeros((num_rows, h.shape[1]), dtype=torch.float32,
                      device=h.device)
    return out.index_add_(0, row_ids, gathered).to(h.dtype)


def sddmm_element_dots(row_ids, col_ids, b, c):
    """dots[e] = b[row[e]] . c[:, col[e]], the per-edge dot products;
    b: [M, K], c: [K, N]."""
    bs = b[row_ids].float()    # [nnz, K]
    cs = c.T[col_ids].float()  # [nnz, K]
    return (bs * cs).sum(dim=-1).to(b.dtype)


# ---------------------------------------------------------------------------
# Blocked ("ell") paths
# ---------------------------------------------------------------------------


def spmm_ell(ell: BlockELL, h):
    """Y = A @ H with A in Block-ELL; H already padded to ell.shape[1]."""
    return spmm_blockell(ell, h)


def spmm_ell_t(ell: BlockELL, h):
    """Y = Aᵀ @ H with A in Block-ELL, its blocks read in place (N1);
    H padded to ell.shape[0]."""
    return transposed.spmm_blockell_t(ell, h)


def spmm_coo(coo: BlockCOO, h):
    """Y = A @ H with A in Block-COO (``index_add_`` over the nonzero
    blocks; padded entries carry zero blocks); H padded to
    coo.shape[1]; f32 sums in ``result_type(blocks, h)``, as the
    Block-ELL path."""
    mp, np_ = coo.shape
    _, bm, bn = coo.blocks.shape
    d = h.shape[1]
    prods = torch.einsum("emn,end->emd", coo.blocks.float(),
                         h.reshape(np_ // bn, bn, d)[coo.cols].float())
    out = prods.new_zeros((mp // bm, bm, d)).index_add_(0, coo.rows, prods)
    return out.reshape(mp, d).to(torch.promote_types(coo.blocks.dtype,
                                                     h.dtype))


def sddmm_blocked(coo: BlockCOO, b, c, weighted: bool = True) -> BlockCOO:
    """coo.blocks ⊙ (B @ C) at the nonzero blocks (B @ C there when not
    ``weighted``); B/C already padded."""
    return sddmm_blockcoo(coo, b, c, weighted)


def ell_to_coo(ell: BlockELL) -> BlockCOO:
    """Flatten Block-ELL slots into Block-COO (device work only): padded
    slots become zero blocks at duplicated coordinates, the Block-COO
    padding contract."""
    nbr, w = ell.indices.shape
    rows = torch.arange(nbr, dtype=torch.int32,
                        device=ell.device).repeat_interleave(w)
    return BlockCOO(rows=rows, cols=ell.indices.reshape(-1),
                    blocks=ell.blocks.reshape(nbr * w, ell.bm, ell.bn),
                    shape=ell.shape)


def transpose_coo(coo: BlockCOO) -> BlockCOO:
    """A.T in Block-COO: swap coordinates, transpose each block (a view;
    ``spmm_coo`` reads it through ``einsum``, so nothing is copied)."""
    return BlockCOO(rows=coo.cols, cols=coo.rows,
                    blocks=coo.blocks.transpose(1, 2),
                    shape=(coo.shape[1], coo.shape[0]))


# ---------------------------------------------------------------------------
# SELL-C-σ ("sell") paths
# ---------------------------------------------------------------------------


def spmm_sell(sell: SellCS, h):
    """Y = A @ H with A in SELL-C-σ; h carries the logical N rows."""
    return spmm_sell_blocked(sell, h)


def spmm_sell_t(sell: SellCS, h):
    """Y = Aᵀ @ H with A in SELL-C-σ (K2 on Aᵀ's row view); h carries
    the logical M rows."""
    return transposed.spmm_sell_t(sell, h)


def sample_sell(sell: SellCS, b, c):
    """Raw dots of B @ C at the packed slots (slot order), through the
    tile route; padding slots read the appended zero cell, and the caller
    masks them against the structural values."""
    return sample_sell_blocked(sell, b, c)


# ---------------------------------------------------------------------------
# Densify ("dense") paths
# ---------------------------------------------------------------------------


def spmm_dense(a_dense, h):
    """Dense baseline (the paper's Fig. 2 failure mode)."""
    return a_dense @ h


def sample_blocks(full, rows, cols, bm: int, bn: int):
    """Gather (bm, bn) tiles of a full [M, N] product at block coords."""
    m, n = full.shape
    tiles = full.reshape(m // bm, bm, n // bn, bn).permute(0, 2, 1, 3)
    return tiles[rows.long(), cols.long()]  # [nnzb, bm, bn]


def densify_elements(row_ids, col_ids, values, shape: Tuple[int, int]):
    out = values.new_zeros(shape)
    return out.index_put_((row_ids.long(), col_ids.long()), values,
                          accumulate=True)


def densify_ell(ell: BlockELL):
    nbr, w, bm, bn = ell.blocks.shape
    out = ell.blocks.new_zeros((nbr, ell.shape[1] // bn, bm, bn))
    rows = torch.arange(nbr, device=ell.device)[:, None].expand(nbr, w)
    out.index_put_((rows, ell.indices.long()), ell.blocks, accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(ell.shape)


def densify_coo(coo: BlockCOO):
    bm, bn = coo.bm, coo.bn
    out = coo.blocks.new_zeros((coo.shape[0] // bm, coo.shape[1] // bn,
                                bm, bn))
    out.index_put_((coo.rows.long(), coo.cols.long()), coo.blocks,
                   accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(coo.shape)


def densify_sell(sell: SellCS):
    return densify_elements(sell.slot_rows, sell.slot_cols, sell.slot_vals,
                            sell.shape)


def pad_rows(x, target: int):
    """Zero-pad x's leading dim up to ``target`` (no-op when equal)."""
    if x.shape[0] == target:
        return x
    return F.pad(x, (0, 0) * (x.ndim - 1) + (0, target - x.shape[0]))


def pad_cols(x, target: int):
    """Zero-pad a 2-D x's columns up to ``target`` (no-op when equal)."""
    if x.shape[1] == target:
        return x
    return F.pad(x, (0, target - x.shape[1]))

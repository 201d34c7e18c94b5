"""Execution paths of the sparse front-end (the port of
``repro.sparse.paths``: the SpMM and SDDMM executors).

Planning (which path runs) lives in ``repro_torch.sparse.ops``; these
functions only execute.  The ``ell`` and ``sell`` paths go through the
kernel wrappers, which launch the CUDA kernels for CUDA tensors and run
their plain versions for CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.formats import CSR, BlockCOO, BlockELL, SellCS
from repro_torch.device import resolve_device
from repro_torch.kernels.sddmm.ops import sddmm_blockcoo
from repro_torch.kernels.sddmm.sell import sample_sell_blocked
from repro_torch.kernels.spmm.ops import spmm_blockell
from repro_torch.kernels.spmm.sell import spmm_sell_blocked
from repro_torch.kernels.spmm import transposed
from repro_torch.memo import Table, memoized


# ---------------------------------------------------------------------------
# Element-granular ("csr") paths
# ---------------------------------------------------------------------------

# each element triplet's row order, per structure (keyed on the row ids)
_ROW_ORDERS: Table = {}


def csr_to_device_arrays(csr: CSR, device="cuda"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand host CSR to (row_ids, col_ids, values) tensors on
    ``device``, int32 indices."""
    device = resolve_device(device)
    row_ids = np.repeat(np.arange(csr.shape[0], dtype=np.int32),
                        np.diff(csr.indptr))
    return (torch.from_numpy(row_ids).to(device),
            torch.from_numpy(csr.indices.astype(np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(csr.values)).to(device))


def row_order(row_ids: torch.Tensor, col_ids: torch.Tensor, num_rows: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(``perm``, ``cols``, ``lengths``): a stable permutation of the
    elements by row, the column ids in that order, and each row's element
    count (int64 [num_rows]).  Built on the device with no host sync (a
    serving batch composes new row ids every call) and memoized weakly on
    the row ids, once per structure."""

    def build():
        rows, perm = torch.sort(row_ids.long(), stable=True)
        bounds = torch.searchsorted(
            rows, torch.arange(num_rows + 1, device=rows.device))
        return perm, col_ids[perm], bounds.diff()

    check = (id(col_ids), num_rows, row_ids._version, col_ids._version)
    return memoized(_ROW_ORDERS, row_ids, check, build)


def _row_sums(terms: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row's sum of its ``terms`` (f32, along dim 0, in the order of
    ``row_order``): one ``segment_reduce``, which sums every row in one
    fixed order (``index_add_`` on CUDA adds with atomics); ``unsafe``
    skips its checks of ``lengths``, which ``row_order`` builds, and the
    host syncs they take."""
    if terms.shape[0] == 0:
        return terms.new_zeros((lengths.shape[0],) + terms.shape[1:])
    return torch.segment_reduce(terms, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def segment_sums(terms: torch.Tensor, row_ids: torch.Tensor,
                 col_ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Each row's sum of ``terms`` (one per element of the triplet, along
    dim 0) in one fixed order, ``row_order``'s: the ``segment_sum`` of the
    reference where ``index_add_`` on CUDA would add with atomics."""
    perm, _, lengths = row_order(row_ids, col_ids, num_rows)
    return _row_sums(terms[perm], lengths)


def spmm_elements(row_ids, col_ids, values, h, num_rows: int):
    """Y = A @ H via gather + a fixed-order segmented sum over each row's
    elements (element-granular, f32 sums); the triplet's rows need not
    ascend (``A.T``'s swapped triplet)."""
    perm, cols, lengths = row_order(row_ids, col_ids, num_rows)
    # scaled in place: the gather is the one E x D array
    gathered = h[cols.long()].float().mul_(values[perm][:, None].float())
    return _row_sums(gathered, lengths).to(h.dtype)


def spmv_elements(row_ids, col_ids, values, x, num_rows: int):
    """y = A @ x for a [N] vector, as ``spmm_elements`` (fixed-order
    segmented sums)."""
    perm, cols, lengths = row_order(row_ids, col_ids, num_rows)
    prod = values[perm].float() * x[cols.long()].float()
    return _row_sums(prod, lengths).to(x.dtype)


def sddmm_element_dots(row_ids, col_ids, b, c):
    """dots[e] = b[row[e]] . c[:, col[e]], the per-edge dot products;
    b: [M, K], c: [K, N]."""
    bs = b[row_ids].float()    # [nnz, K]
    cs = c.T[col_ids].float()  # [nnz, K]
    return (bs * cs).sum(dim=-1).to(b.dtype)


# ---------------------------------------------------------------------------
# SpMV (d = 1) paths: a direct reduction per layout
# ---------------------------------------------------------------------------
#
# y = A @ x for a [N] vector.  The reference has no Pallas kernel here: each
# layout is one plain reduction, and none sums with atomics (the element
# and Block-COO routes take the fixed-order segmented sum).


def spmv_ell(ell: BlockELL, x):
    """y = A @ x with A in Block-ELL; x already padded to ell.shape[1]:
    one einsum over the x-blocks each slot points at, in
    ``result_type(blocks, x)``."""
    x_blocks = x.reshape(ell.shape[1] // ell.bn, ell.bn)
    gathered = x_blocks[ell.indices.long()]  # [nbr, W, bn]
    y = torch.einsum("rwmn,rwn->rm", ell.blocks.float(), gathered.float())
    return y.reshape(ell.shape[0]).to(torch.promote_types(ell.blocks.dtype,
                                                          x.dtype))


def spmv_coo(coo: BlockCOO, x):
    """y = A @ x with A in Block-COO; x padded to coo.shape[1]: each block's
    product, then a fixed-order segmented sum over each block-row's
    blocks."""
    bm, bn = coo.bm, coo.bn
    x_blocks = x.reshape(coo.shape[1] // bn, bn)
    prods = torch.einsum("emn,en->em", coo.blocks.float(),
                         x_blocks[coo.cols.long()].float())
    perm, _, lengths = row_order(coo.rows, coo.cols, coo.shape[0] // bm)
    out = _row_sums(prods[perm], lengths)
    return out.reshape(coo.shape[0]).to(torch.promote_types(
        coo.blocks.dtype, x.dtype))


def spmv_sell(sell: SellCS, x):
    """y = A @ x with A in SELL-C-σ: one [rows, w] product and row sum per
    width bucket, then the rows un-permuted (rows of pruned slices read an
    appended 0)."""
    out_dtype = torch.promote_types(sell.slot_vals.dtype, x.dtype)
    if not sell.buckets:
        return x.new_zeros((sell.shape[0],), dtype=out_dtype)
    outs, off = [], 0
    for _, rows, width in sell.buckets:
        cols = sell.slot_cols[off:off + rows * width].reshape(rows, width)
        vals = sell.slot_vals[off:off + rows * width].reshape(rows, width)
        outs.append((vals.float() * x[cols.long()].float()).sum(dim=-1))
        off += rows * width
    packed = torch.cat(outs + [outs[0].new_zeros(1)])
    return packed[sell.out_gather.long()].to(out_dtype)


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
    """Y = A @ H with A in Block-COO (each nonzero block's product, then a
    fixed-order segmented sum over each block-row's blocks; padded entries
    carry zero blocks); H padded to coo.shape[1]; f32 sums in
    ``result_type(blocks, h)``, as the Block-ELL path.  The blocks are
    taken in ``row_order``, so the one copy is of the blocks, not of the
    products."""
    mp, np_ = coo.shape
    _, bm, bn = coo.blocks.shape
    d = h.shape[1]
    perm, cols, lengths = row_order(coo.rows, coo.cols, mp // bm)
    prods = torch.einsum("emn,end->emd", coo.blocks[perm].float(),
                         h.reshape(np_ // bn, bn, d)[cols.long()].float())
    out = _row_sums(prods, lengths)
    return out.reshape(mp, d).to(torch.promote_types(coo.blocks.dtype,
                                                     h.dtype))


def sddmm_blocked(coo: BlockCOO, b, c, weighted: bool = True) -> BlockCOO:
    """coo.blocks ⊙ (B @ C) at the nonzero blocks (B @ C there when not
    ``weighted``); B/C already padded.  The dot is rounded to the output
    dtype before the values multiply it: the unweighted dots times the
    values, as the reference's ``sddmm_values`` composes them."""
    return sddmm_blockcoo(coo, b, c, weighted, round_dot=True)


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
    """Dense baseline (the paper's Fig. 2 failure mode); mixed operands
    (f32 weights, bf16 activations) are promoted to their common type, as
    ``jnp.matmul`` promotes them."""
    out = torch.promote_types(a_dense.dtype, h.dtype)
    return a_dense.to(out) @ h.to(out)


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

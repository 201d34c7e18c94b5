"""The transposed SpMM ``Y = Aᵀ H`` of the backward: the wrapper of kernel
N1 (``csrc/spmm_blockell_t.cu``) on the ell path, K2's row-view kernel on
the sell path, and the per-structure lists both walk.

No Pallas kernel of ``repro`` computes this product: its backward runs it
in jnp, an einsum over the transposed Block-COO view and a segment sum
(``repro.sparse.paths.spmm_coo``), or a segment sum over the swapped slot
triplet (``spmm_elements``).  Both sum in a fixed order.  The port's
``einsum`` + ``index_add_`` did not on CUDA, so these routes sum each
output element in one order, with no atomics:

  * ell: N1 reads A's Block-ELL blocks in place, transposed, walking the
    list of each block column (``blockell_columns``) in ascending
    block-row;
  * sell: K2 reads a row view of Aᵀ (``sell_t_operands``): A's
    structural slots sorted by column, then row, so each row of Aᵀ sums
    its terms in ascending row of A.  Each call gathers A's slot values
    through that order.

Both lists are built on the matrix's device once per structure and
memoized weakly on a topology tensor that every form sharing A's
structure shares (``BlockELL.indices``, ``SellCS.slot_cols``): the
backward's per-step ``single_form(a, ...).T`` matrices find them built.
Padded slots are left out by structure (``nblocks``, ``tile_row_nnz``),
never by a value test: a stored zero is still a structural entry.

N1 runs one of three paths, picked by ``n1_plan`` from D, the dtype, the
block shape and the structure's shape alone (never from the values, never
with a host sync), so the same inputs always take the same path and two
launches give equal bits:

  * ``"stream"`` (D <= ``STREAM_MAX_D``): each live block read once,
    coalesced, with no compaction; each column's list cut into ``chunks``
    near-equal runs, one CTA each, the runs' f32 partials added in chunk
    order by a second kernel (so a launch with ``chunks`` > 1 runs two
    kernels);
  * ``"tensor"`` (64-column blocks, bm a multiple of 16, D >=
    ``TENSOR_MIN_D``): the whole blocks on the tensor cores, f32 as three
    TF32 products per product, bf16 / f16 as m16n8k16 with f32 sums;
  * ``"sparse"`` otherwise: the nonzero-granular FFMA body (each block's
    nonzeros compacted by column).

The wrapper runs the plain version (``ref.spmm_blockell_t_ref``) for CPU
tensors and the kernel for CUDA tensors; ``spmm_blockell_t_kernel
.launches`` counts its calls that launch (one a call, whichever path,
the stream path's combine kernel included).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.formats import SELL_HEAVY_ROW_NNZ, BlockELL, SellCS
from repro_torch.kernels import _build
from repro_torch.kernels.spmm.kernel import (KERNEL_DTYPES, MAX_BLOCK,
                                             check_operand, require_cuda,
                                             result_dtype)
from repro_torch.kernels.spmm.ref import spmm_blockell_t_ref
from repro_torch.kernels.spmm.sell import spmm_sell_kernel
from repro_torch.memo import Table, memoized

# the lists by structure: N1's on the Block-ELL indices, K2's row view of
# Aᵀ on the slot columns
_ELL_LISTS: Table = {}
_SELL_LISTS: Table = {}

# N1's paths, by their code in csrc/spmm_blockell_t.cu
N1_PATHS = ("sparse", "tensor", "stream")
# the widest D the stream path takes (its kernel holds 8 columns of H)
STREAM_MAX_D = 8
# CTAs the stream path aims at: one a streaming multiprocessor of an H100
# (more chunks add partials and a second kernel without a faster stream:
# python -m repro_torch.kernels.spmm.transposed_parts)
STREAM_CTAS = 132
# the tensor path's block: 64 columns (Y rows of a tile), bm a multiple of
# TENSOR_BM_STEP (one m16n8k16 depth)
TENSOR_BN, TENSOR_BM_STEP = 64, 16
# the narrowest D the tensor path takes; below it the sparse path.  On
# graph (a) of chip_smoke.py (10 % fill, f32) the sparse path wins at
# D = 16 and 32 (1.06 against 1.24 ms), the two tie at D = 64 and the
# tensor path wins at D = 128 (1.24 against 1.56 ms)
# (python -m repro_torch.kernels.spmm.transposed_parts); bf16 / f16 take
# the same crossover, not measured apart
TENSOR_MIN_D = 64


def stream_chunks(nbr: int, nbc: int) -> int:
    """Runs each block column's list is cut into on the stream path: enough
    for ``STREAM_CTAS`` CTAs over ``nbc`` columns, at most one a block-row
    (a list holds at most ``nbr`` slots)."""
    if nbc < 1:
        return 1
    return max(1, min(nbr, -(-STREAM_CTAS // nbc)))


def n1_plan(d: int, dtype: torch.dtype, block: Tuple[int, int], nbr: int,
            nbc: int) -> Tuple[str, int]:
    """N1's (path, chunks) for Y [nbc*bn, D] = Aᵀ H over ``nbr`` x ``nbc``
    blocks of shape ``block`` = (bm, bn) in ``dtype``: a pure function of
    these, so the same inputs always take the same path (every dtype takes
    the same crossovers)."""
    bm, bn = block
    if d <= STREAM_MAX_D:
        return "stream", stream_chunks(nbr, nbc)
    if bn == TENSOR_BN and bm % TENSOR_BM_STEP == 0 and d >= TENSOR_MIN_D:
        return "tensor", 1
    return "sparse", 1


def blockell_columns(ell: BlockELL) -> Tuple[torch.Tensor, torch.Tensor]:
    """The list N1 walks: (``col_ptr`` int32 [nbc + 1], ``col_slots`` int32
    [live slots]) — block column j's slots ``i * W + t`` (``t <
    nblocks[i]``) are ``col_slots[col_ptr[j]:col_ptr[j + 1]]``, in
    ascending block-row.  Built once per structure."""
    nbc = ell.shape[1] // ell.bn

    def build():
        nbr, w = ell.indices.shape
        dev = ell.indices.device
        live = torch.arange(w, device=dev)[None, :] \
            < ell.nblocks.long()[:, None]
        slots = torch.nonzero(live.reshape(-1)).squeeze(1)  # ascending i
        cols = ell.indices.reshape(-1)[slots].long()
        order = torch.sort(cols, stable=True).indices
        col_ptr = torch.zeros(nbc + 1, dtype=torch.int32, device=dev)
        col_ptr[1:] = torch.cumsum(torch.bincount(cols, minlength=nbc), 0)
        return col_ptr, slots[order].to(torch.int32)

    check = (id(ell.nblocks), nbc, ell.indices._version,
             ell.nblocks._version)
    return memoized(_ELL_LISTS, ell.indices, check, build)


def spmm_blockell_t_kernel(col_ptr: torch.Tensor, col_slots: torch.Tensor,
                           blocks: torch.Tensor, h: torch.Tensor, *,
                           path: Optional[str] = None) -> torch.Tensor:
    """N1: Y [nbc*bn, D] = Aᵀ @ H with A's Block-ELL ``blocks`` read in
    place (``h`` [nbr*bm, D], A's padded rows); the lists of
    ``blockell_columns``.  ``path`` forces one of ``N1_PATHS`` (default:
    ``n1_plan``'s); the stream path is cut into ``n1_plan``'s chunks."""
    if path is not None and path not in N1_PATHS:
        raise ValueError(f"N1 path {path!r} not one of {N1_PATHS}")
    if h.device.type == "cpu":
        return spmm_blockell_t_ref(col_ptr, col_slots, blocks, h)
    require_cuda(h, "spmm_blockell_t_kernel")
    dev = h.device
    nbr, w, bm, bn = blocks.shape
    n, d = h.shape
    nbc = col_ptr.shape[0] - 1
    if not (1 <= bm <= MAX_BLOCK and 1 <= bn <= MAX_BLOCK):
        raise ValueError(f"block ({bm}, {bn}) outside 1..{MAX_BLOCK}")
    if n != nbr * bm:
        raise ValueError(f"H has {n} rows, Block-ELL A has {nbr * bm} "
                         "(padded) rows")
    out = result_dtype(blocks, h)
    check_operand(col_ptr, "col_ptr", torch.int32, (nbc + 1,), dev)
    check_operand(col_slots, "col_slots", torch.int32,
                  (col_slots.shape[0],), dev)
    check_operand(blocks, "blocks", None, (nbr, w, bm, bn), dev)
    check_operand(h, "h", None, (n, d), dev)
    blocks, h = blocks.to(out), h.to(out)
    rule, chunks = n1_plan(d, out, (bm, bn), nbr, nbc)
    path = path or rule
    if path == "tensor" and (bn != TENSOR_BN or bm % TENSOR_BM_STEP):
        raise ValueError(f"N1's tensor path takes {TENSOR_BN}-column blocks "
                         f"of a multiple of {TENSOR_BM_STEP} rows, not "
                         f"({bm}, {bn})")
    if path == "stream" and d > STREAM_MAX_D:
        raise ValueError(f"N1's stream path takes D <= {STREAM_MAX_D}, "
                         f"not {d}")
    if path != "stream":
        chunks = 1
    y = torch.empty((nbc * bn, d), dtype=out, device=dev)
    part = torch.empty((nbc * chunks, bn, d), dtype=torch.float32,
                       device=dev) if chunks > 1 else None
    with torch.cuda.device(dev):
        err = _build.entry("spmm_blockell_t")(
            KERNEL_DTYPES[out], N1_PATHS.index(path), col_ptr.data_ptr(),
            col_slots.data_ptr(), blocks.data_ptr(), h.data_ptr(),
            y.data_ptr(), None if part is None else part.data_ptr(), nbr,
            nbc, w, bm, bn, d, chunks,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"N1 spmm_blockell_t ({path})")
    spmm_blockell_t_kernel.launches += 1
    return y


spmm_blockell_t_kernel.launches = 0


def spmm_blockell_t(ell: BlockELL, h: torch.Tensor) -> torch.Tensor:
    """Y [N_pad, D] = Aᵀ @ H with A in Block-ELL; ``h`` has exactly
    ``ell.shape[0]`` rows.  N1 for CUDA tensors, its plain version for CPU
    tensors."""
    if h.shape[0] != ell.shape[0]:
        raise ValueError(f"H has {h.shape[0]} rows, Block-ELL A has "
                         f"{ell.shape[0]} (padded) rows")
    return spmm_blockell_t_kernel(*blockell_columns(ell), ell.blocks,
                                  h.contiguous())


def sell_t_operands(sell: SellCS) -> Tuple[torch.Tensor, ...]:
    """Aᵀ's row view for K2: (``row_slot``, ``row_nnz``, ``cols`` over
    Aᵀ's N rows and its nonzeros, ``perm`` int64 (A's slot of each), and
    ``heavy_rows``, Aᵀ's rows above ``SELL_HEAVY_ROW_NNZ`` nonzeros).  A's
    structural slots sorted by column, then row; built once per
    structure."""

    def build():
        counts = sell.tile_row_nnz.long()
        dev = counts.device
        rows = torch.repeat_interleave(
            torch.arange(counts.shape[0], device=dev), counts)
        first = torch.cumsum(counts, 0) - counts
        slots = torch.arange(rows.shape[0], device=dev) \
            + (sell.tile_row_slot.long() - first)[rows]
        by_row = slots[torch.sort(sell.slot_rows[slots].long(),
                                  stable=True).indices]
        cols = sell.slot_cols[by_row].long()
        order = torch.sort(cols, stable=True).indices
        perm = by_row[order]
        row_nnz = torch.bincount(cols, minlength=sell.shape[1])
        row_slot = torch.cumsum(row_nnz, 0) - row_nnz
        heavy = torch.nonzero(row_nnz > SELL_HEAVY_ROW_NNZ).squeeze(1)
        return (row_slot.to(torch.int32), row_nnz.to(torch.int32),
                sell.slot_rows[perm].to(torch.int32), perm,
                heavy.to(torch.int32))

    check = (id(sell.slot_rows), id(sell.tile_row_slot),
             id(sell.tile_row_nnz), sell.slot_cols._version,
             sell.slot_rows._version)
    return memoized(_SELL_LISTS, sell.slot_cols, check, build)


def spmm_sell_t(sell: SellCS, h: torch.Tensor) -> torch.Tensor:
    """Y [N, D] = Aᵀ @ H with A in SELL-C-σ; ``h`` carries A's M rows.  K2
    on Aᵀ's row view for CUDA tensors, its plain version for CPU ones."""
    row_slot, row_nnz, cols, perm, heavy = sell_t_operands(sell)
    return spmm_sell_kernel(row_slot, row_nnz, cols, sell.slot_vals[perm],
                            h.contiguous(), heavy_rows=heavy)

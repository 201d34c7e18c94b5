"""Plain PyTorch version of Block-ELL SpMM: Y = A @ H (kernel K1's
counterpart, following ``repro.kernels.spmm.ref``)."""
from __future__ import annotations

import torch


def spmm_blockell_f32(indices: torch.Tensor, blocks: torch.Tensor,
                      h: torch.Tensor) -> torch.Tensor:
    """The f32 sum A @ H, [nbr*bm, D], before any rounding to the output
    dtype (K5's plain version applies its epilogue to it)."""
    nbr, w, bm, bn = blocks.shape
    n, d = h.shape
    if n % bn:
        raise ValueError(f"H has {n} rows, not a multiple of bn={bn}")
    gathered = h.reshape(n // bn, bn, d)[indices]  # [nbr, W, bn, D]
    acc = torch.einsum("rwmn,rwnd->rmd", blocks.float(), gathered.float())
    return acc.reshape(nbr * bm, d)


def spmm_blockell_ref(indices: torch.Tensor, blocks: torch.Tensor,
                      h: torch.Tensor) -> torch.Tensor:
    """Y[nbr*bm, D] = A @ H with A's Block-ELL ``indices`` [nbr, W] and
    ``blocks`` [nbr, W, bm, bn]; ``h`` [N, D] with N a multiple of bn.
    Summed in f32, returned in ``result_type(blocks, h)``.

    Padded slots carry zero blocks, so gathering an arbitrary (valid) H
    tile for them is harmless — the same contract as the kernel.
    """
    return spmm_blockell_f32(indices, blocks, h).to(
        torch.promote_types(blocks.dtype, h.dtype))


def spmm_blockell_t_ref(col_ptr: torch.Tensor, col_slots: torch.Tensor,
                        blocks: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Plain version of N1: Y[nbc*bn, D] = Aᵀ @ H with A's Block-ELL
    ``blocks`` [nbr, W, bm, bn] read transposed in place; ``h`` [nbr*bm, D].

    ``col_ptr`` [nbc + 1] / ``col_slots`` list the slots ``i * W + t`` of
    each block column in ascending block-row (padded slots left out;
    ``transposed.blockell_columns``).  Each output block-row sums its
    list's tiles in that order, position by position, in f32; within a
    tile the product's own order.  Returned in ``result_type(blocks, h)``.
    """
    nbr, w, bm, bn = blocks.shape
    n, d = h.shape
    if n != nbr * bm:
        raise ValueError(f"H has {n} rows, Block-ELL A has {nbr * bm} "
                         "(padded) rows")
    nbc = col_ptr.shape[0] - 1
    starts = col_ptr[:-1].long()
    counts = col_ptr[1:].long() - starts
    flat = blocks.reshape(nbr * w, bm, bn)
    h_tiles = h.reshape(nbr, bm, d)
    acc = torch.zeros((nbc, bn, d), dtype=torch.float32, device=h.device)
    for pos in range(int(counts.max()) if nbc else 0):
        js = torch.nonzero(counts > pos).squeeze(1)
        s = col_slots[starts[js] + pos].long()
        acc[js] += torch.einsum("tmn,tmd->tnd", flat[s].float(),
                                h_tiles[s // w].float())
    return acc.reshape(nbc * bn, d).to(torch.promote_types(blocks.dtype,
                                                           h.dtype))

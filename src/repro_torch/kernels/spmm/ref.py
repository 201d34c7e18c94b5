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

"""Block-ELL SpMM on a ``BlockELL`` (the port of
``repro.kernels.spmm.ops``)."""
from __future__ import annotations

import torch

from repro_torch.core.formats import BlockELL
from repro_torch.kernels.spmm.kernel import spmm_blockell_kernel


def spmm_blockell(ell: BlockELL, h: torch.Tensor) -> torch.Tensor:
    """Y [nbr*bm, D] = A @ H with A in Block-ELL; ``h`` has exactly
    ``ell.shape[1]`` rows.  K1 for CUDA tensors, its plain version for
    CPU tensors."""
    if h.shape[0] != ell.shape[1]:
        raise ValueError(f"H has {h.shape[0]} rows, Block-ELL A has "
                         f"{ell.shape[1]} (padded) columns")
    return spmm_blockell_kernel(ell.indices, ell.blocks, h)

"""Block-COO SDDMM on a ``BlockCOO`` (the port of
``repro.kernels.sddmm.ops``)."""
from __future__ import annotations

import torch

from repro_torch.core.formats import BlockCOO
from repro_torch.kernels.sddmm.kernel import sddmm_blockcoo_kernel


def sddmm_blockcoo(coo: BlockCOO, b: torch.Tensor, c: torch.Tensor,
                   weighted: bool = True) -> BlockCOO:
    """Y = A ⊙ (B @ C), computed only at A's nonzero blocks; ``b`` has
    ``coo.shape[0]`` rows and ``c`` ``coo.shape[1]`` columns.  With
    ``weighted`` False, Y = B @ C at every cell of those blocks (the
    unweighted SDDMM): A's values are not read, in
    ``result_type(coo.blocks, b)`` all the same.  K3 for CUDA tensors, its
    plain version for CPU tensors."""
    if b.shape[0] != coo.shape[0] or c.shape[1] != coo.shape[1]:
        raise ValueError(f"B {tuple(b.shape)} / C {tuple(c.shape)} do not "
                         f"match the padded Block-COO shape {coo.shape}")
    if weighted:
        out = sddmm_blockcoo_kernel(coo.rows, coo.cols, coo.blocks,
                                    b.contiguous(), c.contiguous())
    else:
        out = sddmm_blockcoo_kernel(
            coo.rows, coo.cols, None, b.contiguous(), c.contiguous(),
            block=(coo.bm, coo.bn),
            out_dtype=torch.promote_types(coo.blocks.dtype, b.dtype))
    return BlockCOO(rows=coo.rows, cols=coo.cols, blocks=out,
                    shape=coo.shape)

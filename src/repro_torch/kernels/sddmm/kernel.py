"""Block-COO SDDMM on the card: the wrapper of kernel K3.

K3 replaces the Pallas kernel ``sddmm_blockcoo_kernel`` of
``repro.kernels.sddmm.kernel``.  The CUDA source is ``csrc/sddmm.cu``
(beside K4's slot kernel); its note says what bounds it on an H100 and
how its design answers that.  The CUDA kernel loops over K itself and
masks the ragged last chunk, so any K >= 1 works.

The wrapper runs the plain version (``ref.sddmm_blockcoo_ref``) for CPU
tensors and the kernel for CUDA tensors; there is no fallback between the
two.  ``sddmm_blockcoo_kernel.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sddmm.ref import sddmm_blockcoo_ref
from repro_torch.kernels.spmm.kernel import (check_geometry, check_operand,
                                             require_cuda, result_dtype)


def launch_tiles(rows, cols, mask_blocks, b, c, what: str) -> torch.Tensor:
    """Check the operands and launch the tile kernel of ``csrc/sddmm.cu``
    (K3's) on the current stream; returns Y [T, bm, bn] in
    ``result_type(mask_blocks, b)``.  The kernel loads f32: narrower
    operands are promoted to f32 here (exact for bf16 and f16) and Y is
    cast after the launch, which gives what a kernel loading them
    natively and summing in f32 gives."""
    dev = b.device
    t_count, bm, bn = mask_blocks.shape
    m, k = b.shape
    n = c.shape[1]
    check_geometry(bm, bn, n)
    if m % bm:
        raise ValueError(f"B has {m} rows, not a multiple of bm={bm}")
    out = result_dtype(mask_blocks, b)
    result_dtype(c)  # raises on a dtype the kernel does not take
    check_operand(rows, "rows", torch.int32, (t_count,), dev)
    check_operand(cols, "cols", torch.int32, (t_count,), dev)
    check_operand(mask_blocks, "mask_blocks", None,
                  (t_count, bm, bn), dev)
    check_operand(b, "b", None, (m, k), dev)
    check_operand(c, "c", None, (k, n), dev)
    mask_blocks, b, c = mask_blocks.float(), b.float(), c.float()
    y = torch.empty((t_count, bm, bn), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry("sddmm")(
            rows.data_ptr(), cols.data_ptr(), mask_blocks.data_ptr(),
            b.data_ptr(), c.data_ptr(), y.data_ptr(), t_count, bm, bn, k, n,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    return y.to(out)


def sddmm_blockcoo_kernel(rows: torch.Tensor, cols: torch.Tensor,
                          mask_blocks: torch.Tensor, b: torch.Tensor,
                          c: torch.Tensor) -> torch.Tensor:
    """K3: Y[e] = mask[e] ⊙ (B[rows[e]-block] @ C[:, cols[e]-block]),
    [nnzb, bm, bn] in ``result_type(mask_blocks, b)``; ``b`` [Mp, K] and
    ``c`` [K, Np] padded to the block grid."""
    if b.device.type == "cpu":
        return sddmm_blockcoo_ref(rows, cols, mask_blocks, b, c)
    require_cuda(b, "sddmm_blockcoo_kernel")
    y = launch_tiles(rows, cols, mask_blocks, b, c, "K3 sddmm_blockcoo")
    sddmm_blockcoo_kernel.launches += 1
    return y


sddmm_blockcoo_kernel.launches = 0

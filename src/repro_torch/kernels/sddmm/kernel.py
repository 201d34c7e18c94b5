"""Block-COO SDDMM on the card: the wrapper of kernel K3.

K3 replaces the Pallas kernel ``sddmm_blockcoo_kernel`` of
``repro.kernels.sddmm.kernel``.  The CUDA source is ``csrc/sddmm.cu``
(beside K4's slot kernel); its note says what bounds it on an H100 and
how its design answers that.  Any K >= 1 works.

The mask is optional: without one every cell of each listed tile is
sampled (the ELL path's unweighted dots), and the kernel reads no mask at
all.  With one, ``round_dot`` picks the epilogue's rounding: False (the
default) rounds mask x dot once, as the reference's kernel does; True
rounds the dot to the output dtype first and the product again, which the
``SparseMatrix`` ELL path asks for (it equals the unweighted launch
followed by values x dots, the reference's ``sddmm_values``).  In f32, or
with a 0/1 mask, the two agree bit for bit.  B, C and the mask are read in their own dtype (f32, bf16 or f16)
and Y is written in its own.

The wrapper runs the plain version (``ref.sddmm_blockcoo_ref``) for CPU
tensors and the kernel for CUDA tensors; there is no fallback between the
two.  ``sddmm_blockcoo_kernel.launches`` counts kernel launches.

``sddmm_pattern_kernel`` is K3 at a pattern: the unweighted tiles at the
cells an occupancy bit marks (``ref.pack_occupancy``), exact 0 elsewhere,
with work only at those cells (``csrc/sddmm.cu``'s
``sddmm_pattern_kernel``); its plain version is ``ref.sddmm_pattern_ref``
and it keeps its own ``.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sddmm.ref import (WORD_BITS, sddmm_blockcoo_ref,
                                           sddmm_pattern_ref)
from repro_torch.kernels.spmm.kernel import (KERNEL_DTYPES, check_geometry,
                                             check_operand, require_cuda,
                                             result_dtype)


def launch_tiles(rows, cols, mask_blocks, b, c, what: str, *,
                 block: Optional[Tuple[int, int]] = None,
                 out_dtype: Optional[torch.dtype] = None,
                 round_dot: bool = False) -> torch.Tensor:
    """Check the operands and launch K3 (``csrc/sddmm.cu``) on the current
    stream; returns Y [T, bm, bn] in ``result_type(mask_blocks, b)``, or
    with no mask in ``out_dtype``, with (bm, bn) from ``block``.  B and C of different dtypes are both widened to
    their common type, and a mask narrower than Y to Y's (exact); the
    kernel reads them in that type."""
    dev = b.device
    if mask_blocks is None:
        t_count, (bm, bn), out = rows.shape[0], block, out_dtype
    else:
        t_count, bm, bn = mask_blocks.shape
        out = result_dtype(mask_blocks, b)
    m, k = b.shape
    n = c.shape[1]
    check_geometry(bm, bn, n)
    if m % bm:
        raise ValueError(f"B has {m} rows, not a multiple of bm={bm}")
    operand = result_dtype(b, c)
    if out not in KERNEL_DTYPES:
        raise TypeError(f"output dtype {out} is not one the kernel writes")
    check_operand(rows, "rows", torch.int32, (t_count,), dev)
    check_operand(cols, "cols", torch.int32, (t_count,), dev)
    if mask_blocks is not None:
        check_operand(mask_blocks, "mask_blocks", None, (t_count, bm, bn),
                      dev)
        mask_blocks = mask_blocks.to(out)
    check_operand(b, "b", None, (m, k), dev)
    check_operand(c, "c", None, (k, n), dev)
    b, c = b.to(operand), c.to(operand)
    y = torch.empty((t_count, bm, bn), dtype=out, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry("sddmm")(
            rows.data_ptr(), cols.data_ptr(),
            None if mask_blocks is None else mask_blocks.data_ptr(),
            b.data_ptr(), c.data_ptr(), y.data_ptr(), t_count, bm, bn, k, n,
            KERNEL_DTYPES[operand], KERNEL_DTYPES[out], int(round_dot),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    return y


def sddmm_blockcoo_kernel(rows: torch.Tensor, cols: torch.Tensor,
                          mask_blocks: Optional[torch.Tensor],
                          b: torch.Tensor, c: torch.Tensor, *,
                          block: Optional[Tuple[int, int]] = None,
                          out_dtype: Optional[torch.dtype] = None,
                          round_dot: bool = False) -> torch.Tensor:
    """K3: Y[e] = mask[e] ⊙ (B[rows[e]-block] @ C[:, cols[e]-block]),
    [nnzb, bm, bn] in ``result_type(mask_blocks, b)``, rounded once (with
    ``round_dot`` the dot is rounded before the mask multiplies it); ``b``
    [Mp, K] and ``c`` [K, Np] padded to the block grid.  ``mask_blocks``
    None samples every cell of each tile, (bm, bn) = ``block``, in
    ``out_dtype``."""
    if mask_blocks is None and (block is None or out_dtype is None):
        raise ValueError("sddmm_blockcoo_kernel: without a mask, block and "
                         "out_dtype are needed")
    kw = dict(block=block, out_dtype=out_dtype, round_dot=round_dot)
    if b.device.type == "cpu":
        return sddmm_blockcoo_ref(rows, cols, mask_blocks, b, c, **kw)
    require_cuda(b, "sddmm_blockcoo_kernel")
    y = launch_tiles(rows, cols, mask_blocks, b, c, "K3 sddmm_blockcoo", **kw)
    sddmm_blockcoo_kernel.launches += 1
    return y


sddmm_blockcoo_kernel.launches = 0


def launch_pattern(rows, cols, occupancy, b, c, what: str, *,
                   block: Tuple[int, int],
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Check the operands and launch K3 at a pattern (``csrc/sddmm.cu``,
    ``sddmm_pattern``) on the current stream; returns Y [T, bm, bn] in
    ``out_dtype``.  C is read as its transpose: where ``c`` is a
    transposed view of a contiguous tensor (the backward's ``v.T``) that
    costs no copy.  B and C of different dtypes are both widened to their
    common type."""
    dev = b.device
    t_count = rows.shape[0]
    bm, bn = block
    m, k = b.shape
    n = c.shape[1]
    check_geometry(bm, bn, n)
    if m % bm:
        raise ValueError(f"B has {m} rows, not a multiple of bm={bm}")
    operand = result_dtype(b, c)
    if out_dtype not in KERNEL_DTYPES:
        raise TypeError(f"output dtype {out_dtype} is not one the kernel "
                        "writes")
    check_operand(rows, "rows", torch.int32, (t_count,), dev)
    check_operand(cols, "cols", torch.int32, (t_count,), dev)
    check_operand(occupancy, "occupancy", torch.int32,
                  (t_count, bm, -(-bn // WORD_BITS)), dev)
    check_operand(b, "b", None, (m, k), dev)
    check_operand(c, "c", None, (k, n), dev, contiguous=False)
    b, ct = b.to(operand), c.T.to(operand).contiguous()
    y = torch.empty((t_count, bm, bn), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry("sddmm_pattern")(
            rows.data_ptr(), cols.data_ptr(), occupancy.data_ptr(),
            b.data_ptr(), ct.data_ptr(), y.data_ptr(), t_count, bm, bn, k,
            KERNEL_DTYPES[operand], KERNEL_DTYPES[out_dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    return y


def sddmm_pattern_kernel(rows: torch.Tensor, cols: torch.Tensor,
                         occupancy: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, *, block: Tuple[int, int],
                         out_dtype: torch.dtype) -> torch.Tensor:
    """K3 at a pattern: Y[t] = B[rows[t]-block] @ C[:, cols[t]-block] at
    the cells whose ``occupancy`` bit is set (int32 [T, bm, ceil(bn /
    32)], ``ref.pack_occupancy``), exact 0 elsewhere; [T, bm, bn] in
    ``out_dtype`` with (bm, bn) = ``block``; ``b`` [Mp, K] and ``c``
    [K, Np] padded to the block grid."""
    if b.device.type == "cpu":
        return sddmm_pattern_ref(rows, cols, occupancy, b, c, block=block,
                                 out_dtype=out_dtype)
    require_cuda(b, "sddmm_pattern_kernel")
    y = launch_pattern(rows, cols, occupancy, b, c, "K3 sddmm_pattern",
                       block=block, out_dtype=out_dtype)
    sddmm_pattern_kernel.launches += 1
    return y


sddmm_pattern_kernel.launches = 0

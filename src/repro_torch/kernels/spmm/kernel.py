"""Block-ELL SpMM on the card: the wrapper of kernel K1.

K1 replaces the Pallas kernel ``spmm_blockell_kernel`` of
``repro.kernels.spmm.kernel``.  The CUDA source is
``csrc/spmm_blockell.cu`` (shared with K5, which adds the epilogue); its
note says what bounds it on an H100 and how its design answers that.

The wrapper runs the plain version (``ref.spmm_blockell_ref``) for CPU
tensors and the kernel for CUDA tensors; there is no fallback between
the two.  ``spmm_blockell_kernel.launches`` counts kernel launches.

Operands may be f32, bf16 or f16.  Both sides sum in f32 and return the
reference's default output dtype, ``result_type(blocks, h)``
(``repro.kernels.spmm.ops.spmm_blockell``); the kernel reads bf16 and f16
blocks and H natively.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused.epilogue import IDENTITY, Epilogue
from repro_torch.kernels.spmm.ref import spmm_blockell_ref

ACT_CODES = {"identity": 0, "relu": 1, "leaky_relu": 2}
MAX_BLOCK = 128  # largest bm / bn the kernels take (shared-memory tiles)
# the float dtypes the wrappers take, with K1/K5's element-type codes
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def result_dtype(*tensors: torch.Tensor) -> torch.dtype:
    """The promoted dtype of ``tensors`` (``jnp.result_type`` of the
    reference's default ``out_dtype`` lines), after checking that each is
    one the kernels take."""
    out = tensors[0].dtype
    for t in tensors:
        if t.dtype not in KERNEL_DTYPES:
            raise TypeError(f"dtype {t.dtype} is not one the kernels take "
                            f"({', '.join(map(str, KERNEL_DTYPES))})")
        out = torch.promote_types(out, t.dtype)
    return out


def check_operand(t: Optional[torch.Tensor], name: str,
                  dtype: Optional[torch.dtype], shape: Sequence[int],
                  device: torch.device, contiguous: bool = True) -> None:
    """Raise unless ``t`` is a tensor of ``shape`` on ``device``,
    contiguous unless ``contiguous`` is False (a kernel that reads it
    through its strides), and, where ``dtype`` is given, of that dtype
    (the kernels take nothing else; float operands are checked by
    ``result_dtype``)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_geometry(bm: int, bn: int, n: int) -> None:
    if not (1 <= bm <= MAX_BLOCK and 1 <= bn <= MAX_BLOCK):
        raise ValueError(f"block ({bm}, {bn}) outside 1..{MAX_BLOCK}")
    if n % bn:
        raise ValueError(f"H has {n} rows, not a multiple of bn={bn}")


def require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {t.device} are neither CPU "
                         "(plain version) nor CUDA (kernel)")


def launch_blockell(indices, blocks, h, bias, res, epi: Epilogue,
                    what: str) -> torch.Tensor:
    """Check the operands and launch ``csrc/spmm_blockell.cu`` on the
    current stream; returns Y [nbr*bm, D] in ``result_type(blocks, h)``.
    Blocks and H of different dtypes are promoted to that type first;
    bias and residual go to the kernel in f32 (exact), as the
    reference's epilogue adds them."""
    dev = h.device
    nbr, w, bm, bn = blocks.shape
    n, d = h.shape
    check_geometry(bm, bn, n)
    out = result_dtype(blocks, h)
    check_operand(indices, "indices", torch.int32, (nbr, w), dev)
    check_operand(blocks, "blocks", None, (nbr, w, bm, bn), dev)
    check_operand(h, "h", None, (n, d), dev)
    blocks, h = blocks.to(out), h.to(out)
    if epi.has_bias:
        check_operand(bias, "bias", None, (d,), dev)
        result_dtype(bias)  # raises on a dtype the kernels do not take
        bias = bias.float()
    if epi.has_residual:
        check_operand(res, "residual", None, (nbr * bm, d), dev)
        result_dtype(res)
        res = res.float()
    y = torch.empty((nbr * bm, d), dtype=out, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry("spmm_blockell")(
            KERNEL_DTYPES[out], indices.data_ptr(), blocks.data_ptr(),
            h.data_ptr(), bias.data_ptr() if epi.has_bias else None,
            res.data_ptr() if epi.has_residual else None,
            y.data_ptr(), nbr, w, bm, bn, d, ACT_CODES[epi.act],
            float(epi.negative_slope),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    return y


def spmm_blockell_kernel(indices: torch.Tensor, blocks: torch.Tensor,
                         h: torch.Tensor) -> torch.Tensor:
    """K1: Y[nbr*bm, D] = A @ H with A in Block-ELL (``h`` padded to the
    block-column grid)."""
    if h.device.type == "cpu":
        return spmm_blockell_ref(indices, blocks, h)
    require_cuda(h, "spmm_blockell_kernel")
    y = launch_blockell(indices, blocks, h, None, None, IDENTITY,
                        "K1 spmm_blockell")
    spmm_blockell_kernel.launches += 1
    return y


spmm_blockell_kernel.launches = 0

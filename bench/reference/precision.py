"""The products of the reference, in float32 or, for the control, in TF32.

TF32 keeps 10 of float32's 23 mantissa bits.  The control rounds every
operand of every product to it (to nearest, ties away from zero, as
``cvt.rna.tf32.f32`` does) and sums in float32, forward and backward, as
the tensor cores would with TF32 on; it does so on any device, so the CPU
tests run the same control as the card.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32")


def strict_float32() -> None:
    """Turn TF32 off for float32 products (the configurations' precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits."""
    bits = x.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ b.T, a.T @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return a @ b
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    raise ValueError(f"precision must be one of {PRECISIONS}, got "
                     f"{precision!r}")

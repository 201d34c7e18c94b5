"""Epilogue vocabulary for fused SpMM (the port of
``repro.kernels.fused.epilogue``).

An :class:`Epilogue` is a small hashable spec of the elementwise tail
applied to the SpMM accumulator before the single output store:

    out = act(A @ H + bias + residual)

The bias/residual tensors are separate operands; the spec only records
which of them participate and the activation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

ACTS = ("identity", "relu", "leaky_relu")


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Hashable spec of the fused SpMM tail: act(y + bias + residual)."""

    act: str = "identity"
    negative_slope: float = 0.01   # leaky_relu only
    has_bias: bool = False
    has_residual: bool = False

    def __post_init__(self):
        if self.act not in ACTS:
            raise ValueError(
                f"unknown epilogue activation {self.act!r}; expected one "
                f"of {ACTS}")

    def describe(self) -> str:
        parts = [self.act] if self.act != "identity" else []
        if self.has_bias:
            parts.append("bias")
        if self.has_residual:
            parts.append("residual")
        return "+".join(parts) or "identity"


IDENTITY = Epilogue()


def normalize_epilogue(epilogue, bias, residual) -> Optional[Epilogue]:
    """Canonicalize the public (epilogue, bias, residual) kwargs.

    ``epilogue`` may be an activation name, an :class:`Epilogue`, or
    None; supplying ``bias``/``residual`` alone implies an identity-act
    epilogue.  Returns None when there is nothing to fuse.
    """
    if epilogue is None and bias is None and residual is None:
        return None
    if epilogue is None:
        epi = Epilogue()
    elif isinstance(epilogue, Epilogue):
        epi = epilogue
    else:
        epi = Epilogue(act=str(epilogue),
                       negative_slope=0.2 if epilogue == "leaky_relu"
                       else 0.01)
    has_bias = bias is not None
    has_residual = residual is not None
    if epi.has_bias != has_bias or epi.has_residual != has_residual:
        epi = dataclasses.replace(epi, has_bias=has_bias,
                                  has_residual=has_residual)
    return epi


def apply_act(z: torch.Tensor, act: str, negative_slope: float):
    """The epilogue activation on an f32 tensor."""
    if act == "identity":
        return z
    if act == "relu":
        return torch.clamp_min(z, 0.0)
    if act == "leaky_relu":
        return torch.where(z >= 0, z, negative_slope * z)
    raise ValueError(f"unknown epilogue activation {act!r}")


def act_grad_from_out(out: torch.Tensor, act: str, negative_slope: float):
    """d act/dz evaluated from the *post*-activation value (or from z
    itself: the fused-attention backward passes its raw scores).

    Valid because relu and leaky_relu (slope > 0) keep the sign of z:
    out > 0 <=> z > 0 and out >= 0 <=> z >= 0.
    """
    if act == "identity":
        return torch.ones_like(out)
    if act == "relu":
        return (out > 0).to(out.dtype)
    if act == "leaky_relu":
        return torch.where(out >= 0, 1.0, negative_slope).to(out.dtype)
    raise ValueError(f"unknown epilogue activation {act!r}")


def apply_epilogue(y: torch.Tensor, epi: Optional[Epilogue], bias=None,
                   residual=None) -> torch.Tensor:
    """Plain application of the epilogue to a [M, D] product."""
    if epi is None:
        return y
    z = y.float()
    if epi.has_bias:
        z = z + bias.float()
    if epi.has_residual:
        z = z + residual.float()
    return apply_act(z, epi.act, epi.negative_slope).to(y.dtype)

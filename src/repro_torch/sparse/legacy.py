"""Legacy-surface shim helpers: kwarg coercion and deprecation warnings
(the port of ``repro.sparse.legacy``).

This is the one place that interprets the historical ``use_kernel=`` /
``interpret=`` keywords of ``dispatch_spmm`` / ``dispatch_sddmm`` (and so
of ``core.spmm.spmm``, ``core.sddmm.sddmm`` and ``SparseOperand``):
passing either explicitly forces the blocked ("ell") path under ``auto``
/ ``autotune``, because the keywords parameterize that path and asking
for them implies it.  In the port they mean:

  * ``use_kernel=False``: the ell path runs its kernel's plain PyTorch
    version, on any device.  The caller asked for it; it is no fallback.
  * ``interpret=True``: the plain version too (the port's counterpart of
    Pallas's interpret mode).
  * ``use_kernel=True`` or ``None`` on a CUDA operand: the CUDA kernel.
  * ``use_kernel=True`` on a CPU operand without ``interpret``: a
    ``ValueError`` that names the device (there is no kernel to run).
  * ``use_kernel=None`` on a CPU operand: the kernel's wrapper, which runs
    the plain version because the tensors lie on the CPU.

``out_dtype`` sets the result's dtype as the reference's kernels write
it (the f32 sums rounded once to it).  ``bd`` / ``bk`` are the
reference's TPU tile sizes; the port's kernels choose their own tiles,
so they are accepted and choose nothing.

``warn_deprecated`` is the single ``DeprecationWarning`` emitter for the
old free-function surface; the message carries the one-line migration
hint to ``repro_torch.sparse``.  No module of the port calls the
deprecated entry points.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from repro_torch.dispatch.policy import (PATH_ELL, POLICY_AUTO,
                                         POLICY_AUTOTUNE, normalize_policy)

_MIGRATION_HINT = ("migrate to repro.sparse: "
                   "A = SparseMatrix.from_dense(a); A @ h / A.sddmm(b, c)")


def warn_deprecated(name: str, hint: str = _MIGRATION_HINT) -> None:
    """Emit the single DeprecationWarning for a legacy entry point."""
    warnings.warn(f"{name} is deprecated; {hint}",
                  DeprecationWarning, stacklevel=3)


def coerce_kernel_kwargs(
    policy: str,
    use_kernel: Optional[bool],
    interpret: Optional[bool],
) -> Tuple[str, Optional[bool], bool, bool]:
    """Normalize policy and apply the legacy kernel-kwarg rule.

    Returns ``(policy, use_kernel, interpret, kernel_forced)`` where
    ``kernel_forced`` records whether the caller passed either kwarg
    explicitly (which forces the blocked path under auto policies, so
    legacy ``spmm(ell, h, use_kernel=False)`` call sites stay
    meaningful).
    """
    kernel_forced = use_kernel is not None or interpret is not None
    policy = normalize_policy(policy)
    if kernel_forced and policy in (POLICY_AUTO, POLICY_AUTOTUNE):
        policy = PATH_ELL
    return policy, use_kernel, bool(interpret), kernel_forced


def plain_requested(use_kernel: Optional[bool], interpret: bool,
                    device) -> bool:
    """Whether the caller asked for the plain version of the ell path's
    kernel (``use_kernel=False`` or ``interpret=True``).  False means the
    kernel's wrapper runs: the kernel on a CUDA operand, its plain version
    on a CPU one.  ``use_kernel=True`` on a device with no kernel (without
    ``interpret``) raises ``ValueError``."""
    if interpret or use_kernel is False:
        return True
    if use_kernel and torch.device(device).type != "cuda":
        raise ValueError(
            f"use_kernel=True: the operand is on {torch.device(device)}, "
            "where no CUDA kernel runs (pass interpret=True or "
            "use_kernel=False for the plain version)")
    return False


def check_front_end_kwargs(use_kernel: Optional[bool], interpret: bool,
                           device) -> None:
    """The legacy keywords on ``sparse.ops.matmul`` / ``spmv`` / ``sddmm``,
    which plan as the reference's do (the keywords force no path there):
    the operand's device chooses the kernel or its plain version, so a
    keyword that asks for the other raises ``ValueError`` (the plain
    versions on the card are reached through ``dispatch_spmm`` /
    ``dispatch_sddmm``, or by passing CPU tensors)."""
    dev = torch.device(device)
    if plain_requested(use_kernel, interpret, dev) and dev.type == "cuda":
        raise ValueError(
            "use_kernel=False / interpret=True: the SparseMatrix front-ends "
            f"run the CUDA kernels for an operand on {dev}; pass CPU tensors "
            "for the plain versions, or use dispatch_spmm / dispatch_sddmm")


def in_out_dtype(y: torch.Tensor, out_dtype) -> torch.Tensor:
    """``y`` in ``out_dtype`` (None keeps its own)."""
    return y if out_dtype is None else y.to(out_dtype)


def compute_dtype(natural: torch.dtype, out_dtype) -> torch.dtype:
    """The dtype a kernel writes so that ``out_dtype`` comes out rounded
    once: the wider of its natural result and ``out_dtype`` (a narrower
    ``out_dtype`` is one rounding of the f32 result)."""
    return natural if out_dtype is None \
        else torch.promote_types(natural, out_dtype)

"""Planned SpMM front-end for ``SparseMatrix`` (the port of
``repro.sparse.ops.matmul``).

``matmul`` (what ``A @ H`` calls) resolves an execution path through the
analytic cost model for ``policy="auto"`` or takes a forced path, then
runs it.  Plans are memoized per matrix: the first call for a given key
plans, every later call hits the memo.  Candidate paths follow the forms
a matrix carries; ``dense`` densifies on the device and is always
available.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.dispatch.cost_model import DEFAULT_COST_MODEL, CostModel
from repro_torch.dispatch.dispatcher import Plan, plan_spmm, record_plan
from repro_torch.dispatch.policy import (PATH_CSR, PATH_DENSE, PATH_ELL,
                                         PATH_SELL, PATHS, POLICY_AUTO,
                                         normalize_policy)
from repro_torch.kernels.fused.epilogue import normalize_epilogue
from repro_torch.sparse import autodiff
from repro_torch.sparse.matrix import SparseMatrix


def available_paths(a: SparseMatrix) -> Tuple[str, ...]:
    """Execution paths the matrix's carried forms can run."""
    cand = []
    if a.has_form("ell"):
        cand.append(PATH_ELL)
    if a.has_form("sell"):
        cand.append(PATH_SELL)
    if a.has_form("csr"):
        cand.append(PATH_CSR)
    cand.append(PATH_DENSE)  # device densify works for every form
    return tuple(cand)


def _resolve_plan(op: str, a: SparseMatrix, inner_dim: int, ref_dtype,
                  policy: str, cand: Tuple[str, ...],
                  cost_model: CostModel, key_extra: Tuple = (),
                  fused: Optional[str] = None) -> Plan:
    """Resolve (and memoize) one dispatch plan (forced or cost model)."""
    key = (op, int(inner_dim), policy, str(ref_dtype), cand,
           cost_model) + tuple(key_extra)
    plan = a.plan_cache.get(key)
    if plan is not None:
        return plan
    if policy in PATHS:
        if policy not in cand:
            raise ValueError(
                f"policy {policy!r} not among available paths {cand}")
        plan = Plan(op=op, path=policy, policy=policy, reason="forced",
                    use_kernel=a.device.type == "cuda", stats=a.stats)
    else:
        if a.stats is None:
            raise ValueError(
                f"{op}: matrix has no sparsity stats; construct it with "
                "SparseMatrix.from_dense or force a path policy")
        plan = plan_spmm(a.stats, inner_dim, policy=policy,
                         cost_model=cost_model, device=a.device,
                         candidates=cand)
    if fused is not None and plan.fused != fused:
        plan = dataclasses.replace(plan, fused=fused)
    a.plan_cache.put(key, plan)
    return plan


def matmul(
    a: SparseMatrix,
    h: torch.Tensor,
    *,
    policy: str = POLICY_AUTO,
    candidates: Optional[Tuple[str, ...]] = None,
    epilogue=None,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    cost_model: CostModel = DEFAULT_COST_MODEL,
) -> torch.Tensor:
    """Y = A @ H through the planned sparse front-end.

    ``epilogue`` fuses an elementwise tail into the product:
    ``Y = act(A @ H + bias + residual)`` with ``act`` one of
    ``"identity" | "relu" | "leaky_relu"`` (or a full
    :class:`repro_torch.kernels.fused.epilogue.Epilogue`).  ``H`` is a
    2-D tensor on the matrix's device.
    """
    if not isinstance(a, SparseMatrix):
        raise TypeError(f"matmul expects a SparseMatrix, got {type(a)}")
    if not isinstance(h, torch.Tensor) or h.ndim != 2:
        raise ValueError("spmm: H must be a 2-D tensor, got "
                         f"{getattr(h, 'shape', type(h))}")
    if h.shape[0] != a.shape[1]:
        raise ValueError(
            f"spmm: H has {h.shape[0]} rows but A has {a.shape[1]} "
            f"columns (A shape {a.shape})")
    if h.device != a.device:
        raise ValueError(f"spmm: H is on {h.device}, A on {a.device}")
    if bias is not None:
        # canonicalize to a [D] vector (scalars broadcast)
        bias = torch.as_tensor(bias, dtype=h.dtype, device=h.device)
        if bias.ndim == 0:
            bias = bias.expand(h.shape[1])
        if tuple(bias.shape) != (h.shape[1],):
            raise ValueError(
                f"spmm epilogue: bias must be a scalar or a [{h.shape[1]}]"
                f" vector, got shape {tuple(bias.shape)}")
        bias = bias.contiguous()
    if residual is not None:
        if tuple(residual.shape) != (a.shape[0], h.shape[1]):
            raise ValueError(
                f"spmm epilogue: residual must be output-shaped "
                f"[{a.shape[0]}, {h.shape[1]}], got "
                f"{tuple(residual.shape)}")
        residual = residual.contiguous()
    epi = normalize_epilogue(epilogue, bias, residual)
    policy = normalize_policy(policy)
    cand = tuple(candidates) if candidates else available_paths(a)
    plan = _resolve_plan("spmm", a, h.shape[1], h.dtype, policy, cand,
                         cost_model,
                         key_extra=() if epi is None else (epi,),
                         fused=None if epi is None else epi.describe())
    record_plan(plan)
    h = h.contiguous()
    if epi is None:
        return autodiff.spmm_exec(plan.path, a, h)
    return autodiff.spmm_epilogue_exec(plan.path, epi, a, h, bias, residual)

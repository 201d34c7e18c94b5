"""Planned SpMM, SpMV, SDDMM and fused-attention front-ends for
``SparseMatrix`` (the port of ``repro.sparse.ops``).

``matmul`` (what ``A @ H`` calls; a 1-D ``H`` takes ``spmv``), ``spmv``,
``sddmm`` / ``sample`` and ``fused_graph_attention`` resolve an execution
path through the analytic cost model for ``policy="auto"``, through the
timed autotune cache for ``policy="autotune"`` (each candidate path timed
once on the operand's device, ``repro_torch.dispatch.autotune``), or take
a forced path, then run it.  Plans are memoized per matrix: the first
call for a given key plans, every later call hits the memo.  Candidate
paths follow the forms a matrix carries (``ell`` needs an ``ell`` or
``coo`` form); ``dense`` densifies on the device and is always
available.  Each op runs through
its ``torch.autograd.Function`` (``repro_torch.sparse.autodiff``), so
``loss.backward()`` differentiates through the SpMM <-> SDDMM duality.

``matmul``, ``spmv`` and ``sddmm`` take the reference's ``use_kernel`` /
``interpret`` / ``bd`` (``bk``) / ``out_dtype`` keywords: the first two
are checked against the operand's device
(``repro_torch.sparse.legacy.check_front_end_kwargs``), ``bd`` / ``bk``
choose nothing (the kernels pick their own tiles) and ``out_dtype`` casts
the result.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.dispatch.autotune import AutotuneCache
from repro_torch.dispatch.cost_model import DEFAULT_COST_MODEL, CostModel
from repro_torch.dispatch.dispatcher import (Plan, autotune_plan, on_cuda,
                                             plan_fused_attention,
                                             plan_sddmm, plan_spmm,
                                             plan_spmv, record_plan)
from repro_torch.dispatch.policy import (DEFAULT_CONFIG, PATH_CSR,
                                         PATH_DENSE, PATH_ELL,
                                         PATH_FUSED_ATTN, PATH_SELL, PATHS,
                                         POLICY_AUTO, POLICY_AUTOTUNE,
                                         DispatchConfig, normalize_policy)
from repro_torch.kernels.fused.epilogue import normalize_epilogue
from repro_torch.sparse import autodiff
from repro_torch.sparse.legacy import check_front_end_kwargs, in_out_dtype
from repro_torch.sparse.matrix import SparseMatrix, single_form


def available_paths(a: SparseMatrix) -> Tuple[str, ...]:
    """Execution paths the matrix's carried forms can run."""
    cand = []
    if a.has_form("ell") or a.has_form("coo"):
        cand.append(PATH_ELL)
    if a.has_form("sell"):
        cand.append(PATH_SELL)
    if a.has_form("csr"):
        cand.append(PATH_CSR)
    cand.append(PATH_DENSE)  # device densify works for every form
    return tuple(cand)


def _resolve_plan(op: str, a: SparseMatrix, inner_dim, ref_dtype,
                  policy: str, cand: Tuple[str, ...],
                  cost_model: CostModel, config: DispatchConfig,
                  autotune_cache: Optional[AutotuneCache], exec_thunk,
                  key_extra: Tuple = (),
                  fused: Optional[str] = None) -> Plan:
    """Resolve (and memoize) one dispatch plan: forced, the cost model, or
    timed (``autotune``: each candidate's ``exec_thunk(path)`` timed once
    per autotune key, the winner cached in ``autotune_cache``, else
    ``GLOBAL_CACHE``; ``dispatcher.autotune_plan``).

    ``inner_dim`` is the operand width: an int for spmm / spmv / sddmm, a
    ``(k, d)`` pair for the fused attention op.  ``key_extra`` folds
    op-specific static config (the epilogue, the edge act) into both keys;
    ``fused`` tags the plan for the dispatch log.
    """
    inner_key = tuple(int(x) for x in inner_dim) \
        if isinstance(inner_dim, tuple) else int(inner_dim)
    key = (op, inner_key, policy, str(ref_dtype), cand,
           cost_model) + tuple(key_extra)
    plan = a.plan_cache.get(key)
    if plan is not None:
        return plan
    if policy in PATHS:
        if policy not in cand:
            raise ValueError(
                f"policy {policy!r} not among available paths {cand}")
        plan = Plan(op=op, path=policy, policy=policy, reason="forced",
                    use_kernel=on_cuda(a.device), stats=a.stats)
    elif a.stats is None:
        raise ValueError(
            f"{op}: matrix has no sparsity stats; construct it with "
            "SparseMatrix.from_dense / from_* or force a path policy")
    elif policy == POLICY_AUTOTUNE:
        # the fused op is keyed at its width k + d
        width = sum(inner_key) if isinstance(inner_key, tuple) \
            else inner_key
        plan = autotune_plan(op, a.stats, width, ref_dtype,
                             {p: exec_thunk(p) for p in cand}, a.device,
                             config, autotune_cache, key_extra)
    else:
        kw = dict(policy=policy, cost_model=cost_model, config=config,
                  device=a.device, candidates=cand)
        if op == PATH_FUSED_ATTN:
            plan = plan_fused_attention(a.stats, *inner_key, **kw)
        elif op == "spmv":
            plan = plan_spmv(a.stats, **kw)
        elif op == "sddmm":
            plan = plan_sddmm(a.stats, inner_key, **kw)
        else:
            plan = plan_spmm(a.stats, inner_key, **kw)
    if fused is not None and plan.fused != fused:
        plan = dataclasses.replace(plan, fused=fused)
    a.plan_cache.put(key, plan)
    return plan


def _check_operand(what: str, x, a: SparseMatrix) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} must be a tensor, got {type(x)}")
    if x.device != a.device:
        raise ValueError(f"{what} is on {x.device}, A on {a.device}")
    return x


# ---------------------------------------------------------------------------
# SpMM
# ---------------------------------------------------------------------------


def matmul(
    a: SparseMatrix,
    h: torch.Tensor,
    *,
    policy: str = POLICY_AUTO,
    candidates: Optional[Tuple[str, ...]] = None,
    use_kernel: Optional[bool] = None,
    interpret: bool = False,
    bd: Optional[int] = None,
    out_dtype=None,
    epilogue=None,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    config: DispatchConfig = DEFAULT_CONFIG,
    autotune_cache: Optional[AutotuneCache] = None,
) -> torch.Tensor:
    """Y = A @ H through the planned sparse front-end.

    ``epilogue`` fuses an elementwise tail into the product:
    ``Y = act(A @ H + bias + residual)`` with ``act`` one of
    ``"identity" | "relu" | "leaky_relu"`` (or a full
    :class:`repro_torch.kernels.fused.epilogue.Epilogue`).  ``H`` is a
    1-D or 2-D tensor on the matrix's device; a 1-D ``H`` with no tail
    takes the SpMV lane (``spmv``).
    """
    if not isinstance(a, SparseMatrix):
        raise TypeError(f"matmul expects a SparseMatrix, got {type(a)}")
    _check_operand("spmm: H", h, a)
    check_front_end_kwargs(use_kernel, interpret, a.device)
    h_was_1d = h.ndim == 1
    if h_was_1d and epilogue is None and bias is None and residual is None:
        return spmv(a, h, policy=policy, candidates=candidates,
                    use_kernel=use_kernel, interpret=interpret,
                    out_dtype=out_dtype, cost_model=cost_model,
                    config=config, autotune_cache=autotune_cache)
    if h_was_1d:
        h = h[:, None]
        if residual is not None and residual.ndim == 1:
            residual = residual[:, None]
    if h.ndim != 2:
        raise ValueError("spmm: H must be 1-D or 2-D, got shape "
                         f"{tuple(h.shape)}")
    if h.shape[0] != a.shape[1]:
        raise ValueError(
            f"spmm: H has {h.shape[0]} rows but A has {a.shape[1]} "
            f"columns (A shape {a.shape})")
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
    h = h.contiguous()

    def exec_thunk(p):
        if epi is None:
            return lambda: autodiff.spmm_exec(p, a, h)
        return lambda: autodiff.spmm_epilogue_exec(p, epi, a, h, bias,
                                                   residual)

    plan = _resolve_plan("spmm", a, h.shape[1], h.dtype, policy, cand,
                         cost_model, config, autotune_cache, exec_thunk,
                         key_extra=() if epi is None else (epi,),
                         fused=None if epi is None else epi.describe())
    record_plan(plan)
    vals = autodiff.read_values(a, plan.path)
    if epi is None:
        y = autodiff.SpMM.apply(plan.path, a, vals, h)
    else:
        y = autodiff.SpMMEpilogue.apply(plan.path, epi, a, vals, h, bias,
                                        residual)
    y = in_out_dtype(y, out_dtype)
    return y[:, 0] if h_was_1d else y


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------


def spmv(
    a: SparseMatrix,
    x: torch.Tensor,
    *,
    policy: str = POLICY_AUTO,
    candidates: Optional[Tuple[str, ...]] = None,
    use_kernel: Optional[bool] = None,
    interpret: bool = False,
    out_dtype=None,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    config: DispatchConfig = DEFAULT_CONFIG,
    autotune_cache: Optional[AutotuneCache] = None,
) -> torch.Tensor:
    """y = A @ x for a [N] vector, through the planned front-end.

    Plans on the SpMM cost surface at unit width (op tag ``"spmv"`` in the
    dispatch log) and runs each layout's direct reduction
    (``paths.spmv_*``); ``matmul`` delegates its 1-D branch here.
    Differentiable (``autodiff.SpMV``): dx = Aᵀ ḡ, dA a rank-1 SDDMM.
    """
    if not isinstance(a, SparseMatrix):
        raise TypeError(f"spmv expects a SparseMatrix, got {type(a)}")
    _check_operand("spmv: x", x, a)
    check_front_end_kwargs(use_kernel, interpret, a.device)
    if x.ndim != 1:
        raise ValueError(f"spmv: x must be 1-D, got shape {tuple(x.shape)}")
    if x.shape[0] != a.shape[1]:
        raise ValueError(
            f"spmv: x has {x.shape[0]} rows but A has {a.shape[1]} "
            f"columns (A shape {a.shape})")
    policy = normalize_policy(policy)
    cand = tuple(candidates) if candidates else available_paths(a)
    x = x.contiguous()
    plan = _resolve_plan("spmv", a, 1, x.dtype, policy, cand, cost_model,
                         config, autotune_cache,
                         lambda p: lambda: autodiff.spmv_exec(p, a, x))
    record_plan(plan)
    return in_out_dtype(autodiff.SpMV.apply(
        plan.path, a, autodiff.read_values(a, plan.path), x), out_dtype)


# ---------------------------------------------------------------------------
# SDDMM
# ---------------------------------------------------------------------------


def sddmm(
    a: SparseMatrix,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    policy: str = POLICY_AUTO,
    candidates: Optional[Tuple[str, ...]] = None,
    use_kernel: Optional[bool] = None,
    interpret: bool = False,
    bk: Optional[int] = None,
    out_dtype=None,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    config: DispatchConfig = DEFAULT_CONFIG,
    autotune_cache: Optional[AutotuneCache] = None,
) -> SparseMatrix:
    """S = A ⊙ (B @ C) at A's stored entries.

    Returns a single-form ``SparseMatrix`` sharing A's topology, in the
    layout of the form the planned path read; ``S.data`` holds the
    sampled values (element order for the csr path, what GAT's segment
    softmax consumes).  ``b`` [M, K] and ``c`` [K, N] lie on A's device.
    """
    if not isinstance(a, SparseMatrix):
        raise TypeError(f"sddmm expects a SparseMatrix, got {type(a)}")
    _check_operand("sddmm: B", b, a)
    _check_operand("sddmm: C", c, a)
    check_front_end_kwargs(use_kernel, interpret, a.device)
    if b.shape[0] != a.shape[0]:
        raise ValueError(
            f"sddmm: B has {b.shape[0]} rows but A has {a.shape[0]}")
    if c.shape[1] != a.shape[1]:
        raise ValueError(
            f"sddmm: C has {c.shape[1]} columns but A has {a.shape[1]}")
    if b.shape[1] != c.shape[0]:
        raise ValueError(
            f"sddmm: inner dims disagree: B {tuple(b.shape)} vs C "
            f"{tuple(c.shape)}")
    policy = normalize_policy(policy)
    cand = tuple(candidates) if candidates else available_paths(a)
    plan = _resolve_plan("sddmm", a, b.shape[1], b.dtype, policy, cand,
                         cost_model, config, autotune_cache,
                         lambda p: lambda: autodiff.sddmm_values(p, a, b, c))
    record_plan(plan)
    vals = in_out_dtype(autodiff.SDDMMValues.apply(
        plan.path, a, autodiff.read_values(a, plan.path), b, c), out_dtype)
    return single_form(a, autodiff.form_read_by(a, plan.path), vals)


# the paper's naming for the masked product
sample = sddmm


# ---------------------------------------------------------------------------
# Fused graph attention (one-pass SDDMM -> edge act -> softmax -> SpMM)
# ---------------------------------------------------------------------------


def fused_graph_attention(
    a: SparseMatrix,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    edge_act: str = "leaky_relu",
    negative_slope: float = 0.2,
    policy: str = POLICY_AUTO,
    candidates: Optional[Tuple[str, ...]] = None,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    config: DispatchConfig = DEFAULT_CONFIG,
    autotune_cache: Optional[AutotuneCache] = None,
) -> torch.Tensor:
    """Y = softmax_row(act(q kᵀ ⊙ pattern(A))) @ V, in one dispatch.

    The whole GAT aggregation (score the edges at A's nonzero pattern,
    activate, softmax each row, aggregate V) runs as ONE planned
    pipeline: a single plan in ``dispatch_log()``, and on the ell and
    sell paths a single pass of kernel K7 or K8 over the topology's live
    tiles (the E-length edge scores never exist in device memory).

    ``q``: [M, dk] / ``k``: [N, dk] score factors (1-D inputs are one
    column), ``v``: [N, D] values (a 1-D ``v`` gives a 1-D result).  A
    contributes its structural nonzeros only (values are not read).
    """
    if not isinstance(a, SparseMatrix):
        raise TypeError(
            f"fused_graph_attention expects a SparseMatrix, got {type(a)}")
    for what, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(f"fused_graph_attention: {what}", x, a)
    if q.ndim == 1:
        q = q[:, None]
    if k.ndim == 1:
        k = k[:, None]
    v_was_1d = v.ndim == 1
    if v_was_1d:
        v = v[:, None]
    if q.shape[0] != a.shape[0]:
        raise ValueError(
            f"fused_graph_attention: q has {q.shape[0]} rows but A has "
            f"{a.shape[0]}")
    if k.shape[0] != a.shape[1]:
        raise ValueError(
            f"fused_graph_attention: k has {k.shape[0]} rows but A has "
            f"{a.shape[1]} columns")
    if v.shape[0] != a.shape[1]:
        raise ValueError(
            f"fused_graph_attention: v has {v.shape[0]} rows but A has "
            f"{a.shape[1]} columns")
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"fused_graph_attention: score widths disagree: q "
            f"{tuple(q.shape)} vs k {tuple(k.shape)}")
    policy = normalize_policy(policy)
    cand = tuple(candidates) if candidates else available_paths(a)
    slope = float(negative_slope)
    plan = _resolve_plan(
        PATH_FUSED_ATTN, a, (q.shape[1], v.shape[1]), q.dtype, policy, cand,
        cost_model, config, autotune_cache,
        lambda p: lambda: autodiff.fused_attention_exec(p, a, q, k, v,
                                                        edge_act, slope),
        key_extra=(edge_act, slope), fused="attn")
    record_plan(plan)
    y = autodiff.FusedAttention.apply(plan.path, a,
                                      autodiff.read_values(a, plan.path), q, k,
                                      v, edge_act, slope)
    return y[:, 0] if v_was_1d else y

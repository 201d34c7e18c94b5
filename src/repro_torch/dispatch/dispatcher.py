"""Sparsity-adaptive dispatch for SpMM, SpMV and SDDMM: planning, the
plan log and the legacy entry points (the port of
``repro.dispatch.dispatcher``).

A plan names the execution path, chosen by a forced policy, the analytic
cost model (``auto``) or a timed autotune pass with a per-(shape, width,
dtype, sparsity-bucket) cache (``autotune``; the pure planners here cannot
time, so they plan ``autotune`` through the cost model and say so).
``use_kernel`` records whether the path runs the CUDA kernels, which is so
exactly when the operand lives on a CUDA device.  Every recorded plan
counts in ``obs.counter("dispatch_plans_total", op=, path=, policy=)``.

``dispatch_spmm`` / ``dispatch_sddmm`` are the legacy entry points over a
``LazyForms`` (a ``BlockELL``, a ``SparseMatrix`` or a dense matrix is
wrapped in one); their candidates are ell, csr and dense, and every run
is timed into ``obs.AUDIT`` (``_audit_run``).  They take the reference's
``use_kernel`` / ``interpret`` / ``bd`` (``bk``) / ``out_dtype`` keywords,
read as ``repro_torch.sparse.legacy`` says.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.formats import BlockCOO, BlockELL
from repro_torch.dispatch import autotune as autotune_mod
from repro_torch.dispatch._forms import LazyForms
from repro_torch.dispatch.autotune import AutotuneCache, make_key, measure
from repro_torch.dispatch.cost_model import DEFAULT_COST_MODEL, CostModel
from repro_torch.dispatch.policy import (DEFAULT_CONFIG, DispatchConfig,
                                         PATH_CSR, PATH_DENSE, PATH_ELL,
                                         PATH_FUSED_ATTN, PATHS,
                                         POLICY_AUTO, POLICY_AUTOTUNE,
                                         normalize_policy)
from repro_torch.dispatch.stats import MatrixStats


@dataclasses.dataclass(frozen=True)
class Plan:
    """One resolved dispatch decision (also the reporting record)."""

    op: str                      # "spmm" | "spmv" | "sddmm" | "fused_attn"
    path: str                    # ell | sell | csr | dense
    policy: str                  # policy that produced this plan
    reason: str                  # human-readable why
    use_kernel: bool             # the operand is on CUDA: kernels run
    costs: Optional[Dict[str, float]] = None       # analytic model output
    timings_us: Optional[Dict[str, float]] = None  # autotune output
    stats: Optional[MatrixStats] = None
    # the epilogue description of a fused SpMM ("relu+bias"), "attn" for
    # the fused attention pipeline; None = unfused
    fused: Optional[str] = None

    def describe(self) -> str:
        extra = ""
        if self.fused is not None:
            extra += f" fused={self.fused}"
        if self.stats is not None:
            extra += (f" density={self.stats.density:.2e}"
                      f" blowup={self.stats.padded_stream_blowup:.1f}")
        return f"{self.op}->{self.path} [{self.policy}: {self.reason}]{extra}"


# Bounded record of recent decisions, for engines and benchmarks to
# report; every access goes through the lock.
DEFAULT_LOG_CAPACITY = 256

_LOG_LOCK = threading.Lock()
_LOG: "collections.deque[Plan]" = collections.deque(
    maxlen=DEFAULT_LOG_CAPACITY)


def dispatch_log() -> Tuple[Plan, ...]:
    with _LOG_LOCK:
        return tuple(_LOG)


def last_plan(op: Optional[str] = None) -> Optional[Plan]:
    with _LOG_LOCK:
        for plan in reversed(_LOG):
            if op is None or plan.op == op:
                return plan
    return None


def clear_log() -> None:
    with _LOG_LOCK:
        _LOG.clear()


def log_capacity() -> int:
    return _LOG.maxlen or 0


def set_log_capacity(capacity: int) -> None:
    """Resize the plan ring (keeps the newest entries that still fit)."""
    global _LOG
    capacity = int(capacity)
    if capacity < 1:
        raise ValueError(f"log capacity must be >= 1, got {capacity}")
    with _LOG_LOCK:
        _LOG = collections.deque(_LOG, maxlen=capacity)


def record_plan(plan: Plan) -> Plan:
    """Append a plan to the dispatch log and count it."""
    with _LOG_LOCK:
        _LOG.append(plan)
    obs.counter("dispatch_plans_total", op=plan.op, path=plan.path,
                policy=plan.policy).inc()
    return plan


def on_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _audit_run(plan: Plan, run):
    """Run ``run()`` and record predicted-vs-measured in ``obs.AUDIT``:
    the wall time up to the card finishing the result (the output is
    waited for where it lies on a CUDA device)."""
    t0 = time.perf_counter()
    out = run()
    autotune_mod.wait_for(out.blocks if isinstance(out, BlockCOO) else out)
    obs.AUDIT.record(plan, (time.perf_counter() - t0) * 1e3)
    return out


def plan_spmm(
    stats: MatrixStats,
    d: int,
    *,
    policy: str = POLICY_AUTO,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    config: DispatchConfig = DEFAULT_CONFIG,
    device=None,
    candidates: Optional[Tuple[str, ...]] = None,
) -> Plan:
    """Pure planning from static stats.

    ``candidates`` restricts the choice to the paths the caller can
    execute (e.g. a Graph carries only some forms); ``device`` is where
    the operand lives.  ``config`` is the reference's argument; pure
    planning reads none of its fields.
    """
    return _plan("spmm", cost_model.spmm_costs(stats, d), stats,
                 policy=policy, device=device,
                 candidates=candidates)


def plan_spmv(
    stats: MatrixStats,
    *,
    policy: str = POLICY_AUTO,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    config: DispatchConfig = DEFAULT_CONFIG,
    device=None,
    candidates: Optional[Tuple[str, ...]] = None,
) -> Plan:
    """Plan y = A @ x for a vector operand: the SpMM cost surface at unit
    width, under its own op tag ``"spmv"``."""
    return _plan("spmv", cost_model.spmm_costs(stats, 1), stats,
                 policy=policy, device=device, candidates=candidates)


def plan_sddmm(
    stats: MatrixStats,
    k: int,
    *,
    policy: str = POLICY_AUTO,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    config: DispatchConfig = DEFAULT_CONFIG,
    device=None,
    candidates: Optional[Tuple[str, ...]] = None,
) -> Plan:
    """Plan Y = A ⊙ (B @ C) with inner width ``k``."""
    return _plan("sddmm", cost_model.sddmm_costs(stats, k), stats,
                 policy=policy, device=device, candidates=candidates)


def plan_fused_attention(
    stats: MatrixStats,
    k: int,
    d: int,
    *,
    policy: str = POLICY_AUTO,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    config: DispatchConfig = DEFAULT_CONFIG,
    device=None,
    candidates: Optional[Tuple[str, ...]] = None,
) -> Plan:
    """Plan the one-pass fused SDDMM -> softmax -> SpMM attention.

    ``k`` is the score width (the SDDMM's K), ``d`` the value width (the
    SpMM's D); the layout is chosen on the single-stream cost surface
    (``CostModel.fused_attn_costs``).
    """
    plan = _plan(PATH_FUSED_ATTN, cost_model.fused_attn_costs(stats, k, d),
                 stats, policy=policy, device=device, candidates=candidates)
    return dataclasses.replace(
        plan, fused="attn",
        reason=plan.reason if plan.policy in PATHS
        else f"one-stream fused pricing (k={k}, d={d}): {plan.reason}")


def _plan(op, costs, stats, *, policy, device,
          candidates=None) -> Plan:
    policy = normalize_policy(policy)
    if policy == POLICY_AUTOTUNE:
        # pure planning cannot time candidates; be honest about what ran
        policy = POLICY_AUTO
    if candidates:
        costs = {p: c for p, c in costs.items() if p in candidates}
    uk = on_cuda(device)
    if policy in PATHS:
        if candidates and policy not in candidates:
            raise ValueError(
                f"policy {policy!r} not among available paths {candidates}")
        return Plan(op=op, path=policy, policy=policy, reason="forced",
                    use_kernel=uk, costs=costs, stats=stats)
    path = CostModel.pick(costs)
    reason = (f"cost model: {path} cheapest of "
              + ", ".join(f"{p}={c:.3g}" for p, c in sorted(costs.items())))
    return Plan(op=op, path=path, policy=policy, reason=reason,
                use_kernel=uk, costs=costs, stats=stats)


def autotune_plan(op: str, stats: MatrixStats, width: int, dtype,
                  thunks: Dict[str, object], device,
                  config: DispatchConfig = DEFAULT_CONFIG,
                  cache: Optional[AutotuneCache] = None,
                  key_extra: Tuple = ()) -> Plan:
    """The ``autotune`` plan: ``thunks`` (path -> a call running it) timed
    once per key (``make_key`` of op, shape, width, dtype and sparsity
    bucket, plus ``key_extra`` stringified) and the winner cached in
    ``cache`` (``GLOBAL_CACHE`` by default).  A cached winner the caller
    cannot run (a cache shared by matrices of other forms) gives way to
    the fastest timed path it can."""
    cache = cache if cache is not None else autotune_mod.GLOBAL_CACHE
    key = make_key(op, stats.shape, width, dtype, stats.density,
                   buckets_per_decade=config.buckets_per_decade) \
        + tuple(str(x) for x in key_extra)
    hit = cache.get(key)
    if hit is None:
        with torch.no_grad():
            hit = measure(thunks, warmup=config.autotune_warmup,
                          iters=config.autotune_iters)
        cache.put(key, hit)
        reason = "autotune: measured " + ", ".join(
            f"{p}={t:.0f}us" for p, t in sorted(hit.timings_us.items()))
    else:
        reason = "autotune: cached winner"
    path = hit.path
    if path not in thunks:
        timed = {p: t for p, t in hit.timings_us.items() if p in thunks}
        path = min(timed, key=timed.get) if timed else next(iter(thunks))
    return Plan(op=op, path=path, policy=POLICY_AUTOTUNE, reason=reason,
                use_kernel=on_cuda(device), timings_us=hit.timings_us,
                stats=stats)


# ---------------------------------------------------------------------------
# SpMM dispatch (legacy entry point)
# ---------------------------------------------------------------------------

# the legacy entry points' paths: a LazyForms carries no sell packing
LEGACY_PATHS = (PATH_ELL, PATH_CSR, PATH_DENSE)



def _as_spmm_operand(a, device: torch.device) -> LazyForms:
    """``a`` as a ``LazyForms``; a dense one (numpy or a tensor) lives on
    ``device``."""
    from repro_torch.sparse.matrix import SparseMatrix

    if isinstance(a, SparseMatrix):
        if a.has_form("ell"):
            return LazyForms.from_blockell(a.form("ell"))
        return LazyForms.from_dense(a.to_dense(), device=a.device)
    if isinstance(a, LazyForms):
        return a
    if isinstance(a, BlockELL):
        return LazyForms.from_blockell(a)
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return LazyForms.from_dense(np.asarray(a), device=device)


def _run_spmm_path(path: str, op: LazyForms, h: torch.Tensor, *,
                   use_kernel: Optional[bool] = None, interpret: bool = False,
                   out_dtype=None):
    from repro_torch.kernels.spmm.ops import spmm_blockell
    from repro_torch.kernels.spmm.ref import spmm_blockell_ref
    from repro_torch.sparse import legacy, paths

    m, n = op.shape
    if h.shape[0] != n:
        raise ValueError(
            f"spmm: H has {h.shape[0]} rows but A has {n} columns (A shape "
            f"{op.shape})")
    if h.device != op.device:
        raise ValueError(f"spmm: H is on {h.device}, A on {op.device}")
    if path == PATH_ELL:
        ell = op.ell()
        hh = paths.pad_rows(h, ell.shape[1]).contiguous()
        plain = legacy.plain_requested(use_kernel, interpret, hh.device)
        blocks = ell.blocks.to(legacy.compute_dtype(
            torch.promote_types(ell.blocks.dtype, h.dtype), out_dtype))
        if plain:  # asked for by the caller, on any device
            y = spmm_blockell_ref(ell.indices, blocks, hh)
        else:
            y = spmm_blockell(dataclasses.replace(ell, blocks=blocks), hh)
        return legacy.in_out_dtype(y[:m], out_dtype)
    if path == PATH_CSR:
        row_ids, col_ids, values = op.csr_arrays()
        return legacy.in_out_dtype(
            paths.spmm_elements(row_ids, col_ids, values, h, m), out_dtype)
    if path == PATH_DENSE:
        return legacy.in_out_dtype(paths.spmm_dense(op.dense_tensor(), h),
                                   out_dtype)
    raise ValueError(f"unknown spmm path {path!r}")


def dispatch_spmm(
    a,
    h: torch.Tensor,
    *,
    policy: str = POLICY_AUTO,
    use_kernel: Optional[bool] = None,
    interpret: Optional[bool] = None,
    bd: Optional[int] = None,
    out_dtype=None,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    config: DispatchConfig = DEFAULT_CONFIG,
    cache: Optional[AutotuneCache] = None,
) -> torch.Tensor:
    """Y = A @ H through the sparsity-adaptive dispatch layer.

    ``a``: a ``LazyForms``, ``BlockELL``, ``SparseMatrix`` or dense matrix
    (numpy or a tensor; its forms are built on ``h``'s device).  A 1-D
    ``h`` gives a 1-D result.  The candidates are ell (K1 on the card),
    csr and dense: a ``LazyForms`` carries no sell packing.  Explicit
    ``use_kernel`` / ``interpret`` force the ell path (the legacy kwarg
    rule, ``repro_torch.sparse.legacy.coerce_kernel_kwargs``, which also
    says what they, ``bd`` and ``out_dtype`` mean).
    """
    from repro_torch.sparse.legacy import coerce_kernel_kwargs

    policy, use_kernel, interpret, _ = coerce_kernel_kwargs(
        policy, use_kernel, interpret)
    h_was_1d = h.ndim == 1
    if h_was_1d:
        h = h[:, None]
    operand = _as_spmm_operand(a, h.device)
    d = h.shape[1]

    def run(p):
        return _run_spmm_path(p, operand, h, use_kernel=use_kernel,
                              interpret=interpret, out_dtype=out_dtype)

    if policy in LEGACY_PATHS:
        # forced path: no stats needed (skips the host nonzero count)
        plan = record_plan(Plan(op="spmm", path=policy, policy=policy,
                                reason="forced",
                                use_kernel=on_cuda(operand.device)))
    else:
        stats = operand.stats()
        if policy == POLICY_AUTOTUNE:
            plan = autotune_plan(
                "spmm", stats, d, h.dtype,
                {p: (lambda p=p: run(p)) for p in LEGACY_PATHS},
                operand.device, config, cache)
        else:
            plan = plan_spmm(stats, d, policy=policy, cost_model=cost_model,
                             config=config, device=operand.device,
                             candidates=LEGACY_PATHS)
        record_plan(plan)
    y = _audit_run(plan, lambda: run(plan.path))
    return y[:, 0] if h_was_1d else y


# ---------------------------------------------------------------------------
# SDDMM dispatch (legacy entry point)
# ---------------------------------------------------------------------------


def _coo_element_coords(coo: BlockCOO):
    """Host-side element coordinates of a BlockCOO's nonzeros."""
    blocks = (coo.blocks != 0).cpu().numpy()  # numpy has no bf16
    rows = coo.rows.cpu().numpy()
    cols = coo.cols.cpu().numpy()
    e, i, j = np.nonzero(blocks)
    gr = rows[e] * coo.bm + i
    gc = cols[e] * coo.bn + j
    return e, i, j, gr.astype(np.int32), gc.astype(np.int32)


def _run_sddmm_path(path: str, coo: BlockCOO, b: torch.Tensor,
                    c: torch.Tensor, *, use_kernel: Optional[bool] = None,
                    interpret: bool = False, out_dtype=None) -> BlockCOO:
    from repro_torch.kernels.sddmm.ops import sddmm_blockcoo
    from repro_torch.kernels.sddmm.ref import sddmm_blockcoo_ref
    from repro_torch.sparse import legacy, paths

    natural = torch.promote_types(coo.blocks.dtype, b.dtype)
    if path == PATH_ELL:
        # the reference's kernel: A's value times the f32 dot, rounded once
        plain = legacy.plain_requested(use_kernel, interpret, b.device)
        mask = coo.blocks.to(legacy.compute_dtype(natural, out_dtype))
        if plain:  # asked for by the caller, on any device
            blocks = sddmm_blockcoo_ref(coo.rows, coo.cols, mask, b, c)
        else:
            blocks = sddmm_blockcoo(
                dataclasses.replace(coo, blocks=mask), b, c).blocks
        return BlockCOO(rows=coo.rows, cols=coo.cols,
                        blocks=legacy.in_out_dtype(blocks, out_dtype),
                        shape=coo.shape)
    out_dtype = out_dtype or natural
    if path == PATH_CSR:
        e, i, j, gr, gc = (torch.from_numpy(x).to(b.device)
                           for x in _coo_element_coords(coo))
        dots = paths.sddmm_element_dots(gr, gc, b, c)
        vals = coo.blocks[e, i, j].float() * dots.float()
        out = torch.zeros(coo.blocks.shape, dtype=torch.float32,
                          device=b.device)
        out[e, i, j] = vals
        return BlockCOO(rows=coo.rows, cols=coo.cols,
                        blocks=out.to(out_dtype), shape=coo.shape)
    if path == PATH_DENSE:
        full = b.float() @ c.float()  # [M, N]
        gathered = paths.sample_blocks(full, coo.rows, coo.cols, coo.bm,
                                       coo.bn)
        return BlockCOO(rows=coo.rows, cols=coo.cols,
                        blocks=(coo.blocks.float() * gathered).to(out_dtype),
                        shape=coo.shape)
    raise ValueError(f"unknown sddmm path {path!r}")


def dispatch_sddmm(
    a,
    b: torch.Tensor,
    c: torch.Tensor,
    *,
    policy: str = POLICY_AUTO,
    use_kernel: Optional[bool] = None,
    interpret: Optional[bool] = None,
    bk: Optional[int] = None,
    out_dtype=None,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    config: DispatchConfig = DEFAULT_CONFIG,
    cache: Optional[AutotuneCache] = None,
) -> BlockCOO:
    """Y = A ⊙ (B @ C) through the dispatch layer; returns a BlockCOO.

    ``a``: a BlockCOO (A's mask and values), a ``SparseMatrix`` or a dense
    matrix (numpy or a tensor), which is tiled in 64 x 64 blocks on
    ``b``'s device.  Paths as SpMM's: "ell" is the Block-COO path (K3 on
    the card, each cell A's value times the f32 dot rounded once, as the
    reference's kernel), "csr" the element path, "dense" the full product
    sampled.  The legacy keywords as ``dispatch_spmm``'s.
    """
    from repro_torch.sparse.legacy import coerce_kernel_kwargs
    from repro_torch.sparse.matrix import SparseMatrix

    policy, use_kernel, interpret, _ = coerce_kernel_kwargs(
        policy, use_kernel, interpret)
    if not isinstance(a, BlockCOO):
        if isinstance(a, SparseMatrix):
            a = a.form("coo") if a.has_form("coo") else BlockCOO.from_dense(
                a.to_dense(), 64, 64, device=a.device)
        else:
            if isinstance(a, torch.Tensor):
                a = a.cpu().numpy()
            a = BlockCOO.from_dense(np.asarray(a), 64, 64, device=b.device)
    # A's BlockCOO shape is block-padded; B and C are padded to match, so
    # every path sees aligned shapes (A's padded region is zero)
    mp, np_pad = a.shape
    if b.shape[0] > mp:
        raise ValueError(f"sddmm: B has {b.shape[0]} rows but A has {mp}")
    if c.shape[1] > np_pad:
        raise ValueError(
            f"sddmm: C has {c.shape[1]} columns but A has {np_pad}")
    if b.device != a.device or c.device != a.device:
        raise ValueError(f"sddmm: B on {b.device}, C on {c.device}, A on "
                         f"{a.device}")
    from repro_torch.sparse.paths import pad_cols, pad_rows

    b, c = pad_rows(b, mp), pad_cols(c, np_pad)
    k = b.shape[1]

    def run(p):
        return _run_sddmm_path(p, a, b, c, use_kernel=use_kernel,
                               interpret=interpret, out_dtype=out_dtype)

    if policy in LEGACY_PATHS:
        # forced path: no stats needed (skips the host nonzero count)
        plan = record_plan(Plan(op="sddmm", path=policy, policy=policy,
                                reason="forced",
                                use_kernel=on_cuda(a.device)))
    else:
        stats = MatrixStats.from_blockcoo(a)
        if policy == POLICY_AUTOTUNE:
            plan = autotune_plan(
                "sddmm", stats, k, b.dtype,
                {p: (lambda p=p: run(p).blocks) for p in LEGACY_PATHS},
                a.device, config, cache)
        else:
            plan = plan_sddmm(stats, k, policy=policy, cost_model=cost_model,
                              config=config, device=a.device,
                              candidates=LEGACY_PATHS)
        record_plan(plan)
    return _audit_run(plan, lambda: run(plan.path))

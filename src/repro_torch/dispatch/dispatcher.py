"""SpMM, SDDMM and fused-attention planning and the plan log (the port
of the planning half of ``repro.dispatch.dispatcher``).

A plan names the execution path, chosen by a forced policy or by the
analytic cost model.  ``use_kernel`` records whether the path runs the
CUDA kernels, which is so exactly when the operand lives on a CUDA device.
Every recorded plan counts in ``obs.counter("dispatch_plans_total", op=,
path=, policy=)``.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.dispatch.cost_model import DEFAULT_COST_MODEL, CostModel
from repro_torch.dispatch.policy import (PATH_FUSED_ATTN, PATHS,
                                         POLICY_AUTO, POLICY_AUTOTUNE,
                                         normalize_policy)
from repro_torch.dispatch.stats import MatrixStats


@dataclasses.dataclass(frozen=True)
class Plan:
    """One resolved dispatch decision (also the reporting record)."""

    op: str                      # "spmm" | "sddmm" | "fused_attn"
    path: str                    # ell | sell | csr | dense
    policy: str                  # policy that produced this plan
    reason: str                  # human-readable why
    use_kernel: bool             # the operand is on CUDA: kernels run
    costs: Optional[Dict[str, float]] = None       # analytic model output
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


def plan_spmm(
    stats: MatrixStats,
    d: int,
    *,
    policy: str = POLICY_AUTO,
    cost_model: CostModel = DEFAULT_COST_MODEL,
    device=None,
    candidates: Optional[Tuple[str, ...]] = None,
) -> Plan:
    """Pure planning from static stats.

    ``candidates`` restricts the choice to the paths the caller can
    execute (e.g. a Graph carries only some forms); ``device`` is where
    the operand lives.
    """
    return _plan("spmm", cost_model.spmm_costs(stats, d), stats,
                 policy=policy, device=device,
                 candidates=candidates)


def plan_sddmm(
    stats: MatrixStats,
    k: int,
    *,
    policy: str = POLICY_AUTO,
    cost_model: CostModel = DEFAULT_COST_MODEL,
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

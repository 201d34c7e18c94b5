"""The numbers that decide ``correct``, and the verdict against each
cell's limits (``limits/<cell>.json``).

- ``logit_gap`` (served requests): over a sample of the window's
  requests, the widest ``max|got - want| / max|want|`` of a request's
  logits against the reference's for the same features.
- Training, over the first three steps of the one trainer the window
  then drives: ``loss_gap``, the widest ``|L - L_ref| / |L_ref|`` of a
  step's loss; ``grad_gap``, the first gradient as the optimizer got it
  (``(p0 - p1) / lr``, from the state after one step, on both sides);
  ``change_gap``, the parameters' change after three steps.  Both by the
  worst leaf: ``|‖prog‖ - ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)``.
  Leaves whose reference gradient is under ``ZERO_GRAD_SHARE`` of the
  median leaf's are left out of the change: they move by round-off alone
  (the last layer's ``a_src`` under GAT's row softmax).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

ZERO_GRAD_SHARE = 1e-3


def logit_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape:
        return float("inf")
    got = got.to(want.device, torch.float32)
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    if gap != gap:  # NaN in the answer
        return float("inf")
    return gap / scale if scale > 0 else gap


def worst_leaf_gap(prog: Dict[str, torch.Tensor],
                   ref: Dict[str, torch.Tensor],
                   names: List[str]) -> Tuple[float, str]:
    """The worst leaf's gap of norms, and its name."""
    norms = {n: float(ref[n].norm()) for n in names}
    floor = statistics.median(norms.values())
    worst, worst_name = 0.0, ""
    for n in names:
        p = float(prog[n].to(ref[n].device).norm())
        if p != p:
            return float("inf"), n
        gap = abs(p - norms[n]) / max(norms[n], floor) \
            if max(norms[n], floor) > 0 else abs(p)
        if gap >= worst:
            worst, worst_name = gap, n
    return worst, worst_name


def train_readings(p0: Dict[str, torch.Tensor],
                   prog_first: Dict[str, torch.Tensor],
                   prog_last: Dict[str, torch.Tensor],
                   prog_losses: List[float],
                   ref_first: Dict[str, torch.Tensor],
                   ref_last: Dict[str, torch.Tensor],
                   ref_losses: List[float], lr: float) -> Dict[str, float]:
    names = sorted(p0)
    dev = next(iter(ref_first.values())).device

    def moved(a, b):  # b - a, leaf by leaf, on the reference's device
        return {n: b[n].to(dev) - a[n].to(dev) for n in names}

    g_prog = {n: v / -lr for n, v in moved(p0, prog_first).items()}
    g_ref = {n: v / -lr for n, v in moved(p0, ref_first).items()}
    g_norm = {n: float(g_ref[n].norm()) for n in names}
    floor = statistics.median(g_norm.values())
    kept = [n for n in names if g_norm[n] >= ZERO_GRAD_SHARE * floor]
    loss_gap = max(abs(a - b) / abs(b) if b else abs(a - b)
                   for a, b in zip(prog_losses, ref_losses))
    if any(v != v for v in prog_losses):
        loss_gap = float("inf")
    return {
        "loss_gap": loss_gap,
        "grad_gap": worst_leaf_gap(g_prog, g_ref, names)[0],
        "change_gap": worst_leaf_gap(moved(p0, prog_last),
                                     moved(p0, ref_last), kept)[0],
    }


def verdict(readings: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Every reading at or under its limit; a reading without a limit, or
    a limit without a reading, is not correct."""
    checks = {name: {"value": readings.get(name, float("inf")),
                     "limit": limits.get(name, 0.0)}
              for name in sorted(set(readings) | set(limits))}
    ok = all(name in limits and name in readings
             and c["value"] <= c["limit"] for name, c in checks.items())
    return ok, checks

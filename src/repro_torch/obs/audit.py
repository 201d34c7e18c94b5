"""Cost-model audit: predicted path costs vs measured wall time.

The dispatch layer picks execution paths from an analytic cost model
(``repro_torch.dispatch.cost_model``).  Mispredictions — an ELL
hub-row case, a miscalibrated constant, a backend where the model was
never measured — otherwise surface only when a bench run happens to
sweep the offending regime.  The audit keeps a bounded trail of every
dispatched plan's **predicted cost vector** alongside the **wall time
measured at execution**, keyed per (op, path, stats bucket), so the
``summary()`` exposes exactly the evidence a learned autotuner
trains on, and ``mispredictions()`` lists the
buckets where the model's ranking disagrees with the measurements.

Stats buckets are coarse on purpose (shape rounded to a power of two,
density rounded to a decade): rows aggregate across calls instead of
one row per exact shape.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Deque, Dict, List, Mapping, Optional, Tuple

import collections

from repro_torch.obs.registry import MetricsRegistry


def stats_bucket(stats: Any) -> str:
    """Coarse aggregation key for audit rows ("n4096/d1e-2")."""
    if stats is None:
        return "unknown"
    m, n = stats.shape
    side = max(int(m), int(n), 1)
    n_pow2 = 1 << max(side - 1, 1).bit_length()
    density = float(getattr(stats, "density", 0.0))
    if density <= 0.0:
        dens = "d0"
    else:
        dens = f"d1e{int(math.floor(math.log10(density) + 0.5))}"
    return f"n{n_pow2}/{dens}"


@dataclasses.dataclass(frozen=True)
class AuditRow:
    """One executed plan: what the model predicted, what the clock said."""

    op: str
    path: str
    bucket: str                  # stats_bucket(...) or a serving bucket label
    measured_ms: float
    predicted: Optional[float]   # model cost of the chosen path
    costs: Optional[Tuple[Tuple[str, float], ...]]  # full cost vector
    policy: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return {
            "op": self.op,
            "path": self.path,
            "bucket": self.bucket,
            "measured_ms": round(self.measured_ms, 4),
            "predicted": self.predicted,
            "costs": dict(self.costs) if self.costs is not None else None,
            "policy": self.policy,
        }


class CostAudit:
    """Bounded ring of :class:`AuditRow` with per-cell aggregation."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 capacity: int = 2048):
        self.registry = registry
        self._rows: Deque[AuditRow] = collections.deque(maxlen=capacity)
        self._lock = threading.RLock()

    # -- recording -----------------------------------------------------------

    def record(self, plan: Any, measured_ms: float,
               bucket: Optional[str] = None) -> None:
        """Record one executed dispatch ``Plan`` (predicted costs taken
        from ``plan.costs``; ``bucket`` defaults to the plan's stats
        bucket)."""
        costs = getattr(plan, "costs", None)
        self.record_raw(
            op=plan.op, path=plan.path, measured_ms=measured_ms,
            bucket=bucket if bucket is not None
            else stats_bucket(getattr(plan, "stats", None)),
            costs=costs, policy=getattr(plan, "policy", ""))

    def record_raw(self, *, op: str, path: str, measured_ms: float,
                   bucket: str, costs: Optional[Mapping[str, float]] = None,
                   policy: str = "") -> None:
        predicted = None
        frozen = None
        if costs:
            frozen = tuple(sorted((str(k), float(v))
                                  for k, v in costs.items()
                                  if math.isfinite(float(v))))
            predicted = dict(frozen).get(path)
        row = AuditRow(op=op, path=path, bucket=bucket,
                       measured_ms=float(measured_ms), predicted=predicted,
                       costs=frozen, policy=policy)
        with self._lock:
            self._rows.append(row)
        if self.registry is not None:
            self.registry.histogram("audit_measured_ms", op=op, path=path) \
                .observe(measured_ms)

    # -- reading -------------------------------------------------------------

    def rows(self) -> Tuple[AuditRow, ...]:
        with self._lock:
            return tuple(self._rows)

    def summary(self) -> Dict[str, Dict[str, Any]]:
        """Aggregate per "op/path/bucket": call count, measured wall-time
        mean, and mean predicted cost of the chosen path."""
        cells: Dict[Tuple[str, str, str], List[AuditRow]] = {}
        with self._lock:
            for r in self._rows:
                cells.setdefault((r.op, r.path, r.bucket), []).append(r)
        out: Dict[str, Dict[str, Any]] = {}
        for (op, path, bucket), rows in sorted(cells.items()):
            ms = [r.measured_ms for r in rows]
            preds = [r.predicted for r in rows if r.predicted is not None]
            out[f"{op}/{path}/{bucket}"] = {
                "n": len(rows),
                "measured_ms_mean": round(sum(ms) / len(ms), 4),
                "measured_ms_max": round(max(ms), 4),
                "predicted_mean": (round(sum(preds) / len(preds), 4)
                                   if preds else None),
            }
        return out

    def mispredictions(self) -> List[Dict[str, Any]]:
        """Cells where the model's cheapest path is measurably not the
        fastest executed path of the same (op, bucket).

        Only (op, bucket) cells where at least two distinct paths ran
        can be judged — with one path there is nothing to rank against.
        """
        by_cell: Dict[Tuple[str, str], Dict[str, List[AuditRow]]] = {}
        with self._lock:
            for r in self._rows:
                by_cell.setdefault((r.op, r.bucket), {}) \
                    .setdefault(r.path, []).append(r)
        out = []
        for (op, bucket), paths in sorted(by_cell.items()):
            if len(paths) < 2:
                continue
            measured = {p: sum(r.measured_ms for r in rs) / len(rs)
                        for p, rs in paths.items()}
            predicted = {p: sum(r.predicted for r in rs) / len(rs)
                         for p, rs in paths.items()
                         if all(r.predicted is not None for r in rs)}
            pred_ranked = {p: c for p, c in predicted.items()
                           if p in measured}
            if len(pred_ranked) < 2:
                continue
            pred_best = min(pred_ranked, key=pred_ranked.get)
            meas_best = min(measured, key=measured.get)
            if pred_best != meas_best:
                out.append({
                    "op": op, "bucket": bucket,
                    "predicted_best": pred_best,
                    "measured_best": meas_best,
                    "measured_ms": {p: round(v, 4)
                                    for p, v in sorted(measured.items())},
                    "predicted": {p: round(v, 4)
                                  for p, v in sorted(pred_ranked.items())},
                })
        return out

    def report(self) -> Dict[str, Any]:
        return {
            "rows": [r.as_dict() for r in self.rows()],
            "summary": self.summary(),
            "mispredictions": self.mispredictions(),
        }

    def clear(self) -> None:
        with self._lock:
            self._rows.clear()

"""Thread-safe metrics registry: counters, gauges, histograms.

One process-wide :class:`MetricsRegistry` (``repro_torch.obs.REGISTRY``) is the
single sink every layer reports into — the dispatcher counts plans, the
bucketed executor counts compiles/calls/evictions, the serving engines
observe latencies, the ladder counts refits, the padding ledger streams
its volume counters.  The scattered per-object ``report()`` methods stay
as *views*; the registry is the substrate a multi-worker tier scrapes.

Metrics are keyed by ``(name, labels)`` where labels are a small
``str -> str`` mapping (``op="spmm", path="ell"``).  Keep label
cardinality bounded: one series exists per distinct label set.

Exporters:

* :meth:`MetricsRegistry.snapshot` — nested plain-dict view (stable
  schema, pinned in ``tests/test_obs.py``).
* :meth:`MetricsRegistry.to_prometheus` — Prometheus text exposition
  (histograms as summaries with p50/p90/p99 quantiles).
* :meth:`MetricsRegistry.to_jsonl` — one JSON object per series per
  line, for log shipping.
"""
from __future__ import annotations

import collections
import json
import threading
from typing import Any, Deque, Dict, List, Mapping, Optional, Tuple

import numpy as np

LabelKey = Tuple[Tuple[str, str], ...]   # sorted (k, v) pairs


def _label_key(labels: Mapping[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    """Stable flat form used as the snapshot dict key ("" = unlabeled)."""
    return ",".join(f"{k}={v}" for k, v in key)


class Counter:
    """Monotonic counter (increments only)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increments must be >= 0, got {n}")
        with self._lock:
            self.value += n


class Gauge:
    """Point-in-time value (set / add)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self.value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += float(n)

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)


class Histogram:
    """Streaming distribution: exact count/sum/min/max plus a bounded
    reservoir of the most recent observations for quantiles.

    The reservoir is a ring (default 2048): quantiles reflect *recent*
    behavior, which is what serving dashboards want, while count/sum
    stay exact over the process lifetime.
    """

    __slots__ = ("_lock", "count", "sum", "min", "max", "_recent")

    def __init__(self, lock: threading.RLock, reservoir: int = 2048):
        self._lock = lock
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._recent: Deque[float] = collections.deque(maxlen=reservoir)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self._recent.append(v)

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._recent:
                return 0.0
            return float(np.percentile(np.asarray(self._recent), q))

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                        "mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
            arr = np.asarray(self._recent)
            p50, p90, p99 = np.percentile(arr, (50, 90, 99))
            return {
                "count": self.count,
                "sum": round(self.sum, 6),
                "min": round(self.min, 6),
                "max": round(self.max, 6),
                "mean": round(self.sum / self.count, 6),
                "p50": round(float(p50), 6),
                "p90": round(float(p90), 6),
                "p99": round(float(p99), 6),
            }


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create registry of labeled metric series (thread-safe)."""

    def __init__(self, reservoir: int = 2048):
        self._lock = threading.RLock()
        self._reservoir = int(reservoir)
        # name -> kind; (name, label_key) -> metric object
        self._kinds: Dict[str, str] = {}
        self._series: Dict[Tuple[str, LabelKey], Any] = {}

    # -- get-or-create -------------------------------------------------------

    def _get(self, kind: str, name: str, labels: Mapping[str, Any]):
        key = (name, _label_key(labels))
        with self._lock:
            existing = self._kinds.get(name)
            if existing is None:
                self._kinds[name] = kind
            elif existing != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {existing}, "
                    f"requested as {kind}")
            metric = self._series.get(key)
            if metric is None:
                if kind == "histogram":
                    metric = Histogram(self._lock, self._reservoir)
                else:
                    metric = _KINDS[kind](self._lock)
                self._series[key] = metric
            return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    # -- reading -------------------------------------------------------------

    def value(self, name: str, **labels) -> Optional[float]:
        """Current value of one series (None when it does not exist)."""
        key = (name, _label_key(labels))
        with self._lock:
            metric = self._series.get(key)
            if metric is None:
                return None
            if isinstance(metric, Histogram):
                return float(metric.count)
            return metric.value

    def total(self, name: str) -> float:
        """Sum of a counter/gauge over every label set (0 when absent)."""
        with self._lock:
            return sum(m.value for (n, _), m in self._series.items()
                       if n == name and not isinstance(m, Histogram))

    def snapshot(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """Stable nested view: kind -> name -> label_str -> value/summary."""
        out: Dict[str, Dict[str, Dict[str, Any]]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            for (name, lkey), metric in sorted(self._series.items()):
                kind = self._kinds[name]
                ls = _label_str(lkey)
                if kind == "counter":
                    out["counters"].setdefault(name, {})[ls] = metric.value
                elif kind == "gauge":
                    out["gauges"].setdefault(name, {})[ls] = metric.value
                else:
                    out["histograms"].setdefault(name, {})[ls] = \
                        metric.summary()
        return out

    # -- exporters -----------------------------------------------------------

    @staticmethod
    def _prom_name(name: str) -> str:
        return "".join(c if (c.isalnum() or c == "_") else "_"
                       for c in name)

    @staticmethod
    def _prom_labels(lkey: LabelKey, extra: str = "") -> str:
        parts = [f'{MetricsRegistry._prom_name(k)}="{v}"' for k, v in lkey]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (histograms as summaries)."""
        lines: List[str] = []
        with self._lock:
            by_name: Dict[str, List[Tuple[LabelKey, Any]]] = {}
            for (name, lkey), metric in sorted(self._series.items()):
                by_name.setdefault(name, []).append((lkey, metric))
            for name, series in by_name.items():
                kind = self._kinds[name]
                pn = self._prom_name(name)
                lines.append(f"# TYPE {pn} "
                             f"{'summary' if kind == 'histogram' else kind}")
                for lkey, metric in series:
                    if kind == "histogram":
                        s = metric.summary()
                        for q, k in ((0.5, "p50"), (0.9, "p90"),
                                     (0.99, "p99")):
                            lab = self._prom_labels(
                                lkey, f'quantile="{q}"')
                            lines.append(f"{pn}{lab} {s[k]}")
                        lab = self._prom_labels(lkey)
                        lines.append(f"{pn}_sum{lab} {s['sum']}")
                        lines.append(f"{pn}_count{lab} {s['count']}")
                    else:
                        lab = self._prom_labels(lkey)
                        lines.append(f"{pn}{lab} {metric.value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_jsonl(self) -> str:
        """One JSON object per series per line (log-shipping format)."""
        lines: List[str] = []
        with self._lock:
            for (name, lkey), metric in sorted(self._series.items()):
                kind = self._kinds[name]
                rec: Dict[str, Any] = {
                    "name": name, "type": kind, "labels": dict(lkey)}
                if kind == "histogram":
                    rec.update(metric.summary())
                else:
                    rec["value"] = metric.value
                lines.append(json.dumps(rec, sort_keys=True))
        return "\n".join(lines) + ("\n" if lines else "")

    # -- lifecycle -----------------------------------------------------------

    def reset(self) -> None:
        """Drop every series (tests / per-run scoping)."""
        with self._lock:
            self._kinds.clear()
            self._series.clear()

"""repro_torch.obs — unified observability: metrics, traces, sentry,
audit (the port of ``repro.obs``: the same instruments and the same
``snapshot()`` schema).

One import gives every layer the same four instruments:

* ``obs.counter/gauge/histogram(name, **labels)`` — series in the
  process-wide :data:`REGISTRY` (``snapshot()``, ``to_prometheus()``,
  ``to_jsonl()``).
* ``obs.span(name, **tags)`` — timed spans with parent propagation
  through the serve, model, dispatch and train paths (:data:`TRACER`).
  The ring that keeps them, and ``span_ms``, is off until
  ``obs.TRACER.enable()``; off, a span costs one shared no-op context,
  and under ``torch.profiler`` each span is a host event of its trace
  (``repro_torch.obs.tracing``).
* :data:`SENTRY` — compiles-vs-calls per executor lane; any compile
  past a lane's warmup is an ``unexpected_retrace`` event (in the
  port a compile is a lane's first call at a new input signature,
  ``instrumented_jit``).
* :data:`AUDIT` — predicted-vs-measured cost trail per
  (op, path, stats-bucket).

``obs.snapshot()`` is the one-call export: metrics + span summary +
sentry lanes/events + audit rows.  ``obs.reset()`` clears everything
(tests, per-run scoping).

The singletons are module-level so the dispatcher, the bucketed
executor, the serving engines, and the train loop all write into one
sink without plumbing a handle through every constructor; code that
needs isolation (a multi-worker tier with one registry per worker)
instantiates the classes directly.
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.obs.audit import AuditRow, CostAudit, stats_bucket
from repro_torch.obs.compat import ReportDict, renamed_keys
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry)
from repro_torch.obs.sentry import (RetraceEvent, RetraceSentry,
                                    instrumented_jit)
from repro_torch.obs.tracing import SpanRecord, Tracer

REGISTRY = MetricsRegistry()
TRACER = Tracer(registry=REGISTRY)
SENTRY = RetraceSentry(registry=REGISTRY)
AUDIT = CostAudit(registry=REGISTRY)

# bound convenience entry points (the common call sites)
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
span = TRACER.span


def snapshot() -> Dict[str, Any]:
    """One coherent view of everything the process observed.

    Stable schema (the reference's, ``tests/test_torch_obs.py``)::

        {"metrics":  {"counters": ..., "gauges": ..., "histograms": ...},
         "spans":    {name: {"count", "total_ms", "p50_ms", "max_ms"}},
         "sentry":   {"lanes", "compiles", "calls",
                      "unexpected_retraces", "events"},
         "audit":    {"rows", "summary", "mispredictions"}}
    """
    return {
        "metrics": REGISTRY.snapshot(),
        "spans": TRACER.summary(),
        "sentry": SENTRY.report(),
        "audit": AUDIT.report(),
    }


def to_prometheus() -> str:
    """Prometheus text exposition of the metrics registry."""
    return REGISTRY.to_prometheus()


def to_jsonl() -> str:
    """JSON-lines export: metric series followed by span records."""
    return REGISTRY.to_jsonl() + TRACER.to_jsonl()


def reset() -> None:
    """Clear every instrument (tests / per-run scoping)."""
    REGISTRY.reset()
    TRACER.clear()
    SENTRY.clear()
    AUDIT.clear()


__all__ = [
    "AUDIT", "AuditRow", "CostAudit", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "REGISTRY", "ReportDict", "RetraceEvent",
    "RetraceSentry", "SENTRY", "SpanRecord", "TRACER", "Tracer",
    "counter", "gauge", "histogram", "instrumented_jit", "renamed_keys",
    "reset", "snapshot", "span", "stats_bucket", "to_jsonl",
    "to_prometheus",
]

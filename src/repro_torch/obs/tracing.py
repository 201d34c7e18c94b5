"""Span-based tracing for the serve and train paths.

``span("serve.compose", bucket=...)`` opens a timed span; nesting
propagates parentage through a thread-local stack, so one admitted
request's trace reads ``serve.flush`` → ``serve.compose`` →
``serve.execute`` → ``serve.complete`` with parent/child links intact.
Completed spans land in a bounded ring on the :class:`Tracer` and their
durations feed the ``span_ms{name=...}`` histogram of the attached
:class:`~repro_torch.obs.registry.MetricsRegistry`, so the latency breakdown
is visible both as individual traces and as aggregate percentiles.

The canonical serve-path span taxonomy (the reference's DESIGN.md,
"Observability"):

  serve.admit     — request admission (queue / lane seating)
  serve.bucket    — bucket / ladder decision for one request group
  serve.flush     — one micro-batch flush (batch engine)
  serve.lane_step — one continuous-engine lane execution
  serve.compose   — block-diagonal composition + feature concat
  serve.execute   — the executor call (a lane's first call at a new
                    input signature is its compile — the sentry
                    separates it)
  serve.complete  — unbatch, trim, future resolution
  train.step      — one optimizer step of ``train_loop``
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import threading
import time
from typing import Any, Deque, Dict, Iterator, Mapping, Optional, Tuple

import collections

from repro_torch.obs.registry import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed span (immutable; rings and exporters share it)."""

    name: str
    tags: Tuple[Tuple[str, str], ...]
    trace_id: int                 # id of the root span of this tree
    span_id: int
    parent_id: Optional[int]      # None for a root span
    t_wall: float                 # wall-clock start (time.time)
    dur_ms: float

    def as_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "tags": dict(self.tags),
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "t_wall": self.t_wall,
            "dur_ms": round(self.dur_ms, 4),
        }


class _ActiveSpan:
    __slots__ = ("name", "tags", "trace_id", "span_id", "parent_id",
                 "t_wall", "t0")

    def __init__(self, name, tags, trace_id, span_id, parent_id):
        self.name = name
        self.tags = tags
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.t_wall = time.time()
        self.t0 = time.perf_counter()


class Tracer:
    """Bounded ring of completed spans + thread-local parent stacks."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 capacity: int = 4096):
        self.registry = registry
        self._ring: Deque[SpanRecord] = collections.deque(maxlen=capacity)
        self._lock = threading.RLock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **tags) -> Iterator[_ActiveSpan]:
        """Open a timed span; nested calls chain parent ids per thread."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        span_id = next(self._ids)
        sp = _ActiveSpan(
            name=name,
            tags=tuple(sorted((str(k), str(v)) for k, v in tags.items())),
            trace_id=parent.trace_id if parent else span_id,
            span_id=span_id,
            parent_id=parent.span_id if parent else None)
        stack.append(sp)
        try:
            yield sp
        finally:
            stack.pop()
            dur_ms = (time.perf_counter() - sp.t0) * 1e3
            rec = SpanRecord(name=sp.name, tags=sp.tags,
                             trace_id=sp.trace_id, span_id=sp.span_id,
                             parent_id=sp.parent_id, t_wall=sp.t_wall,
                             dur_ms=dur_ms)
            with self._lock:
                self._ring.append(rec)
            if self.registry is not None:
                # label key is "span", not "name": the registry's
                # positional ``name`` parameter reserves that spelling
                self.registry.histogram("span_ms", span=name) \
                    .observe(dur_ms)

    def current(self) -> Optional[_ActiveSpan]:
        stack = self._stack()
        return stack[-1] if stack else None

    # -- reading -------------------------------------------------------------

    def spans(self, name: Optional[str] = None) -> Tuple[SpanRecord, ...]:
        with self._lock:
            return tuple(s for s in self._ring
                         if name is None or s.name == name)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name count and duration stats over the ring."""
        agg: Dict[str, list] = {}
        with self._lock:
            for s in self._ring:
                agg.setdefault(s.name, []).append(s.dur_ms)
        out = {}
        for name in sorted(agg):
            ds = sorted(agg[name])
            n = len(ds)
            out[name] = {
                "count": n,
                "total_ms": round(sum(ds), 4),
                "p50_ms": round(ds[n // 2], 4),
                "max_ms": round(ds[-1], 4),
            }
        return out

    def to_jsonl(self) -> str:
        with self._lock:
            recs = list(self._ring)
        return "\n".join(json.dumps(r.as_dict(), sort_keys=True)
                         for r in recs) + ("\n" if recs else "")

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

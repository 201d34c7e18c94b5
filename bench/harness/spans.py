"""The port's own spans in a traced window.

While ``torch.profiler`` records, each ``repro_torch.obs.span`` is a host
operation (``cpu_op``) of the span's name, on the profiler's clock: it
reaches ``Trace.host_ops`` with the other host operations.  The trace
keeps no thread, so the port's spans of every thread (the caller's and
autograd's) lie in one list.  The span names are the port's taxonomy
(``src/repro_torch/obs/tracing.py``); no PyTorch operation's name starts
with one of its families.
"""
from __future__ import annotations

import bisect
from typing import List, Tuple

from bench.harness.trace import Event, Trace

FAMILIES = ("serve.", "gnn.", "sparse.", "train.")
Interval = Tuple[float, float]


def named(trace: Trace, name: str) -> List[Event]:
    return [e for e in trace.host_ops if e.name == name]


def port_spans(trace: Trace) -> List[Event]:
    """Every span of the port in the window, of any name."""
    return [e for e in trace.host_ops if e.name.startswith(FAMILIES)]


def union(events: List[Event]) -> List[Interval]:
    """The events' intervals merged, in order (as ``Trace.busy`` merges
    the device's): a span nested in another, or overlapping one of
    another thread, counts once."""
    return Trace(0.0, events, [], []).busy()


def overlap_s(intervals: List[Interval], starts: List[float], a: float,
              b: float) -> float:
    """Seconds of ``[a, b]`` that the merged ``intervals`` (``starts``:
    their starts) cover.  Only the intervals that can meet ``[a, b]`` are
    visited, so a window of many spans reads in ``O(n log n)``."""
    total = 0.0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(intervals) and intervals[i][0] < b:
        lo, hi = intervals[i]
        total += max(0.0, min(b, hi) - max(a, lo))
        i += 1
    return total


def open_at(intervals: List[Interval], starts: List[float],
            t: float) -> bool:
    """Whether one of the merged ``intervals`` (``starts``: their starts)
    is open at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and intervals[i][1] >= t

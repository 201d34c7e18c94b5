"""The traced window: ``torch.profiler`` over the window, its Chrome trace
reduced to device operations, the benchmark's own host spans and the host
operations, on one clock, in seconds from the window's start.

The benchmark's spans are ``record_function`` ranges named ``bench.*``
that the drivers open around their calls into the program (``bench.infer``,
``bench.train_step``, ``bench.sync``, ``bench.request``) and around the
whole window (``bench.window``).

The port's own kernels (``src/repro_torch/csrc/``) all live in an anonymous
namespace at the top level, which no library kernel's name starts with:
``is_port_kernel`` tells them apart by that.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "bench.window"
SPAN_PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
BREAKDOWN_ROWS = 10
NAME_CHARS = 160
PORT_KERNEL = re.compile(r"^(void )?\(anonymous namespace\)::")


def is_port_kernel(name: str) -> bool:
    return PORT_KERNEL.match(name) is not None


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    start: float  # s from the window's start
    dur: float    # s

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclasses.dataclass
class Trace:
    """What one traced window recorded."""

    window_s: float
    device: List[Event]
    spans: List[Event]
    host_ops: List[Event]

    def device_s(self, keep: Callable[[str], bool] = lambda name: True
                 ) -> float:
        """Device seconds of the operations whose name ``keep`` accepts."""
        return sum(e.dur for e in self.device if keep(e.name))

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, merged."""
        merged: List[List[float]] = []
        for e in sorted(self.device, key=lambda e: e.start):
            if merged and e.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e.end)
            else:
                merged.append([e.start, e.end])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """(start, length) of each stretch of the window in which no
        device operation ran."""
        gaps, t = [], 0.0
        for a, b in self.busy():
            if a > t:
                gaps.append((t, a - t))
            t = max(t, b)
        if self.window_s > t:
            gaps.append((t, self.window_s - t))
        return gaps

    def spans_named(self, name: str) -> List[Event]:
        return [s for s in self.spans if s.name == name]


def _innermost(events: List[Event], starts: List[float], t: float,
               reach: int = 256) -> Optional[Event]:
    """The latest-starting event that is open at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - reach, -1), -1):
        if events[j].end >= t:
            return events[j]
    return None


def idle_by_host(trace: Trace) -> List[Tuple[str, float]]:
    """Idle seconds by what the host was doing as each gap began: the
    innermost ``bench.*`` span open then, and the innermost host
    operation, longest first."""
    spans = sorted((s for s in trace.spans if s.name != WINDOW_SPAN),
                   key=lambda e: e.start)
    ops = sorted(trace.host_ops, key=lambda e: e.start)
    span_starts = [s.start for s in spans]
    op_starts = [o.start for o in ops]
    total: Dict[str, float] = defaultdict(float)
    for t, length in trace.idle_gaps():
        span = _innermost(spans, span_starts, t)
        op = _innermost(ops, op_starts, t)
        name = span.name if span else "outside the spans"
        if op is not None:
            name += " > " + op.name[:NAME_CHARS]
        total[name] += length
    return sorted(total.items(), key=lambda kv: -kv[1])


def device_ops(trace: Trace) -> List[Tuple[str, float]]:
    """Device seconds by operation name, longest first."""
    total: Dict[str, float] = defaultdict(float)
    for e in trace.device:
        total[e.name[:NAME_CHARS]] += e.dur
    return sorted(total.items(), key=lambda kv: -kv[1])


def breakdown(trace: Trace) -> Dict[str, List[list]]:
    return {"device_ops": [[n, s] for n, s in
                           device_ops(trace)[:BREAKDOWN_ROWS]],
            "idle_gaps": [[n, s] for n, s in
                          idle_by_host(trace)[:BREAKDOWN_ROWS]]}


def from_chrome(data: dict) -> Trace:
    """Reduce a Chrome trace (``export_chrome_trace``'s JSON; times in
    µs) to the window's events.  The window is the ``bench.window`` span;
    device and host events are clipped to it."""
    events = [e for e in data.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW_SPAN]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW_SPAN!r} span")
    w = windows[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])

    def clipped(e) -> Optional[Event]:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b < a:
            return None
        return Event(e["name"], (a - w0) * 1e-6, (b - a) * 1e-6)

    device, spans, host = [], [], []
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            out = device
        elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            out = spans
        elif cat in HOST_CATS:
            out = host
        else:
            continue
        ev = clipped(e)
        if ev is not None:
            out.append(ev)
    return Trace(window_s=(w1 - w0) * 1e-6, device=device, spans=spans,
                 host_ops=host)


class Tracer:
    """Spans around the benchmark's calls; with ``enabled``, the profiler
    over the window.  Off, a span costs one no-op context."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def __enter__(self):
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def reduce(self) -> Trace:
        """The recorded window, read back through a Chrome trace written
        to (and removed from) the run's temporary directory."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        self.prof = None
        return from_chrome(data)

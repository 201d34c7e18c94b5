"""Retrace sentry: compiles-vs-calls accounting per executor lane (the
port of ``repro.obs.sentry``).

The serving stack's central compilation invariant — O(#buckets)
compiles, zero retraces at steady state — is otherwise enforced only by
hand-pinned trace-count tests.  The sentry turns the invariant into an
always-on runtime check: every executor lane (a ``(bucket, batch, d,
form)`` cell, or any label a caller picks) records its compiles and
calls, and **any compile after the lane's warmup budget is flagged as an
``unexpected_retrace`` event** — visible in ``obs.snapshot()`` the moment
a shape/static-aux leak sneaks back in, instead of waiting for a bench
run or a test that happens to pin it.

PyTorch runs eagerly and traces nothing, so in the port a "compile" is
what ``jax.jit`` would retrace on: a lane's first call at a new input
signature (``instrumented_jit``).

Eviction is the one legitimate reason a lane recompiles: the owner of
the compile cache calls :meth:`RetraceSentry.forget` when it drops an
executor, resetting that lane's warmup budget.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import (Any, Callable, Deque, Dict, Hashable, Optional, Set,
                    Tuple)

import collections

import torch

from repro_torch.obs.registry import MetricsRegistry


@dataclasses.dataclass(frozen=True)
class RetraceEvent:
    """One compile observed past a lane's warmup budget."""

    lane: str
    compiles: int      # lane compile count including this one
    calls: int         # lane calls when the retrace happened
    note: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return {"lane": self.lane, "compiles": self.compiles,
                "calls": self.calls, "note": self.note}


class _LaneState:
    __slots__ = ("compiles", "calls", "budget")

    def __init__(self, budget: int):
        self.compiles = 0
        self.calls = 0
        self.budget = budget


class RetraceSentry:
    """Per-lane compile/call counters with an unexpected-retrace alarm.

    ``warmup`` is the per-lane compile budget (default 1: the first
    trace of a lane is expected, everything after is an event).
    Thread-safe — compiles are recorded on whatever thread called the
    executor.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 warmup: int = 1, capacity: int = 256):
        self.registry = registry
        self.warmup = int(warmup)
        self._lanes: Dict[str, _LaneState] = {}
        self._events: Deque[RetraceEvent] = collections.deque(
            maxlen=capacity)
        self._lock = threading.RLock()

    def _lane(self, lane: str) -> _LaneState:
        st = self._lanes.get(lane)
        if st is None:
            st = self._lanes[lane] = _LaneState(self.warmup)
        return st

    # -- recording -----------------------------------------------------------

    def record_compile(self, lane: str, note: str = "") -> bool:
        """Count one trace of ``lane``; returns True when it was
        unexpected (past the lane's warmup budget)."""
        with self._lock:
            st = self._lane(lane)
            st.compiles += 1
            unexpected = st.compiles > st.budget
            if unexpected:
                self._events.append(RetraceEvent(
                    lane=lane, compiles=st.compiles, calls=st.calls,
                    note=note))
            if self.registry is not None:
                self.registry.counter("executor_compiles_total",
                                      lane=lane).inc()
                if unexpected:
                    self.registry.counter("unexpected_retrace_total",
                                          lane=lane).inc()
            return unexpected

    def record_call(self, lane: str) -> None:
        with self._lock:
            self._lane(lane).calls += 1
            if self.registry is not None:
                self.registry.counter("executor_calls_total",
                                      lane=lane).inc()

    def forget(self, lane: str) -> None:
        """The lane's executor was evicted: its next compile is a warm-up
        again, not a retrace (the budget grows by one warmup)."""
        with self._lock:
            st = self._lanes.get(lane)
            if st is not None:
                st.budget = st.compiles + self.warmup

    # -- reading -------------------------------------------------------------

    def lanes(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {lane: {"compiles": st.compiles, "calls": st.calls,
                           "budget": st.budget}
                    for lane, st in sorted(self._lanes.items())}

    def events(self) -> Tuple[RetraceEvent, ...]:
        with self._lock:
            return tuple(self._events)

    def unexpected(self, lane: Optional[str] = None) -> int:
        """Number of unexpected-retrace events (optionally one lane's)."""
        with self._lock:
            return sum(1 for e in self._events
                       if lane is None or e.lane == lane)

    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "lanes": self.lanes(),
                "compiles": sum(s.compiles for s in self._lanes.values()),
                "calls": sum(s.calls for s in self._lanes.values()),
                "unexpected_retraces": len(self._events),
                "events": [e.as_dict() for e in self._events],
            }

    def clear(self) -> None:
        with self._lock:
            self._lanes.clear()
            self._events.clear()


def _signature(x: Any) -> Hashable:
    """What ``jax.jit`` retraces on, for one argument: a tensor's shape,
    dtype and device; a sequence's or mapping's elements in turn; a
    storage form (a dataclass) field by field; a ``SparseMatrix`` as its
    shape, stats and forms (the reference's pytree aux and leaves); any
    other argument by value (it must be hashable)."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_signature(v) for v in x)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _signature(v))
                                 for k, v in sorted(x.items()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _signature(getattr(x, f.name)) for f in dataclasses.fields(x))
    forms = getattr(x, "_forms", None)
    if isinstance(forms, dict):  # a SparseMatrix
        return (type(x).__name__, x.shape, x.stats) + tuple(
            (name, _signature(form)) for name, form in forms.items())
    return (type(x).__name__, x)


def instrumented_jit(fn: Callable, lane: str, *,
                     sentry: Optional[RetraceSentry] = None) -> Callable:
    """``fn`` with the sentry watching its calls and "compiles".

    The counterpart of the reference's ``jax.jit`` wrapper (for consumers
    outside the bucketed-executor stack, e.g. a ``DeltaGraph`` SpMM
    consumer): every call records a lane call, and the first call at an
    input signature ``jax.jit`` would trace anew records a lane compile
    (the shapes, dtypes and devices of the tensor arguments, the other
    arguments by value) — so a shape leak that would start retracing the
    consumer shows up as ``unexpected_retrace`` events without a
    hand-pinned test.  ``fn`` runs eagerly, as everything in PyTorch.
    """
    from repro_torch import obs as _obs

    s = sentry if sentry is not None else _obs.SENTRY
    seen: Set[Hashable] = set()
    lock = threading.Lock()

    def call(*args, **kwargs):
        s.record_call(lane)
        sig = _signature((args, kwargs))
        with lock:
            new = sig not in seen
            seen.add(sig)
        if new:
            s.record_compile(lane)
        return fn(*args, **kwargs)

    call.__wrapped__ = fn
    return call

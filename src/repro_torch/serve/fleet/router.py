"""Request routing and the journal that makes failover at-most-once
(the port of ``repro.serve.fleet.router``: the same picks, journal states,
orphans and hedges for the same event sequence).

Every request the fleet accepts gets a :class:`JournalEntry` keyed by a
monotonically increasing request id.  The journal is the single source
of truth for a request's life: which worker holds it, whether a hedge
duplicate is out, and — critically — whether its future has already
resolved.  All completion paths funnel through :meth:`Router.complete`,
which flips ``done`` under the fleet lock exactly once; any later
completion for the same rid (a result that was already in the pipe when
its worker was killed, a hedge loser racing its cancel, a failover
re-execution racing a zombie) is counted in
``fleet_duplicate_results_total`` and dropped.  Futures therefore
resolve at most once no matter how many workers end up running the
request.

Placement is deliberately boring: a lane (pow2-rows, feature-dim) is
assigned to a worker round-robin on first sight and stays **sticky**
so repeat traffic hits the worker that already compiled that bucket
(warm-executor locality).  Stickiness yields only when the owner dies
(failover reassigns) or when the owner's in-flight load exceeds
``rebalance_factor`` times the fleet mean (counted in
``fleet_rebalances_total``).  Load-based placement would be faster for
adversarial mixes but timing-dependent — round-robin keeps a seeded
storm byte-reproducible, which the acceptance tests rely on.

When no live worker exists (all dead or restarting) dispatch parks the
rid on the ``unrouted`` queue instead of failing it; the supervisor
re-drives the queue the moment a worker comes up.  Requests only fail
with :class:`~repro_torch.resilience.errors.WorkerLostError` once the
restart budget is truly exhausted.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from concurrent.futures import Future
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

from repro_torch import obs
from repro_torch.serve.fleet import rpc


@dataclasses.dataclass
class JournalEntry:
    """One accepted request's routing state (owned by the fleet lock)."""

    rid: int
    payload: Dict[str, Any]
    lane: Tuple[int, int]
    future: Future
    t_submit: float
    tag: Any = None
    worker: Optional[str] = None        # primary assignment
    hedge_worker: Optional[str] = None  # duplicate assignment, if hedged
    t_dispatch: float = 0.0
    attempts: int = 0
    done: bool = False
    ok: bool = False


class Router:
    """Lane-sticky placement + the at-most-once journal.

    ``send(worker, msg) -> bool`` and ``live() -> [names]`` are supplied
    by the fleet; ``lock`` is the fleet-wide mutex (shared so journal
    state and worker state flip together).
    """

    def __init__(self, *, send: Callable[[str, rpc.Message], bool],
                 live: Callable[[], List[str]],
                 lock, rebalance_factor: float = 4.0,
                 keep_done: int = 4096):
        self._send = send
        self._live = live
        self._lock = lock
        self.rebalance_factor = float(rebalance_factor)
        self.keep_done = int(keep_done)
        self.journal: Dict[int, JournalEntry] = {}
        self._done_order: Deque[int] = collections.deque()
        self.lane_owner: Dict[Tuple[int, int], str] = {}
        self.lane_sample: Dict[Tuple[int, int], Dict[str, Any]] = {}
        self.lane_hits: collections.Counter = collections.Counter()
        self.inflight: Dict[str, Set[int]] = collections.defaultdict(set)
        self.unrouted: Deque[int] = collections.deque()
        self._rids = itertools.count(1)
        self._rr = 0

    # -- admission ----------------------------------------------------------

    def admit(self, payload: Dict[str, Any], *, tag: Any = None
              ) -> JournalEntry:
        """Journal a new request (does not dispatch it)."""
        lane = rpc.lane_key(payload)
        with self._lock:
            entry = JournalEntry(
                rid=next(self._rids), payload=payload, lane=lane,
                future=Future(), t_submit=time.monotonic(), tag=tag)
            self.journal[entry.rid] = entry
            self.lane_sample[lane] = payload
            self.lane_hits[lane] += 1
        return entry

    # -- placement ----------------------------------------------------------

    def _pick(self, lane: Tuple[int, int],
              exclude: Tuple[str, ...]) -> Optional[str]:
        live = [w for w in self._live() if w not in exclude]
        if not live:
            return None
        owner = self.lane_owner.get(lane)
        if owner in live:
            mean = sum(len(self.inflight[w]) for w in live) / len(live)
            if len(live) > 1 and \
                    len(self.inflight[owner]) > \
                    self.rebalance_factor * max(mean, 1.0):
                new = min(live, key=lambda w: (len(self.inflight[w]), w))
                if new != owner:
                    self.lane_owner[lane] = new
                    obs.counter("fleet_rebalances_total").inc()
                    return new
            return owner
        w = live[self._rr % len(live)]
        self._rr += 1
        self.lane_owner[lane] = w
        return w

    def dispatch(self, entry: JournalEntry,
                 exclude: Tuple[str, ...] = ()) -> bool:
        """Send an entry to a worker; parks it unrouted when none can
        take it.  Returns True when it is on a worker."""
        tried = tuple(exclude)
        while True:
            with self._lock:
                if entry.done:
                    return True
                w = self._pick(entry.lane, tried)
                if w is None:
                    if entry.rid not in self.unrouted:
                        self.unrouted.append(entry.rid)
                    obs.counter("fleet_unrouted_total").inc()
                    return False
                entry.worker = w
                entry.t_dispatch = time.monotonic()
                entry.attempts += 1
                self.inflight[w].add(entry.rid)
            if self._send(w, ("req", entry.rid, entry.payload)):
                return True
            with self._lock:
                self.inflight[w].discard(entry.rid)
                entry.worker = None
                if self.lane_owner.get(entry.lane) == w:
                    del self.lane_owner[entry.lane]
            tried = tried + (w,)

    # -- completion (the at-most-once gate) ---------------------------------

    def complete(self, rid: int, ok: bool, value: Any, src: str
                 ) -> Optional[Tuple[JournalEntry, Optional[str]]]:
        """First completion wins: returns (entry, other-worker-to-cancel)
        and resolves the future; duplicates return None."""
        with self._lock:
            entry = self.journal.get(rid)
            if entry is None or entry.done:
                obs.counter("fleet_duplicate_results_total").inc()
                return None
            entry.done = True
            entry.ok = bool(ok)
            self._done_order.append(rid)
            other = None
            for w in (entry.worker, entry.hedge_worker):
                if w is not None:
                    self.inflight[w].discard(rid)
                    if w != src:
                        other = w
            self._gc_done_locked()
        if ok:
            entry.future.set_result(value)
        else:
            entry.future.set_exception(
                value if isinstance(value, BaseException)
                else rpc.decode_error(value))
        return entry, other

    def fail(self, entry: JournalEntry, exc: BaseException) -> bool:
        """Terminal failure (budget exhausted / close): resolve the
        future with ``exc`` unless something already completed it."""
        got = self.complete(entry.rid, False, exc, src="<fleet>")
        return got is not None

    def _gc_done_locked(self) -> None:
        while len(self._done_order) > self.keep_done:
            rid = self._done_order.popleft()
            self.journal.pop(rid, None)

    # -- failover / hedging -------------------------------------------------

    def orphans_of(self, worker: str) -> List[JournalEntry]:
        """Strip a dead worker's assignments; returns its unfinished
        entries (the caller re-dispatches them) and un-sticks its lanes."""
        with self._lock:
            rids = self.inflight.pop(worker, set())
            out = []
            for rid in rids:
                entry = self.journal.get(rid)
                if entry is None or entry.done:
                    continue
                if entry.worker == worker:
                    entry.worker = None
                if entry.hedge_worker == worker:
                    entry.hedge_worker = None
                if entry.worker is None and entry.hedge_worker is None:
                    out.append(entry)
            for lane, owner in list(self.lane_owner.items()):
                if owner == worker:
                    del self.lane_owner[lane]
            return out

    def hedge_candidate(self, worker: str, older_than_s: float
                        ) -> Optional[JournalEntry]:
        """The worker's oldest un-hedged in-flight entry past the age
        threshold (None if it has nothing hedge-worthy)."""
        now = time.monotonic()
        with self._lock:
            best = None
            for rid in self.inflight.get(worker, ()):
                e = self.journal.get(rid)
                if e is None or e.done or e.hedge_worker is not None \
                        or e.worker != worker:
                    continue
                if now - e.t_dispatch < older_than_s:
                    continue
                if best is None or e.t_dispatch < best.t_dispatch:
                    best = e
            return best

    def hedge(self, entry: JournalEntry) -> bool:
        """Send a duplicate of ``entry`` to a different live worker;
        first result wins (``complete`` cancels the loser)."""
        with self._lock:
            if entry.done or entry.hedge_worker is not None \
                    or entry.worker is None:
                return False
            live = [w for w in self._live() if w != entry.worker]
            if not live:
                return False
            w = min(live, key=lambda n: (len(self.inflight[n]), n))
            entry.hedge_worker = w
            self.inflight[w].add(entry.rid)
        if self._send(w, ("req", entry.rid, entry.payload)):
            obs.counter("fleet_hedges_total").inc()
            return True
        with self._lock:
            self.inflight[w].discard(entry.rid)
            if entry.hedge_worker == w:
                entry.hedge_worker = None
        return False

    # -- queries ------------------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return sum(1 for e in self.journal.values() if not e.done)

    def pending_entries(self) -> List[JournalEntry]:
        with self._lock:
            return [e for e in self.journal.values() if not e.done]

    def take_unrouted(self) -> List[JournalEntry]:
        """Pop every parked rid (caller re-dispatches)."""
        with self._lock:
            out = []
            while self.unrouted:
                e = self.journal.get(self.unrouted.popleft())
                if e is not None and not e.done:
                    out.append(e)
            return out

    def hot_lanes(self, k: int = 2) -> List[Dict[str, Any]]:
        """Sample payloads of the ``k`` most-hit lanes (warm fodder)."""
        with self._lock:
            lanes = [lane for lane, _ in self.lane_hits.most_common(k)]
            return [self.lane_sample[l] for l in lanes
                    if l in self.lane_sample]


__all__ = ["JournalEntry", "Router"]

"""Process-level supervision state for the serving fleet (the port of
``repro.serve.fleet.supervisor``).

:class:`~repro_torch.resilience.supervisor.WorkerSupervisor` restarts a dead
*thread* atomically under a lock — spawn is microseconds, so observe-
dead → charge-budget → respawn can all hold the mutex.  A fleet worker
is a process: a respawn imports torch, makes a CUDA context and warms
lanes, which takes seconds and must not block the lock.  The guard
therefore splits in two, the same generation pattern
``WorkerSupervisor.ensure()`` exposes:

* :meth:`FleetSupervisor.begin_death` atomically claims a death — it
  checks the observer's *generation* against the current one and flips
  the state to ``dead`` + ``restarting=True`` under the lock.  Exactly
  one of the racing observers (a pump thread seeing EOF, the monitor
  seeing ``alive() == False``, the heartbeat timeout) wins; the rest
  get ``None`` and walk away.  Double-restart and double-charging the
  budget are structurally impossible, not just unlikely.
* The winner respawns **outside** the lock, then calls
  :meth:`finish_restart` (or :meth:`abandon_restart` when the budget is
  spent) to publish the new generation.

Liveness signals feed :mod:`repro_torch.ft.health`: each worker's
heartbeats go through a shared :class:`~repro_torch.ft.health.Heartbeat`
(missed-beat detection) and its per-request service times through a
per-worker :class:`~repro_torch.ft.health.StragglerDetector` — a worker
that is alive but slow gets flagged, and the fleet hedges its oldest
request instead of killing it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Set

from repro_torch import obs
from repro_torch.ft.health import (Heartbeat, HealthConfig,
                                   StragglerDetector)

#: worker lifecycle states
WARMING = "warming"    # spawned, compiling hot lanes; not routable yet
LIVE = "live"          # in the rotation
DRAINING = "draining"  # finishing in-flight, no new work (scale-down)
DEAD = "dead"          # observed dead; restart may be in flight
RETIRED = "retired"    # deliberately stopped; never restarted


@dataclasses.dataclass
class WorkerState:
    """One worker slot's supervision record (mutated under the lock)."""

    name: str
    handle: Any = None
    status: str = WARMING
    generation: int = 1
    restarts: int = 0
    served: int = 0
    pump: Any = None  # the pump thread draining this handle


class FleetSupervisor:
    """Registry + liveness/straggler bookkeeping for fleet workers."""

    def __init__(self, *, lock, health: Optional[HealthConfig] = None,
                 max_restarts_per_worker: int = 2):
        self._lock = lock
        self.health = health if health is not None else HealthConfig()
        self.max_restarts_per_worker = int(max_restarts_per_worker)
        self.workers: Dict[str, WorkerState] = {}
        self.hb = Heartbeat(self.health)
        self.detectors: Dict[str, StragglerDetector] = {}
        self.stragglers: Set[str] = set()

    # -- registry -----------------------------------------------------------

    def register(self, ws: WorkerState) -> None:
        with self._lock:
            self.workers[ws.name] = ws
            self.detectors.setdefault(ws.name,
                                      StragglerDetector(self.health))
        self.hb.beat(ws.name)  # spawn grace: not dead before first beat
        self._gauge()

    def live(self) -> List[str]:
        """Routable workers, in insertion order (determinism)."""
        with self._lock:
            return [n for n, ws in self.workers.items()
                    if ws.status == LIVE]

    def states(self) -> List[WorkerState]:
        with self._lock:
            return list(self.workers.values())

    def get(self, name: str) -> Optional[WorkerState]:
        with self._lock:
            return self.workers.get(name)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for ws in self.workers.values():
                out[ws.status] = out.get(ws.status, 0) + 1
            return out

    def _gauge(self) -> None:
        counts = self.counts()
        obs.gauge("fleet_workers_live").set(counts.get(LIVE, 0))
        obs.gauge("fleet_workers_total").set(
            sum(v for k, v in counts.items() if k != RETIRED))

    # -- liveness signals ---------------------------------------------------

    def note_heartbeat(self, name: str, generation: int) -> None:
        with self._lock:
            ws = self.workers.get(name)
            if ws is None or ws.generation != generation:
                return  # a dead generation's leftover beat
        self.hb.beat(name)

    def note_service_time(self, name: str, dt_s: float) -> bool:
        """Record one request's service time; True marks a straggler."""
        with self._lock:
            det = self.detectors.get(name)
        if det is None:
            return False
        flagged = det.record(step=0, dt=dt_s)
        if flagged:
            self.stragglers.add(name)
            obs.counter("fleet_stragglers_total", worker=name).inc()
        return flagged

    def heartbeat_dead(self, now: Optional[float] = None) -> List[str]:
        """Live/warming workers whose heartbeats timed out."""
        dead = self.hb.dead_hosts(now)
        with self._lock:
            return [n for n in dead
                    if n in self.workers
                    and self.workers[n].status in (LIVE, WARMING, DRAINING)]

    # -- the split death/restart guard --------------------------------------

    def begin_death(self, name: str, observed_generation: int
                    ) -> Optional[WorkerState]:
        """Atomically claim a worker's death.  Returns the state when
        this caller won (status flipped to DEAD, restart claimed) or
        ``None`` when someone else already handled this generation's
        death — the process-level analog of
        ``WorkerSupervisor.ensure(observed_generation=...)``."""
        with self._lock:
            ws = self.workers.get(name)
            if ws is None or ws.generation != observed_generation:
                return None
            if ws.status in (DEAD, RETIRED):
                return None
            ws.status = DEAD
        self.hb.forget(name)
        self.stragglers.discard(name)
        self._gauge()
        return ws

    def may_restart(self, ws: WorkerState) -> bool:
        with self._lock:
            return ws.restarts < self.max_restarts_per_worker

    def finish_restart(self, ws: WorkerState, handle, pump) -> int:
        """Publish a respawned worker: bump generation, charge budget.
        Returns the new generation."""
        with self._lock:
            ws.restarts += 1
            ws.generation += 1
            ws.handle = handle
            ws.pump = pump
            ws.status = WARMING
            gen = ws.generation
        obs.counter("fleet_restarts_total", worker=ws.name).inc()
        obs.counter("resilience_recoveries_total", site="fleet").inc()
        self.hb.beat(ws.name)
        self._gauge()
        return gen

    def abandon_restart(self, ws: WorkerState) -> None:
        """Budget exhausted: the slot stays DEAD for good."""
        self._gauge()

    # -- deliberate transitions ---------------------------------------------

    def set_status(self, name: str, status: str,
                   generation: Optional[int] = None) -> bool:
        with self._lock:
            ws = self.workers.get(name)
            if ws is None:
                return False
            if generation is not None and ws.generation != generation:
                return False
            if ws.status in (DEAD, RETIRED) and status == LIVE:
                return False  # a ready message from a killed generation
            ws.status = status
        if status == RETIRED:
            self.hb.forget(name)
            self.stragglers.discard(name)
        self._gauge()
        return True


__all__ = [
    "DEAD", "DRAINING", "FleetSupervisor", "LIVE", "RETIRED", "WARMING",
    "WorkerState",
]

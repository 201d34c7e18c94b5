"""Worker-thread supervision: detect dead loops, restart them bounded.

Both serving engines run their work off a single daemon thread (the
micro-batching ``_serve_loop``, the continuous ``_step_loop``).  Before
this layer, any exception escaping that loop left a silently dead
engine: the queue kept accepting work that nothing would ever run.

:class:`WorkerSupervisor` wraps the thread: ``ensure()`` (called from
the engine's submit/drain paths — the places a dead worker actually
hurts) restarts a dead loop up to ``max_restarts`` times, counting each
restart in ``resilience_worker_restarts_total{worker}`` and
``resilience_recoveries_total{site="worker"}``.  Past the budget the
engine falls back to its fail-the-backlog behavior.

Concurrency contract: the observe-dead → charge-budget → respawn
sequence is atomic under one lock, so two threads hitting ``ensure()``
on the same dead worker can never double-restart or double-charge the
budget (the second observer sees the already-respawned thread and
returns).  Each spawn bumps ``generation``; a caller that observed a
death *before* taking the lock can pass its observed generation and
becomes a no-op if another thread already handled that death — the
guard the fleet's process-level supervisor relies on, where a respawn
is seconds long and must happen outside the lock
(the reference's ``repro.serve.fleet.FleetSupervisor``).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch import obs


class WorkerSupervisor:
    """Restartable daemon thread with a bounded restart budget."""

    def __init__(self, name: str, target: Callable[[], None], *,
                 max_restarts: int = 3):
        self.name = name
        self.target = target
        self.max_restarts = int(max_restarts)
        self.restarts = 0
        self.generation = 0
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def _spawn(self) -> None:
        self.generation += 1
        self._thread = threading.Thread(
            target=self.target, name=f"{self.name}-g{self.generation}",
            daemon=True)
        self._thread.start()

    def start(self) -> None:
        with self._lock:
            if self._thread is None:
                self._spawn()

    def alive(self) -> bool:
        with self._lock:
            t = self._thread
        return t is not None and t.is_alive()

    def ensure(self, observed_generation: Optional[int] = None) -> bool:
        """Restart the worker if it died.  Returns True while a live
        worker exists (possibly just restarted); False once the restart
        budget is exhausted and the loop is dead.

        ``observed_generation`` makes a deferred death report safe: a
        caller that saw generation *g* dead, then raced another caller
        to this lock, only restarts if the generation is still *g* —
        otherwise the death was already handled (possibly by a restart
        that has itself since died, which the next plain ``ensure()``
        will observe against the *new* generation).
        """
        with self._lock:
            if self._thread is None:
                return False  # never started (foreground mode)
            if observed_generation is not None \
                    and observed_generation != self.generation:
                return self._thread.is_alive() \
                    or self.restarts < self.max_restarts
            if self._thread.is_alive():
                return True
            if self.restarts >= self.max_restarts:
                return False
            self.restarts += 1
            obs.counter("resilience_worker_restarts_total",
                        worker=self.name).inc()
            obs.counter("resilience_recoveries_total", site="worker").inc()
            self._spawn()
            return True

    def join(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout=timeout)


__all__ = ["WorkerSupervisor"]

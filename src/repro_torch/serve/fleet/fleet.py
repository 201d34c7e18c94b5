"""The serving fleet: supervised multi-worker serving with failover (the
port of ``repro.serve.fleet.fleet``).

:class:`ServingFleet` fronts N workers (threads or real ``spawn``
processes, see :mod:`repro_torch.serve.fleet.rpc`) behind one submit/infer
surface that speaks the same futures-and-taxonomy contract as the
single-process engines.  The moving parts:

* the :class:`~repro_torch.serve.fleet.router.Router` journals every request
  and places it with lane-sticky round-robin (warm-executor locality);
* per-worker **pump threads** drain results and heartbeats;
* a **monitor thread** runs the control loop: crash + missed-heartbeat
  detection (via :mod:`repro_torch.ft.health`), failover of a dead worker's
  in-flight to survivors (at-most-once through the journal), bounded
  respawns that re-warm the hot lanes before rejoining the rotation,
  straggler hedging with first-wins cancellation, unrouted re-drive,
  scale-down retirement, and the
  :class:`~repro_torch.serve.fleet.autoscale.Autoscaler` decisions;
* all four chaos sites (``fleet.worker``, ``fleet.heartbeat``,
  ``fleet.rpc`` at send and recv) fire **parent-side**, so a seeded
  :class:`~repro_torch.resilience.chaos.FaultPlan` replays deterministically
  even over real child processes that never see the plan.

Failure semantics: a request fails with
:class:`~repro_torch.resilience.errors.WorkerLostError` only when every
worker slot is dead with its restart budget spent; anything short of
that re-routes; a request whose kernel failed in a worker fails with
:class:`~repro_torch.resilience.errors.KernelError` and is neither
re-routed nor hedged.  ``close()`` drains, then stops workers, then fails
whatever could not complete with ``EngineClosedError`` — no future is
ever left unresolved, and both ``close()`` and ``submit``-after-close
are safe from any thread at any point of the lifecycle.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.ft.health import HealthConfig
from repro_torch.resilience import chaos
from repro_torch.resilience.errors import (DeadlineExceededError,
                                           EngineClosedError,
                                           WorkerLostError)
from repro_torch.serve.fleet import rpc
from repro_torch.serve.fleet.autoscale import AutoscaleConfig, Autoscaler
from repro_torch.serve.fleet.router import Router
from repro_torch.serve.fleet.supervisor import (DEAD, DRAINING, LIVE,
                                                RETIRED, WARMING,
                                                FleetSupervisor, WorkerState)
from repro_torch.serve.fleet.worker import WorkerConfig


@dataclasses.dataclass
class FleetConfig:
    """Fleet topology + supervision cadence.

    Dataclass-instance knobs (``worker``, ``health``, ``autoscale``)
    default to ``None`` and are built per-instance in ``__post_init__``
    — a shared default instance would alias config state across fleets
    (see the mutable-default audit in tests/test_torch_fleet.py).
    """

    backend: str = "thread"        # "thread" | "process"
    workers: int = 2               # initial fleet size
    worker: Optional[WorkerConfig] = None
    health: Optional[HealthConfig] = None
    autoscale: Optional[AutoscaleConfig] = None
    max_restarts_per_worker: int = 2
    monitor_interval_s: float = 0.005
    rpc_poll_s: float = 0.02       # pump blocking-poll quantum
    hedge_after_ms: float = 250.0  # absolute hedge trigger
    straggler_hedge_scale: float = 0.25  # flagged workers hedge sooner
    rebalance_factor: float = 4.0
    warm_lanes: int = 2            # hot lanes pre-compiled on (re)spawn
    drain_timeout_s: float = 30.0
    ready_timeout_s: float = 60.0
    name_prefix: str = "w"

    def __post_init__(self):
        if self.worker is None:
            self.worker = WorkerConfig()
        if self.health is None:
            # per-backend heartbeat deadline: thread workers beat every
            # ~20ms, process workers pay the torch import and the CUDA
            # start-up on spawn
            timeout = 0.5 if self.backend == "thread" else 5.0
            self.health = HealthConfig(heartbeat_timeout_s=timeout)
        if self.autoscale is None:
            self.autoscale = AutoscaleConfig()


class ServingFleet:
    """Fault-tolerant multi-worker serving engine (module docstring)."""

    def __init__(self, cfg: Optional[FleetConfig] = None):
        self.cfg = cfg if cfg is not None else FleetConfig()
        self._lock = threading.RLock()
        self._close_once = threading.Lock()
        self._closing = False
        self._closed = False
        self._stop_evt = threading.Event()
        self.sup = FleetSupervisor(
            lock=self._lock, health=self.cfg.health,
            max_restarts_per_worker=self.cfg.max_restarts_per_worker)
        self.router = Router(
            send=self._send, live=self.sup.live, lock=self._lock,
            rebalance_factor=self.cfg.rebalance_factor)
        self.scaler = Autoscaler(self.cfg.autoscale)
        self._latencies_ms: List[float] = []
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._lost = 0
        self._waiters: Dict[int, List[Any]] = {}  # token -> [event, value]
        self._tokens = itertools.count(1)
        self._worker_seq = itertools.count(1)
        self._readies: Dict[str, int] = {}  # readies outstanding per worker
        for _ in range(max(1, int(self.cfg.workers))):
            self._spawn_worker()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="fleet-monitor")
        self._monitor.start()

    # ------------------------------------------------------------------
    # spawning
    # ------------------------------------------------------------------

    def _spawn_worker(self, warm: Optional[List[Dict[str, Any]]] = None
                      ) -> WorkerState:
        name = f"{self.cfg.name_prefix}{next(self._worker_seq)}"
        handle = rpc.make_handle(self.cfg.backend, name, self.cfg.worker)
        ws = WorkerState(name=name, handle=handle)
        with self._lock:
            self._readies[name] = 1
        self.sup.register(ws)
        if warm:
            with self._lock:
                self._readies[name] = 2
            try:
                handle.send(("warm", warm))
            except rpc.TransportError:
                with self._lock:
                    self._readies[name] = 1
        pump = threading.Thread(
            target=self._pump_loop, args=(name, ws.generation, handle),
            daemon=True, name=f"fleet-pump-{name}")
        with self._lock:
            ws.pump = pump
        pump.start()
        obs.counter("fleet_workers_spawned_total").inc()
        return ws

    # ------------------------------------------------------------------
    # transport (all chaos fires here, parent-side)
    # ------------------------------------------------------------------

    def _send(self, name: str, msg: rpc.Message) -> bool:
        ws = self.sup.get(name)
        if ws is None or ws.handle is None or ws.status in (DEAD, RETIRED):
            return False
        gen = ws.generation
        try:
            chaos.hook("fleet.rpc", worker=name, phase="send")
        except chaos.ProcessKillRequested:
            self._kill_worker(name)
            return False
        except chaos.WorkerHangRequested:
            return True  # blackholed: claimed sent, never delivered
        except Exception:  # noqa: BLE001 — injected transient send fault
            obs.counter("fleet_rpc_faults_total", phase="send").inc()
            return False
        try:
            ws.handle.send(msg)
        except rpc.TransportError:
            self._worker_down(name, gen, "send")
            return False
        if msg[0] == "req":
            # dispatch-site chaos: a plan can kill/hang this worker
            # deterministically right after its Nth request lands —
            # the "mid-batch kill" the acceptance storm uses.  The
            # request WAS delivered, so failover must recover it.
            try:
                chaos.hook("fleet.worker", worker=name, phase="dispatch")
            except chaos.ProcessKillRequested:
                self._kill_worker(name)
            except chaos.WorkerHangRequested as h:
                self._hang_worker(name, h.payload)
            except Exception:  # noqa: BLE001 — other kinds are no-ops here
                pass
        return True

    def _kill_worker(self, name: str) -> None:
        ws = self.sup.get(name)
        if ws is None:
            return
        gen = ws.generation
        obs.counter("fleet_kills_total", worker=name).inc()
        try:
            ws.handle.kill()
        except Exception:  # noqa: BLE001
            pass
        self._worker_down(name, gen, "killed")

    def _hang_worker(self, name: str, seconds: Optional[float]) -> None:
        ws = self.sup.get(name)
        if ws is None:
            return
        try:
            ws.handle.send(("hang", seconds))
        except rpc.TransportError:
            pass

    # ------------------------------------------------------------------
    # death → failover → bounded respawn
    # ------------------------------------------------------------------

    def _worker_down(self, name: str, observed_gen: int, reason: str
                     ) -> None:
        ws = self.sup.begin_death(name, observed_gen)
        if ws is None:
            return  # another observer already claimed this death
        obs.counter("fleet_worker_deaths_total",
                    worker=name, reason=reason).inc()
        try:
            ws.handle.kill()  # a hung worker is alive; make it not be
        except Exception:  # noqa: BLE001
            pass
        for entry in self.router.orphans_of(name):
            obs.counter("fleet_failovers_total").inc()
            self.router.dispatch(entry, exclude=(name,))
        if not self._closing and self.sup.may_restart(ws):
            handle = rpc.make_handle(self.cfg.backend, name,
                                     self.cfg.worker)
            gen = self.sup.finish_restart(ws, handle, pump=None)
            warm = self.router.hot_lanes(self.cfg.warm_lanes)
            with self._lock:
                self._readies[name] = 1
            if warm:
                with self._lock:
                    self._readies[name] = 2
                try:
                    handle.send(("warm", warm))
                except rpc.TransportError:
                    with self._lock:
                        self._readies[name] = 1
            pump = threading.Thread(
                target=self._pump_loop, args=(name, gen, handle),
                daemon=True, name=f"fleet-pump-{name}-g{gen}")
            with self._lock:
                ws.pump = pump
            pump.start()
        else:
            self.sup.abandon_restart(ws)
            self._strand_check()

    def _strand_check(self) -> None:
        """With no worker slot able to serve, pending futures must not
        hang forever: fail them with WorkerLostError (counted lost)."""
        counts = self.sup.counts()
        if counts.get(LIVE, 0) + counts.get(WARMING, 0) \
                + counts.get(DRAINING, 0) > 0:
            return
        for entry in self.router.pending_entries():
            if self.router.fail(entry, WorkerLostError(
                    "all fleet workers dead, restart budget exhausted")):
                with self._lock:
                    self._lost += 1
                    self._failed += 1
                obs.counter("fleet_requests_lost_total").inc()

    # ------------------------------------------------------------------
    # pump: one thread per worker generation
    # ------------------------------------------------------------------

    def _pump_loop(self, name: str, gen: int, handle) -> None:
        while not self._stop_evt.is_set():
            ws = self.sup.get(name)
            if ws is None or ws.generation != gen or ws.status == RETIRED:
                return
            try:
                msg = handle.poll(self.cfg.rpc_poll_s)
            except rpc.TransportError:
                self._worker_down(name, gen, "transport")
                return
            if msg is None:
                if ws.status != DEAD and not handle.alive():
                    self._worker_down(name, gen, "exit")
                    return
                continue
            try:
                chaos.hook("fleet.rpc", worker=name, phase="recv")
            except chaos.ProcessKillRequested:
                self._kill_worker(name)
                continue
            except chaos.WorkerHangRequested:
                continue  # frame blackholed
            except Exception:  # noqa: BLE001 — injected recv fault
                obs.counter("fleet_rpc_faults_total", phase="recv").inc()
                continue
            self._on_message(name, gen, msg)

    def _on_message(self, name: str, gen: int, msg: rpc.Message) -> None:
        kind = msg[0]
        if kind == "hb":
            try:
                chaos.hook("fleet.heartbeat", worker=name)
            except chaos.ProcessKillRequested:
                self._kill_worker(name)
                return
            except Exception:  # noqa: BLE001 — hang/raise: the beat is
                return         # lost; delay slept above = a late beat
            self.sup.note_heartbeat(name, gen)
        elif kind == "res":
            # results from a freshly-dead generation still count: the
            # journal dedupes against the failover re-execution
            self._on_result(name, msg)
        elif kind == "ready":
            self._on_ready(name, gen)
        elif kind in ("report_res", "drained"):
            token = msg[1]
            with self._lock:
                waiter = self._waiters.get(token)
                if waiter is not None:
                    waiter[1] = msg[2] if len(msg) > 2 else True
                    waiter[0].set()
        elif kind == "bye":
            ws = self.sup.get(name)
            if ws is not None and ws.generation == gen \
                    and ws.status not in (RETIRED, DEAD):
                if self._closing or ws.status == DRAINING:
                    self.sup.set_status(name, RETIRED, generation=gen)
                else:
                    self._worker_down(name, gen, "bye")

    def _on_result(self, src: str, msg: rpc.Message) -> None:
        _, rid, ok, value = msg
        res = self.router.complete(rid, ok, value, src)
        if res is None:
            return  # duplicate (late pipe / hedge loser) — dropped
        entry, other = res
        now = time.monotonic()
        lat_ms = (now - entry.t_submit) * 1e3
        with self._lock:
            self._latencies_ms.append(lat_ms)
            if len(self._latencies_ms) > 8192:
                del self._latencies_ms[:4096]
            self._completed += 1
            if not ok:
                self._failed += 1
            ws = self.sup.workers.get(src)
            if ws is not None:
                ws.served += 1
        obs.histogram("fleet_latency_ms").observe(lat_ms)
        if entry.t_dispatch:
            self.sup.note_service_time(src, now - entry.t_dispatch)
        if other is not None:
            obs.counter("fleet_hedge_cancels_total").inc()
            try:
                ows = self.sup.get(other)
                if ows is not None and ows.status not in (DEAD, RETIRED):
                    ows.handle.send(("cancel", rid))
            except rpc.TransportError:
                pass

    def _on_ready(self, name: str, gen: int) -> None:
        with self._lock:
            left = max(0, self._readies.get(name, 1) - 1)
            self._readies[name] = left
        if left > 0:
            return  # engine is up; still warming hot lanes
        if self.sup.set_status(name, LIVE, generation=gen):
            for entry in self.router.take_unrouted():
                self.router.dispatch(entry)

    # ------------------------------------------------------------------
    # monitor: the control loop
    # ------------------------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop_evt.is_set():
            time.sleep(self.cfg.monitor_interval_s)
            try:
                self._tick()
            except Exception:  # noqa: BLE001 — the loop must survive
                obs.counter("fleet_monitor_errors_total").inc()

    def _tick(self) -> None:
        now = time.monotonic()
        for ws in self.sup.states():
            if ws.status in (DEAD, RETIRED):
                continue
            name, gen = ws.name, ws.generation
            try:
                chaos.hook("fleet.worker", worker=name, phase="monitor")
            except chaos.ProcessKillRequested:
                self._kill_worker(name)
                continue
            except chaos.WorkerHangRequested as h:
                self._hang_worker(name, h.payload)
                continue
            except Exception:  # noqa: BLE001
                pass
            if ws.handle is not None and not ws.handle.alive():
                self._worker_down(name, gen, "exit")
        for name in self.sup.heartbeat_dead(now):
            ws = self.sup.get(name)
            if ws is not None:
                self._worker_down(name, ws.generation, "heartbeat")
        # hedging: stragglers hedge at a fraction of the age threshold
        base_s = self.cfg.hedge_after_ms / 1e3
        for name in self.sup.live():
            age = base_s * (self.cfg.straggler_hedge_scale
                            if name in self.sup.stragglers else 1.0)
            entry = self.router.hedge_candidate(name, age)
            if entry is not None:
                self.router.hedge(entry)
        if self.sup.live():
            for entry in self.router.take_unrouted():
                self.router.dispatch(entry)
        for ws in self.sup.states():
            if ws.status == DRAINING \
                    and not self.router.inflight.get(ws.name):
                self._retire(ws)
        decision = self.scaler.decide(
            now, pending=self.router.pending(),
            live_workers=len(self.sup.live()),
            p99_ms=self._recent_p99())
        if decision == "up" and not self._closing:
            obs.counter("fleet_scale_ups_total").inc()
            self._spawn_worker(warm=self.router.hot_lanes(
                self.cfg.warm_lanes))
        elif decision == "down" and not self._closing:
            live = self.sup.live()
            if len(live) > 1:
                victim = min(live,
                             key=lambda n: (len(self.router.inflight[n]), n))
                obs.counter("fleet_scale_downs_total").inc()
                self.sup.set_status(victim, DRAINING)

    def _retire(self, ws: WorkerState) -> None:
        try:
            ws.handle.send(("stop",))
        except rpc.TransportError:
            pass
        self.sup.set_status(ws.name, RETIRED)
        obs.counter("fleet_workers_retired_total").inc()

    def _recent_p99(self) -> Optional[float]:
        with self._lock:
            if len(self._latencies_ms) < 8:
                return None
            tail = np.asarray(self._latencies_ms[-256:], np.float64)
        return float(np.percentile(tail, 99))

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------

    def submit(self, matrix, features, *, steps: int = 1,
               tag: Any = None) -> Future:
        """Admit one request; resolves to [n_nodes, d_out] (numpy) or
        fails with a taxonomy error.  Survives worker deaths."""
        if self._closing or self._closed:
            raise EngineClosedError("fleet is closed")
        payload = rpc.encode_request(matrix, features, steps)
        entry = self.router.admit(payload, tag=tag)
        with self._lock:
            self._submitted += 1
        obs.counter("fleet_requests_total").inc()
        self.router.dispatch(entry)
        return entry.future

    def infer(self, matrix, features, *, steps: int = 1,
              timeout: Optional[float] = 30.0) -> np.ndarray:
        fut = self.submit(matrix, features, steps=steps)
        try:
            return fut.result(timeout=timeout)
        except _FuturesTimeout:
            raise DeadlineExceededError(
                f"fleet.infer timed out after {timeout}s") from None

    def pending(self) -> int:
        return self.router.pending()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every admitted request resolved (failover and
        respawns keep running underneath)."""
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.cfg.drain_timeout_s)
        while self.router.pending() > 0:
            if time.monotonic() > deadline:
                raise DeadlineExceededError(
                    f"fleet drain timed out with "
                    f"{self.router.pending()} pending")
            time.sleep(0.002)

    def wait_live(self, n: int = 1, timeout: Optional[float] = None
                  ) -> bool:
        """Block until ``n`` workers are in the rotation."""
        deadline = time.monotonic() + (
            timeout if timeout is not None else self.cfg.ready_timeout_s)
        while len(self.sup.live()) < n:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.002)
        return True

    def rolling_restart(self, timeout_per_worker: float = 60.0) -> None:
        """Replace every worker one at a time without dropping requests:
        spawn a warm successor, wait for it to join, drain + retire the
        old worker, repeat."""
        for ws in self.sup.states():
            if ws.status not in (LIVE, WARMING):
                continue
            if self._closing:
                return
            new_ws = self._spawn_worker(
                warm=self.router.hot_lanes(self.cfg.warm_lanes))
            deadline = time.monotonic() + timeout_per_worker
            while True:
                st = self.sup.get(new_ws.name)
                if st is not None and st.status == LIVE:
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.002)
            self.sup.set_status(ws.name, DRAINING)
            while self.router.inflight.get(ws.name) \
                    and time.monotonic() < deadline:
                time.sleep(0.002)
            cur = self.sup.get(ws.name)
            if cur is not None and cur.status == DRAINING:
                self._retire(cur)
        obs.counter("fleet_rolling_restarts_total").inc()

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain, stop the fleet, fail anything unresolved.  Idempotent
        and safe to race with worker deaths."""
        with self._close_once:
            if self._closed:
                return
            self._closing = True
            try:
                self.drain(timeout if timeout is not None
                           else self.cfg.drain_timeout_s)
            except Exception:  # noqa: BLE001 — leftovers failed below
                pass
            self._stop_evt.set()
            for ws in self.sup.states():
                if ws.status in (DEAD, RETIRED):
                    continue
                try:
                    ws.handle.send(("stop",))
                except rpc.TransportError:
                    pass
            deadline = time.monotonic() + 2.0
            for ws in self.sup.states():
                if ws.handle is None:
                    continue
                ws.handle.join(timeout=max(0.0,
                                           deadline - time.monotonic()))
                if ws.handle.alive():
                    try:
                        ws.handle.kill()
                    except Exception:  # noqa: BLE001
                        pass
            for entry in self.router.pending_entries():
                if self.router.fail(entry, EngineClosedError(
                        "fleet closed before this request completed")):
                    with self._lock:
                        self._lost += 1
                        self._failed += 1
                    obs.counter("fleet_requests_lost_total").inc()
            self._closed = True

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------
    # reporting
    # ------------------------------------------------------------------

    def _collect_worker_reports(self, timeout: float = 1.0
                                ) -> Dict[str, Dict[str, Any]]:
        tokens: Dict[str, int] = {}
        for name in self.sup.live():
            token = next(self._tokens)
            with self._lock:
                self._waiters[token] = [threading.Event(), None]
            if self._send(name, ("report", token)):
                tokens[name] = token
            else:
                with self._lock:
                    self._waiters.pop(token, None)
        out: Dict[str, Dict[str, Any]] = {}
        deadline = time.monotonic() + timeout
        for name, token in tokens.items():
            with self._lock:
                waiter = self._waiters.get(token)
            if waiter is None:
                continue
            waiter[0].wait(timeout=max(0.0, deadline - time.monotonic()))
            with self._lock:
                self._waiters.pop(token, None)
            if waiter[1] is not None:
                out[name] = waiter[1]
        return out

    def report(self) -> Dict[str, Any]:
        """Fleet-level canonical keys (p50_ms/p99_ms/waste) + per-worker
        engine reports + the ``fleet`` supervision section."""
        worker_reports = self._collect_worker_reports()
        with self._lock:
            lat = np.asarray(self._latencies_ms, np.float64)
            submitted, completed = self._submitted, self._completed
            failed, lost = self._failed, self._lost
        waste_num = waste_den = 0.0
        for rep in worker_reports.values():
            ex = rep.get("executor") or {}
            calls = float(ex.get("calls", 0) or 0)
            frac = ((ex.get("waste") or {}).get("waste_fraction", 0.0)
                    or 0.0)
            waste_num += calls * float(frac)
            waste_den += calls
        workers = {}
        for ws in self.sup.states():
            workers[ws.name] = {
                "status": ws.status,
                "generation": ws.generation,
                "restarts": ws.restarts,
                "served": ws.served,
                "inflight": len(self.router.inflight.get(ws.name, ())),
            }
        return obs.renamed_keys({
            "submitted": submitted,
            "completed": completed,
            "failed": failed,
            "pending": self.router.pending(),
            "p50_ms": (float(np.percentile(lat, 50)) if len(lat) else 0.0),
            "p99_ms": (float(np.percentile(lat, 99)) if len(lat) else 0.0),
            "waste": (waste_num / waste_den) if waste_den else 0.0,
            "workers": workers,
            "worker_reports": worker_reports,
            "fleet": {
                "backend": self.cfg.backend,
                "live": len(self.sup.live()),
                "requests_lost": lost,
                "unrouted": len(self.router.unrouted),
                "lanes": {f"{b}/d{d}": owner for (b, d), owner
                          in self.router.lane_owner.items()},
            },
        }, {"latency_ms_p50": "p50_ms", "latency_ms_p99": "p99_ms"})


__all__ = ["FleetConfig", "ServingFleet"]

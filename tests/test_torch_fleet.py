"""Port parity: ``repro_torch.serve.fleet`` against ``repro.serve.fleet``.

Mirrors ``tests/test_fleet.py`` case for case on the port (workers with
``device="cpu"``), then holds the port to the reference: the router, the
autoscaler and the supervisor of both packages driven by the same scripted
events make the same decisions (picks, journal states, orphans, hedges,
unrouted parks, scale actions, straggler flags, dead workers), a thread
fleet of each package serves the same seeded numpy requests with results
within the reference test's ``rtol = atol = 1e-4`` of each other and of
``dense @ h``, and both expose the same public names, report keys and
``fleet_*`` metrics.  A ``KernelError`` raised in a worker fails exactly
its request, which is neither hedged nor re-routed.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

from repro import obs as j_obs
from repro.resilience import chaos as j_chaos
from repro.serve import fleet as j_fleet
from repro.serve.fleet import autoscale as j_autoscale
from repro.serve.fleet import router as j_router
from repro.serve.fleet import rpc as j_rpc
from repro.serve.fleet import supervisor as j_supervisor
from repro_torch import obs
from repro_torch.resilience import chaos
from repro_torch.resilience.chaos import FaultPlan, FaultSpec
from repro_torch.resilience.errors import (EngineClosedError, KernelError,
                                           WorkerLostError)
from repro_torch.serve import fleet as t_fleet
from repro_torch.serve.fleet import (AutoscaleConfig, Autoscaler,
                                     FleetConfig, ServingFleet,
                                     WorkerConfig)
from repro_torch.serve.fleet import autoscale as t_autoscale
from repro_torch.serve.fleet import router as t_router
from repro_torch.serve.fleet import rpc as t_rpc
from repro_torch.serve.fleet import supervisor as t_supervisor
from repro_torch.serve.fleet.router import Router
from repro_torch.serve.fleet.rpc import encode_request

TOL = dict(rtol=1e-4, atol=1e-4)
# the port's package and the reference's, each with its obs registry
PORT = dict(router=t_router, rpc=t_rpc, sup=t_supervisor,
            scale=t_autoscale, obs=obs)
REF = dict(router=j_router, rpc=j_rpc, sup=j_supervisor,
           scale=j_autoscale, obs=j_obs)


@pytest.fixture(autouse=True)
def _clean_obs_and_chaos():
    for o, c in ((obs, chaos), (j_obs, j_chaos)):
        o.reset()
        c.uninstall()
    yield
    for o, c in ((obs, chaos), (j_obs, j_chaos)):
        c.uninstall()
        o.reset()


def _graph(rng, n, d=4):
    dense = (rng.random((n, n)) < 0.15).astype(np.float32)
    h = rng.standard_normal((n, d)).astype(np.float32)
    return dense, h


def _counter_total(snap, name):
    return sum(snap["metrics"]["counters"].get(name, {}).values())


# ---------------------------------------------------------------------------
# Router unit tests (no engines, no workers)
# ---------------------------------------------------------------------------


class _FakeCarrier:
    def __init__(self, workers=("a", "b", "c")):
        self.live_workers = list(workers)
        self.sent = []
        self.fail_sends_to = set()

    def send(self, worker, msg):
        if worker in self.fail_sends_to:
            return False
        self.sent.append((worker, msg))
        return True

    def live(self):
        return list(self.live_workers)


def _router(carrier, pkg=PORT, **kw):
    return pkg["router"].Router(send=carrier.send, live=carrier.live,
                                lock=threading.RLock(), **kw)


class TestRouter:
    def _payload(self, rng, n=16, d=4):
        dense, h = _graph(rng, n, d)
        return encode_request(dense, h)

    def test_lane_sticky_round_robin(self, rng):
        carrier = _FakeCarrier()
        router = _router(carrier)
        p16 = self._payload(rng, 16)
        p32 = self._payload(rng, 32)
        e1 = router.admit(p16)
        router.dispatch(e1)
        e2 = router.admit(p32)
        router.dispatch(e2)
        assert e1.worker == "a" and e2.worker == "b"  # round-robin
        e3 = router.admit(self._payload(rng, 16))
        router.dispatch(e3)
        assert e3.worker == "a"  # sticky: same lane, same owner

    def test_journal_completes_exactly_once(self, rng):
        carrier = _FakeCarrier()
        router = _router(carrier)
        entry = router.admit(self._payload(rng))
        router.dispatch(entry)
        out = np.ones((16, 4), np.float32)
        first = router.complete(entry.rid, True, out, src=entry.worker)
        assert first is not None
        dup = router.complete(entry.rid, True, out * 2, src="b")
        assert dup is None
        assert np.array_equal(entry.future.result(0), out)
        snap = obs.snapshot()
        assert _counter_total(snap, "fleet_duplicate_results_total") == 1

    def test_failover_reroutes_orphans(self, rng):
        carrier = _FakeCarrier()
        router = _router(carrier)
        entries = [router.admit(self._payload(rng, 16)) for _ in range(3)]
        for e in entries:
            router.dispatch(e)
        owner = entries[0].worker
        assert all(e.worker == owner for e in entries)
        carrier.live_workers.remove(owner)
        orphans = router.orphans_of(owner)
        assert {o.rid for o in orphans} == {e.rid for e in entries}
        for o in orphans:
            assert router.dispatch(o, exclude=(owner,))
        assert all(e.worker != owner for e in entries)

    def test_unrouted_parks_without_workers(self, rng):
        carrier = _FakeCarrier(workers=())
        router = _router(carrier)
        entry = router.admit(self._payload(rng))
        assert not router.dispatch(entry)
        assert len(router.unrouted) == 1
        carrier.live_workers = ["a"]
        parked = router.take_unrouted()
        assert [e.rid for e in parked] == [entry.rid]
        assert router.dispatch(parked[0])
        assert entry.worker == "a"

    def test_hedge_first_wins_cancels_loser(self, rng):
        carrier = _FakeCarrier(workers=("a", "b"))
        router = _router(carrier)
        entry = router.admit(self._payload(rng))
        router.dispatch(entry)
        assert router.hedge(entry)
        assert entry.hedge_worker == "b"
        assert not router.hedge(entry)  # at most one hedge
        out = np.zeros((16, 4), np.float32)
        got = router.complete(entry.rid, True, out, src="b")
        assert got is not None
        _, loser = got
        assert loser == "a"  # the fleet sends ("cancel", rid) there

    def test_dead_send_falls_through_to_next_worker(self, rng):
        carrier = _FakeCarrier(workers=("a", "b"))
        carrier.fail_sends_to.add("a")
        router = _router(carrier)
        entry = router.admit(self._payload(rng))
        assert router.dispatch(entry)
        assert entry.worker == "b"

    def test_journal_gc_bounds_done_entries(self, rng):
        carrier = _FakeCarrier(workers=("a",))
        router = _router(carrier, keep_done=4)
        p = self._payload(rng)
        for _ in range(10):
            e = router.admit(p)
            router.dispatch(e)
            router.complete(e.rid, True, np.zeros(1), src="a")
        done = [e for e in router.journal.values() if e.done]
        assert len(done) <= 4


# ---------------------------------------------------------------------------
# Autoscaler decision logic (injected clock)
# ---------------------------------------------------------------------------


class TestAutoscaler:
    def _scaler(self, **kw):
        base = dict(enabled=True, min_workers=1, max_workers=3,
                    up_pending_per_worker=4.0,
                    down_pending_per_worker=0.5,
                    idle_grace_s=1.0, cooldown_s=2.0)
        base.update(kw)
        return Autoscaler(AutoscaleConfig(**base))

    def test_scale_up_on_backlog(self):
        s = self._scaler()
        assert s.decide(0.0, pending=20, live_workers=2) == "up"

    def test_cooldown_blocks_consecutive_actions(self):
        s = self._scaler()
        assert s.decide(0.0, pending=20, live_workers=1) == "up"
        assert s.decide(1.0, pending=20, live_workers=2) is None
        assert s.decide(2.5, pending=20, live_workers=2) == "up"

    def test_max_workers_caps_up(self):
        s = self._scaler()
        assert s.decide(0.0, pending=100, live_workers=3) is None

    def test_scale_down_needs_idle_grace(self):
        s = self._scaler()
        assert s.decide(0.0, pending=0, live_workers=2) is None
        assert s.decide(0.5, pending=0, live_workers=2) is None
        assert s.decide(1.5, pending=0, live_workers=2) == "down"

    def test_burst_resets_idle_grace(self):
        s = self._scaler()
        assert s.decide(0.0, pending=0, live_workers=2) is None
        assert s.decide(0.6, pending=3, live_workers=2) is None  # busy again
        assert s.decide(1.4, pending=0, live_workers=2) is None  # regrace
        assert s.decide(2.6, pending=0, live_workers=2) == "down"

    def test_min_workers_floors_down(self):
        s = self._scaler()
        assert s.decide(0.0, pending=0, live_workers=1) is None
        assert s.decide(5.0, pending=0, live_workers=1) is None

    def test_p99_trigger(self):
        s = self._scaler(up_p99_ms=100.0)
        assert s.decide(0.0, pending=1, live_workers=2,
                        p99_ms=250.0) == "up"


# ---------------------------------------------------------------------------
# Config-default hygiene (mutable dataclass defaults)
# ---------------------------------------------------------------------------


class TestConfigDefaults:
    def test_health_detectors_get_private_configs(self):
        from repro_torch.ft.health import Heartbeat, StragglerDetector
        d1, d2 = StragglerDetector(), StragglerDetector()
        assert d1.cfg is not d2.cfg
        d1.cfg.straggler_ratio = 99.0
        assert d2.cfg.straggler_ratio != 99.0
        h1, h2 = Heartbeat(), Heartbeat()
        assert h1.cfg is not h2.cfg

    def test_no_shared_mutable_dataclass_defaults(self):
        """Audit: a dataclass field whose default is a dataclass
        *instance* shares that instance across every config built with
        the default — only safe when the instance is frozen."""
        import repro_torch.ft.health
        import repro_torch.resilience.chaos
        import repro_torch.resilience.retry
        import repro_torch.serve.engine
        import repro_torch.serve.fleet.autoscale
        import repro_torch.serve.fleet.fleet
        import repro_torch.serve.fleet.worker
        import repro_torch.serve.runtime.continuous
        import repro_torch.serve.runtime.ladder
        mods = [repro_torch.serve.engine,
                repro_torch.serve.runtime.continuous,
                repro_torch.serve.runtime.ladder,
                repro_torch.resilience.retry,
                repro_torch.resilience.chaos, repro_torch.ft.health,
                repro_torch.serve.fleet.fleet,
                repro_torch.serve.fleet.worker,
                repro_torch.serve.fleet.autoscale]
        offenders = []
        for mod in mods:
            for obj in vars(mod).values():
                if not (isinstance(obj, type)
                        and dataclasses.is_dataclass(obj)
                        and obj.__module__ == mod.__name__):
                    continue
                for f in dataclasses.fields(obj):
                    default = f.default
                    if default is dataclasses.MISSING or default is None:
                        continue
                    if dataclasses.is_dataclass(default) \
                            and not isinstance(default, type) \
                            and not type(default).__dataclass_params__.frozen:
                        offenders.append(
                            f"{obj.__qualname__}.{f.name} shares a "
                            f"mutable {type(default).__name__} instance")
        assert not offenders, offenders


# ---------------------------------------------------------------------------
# Fleet integration (thread backend — deterministic, tier-1)
# ---------------------------------------------------------------------------


def _fleet(pkg=t_fleet, **kw):
    base = dict(backend="thread", workers=2, hedge_after_ms=10_000.0)
    if pkg is t_fleet:
        base["worker"] = WorkerConfig(device="cpu")
    base.update(kw)
    return pkg.ServingFleet(pkg.FleetConfig(**base))


class TestFleetServing:
    def test_serves_correct_results_and_reports(self, rng):
        fleet = _fleet(workers=2)
        try:
            assert fleet.wait_live(2, timeout=60)
            reqs = [_graph(rng, 16 + 8 * (i % 2)) for i in range(8)]
            futs = [fleet.submit(d, h) for d, h in reqs]
            outs = [f.result(timeout=60) for f in futs]
            for (dense, h), out in zip(reqs, outs):
                np.testing.assert_allclose(out, dense @ h, **TOL)
            rep = fleet.report()
            assert rep["completed"] == 8 and rep["failed"] == 0
            for key in ("p50_ms", "p99_ms", "waste", "workers", "fleet"):
                assert key in rep
            assert rep["fleet"]["requests_lost"] == 0
            served = sum(w["served"] for w in rep["workers"].values())
            assert served == 8
        finally:
            fleet.close()

    def test_fault_storm_kill_and_heartbeat_delay(self, rng):
        """Acceptance: kill 1 of 3 workers mid-batch + delay heartbeats
        → zero strands, outputs bit-identical to the fault-free run,
        the dead worker's in-flight completes on survivors exactly
        once, and no unexpected retraces."""
        reqs = [_graph(np.random.default_rng(100 + i), 16 + 8 * (i % 2))
                for i in range(24)]

        def run(plan):
            obs.reset()
            fleet = _fleet(workers=3, max_restarts_per_worker=2)
            try:
                assert fleet.wait_live(3, timeout=60)
                if plan is not None:
                    chaos.install(plan)
                futs = [fleet.submit(d, h) for d, h in reqs]
                outs = [f.result(timeout=120) for f in futs]
                rep = fleet.report()
            finally:
                chaos.uninstall()
                fleet.close()
            return outs, rep, obs.snapshot()

        base_outs, base_rep, _ = run(None)
        assert base_rep["completed"] == len(reqs)

        plan = FaultPlan([
            FaultSpec(site="fleet.worker", kind="kill_proc", at=3,
                      match={"worker": "w2", "phase": "dispatch"}),
            FaultSpec(site="fleet.heartbeat", kind="delay",
                      payload=0.04, at=4, times=3),
        ], seed=7)
        outs, rep, snap = run(plan)

        assert any(k == "kill_proc" for _, k, _ in plan.events)
        # zero strands: every future resolved with a result
        assert rep["completed"] == len(reqs)
        assert rep["failed"] == 0
        assert rep["fleet"]["requests_lost"] == 0
        # innocents AND the victim's re-routed in-flight: bit-identical
        for a, b in zip(base_outs, outs):
            assert np.array_equal(a, b)
        # the dead worker's in-flight moved to survivors (exactly once
        # is the journal's invariant — completed == submitted above)
        assert _counter_total(snap, "fleet_failovers_total") >= 1
        assert _counter_total(snap, "fleet_worker_deaths_total") >= 1
        # post-failover the executor cache is coherent: no unexpected
        # retraces anywhere in the fleet
        assert snap["sentry"]["unexpected_retraces"] == 0

    def test_hang_triggers_missed_heartbeat_restart(self, rng):
        from repro_torch.ft.health import HealthConfig
        fleet = _fleet(workers=2,
                       health=HealthConfig(heartbeat_timeout_s=0.2),
                       max_restarts_per_worker=2)
        try:
            assert fleet.wait_live(2, timeout=60)
            # one request to warm a lane (owned by w1)
            dense, h = _graph(rng, 16)
            fleet.infer(dense, h, timeout=60)
            chaos.install(FaultPlan([
                FaultSpec(site="fleet.worker", kind="hang", payload=30.0,
                          at=1, match={"worker": "w1",
                                       "phase": "monitor"}),
            ], seed=3))
            futs = [fleet.submit(*_graph(rng, 16)) for _ in range(6)]
            outs = [f.result(timeout=120) for f in futs]
            assert len(outs) == 6
            # the hang command is queued behind the requests, so w1 may
            # serve all six before it stops beating — the death is
            # guaranteed (the hang outlives the heartbeat timeout) but
            # asynchronous; poll for it
            deaths = {}
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                deaths = obs.snapshot()["metrics"]["counters"].get(
                    "fleet_worker_deaths_total", {})
                if deaths:
                    break
                time.sleep(0.02)
            assert any("heartbeat" in k or "killed" in k for k in deaths)
            assert fleet.report()["fleet"]["requests_lost"] == 0
        finally:
            chaos.uninstall()
            fleet.close()

    def test_blackholed_request_is_hedged(self, rng):
        fleet = _fleet(workers=2, hedge_after_ms=50.0)
        try:
            assert fleet.wait_live(2, timeout=60)
            dense, h = _graph(rng, 16)
            fleet.infer(dense, h, timeout=60)  # lane now owned by w1
            # blackhole the next request send to w1: claimed delivered,
            # never arrives — only hedging can complete it
            chaos.install(FaultPlan([
                FaultSpec(site="fleet.rpc", kind="hang", at=1,
                          match={"worker": "w1", "phase": "send"}),
            ], seed=5))
            out = fleet.infer(dense, h, timeout=60)
            np.testing.assert_allclose(out, dense @ h, **TOL)
            snap = obs.snapshot()
            assert _counter_total(snap, "fleet_hedges_total") >= 1
        finally:
            chaos.uninstall()
            fleet.close()

    def test_autoscale_up_then_down(self, rng):
        fleet = _fleet(
            workers=1,
            autoscale=AutoscaleConfig(
                enabled=True, min_workers=1, max_workers=2,
                up_pending_per_worker=2.0, down_pending_per_worker=0.5,
                idle_grace_s=0.1, cooldown_s=0.2))
        try:
            assert fleet.wait_live(1, timeout=60)
            futs = [fleet.submit(*_graph(rng, 16)) for _ in range(12)]
            deadline = time.monotonic() + 60
            while len(fleet.sup.live()) < 2:
                assert time.monotonic() < deadline, "no scale-up"
                time.sleep(0.01)
            for f in futs:
                f.result(timeout=120)
            deadline = time.monotonic() + 60
            while len(fleet.sup.live()) > 1:
                assert time.monotonic() < deadline, "no scale-down"
                time.sleep(0.01)
            snap = obs.snapshot()
            assert _counter_total(snap, "fleet_scale_ups_total") >= 1
            assert _counter_total(snap, "fleet_scale_downs_total") >= 1
            assert fleet.report()["fleet"]["requests_lost"] == 0
        finally:
            fleet.close()

    def test_rolling_restart_keeps_serving(self, rng):
        fleet = _fleet(workers=2)
        try:
            assert fleet.wait_live(2, timeout=60)
            reqs = [_graph(rng, 16) for _ in range(4)]
            for d, h in reqs:
                fleet.infer(d, h, timeout=60)
            old = {ws.name for ws in fleet.sup.states()}
            fleet.rolling_restart()
            assert fleet.wait_live(2, timeout=60)
            live = set(fleet.sup.live())
            assert live and live.isdisjoint(old)
            out = fleet.infer(*reqs[0], timeout=60)
            np.testing.assert_allclose(out, reqs[0][0] @ reqs[0][1], **TOL)
            assert fleet.report()["fleet"]["requests_lost"] == 0
        finally:
            fleet.close()

    def test_restart_budget_exhausted_fails_with_worker_lost(self, rng):
        fleet = _fleet(workers=1, max_restarts_per_worker=0)
        try:
            assert fleet.wait_live(1, timeout=60)
            chaos.install(FaultPlan([
                FaultSpec(site="fleet.worker", kind="kill_proc", at=1,
                          match={"worker": "w1", "phase": "dispatch"}),
            ], seed=1))
            fut = fleet.submit(*_graph(rng, 16))
            with pytest.raises(WorkerLostError):
                fut.result(timeout=30)
            snap = obs.snapshot()
            assert _counter_total(snap, "fleet_requests_lost_total") == 1
        finally:
            chaos.uninstall()
            fleet.close()


class TestFleetCloseDrain:
    def test_double_close_and_submit_after_close(self, rng):
        fleet = _fleet(workers=1)
        assert fleet.wait_live(1, timeout=60)
        dense, h = _graph(rng, 16)
        fut = fleet.submit(dense, h)
        fleet.close()
        fleet.close()  # idempotent
        assert fut.done() and fut.exception() is None
        with pytest.raises(EngineClosedError):
            fleet.submit(dense, h)

    def test_close_while_worker_mid_kill(self, rng):
        """close() racing a chaos kill: every future still resolves —
        with a result (failover) or a taxonomy error, never a hang."""
        fleet = _fleet(workers=2, max_restarts_per_worker=1)
        try:
            assert fleet.wait_live(2, timeout=60)
            chaos.install(FaultPlan([
                FaultSpec(site="fleet.worker", kind="kill_proc", at=2,
                          match={"phase": "dispatch"}),
            ], seed=11))
            futs = [fleet.submit(*_graph(rng, 16)) for _ in range(6)]
        finally:
            fleet.close(timeout=60)
            chaos.uninstall()
        for f in futs:
            assert f.done()
            exc = f.exception()
            assert exc is None or isinstance(
                exc, (EngineClosedError, WorkerLostError))

    def test_concurrent_close_races(self, rng):
        fleet = _fleet(workers=1)
        assert fleet.wait_live(1, timeout=60)
        fut = fleet.submit(*_graph(rng, 16))
        threads = [threading.Thread(target=fleet.close) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert fut.done()


# ---------------------------------------------------------------------------
# Process backend: real SIGKILL surface (spawned children, device="cpu")
# ---------------------------------------------------------------------------


class TestProcessBackend:
    def test_process_worker_serves(self, rng):
        fleet = _fleet(backend="process", workers=1)
        try:
            assert fleet.wait_live(1, timeout=120)
            dense, h = _graph(rng, 16)
            out = fleet.infer(dense, h, timeout=120)
            np.testing.assert_allclose(out, dense @ h, **TOL)
            assert isinstance(out, np.ndarray)
            assert fleet.report()["fleet"]["requests_lost"] == 0
        finally:
            fleet.close()

    def test_child_entry_imports_no_torch(self):
        """The spawned child's entry module imports only the standard
        library, so the child beats while torch imports (which can outlast
        the 5 s heartbeat deadline)."""
        import os
        import pathlib
        import subprocess
        import sys

        src = pathlib.Path(__file__).resolve().parents[1] / "src"
        code = ("import sys, repro_torch.serve.fleet_child as m; "
                "bad = sorted(x for x in sys.modules if x.split('.')[0] in "
                "('torch', 'numpy', 'jax', 'repro')); "
                "print(bad); sys.exit(1 if bad or not callable(m.main) "
                "else 0)")
        out = subprocess.run([sys.executable, "-c", code],
                             env=dict(os.environ, PYTHONPATH=str(src)),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr

    @pytest.mark.slow
    def test_process_worker_sigkill_failover(self, rng):
        fleet = _fleet(backend="process", workers=2,
                       max_restarts_per_worker=1)
        try:
            assert fleet.wait_live(2, timeout=180)
            reqs = [_graph(rng, 16) for _ in range(6)]
            # warm both lanes, then SIGKILL whichever worker owns the
            # next dispatch and require completion on the survivor
            fleet.infer(*reqs[0], timeout=120)
            chaos.install(FaultPlan([
                FaultSpec(site="fleet.worker", kind="kill_proc", at=2,
                          match={"phase": "dispatch"}),
            ], seed=2))
            futs = [fleet.submit(d, h) for d, h in reqs]
            outs = [f.result(timeout=180) for f in futs]
            assert len(outs) == len(reqs)
            snap = obs.snapshot()
            assert _counter_total(snap, "fleet_kills_total") >= 1
            assert fleet.report()["fleet"]["requests_lost"] == 0
        finally:
            chaos.uninstall()
            fleet.close()


# ---------------------------------------------------------------------------
# Parity with the reference: the same decisions for the same event scripts
# ---------------------------------------------------------------------------


def _router_script(pkg, payloads):
    """One scripted run of a router over fake carriers: admissions,
    dispatches, a failing send, a death with orphans, a hedge race, a
    park while no worker lives, journal GC and load rebalancing.
    Returns every decision, the final state and the fleet counters."""
    carrier = _FakeCarrier(workers=("a", "b", "c"))
    router = _router(carrier, pkg, rebalance_factor=1.5, keep_done=6)
    trace = []

    def admit_dispatch(i, exclude=()):
        e = router.admit(payloads[i])
        ok = router.dispatch(e, exclude=exclude)
        trace.append(("dispatch", e.rid, e.lane, ok, e.worker, e.attempts))
        return e

    entries = [admit_dispatch(i) for i in range(6)]
    carrier.fail_sends_to.add("b")
    entries += [admit_dispatch(i) for i in (6, 7, 1)]
    carrier.fail_sends_to.clear()
    # load piles onto one lane's owner until rebalancing moves the lane
    entries += [admit_dispatch(0) for _ in range(10)]
    trace.append(("inflight", {w: sorted(r) for w, r in
                               sorted(router.inflight.items())}))
    # a death: the owner's orphans go to the survivors
    dead = entries[0].worker
    carrier.live_workers.remove(dead)
    orphans = router.orphans_of(dead)
    trace.append(("orphans", dead, sorted(o.rid for o in orphans)))
    for o in sorted(orphans, key=lambda o: o.rid):
        trace.append(("redispatch", o.rid, router.dispatch(o,
                                                           exclude=(dead,)),
                      o.worker, o.attempts))
    # a hedge, the hedge winning, the duplicate dropped
    e = entries[3]
    trace.append(("hedge", e.rid, router.hedge(e), e.hedge_worker,
                  router.hedge(e)))
    win = router.complete(e.rid, True, np.zeros(1), src=e.hedge_worker)
    trace.append(("complete", e.rid, win[1] if win else None,
                  router.complete(e.rid, True, np.ones(1), src=e.worker)))
    # completions in a fixed order, one failure among them
    for x in entries[4:10]:
        got = router.complete(x.rid, x.rid % 3 != 0,
                              np.zeros(1) if x.rid % 3 else
                              ("TransientExecutorError", "boom"), src="a")
        trace.append(("complete", x.rid, got is not None))
    # nobody alive: park, then re-drive
    carrier.live_workers = []
    parked = admit_dispatch(2)
    trace.append(("unrouted", list(router.unrouted)))
    carrier.live_workers = ["c", "a"]
    trace.append(("redrive", [(x.rid, router.dispatch(x), x.worker)
                              for x in router.take_unrouted()]))
    trace.append(("hot", [pkg["rpc"].lane_key(p)
                          for p in router.hot_lanes(3)]))
    trace.append(("pending", router.pending(),
                  sorted(x.rid for x in router.pending_entries())))
    trace.append(("journal", sorted(
        (r, x.worker, x.hedge_worker, x.attempts, x.done, x.ok)
        for r, x in router.journal.items())))
    trace.append(("owners", sorted(router.lane_owner.items())))
    trace.append(("sent", [(w, m[0], m[1]) for w, m in carrier.sent]))
    trace.append(("parked", parked.rid, parked.worker))
    counters = {k: v for k, v in
                pkg["obs"].snapshot()["metrics"]["counters"].items()
                if k.startswith("fleet_")}
    return trace, counters


def test_router_decisions_match_reference():
    rng = np.random.default_rng(5)
    graphs = [_graph(rng, n, d) for n, d in
              ((16, 4), (32, 4), (16, 8), (48, 4), (64, 8), (20, 4),
               (100, 4), (33, 8))]
    port = _router_script(PORT, [t_rpc.encode_request(*g) for g in graphs])
    ref = _router_script(REF, [j_rpc.encode_request(*g) for g in graphs])
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[1]["fleet_rebalances_total"]  # the script rebalanced


@pytest.mark.parametrize("n,d", [(1, 1), (16, 4), (17, 8), (200, 8),
                                 (256, 3)])
def test_request_codec_matches_reference(n, d):
    """The same payload, lane and error round trip; the port takes
    tensors too (a ``SparseMatrix`` through ``to_dense``)."""
    import torch

    from repro_torch.sparse.matrix import SparseMatrix

    dense, h = _graph(np.random.default_rng(n), n, d)
    want = j_rpc.encode_request(dense, h, steps=2)
    for matrix, feats in ((dense, h), (torch.from_numpy(dense),
                                       torch.from_numpy(h)),
                          (SparseMatrix.from_dense(dense, block=(16, 16),
                                                   device="cpu"), h)):
        got = t_rpc.encode_request(matrix, feats, steps=2)
        assert got.keys() == want.keys() and got["steps"] == 2
        for k in ("dense", "h"):
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
        assert t_rpc.lane_key(got) == j_rpc.lane_key(want)
    mat, hh, steps = t_rpc.decode_request(got, block=(16, 16),
                                          device="cpu")
    assert mat.device.type == "cpu" and steps == 2
    np.testing.assert_array_equal(mat.to_dense(), dense)
    for exc in (ValueError("bad"), KeyError("k"), KernelError("launch")):
        pair = t_rpc.encode_error(exc)
        assert pair == j_rpc.encode_error(exc)
    # names the reference knows decode to the same class name; a kernel
    # failure keeps its class (the reference, without it, decodes it as
    # its safe retry class)
    for name in ("WorkerLostError", "PoisonRequestError", "RequestShedError",
                 "NoSuchError"):
        assert type(t_rpc.decode_error((name, "m"))).__name__ \
            == type(j_rpc.decode_error((name, "m"))).__name__
    assert isinstance(t_rpc.decode_error(("KernelError", "m")), KernelError)


@pytest.mark.parametrize("script", [
    [(0.0, 20, 2, None), (1.0, 20, 3, None), (2.5, 0, 3, None),
     (3.0, 0, 3, None), (4.6, 0, 3, None), (5.0, 0, 2, None)],
    [(0.0, 1, 2, 250.0), (1.0, 1, 2, 250.0), (2.1, 9, 1, None),
     (4.2, 0, 1, None), (4.3, 3, 2, 90.0), (6.0, 0, 2, None),
     (6.5, 0, 2, None), (7.2, 0, 2, None)],
    [(0.5 * i, (7 * i) % 23, 1 + i % 4, (50.0 * i) % 300)
     for i in range(40)],
])
def test_autoscaler_decisions_match_reference(script):
    cfgs = dict(enabled=True, min_workers=1, max_workers=4,
                up_pending_per_worker=4.0, up_p99_ms=200.0,
                down_pending_per_worker=0.5, idle_grace_s=1.0,
                cooldown_s=2.0)
    port = t_autoscale.Autoscaler(t_autoscale.AutoscaleConfig(**cfgs))
    ref = j_autoscale.Autoscaler(j_autoscale.AutoscaleConfig(**cfgs))
    got = [(port.decide(t, pending=p, live_workers=w, p99_ms=q),
            ref.decide(t, pending=p, live_workers=w, p99_ms=q))
           for t, p, w, q in script]
    assert [a for a, _ in got] == [b for _, b in got]
    assert any(a for a, _ in got)
    assert dataclasses.asdict(t_autoscale.AutoscaleConfig()) \
        == dataclasses.asdict(j_autoscale.AutoscaleConfig())


def _supervisor_script(pkg):
    """Registry, heartbeats at scripted times, stragglers, a death
    claimed by two racing observers, restarts until the budget is spent
    and deliberate transitions.  Returns every decision and gauge."""
    sup_mod = pkg["sup"]
    from_health = pkg["sup"].HealthConfig
    sup = sup_mod.FleetSupervisor(
        lock=threading.RLock(),
        health=from_health(heartbeat_timeout_s=0.5, window=16),
        max_restarts_per_worker=1)
    trace = []
    for name in ("w1", "w2", "w3"):
        sup.register(sup_mod.WorkerState(name=name))
        sup.hb.beat(name, now=0.0)
    for name in ("w1", "w2"):
        trace.append(("live?", name, sup.set_status(name, sup_mod.LIVE)))
    trace.append(("live", sup.live(), sorted(sup.counts().items())))
    sup.hb.beat("w1", now=0.4)
    sup.hb.beat("w3", now=0.45)
    trace.append(("hb_dead", sup.heartbeat_dead(now=0.6)))
    times = [0.010 + 0.001 * (i % 3) for i in range(12)] + [0.08, 0.011]
    for dt in times:
        trace.append(("svc", sup.note_service_time("w1", dt),
                      sup.note_service_time("w3", 0.02)))
    trace.append(("stragglers", sorted(sup.stragglers)))
    ws = sup.get("w1")
    first = sup.begin_death("w1", ws.generation)
    trace.append(("claim", first is ws,
                  sup.begin_death("w1", ws.generation),
                  ws.status, sorted(sup.stragglers)))
    trace.append(("may", sup.may_restart(ws)))
    gen = sup.finish_restart(ws, handle=None, pump=None)
    trace.append(("restart", gen, ws.restarts, ws.status,
                  sup.begin_death("w1", gen - 1)))
    trace.append(("stale_ready", sup.set_status("w1", sup_mod.LIVE,
                                                generation=gen - 1)))
    trace.append(("ready", sup.set_status("w1", sup_mod.LIVE,
                                          generation=gen)))
    sup.note_heartbeat("w1", gen - 1)  # a dead generation's beat: dropped
    trace.append(("beat_kept", "w1" in sup.hb.last))
    sup.begin_death("w1", gen)
    trace.append(("budget", sup.may_restart(ws)))
    sup.abandon_restart(ws)
    trace.append(("retire", sup.set_status("w3", sup_mod.RETIRED),
                  sup.set_status("w3", sup_mod.LIVE),
                  sup.heartbeat_dead(now=99.0)))
    trace.append(("final", [(w.name, w.status, w.generation, w.restarts)
                            for w in sup.states()],
                  sorted(sup.counts().items())))
    snap = pkg["obs"].snapshot()["metrics"]
    fleet = {kind: {k: v for k, v in snap[kind].items()
                    if k.startswith(("fleet_", "resilience_"))}
             for kind in ("counters", "gauges")}
    return trace, fleet


def test_supervisor_decisions_match_reference():
    port = _supervisor_script(PORT)
    ref = _supervisor_script(REF)
    assert port == ref
    assert ("stragglers", ["w1"]) in port[0]


def test_public_surface_matches_reference():
    assert sorted(t_fleet.__all__) == sorted(j_fleet.__all__)
    for name in t_fleet.__all__:
        assert hasattr(t_fleet, name)
    for port_mod, ref_mod in ((t_router, j_router), (t_rpc, j_rpc),
                              (t_supervisor, j_supervisor),
                              (t_autoscale, j_autoscale)):
        assert sorted(port_mod.__all__) == sorted(ref_mod.__all__)
    fields = {f.name for f in dataclasses.fields(WorkerConfig)}
    ref_fields = {f.name for f in dataclasses.fields(j_fleet.WorkerConfig)}
    assert fields - ref_fields == {"device"}
    assert WorkerConfig().device == "cuda"
    cfg = dataclasses.asdict(WorkerConfig())
    del cfg["device"]
    assert cfg == dataclasses.asdict(j_fleet.WorkerConfig())
    for backend in ("thread", "process"):
        assert dataclasses.asdict(t_fleet.FleetConfig(backend=backend)) \
            == {**dataclasses.asdict(j_fleet.FleetConfig(backend=backend)),
                "worker": dataclasses.asdict(WorkerConfig())}


def test_fleet_results_and_metrics_match_reference():
    """The same seeded requests through a 2-worker thread fleet of each
    package: results within 1e-4 of each other and of ``dense @ h``, the
    same lanes and owners, the same report keys and ``fleet_*`` metric
    names that every such run emits.  Owners are compared under the
    lane-sticky round-robin alone: no rebalance (a factor that 9 requests
    cannot reach) and no heartbeat death on a loaded host (a 30 s
    deadline), the two timing-driven moves of a lane."""
    from repro.ft.health import HealthConfig as JHealthConfig
    from repro_torch.ft.health import HealthConfig

    reqs = [_graph(np.random.default_rng(200 + i), 16 + 8 * (i % 3))
            for i in range(9)]
    runs = []
    for pkg, o, health in ((t_fleet, obs, HealthConfig),
                           (j_fleet, j_obs, JHealthConfig)):
        fleet = _fleet(pkg, workers=2, rebalance_factor=100.0,
                       health=health(heartbeat_timeout_s=30.0))
        try:
            assert fleet.wait_live(2, timeout=60)
            futs = [fleet.submit(d, h) for d, h in reqs]
            outs = [np.asarray(f.result(timeout=60)) for f in futs]
            rep = fleet.report()
        finally:
            fleet.close()
        metrics = o.snapshot()["metrics"]
        names = {kind: sorted(k for k in metrics[kind]
                              if k.startswith("fleet_"))
                 for kind in ("counters", "gauges", "histograms")}
        runs.append((outs, rep, names))
    (outs, rep, names), (j_outs, j_rep, j_names) = runs
    for (dense, h), a, b in zip(reqs, outs, j_outs):
        np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_allclose(a, dense @ h, **TOL)
    assert sorted(rep) == sorted(j_rep)
    assert sorted(rep["fleet"]) == sorted(j_rep["fleet"])
    assert rep["fleet"]["lanes"] == j_rep["fleet"]["lanes"]
    assert (rep["completed"], rep["failed"]) == (j_rep["completed"],
                                                 j_rep["failed"])
    assert {w: v["served"] for w, v in rep["workers"].items()} \
        == {w: v["served"] for w, v in j_rep["workers"].items()}
    # the metrics every fault-free run emits (the rest depend on timing:
    # stragglers, rebalances)
    for kind, must in (("counters", {"fleet_requests_total",
                                     "fleet_workers_spawned_total"}),
                       ("gauges", {"fleet_workers_live",
                                   "fleet_workers_total"}),
                       ("histograms", {"fleet_latency_ms"})):
        assert must <= set(names[kind]) and must <= set(j_names[kind])


def test_fleet_metric_names_match_reference():
    """Both packages name the same 22 ``fleet_*`` series (19 counters, 2
    gauges, 1 histogram) at the same kinds."""
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1] / "src"
    pattern = re.compile(r'obs\.(counter|gauge|histogram)\(\s*"(fleet_\w+)"')

    def names(pkg):
        return sorted({m.groups() for f in
                       sorted((root / pkg / "serve" / "fleet").glob("*.py"))
                       for m in pattern.finditer(f.read_text())})

    got = names("repro_torch")
    assert got == names("repro")
    assert len(got) == 22


# ---------------------------------------------------------------------------
# The device: no fallback, no tensor across the wire, no kernel retry
# ---------------------------------------------------------------------------


def test_worker_naming_cuda_without_a_card_raises(monkeypatch):
    import torch

    from repro_torch.serve.fleet.worker import FleetWorker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("continuous", "batch"):
        worker = FleetWorker(WorkerConfig(engine=engine, device="cuda"))
        with pytest.raises(RuntimeError, match="cuda"):
            worker._build_engine()


def test_worker_ships_host_arrays_and_plain_reports():
    import torch

    from repro_torch.serve.fleet.worker import _plain

    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    out = t_rpc.to_host(t)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, t.numpy())
    rep = _plain({"x": t, "dev": torch.device("cpu"),
                  "dt": torch.float32, "n": np.int64(3),
                  "a": (np.ones(2), [np.float32(1.5)])})
    assert rep == {"x": [[0.0, 1.0, 2.0], [3.0, 4.0, 5.0]], "dev": "cpu",
                   "dt": "torch.float32", "n": 3,
                   "a": [[1.0, 1.0], [1.5]]}


def test_kernel_error_fails_only_its_request(monkeypatch):
    """K1 raising ``KernelError`` in a worker (``form="ell"``): that one
    request fails with it, dispatched once, never hedged, re-routed or
    retried, its worker stays live; the next request is served.  The
    heartbeat deadline is far above the thread default (0.5 s), which a
    loaded host can miss: a restart then warms the hot lanes and runs K1
    twice more, which is not a retry; no worker may die here."""
    from repro_torch.ft.health import HealthConfig
    from repro_torch.kernels.spmm import kernel as k1

    rng = np.random.default_rng(3)
    bad = _graph(rng, 48)
    good = _graph(rng, 48)
    real = k1.spmm_blockell_ref
    calls = []

    def broken_once(*args, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise KernelError("K1 spmm_blockell: CUDA launch failed with "
                              "cudaError_t 700")
        return real(*args, **kw)

    monkeypatch.setattr(k1, "spmm_blockell_ref", broken_once)
    fleet = _fleet(workers=2, hedge_after_ms=100.0,
                   health=HealthConfig(heartbeat_timeout_s=30.0),
                   worker=WorkerConfig(device="cpu", form="ell"))
    try:
        assert fleet.wait_live(2, timeout=60)
        fut = fleet.submit(*bad)
        with pytest.raises(KernelError):
            fut.result(timeout=60)
        time.sleep(0.3)  # past the hedge age: a hedge would have gone out
        entry = fleet.router.journal[1]
        assert entry.done and not entry.ok
        assert entry.attempts == 1 and entry.hedge_worker is None
        snap = obs.snapshot()
        for name in ("fleet_hedges_total", "fleet_failovers_total",
                     "fleet_worker_deaths_total", "fleet_unrouted_total"):
            assert _counter_total(snap, name) == 0, name
        assert not {k for k in snap["metrics"]["counters"]
                    if k.startswith("resilience_")}
        np.testing.assert_allclose(fleet.infer(*good, timeout=60),
                                   good[0] @ good[1], **TOL)
        rep = fleet.report()
        assert rep["failed"] == 1 and rep["completed"] == 2
        assert rep["fleet"]["live"] == 2
        assert _counter_total(obs.snapshot(),
                              "fleet_worker_deaths_total") == 0
    finally:
        fleet.close()
    assert len(calls) == 2  # the failed launch was not retried

"""Port parity: ``repro_torch.resilience`` against ``repro.resilience``.

The same error taxonomy (``classify`` of every error class), the same
retry delays and fault schedules for the same seeds (both draw from numpy
generators), the same worker restarts, and the same ``obs`` counters for
each.  The serving engines (the engine-level cases of
``tests/test_resilience.py``) serve the same seeded requests under the same
fault plans with the same outcomes, counters and fault events."""
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro import resilience as j_res
from repro.resilience import chaos as j_chaos
from repro.serve import runtime as j_runtime
from repro.sparse import SparseMatrix as JSparseMatrix
from repro_torch import obs, resilience
from repro_torch.resilience import chaos
from repro_torch.serve import runtime as t_runtime
from repro_torch.sparse.matrix import SparseMatrix


@pytest.fixture(autouse=True)
def _clean():
    for o, c in ((obs, chaos), (j_obs, j_chaos)):
        o.reset()
        c.uninstall()
    yield
    for o, c in ((obs, chaos), (j_obs, j_chaos)):
        o.reset()
        c.uninstall()


def _counters(o):
    return o.snapshot()["metrics"]["counters"]


# every error class, built the same way in both packages
ERRORS = [
    ("PoisonRequestError", ()), ("NaNOutputError", ()),
    ("TransientExecutorError", ()), ("WorkerLostError", ()),
    ("RequestShedError", ()), ("DeadlineExceededError", ()),
    ("EngineClosedError", ()), ("ResilienceError", ()),
]
CHAOS_ERRORS = [("WorkerKilled", ("x",)), ("ProcessKillRequested", ("x",)),
                ("WorkerHangRequested", ("x", 1.0))]
BUILTINS = [ValueError("v"), TypeError("t"), KeyboardInterrupt(),
            SystemExit(1), RuntimeError("r"), TimeoutError("t"),
            ZeroDivisionError(), MemoryError()]


@pytest.mark.parametrize("name,args", ERRORS + CHAOS_ERRORS,
                         ids=[n for n, _ in ERRORS + CHAOS_ERRORS])
def test_classify_matches_reference(name, args):
    mod, jmod = (chaos, j_chaos) if (name, args) in CHAOS_ERRORS \
        else (resilience.errors, j_res.errors)
    got = resilience.classify(getattr(mod, name)(*args))
    assert got == j_res.classify(getattr(jmod, name)(*args))
    assert [c.__name__ for c in getattr(mod, name).__mro__] \
        == [c.__name__ for c in getattr(jmod, name).__mro__]


@pytest.mark.parametrize("exc", BUILTINS, ids=lambda e: type(e).__name__)
def test_classify_builtins_matches_reference(exc):
    assert resilience.classify(exc) == j_res.classify(exc)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kw", [{}, dict(base_ms=2.0, jitter=0.0),
                                dict(max_attempts=6, multiplier=3.0,
                                     max_ms=20.0, jitter=0.9)],
                         ids=["default", "no-jitter", "steep"])
def test_retry_policy_delays_match_reference(seed, kw):
    pol, jpol = resilience.RetryPolicy(**kw), j_res.RetryPolicy(**kw)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    got = [pol.backoff_s(a, rng) for a in range(1, 10)]
    assert got == [jpol.backoff_s(a, jrng) for a in range(1, 10)]
    assert [pol.allows(a) for a in range(8)] \
        == [jpol.allows(a) for a in range(8)]


@pytest.mark.parametrize("failures", [0, 2, 5])
def test_call_with_retry_matches_reference(failures):
    def run(res, errors, o):
        left = [failures]
        sleeps = []

        def fn():
            if left[0]:
                left[0] -= 1
                raise errors.TransientExecutorError("flaky")
            return "ok"

        try:
            out = res.call_with_retry(
                fn, policy=res.RetryPolicy(max_attempts=4), site="s",
                rng=np.random.default_rng(3), sleep=sleeps.append,
                budget=res.RetryBudget(capacity=10, refill_per_s=0.0))
        except errors.TransientExecutorError:
            out = "raised"
        return out, sleeps, _counters(o)

    assert run(resilience, resilience.errors, obs) \
        == run(j_res, j_res.errors, j_obs)


def test_poison_is_not_retried_and_budget_fails_fast():
    for res in (resilience, j_res):
        calls = []

        def poison():
            calls.append(1)
            raise res.PoisonRequestError("bad")

        with pytest.raises(res.PoisonRequestError):
            res.call_with_retry(poison, sleep=lambda s: None)
        assert len(calls) == 1
        budget = res.RetryBudget(capacity=1, refill_per_s=0.0)
        assert budget.spend() and not budget.spend()
        assert budget.remaining() == 0.0


def _plan(c):
    return c.FaultPlan([
        c.FaultSpec(site="executor.execute", kind=c.RAISE, at=2, times=2),
        c.FaultSpec(site="serve.flush", kind=c.POISON, match={"tags": "t1"}),
        c.FaultSpec(site="train.step", kind=c.DELAY, p=0.4, payload=0.0),
        c.FaultSpec(site="executor.output", kind=c.NAN, at=1, times=None,
                    payload=(1, 0)),
    ], seed=11)


def _fire(c, plan, out_value):
    outcome = []
    with c.active(plan):
        for i in range(6):
            for site, ctx in (("executor.execute", {}),
                              ("serve.flush", {"tags": ["t0", f"t{i % 3}"]}),
                              ("train.step", {"step": i})):
                try:
                    c.hook(site, **ctx)
                    outcome.append((site, "ok"))
                except Exception as exc:  # the injected faults
                    outcome.append((site, type(exc).__name__))
        value = c.corrupt("executor.output", out_value)
    return outcome, list(plan.events), value


def test_fault_plan_fires_as_reference():
    got, events, value = _fire(chaos, _plan(chaos), torch.ones(3, 2))
    want, jevents, jvalue = _fire(j_chaos, _plan(j_chaos), np.ones((3, 2)))
    assert got == want and events == jevents
    np.testing.assert_array_equal(value.numpy(), np.asarray(jvalue))
    assert torch.isnan(value[1, 0]) and not torch.isnan(value[0, 0])
    assert _counters(obs) == _counters(j_obs)
    assert chaos.active_plan() is None  # disarmed after the block


def test_corrupt_does_not_touch_the_input_and_disarmed_is_identity():
    x = torch.ones(2, 2)
    assert chaos.corrupt("executor.output", x) is x
    plan = chaos.FaultPlan([chaos.FaultSpec(site="s", kind=chaos.NAN,
                                            payload="all")])
    with chaos.active(plan):
        y = chaos.corrupt("s", x)
    assert torch.isnan(y).all() and not torch.isnan(x).any()
    with pytest.raises(ValueError):
        chaos.FaultSpec(site="s", kind="nope")


@pytest.mark.parametrize("max_restarts", [0, 2])
def test_worker_supervisor_restarts_as_reference(max_restarts):
    def run(res, o):
        sup = res.WorkerSupervisor("w", lambda: None,
                                   max_restarts=max_restarts)
        assert sup.ensure() is False  # not started: foreground mode
        sup.start()
        seen = []
        for _ in range(max_restarts + 2):
            sup.join(timeout=10)
            assert not sup.alive()
            seen.append((sup.ensure(), sup.restarts, sup.generation))
        stale = sup.ensure(observed_generation=0)
        sup.join(timeout=10)
        return seen, stale, _counters(o)

    assert run(resilience, obs) == run(j_res, j_obs)


def test_worker_supervisor_restarts_once_under_a_race():
    release = threading.Event()
    sup = resilience.WorkerSupervisor("race", release.wait, max_restarts=5)
    sup.start()
    release.set()
    sup.join(timeout=10)
    gen = sup.generation
    threads = [threading.Thread(target=sup.ensure, args=(gen,))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sup.restarts == 1 and sup.generation == gen + 1
    sup.join(timeout=10)


# ---------------------------------------------------------------------------
# The serving engines under chaos (the engine-level cases of
# tests/test_resilience.py): both packages serve the same seeded requests
# under the same fault plan, with the same outcomes and the same counters.
# ---------------------------------------------------------------------------

BLOCK = (16, 16)
D = 8
TOL = dict(rtol=2e-4, atol=2e-4)


class _Pkg:
    """One package's side of a chaos run."""

    def __init__(self, port: bool):
        self.port = port
        self.obs, self.chaos, self.res = (obs, chaos, resilience) if port \
            else (j_obs, j_chaos, j_res)
        self.runtime = t_runtime if port else j_runtime

    def matrix(self, dense):
        if self.port:
            return SparseMatrix.from_dense(dense, formats=("ell", "csr"),
                                           block=BLOCK, device="cpu")
        return JSparseMatrix.from_dense(dense, formats=("ell", "csr"),
                                        block=BLOCK)

    def feats(self, h):
        return h if self.port else jnp.asarray(h)

    def cfg(self, **kw):
        kw.setdefault("slots", 4)
        kw.setdefault("adaptive", False)
        kw.setdefault("max_wait_ms", 0.0)
        kw.setdefault("retry", self.res.RetryPolicy(max_attempts=3,
                                                    base_ms=0.1, max_ms=1.0))
        if self.port:
            kw.setdefault("device", "cpu")
        return self.runtime.ContinuousConfig(**kw)

    def plan(self, *specs, seed=0):
        return self.chaos.FaultPlan(
            [self.chaos.FaultSpec(**s) for s in specs], seed=seed)


PKGS = (_Pkg(True), _Pkg(False))


def _graph(rng, n: int):
    dense = np.where(rng.random((n, n)) < 0.1, rng.normal(size=(n, n)),
                     0.0).astype(np.float32)
    if not dense.any():
        dense[0, 0] = 1.0
    return dense


def _resilience_counters(o):
    return {k: v for k, v in _counters(o).items()
            if k.startswith(("resilience_", "chaos_"))}


def _outcome(fut):
    """A future's outcome: ("ok", result) or the error's class name."""
    exc = fut.exception(timeout=60)
    return ("ok", fut.result()) if exc is None else (type(exc).__name__,
                                                     None)


def _same_outcomes(runs, refs=None):
    """Both packages resolved every future alike (results within TOL of
    each other and of ``refs``), with the same counters and events."""
    (outs, counters, events, rep), (jouts, jcounters, jevents, jrep) = runs
    assert [k for k, _ in outs] == [k for k, _ in jouts]
    for i, ((k, y), (_, jy)) in enumerate(zip(outs, jouts)):
        if k == "ok":
            np.testing.assert_allclose(y, np.asarray(jy), **TOL)
            if refs is not None:
                np.testing.assert_allclose(y, refs[i], **TOL)
    assert counters == jcounters
    assert events == jevents
    assert rep == jrep
    return outs, counters


def _continuous_run(pkg, rng_seed, specs, sizes, tags=(), seed=0, cfg=None,
                    submit_kw=None, drive=None, one_graph=False):
    """Serve ``sizes`` graphs (``one_graph``: the first one each time, so
    all share a lane) through one package's continuous engine under the
    fault plan; returns outcomes, counters, events and the report's
    resilience and completion fields."""
    pkg.obs.reset()
    rng = np.random.default_rng(rng_seed)
    plan = pkg.plan(*specs, seed=seed)
    dense = _graph(rng, sizes[0])
    with pkg.chaos.active(plan), pkg.runtime.ContinuousBatchEngine(
            cfg=pkg.cfg(**(cfg or {}))) as eng:
        futs = []
        for i, n in enumerate(sizes):
            if i and not one_graph:
                dense = _graph(rng, n)
            h = rng.normal(size=(n, D)).astype(np.float32)
            kw = dict((submit_kw or {}).get(i, {}))
            if i < len(tags) and tags[i] is not None:
                kw["tag"] = tags[i]
            futs.append(eng.submit(pkg.matrix(dense), pkg.feats(h), **kw))
        (drive or (lambda e, f: e.drain(timeout=120)))(eng, futs)
        rep = eng.report()
    outs = [_outcome(f) for f in futs]
    return (outs, _resilience_counters(pkg.obs), list(plan.events),
            {k: rep[k] for k in ("submitted", "completed", "failed",
                                 "pending")}
            | {k: v for k, v in rep["resilience"].items()
               if k != "retry_tokens"})


def _refs(rng_seed, sizes):
    rng = np.random.default_rng(rng_seed)
    dense = _graph(rng, sizes[0])
    out = []
    for i, n in enumerate(sizes):
        if i:
            dense = _graph(rng, n)
        out.append(dense @ rng.normal(size=(n, D)).astype(np.float32))
    return out


def test_continuous_poison_bisection_quarantines_only_culprit():
    specs = [dict(site="continuous.execute", kind="poison", times=None,
                  match={"tags": "bad"})]
    runs = [_continuous_run(p, 3, specs, (48,) * 4,
                            tags=(None, None, "bad", None)) for p in PKGS]
    outs, counters = _same_outcomes(runs, _refs(3, (48,) * 4))
    assert [k for k, _ in outs] == ["ok", "ok", "PoisonRequestError", "ok"]
    assert sum(counters["resilience_quarantined_total"].values()) == 1


def test_continuous_transient_fault_retries_and_succeeds():
    specs = [dict(site="continuous.execute", kind="raise", at=1, times=1)]
    runs = [_continuous_run(p, 4, specs, (48,)) for p in PKGS]
    outs, counters = _same_outcomes(runs, _refs(4, (48,)))
    assert outs[0][0] == "ok"
    assert sum(counters["resilience_retries_total"].values()) >= 1


def test_continuous_retries_exhausted_fails_structured():
    specs = [dict(site="continuous.execute", kind="raise", times=None,
                  match={"tags": "cursed"})]
    runs = [_continuous_run(p, 5, specs, (48,), tags=("cursed",),
                            cfg=dict(form="csr")) for p in PKGS]
    outs, _ = _same_outcomes(runs)
    assert outs[0][0] == "TransientExecutorError"


def test_continuous_nan_output_quarantined():
    specs = [dict(site="continuous.output", kind="nan", payload=(0, 0))]
    runs = [_continuous_run(p, 6, specs, (48, 48)) for p in PKGS]
    outs, counters = _same_outcomes(runs)
    assert outs[0][0] == "NaNOutputError"
    assert counters["resilience_quarantined_total"] == {"kind=nan": 1}


def test_continuous_latency_spike_is_survived():
    specs = [dict(site="continuous.execute", kind="delay", payload=0.02,
                  times=2)]
    runs = [_continuous_run(p, 7, specs, (48,)) for p in PKGS]
    outs, _ = _same_outcomes(runs, _refs(7, (48,)))
    assert runs[0][2] == [("continuous.execute", "delay", 1)]


def test_continuous_queued_deadline_expires():
    def drive(eng, futs):
        while not futs[0].done():
            eng.step(force=True)
        futs[1].exception(timeout=10)

    runs = [_continuous_run(p, 8, [], (48, 48), cfg=dict(slots=1),
                            submit_kw={1: dict(deadline_ms=0.0)},
                            drive=drive, one_graph=True) for p in PKGS]
    outs, counters = _same_outcomes(runs)
    assert [k for k, _ in outs] == ["ok", "DeadlineExceededError"]
    assert counters["resilience_shed_total"] == {"reason=deadline": 1}


def test_continuous_queue_overflow_sheds_lowest_priority():
    runs = [_continuous_run(p, 9, [], (48, 48, 48),
                            cfg=dict(slots=1, queue_depth=1),
                            submit_kw={0: dict(priority=1),
                                       1: dict(priority=1),
                                       2: dict(priority=0)},
                            one_graph=True) for p in PKGS]
    outs, counters = _same_outcomes(runs)
    assert [k for k, _ in outs] == ["ok", "ok", "RequestShedError"]
    assert counters["resilience_shed_total"] == {"reason=queue_full": 1}


def test_continuous_degraded_form_rebuilds_lane_on_survivor():
    """A form that keeps failing transiently degrades; the lane rebuilds
    on the surviving form and the request completes."""
    forms = []
    for p in PKGS:
        rng = np.random.default_rng(10)
        dense = _graph(rng, 48)
        h = rng.normal(size=(48, D)).astype(np.float32)
        with p.runtime.ContinuousBatchEngine(cfg=p.cfg()) as probe:
            probe.infer(p.matrix(dense), p.feats(h))
            forms.append(next(iter(probe.report()["lanes"].values()))["form"])
    assert forms[0] == forms[1]
    specs = [dict(site="continuous.execute", kind="raise", times=None,
                  match={"form": forms[0]})]
    runs = [_continuous_run(p, 10, specs, (48,)) for p in PKGS]
    outs, counters = _same_outcomes(runs, _refs(10, (48,)))
    assert outs[0][0] == "ok"
    assert sum(counters["resilience_degraded_total"].values()) == 1
    assert counters["resilience_recoveries_total"]["site=lane_rebuild"] == 1


def test_continuous_fault_storm_strands_nothing():
    specs = [dict(site="continuous.execute", kind="poison", times=None,
                  match={"tags": "p0"}),
             dict(site="continuous.execute", kind="poison", times=None,
                  match={"tags": "p1"}),
             dict(site="continuous.execute", kind="raise", at=4, times=2),
             dict(site="continuous.execute", kind="delay", payload=0.005,
                  at=8, times=3)]
    sizes = tuple(48 if i % 3 else 80 for i in range(20))
    tags = tuple({3: "p0", 11: "p1"}.get(i) for i in range(20))
    runs = [_continuous_run(p, 11, specs, sizes, tags=tags, seed=7)
            for p in PKGS]
    outs, counters = _same_outcomes(runs, _refs(11, sizes))
    assert [i for i, (k, _) in enumerate(outs) if k != "ok"] == [3, 11]
    assert runs[0][3]["completed"] == 20 and runs[0][3]["pending"] == 0
    assert sum(counters["chaos_faults_total"].values()) >= 4


def test_continuous_worker_death_restarts():
    def run(p):
        p.obs.reset()
        rng = np.random.default_rng(12)
        dense = _graph(rng, 48)
        h = rng.normal(size=(48, D)).astype(np.float32)
        plan = p.plan(dict(site="continuous.worker", kind="die", at=1,
                           times=1))
        with p.chaos.active(plan), p.runtime.ContinuousBatchEngine(
                cfg=p.cfg(background=True, max_wait_ms=0.5)) as eng:
            deadline = time.monotonic() + 10
            while eng._sup.alive() and time.monotonic() < deadline:
                time.sleep(0.005)  # the first loop iteration dies
            y = eng.infer(p.matrix(dense), p.feats(h), timeout=30.0)
            restarts = eng.report()["resilience"]["worker_restarts"]
        np.testing.assert_allclose(y, dense @ h, **TOL)
        return restarts, _resilience_counters(p.obs)

    assert run(PKGS[0]) == run(PKGS[1])
    assert run(PKGS[0])[0] == 1


def test_continuous_close_paths_resolve_everything():
    for p in PKGS:
        rng = np.random.default_rng(13)
        mat = p.matrix(_graph(rng, 24))
        h = p.feats(rng.standard_normal((24, D)).astype(np.float32))
        eng = p.runtime.ContinuousBatchEngine(cfg=p.cfg())
        fut = eng.submit(mat, h)
        eng.close()
        eng.close()  # idempotent
        assert fut.done() and fut.exception() is None
        with pytest.raises(p.res.EngineClosedError):
            eng.submit(mat, h)
        # concurrent closers while submissions race
        eng = p.runtime.ContinuousBatchEngine(cfg=p.cfg(background=True))
        futs = [eng.submit(mat, h) for _ in range(4)]
        closers = [threading.Thread(target=eng.close) for _ in range(3)]
        for t in closers:
            t.start()
        for _ in range(8):
            try:
                futs.append(eng.submit(mat, h))
            except p.res.EngineClosedError:
                break
        for t in closers:
            t.join(timeout=30.0)
        assert all(f.done() for f in futs)
        # close while the stepping worker keeps dying
        eng = p.runtime.ContinuousBatchEngine(cfg=p.cfg(background=True))
        with p.chaos.active(p.plan(dict(site="continuous.worker",
                                        kind="die", at=1, times=None))):
            futs = [eng.submit(mat, h) for _ in range(4)]
            eng.close()
        assert all(f.done() for f in futs)


def test_repack_crash_leaves_old_overlay_serving():
    def run(p):
        p.obs.reset()
        rng = np.random.default_rng(14)
        dense = _graph(rng, 64)
        kw = dict(form="csr", slack=0.5)
        dg = (p.runtime.DeltaGraph(dense, device="cpu", **kw) if p.port
              else p.runtime.DeltaGraph(dense, **kw))
        with p.chaos.active(p.plan(dict(site="delta.repack",
                                        kind="raise"))):
            assert dg.maybe_repack_async(low_water=1.0)
            assert not dg.poll_repack(timeout=30.0)
        r, c = np.nonzero(dense)
        dg.delete(int(r[0]), int(c[0]))
        dense[r[0], c[0]] = 0
        np.testing.assert_array_equal(np.asarray(
            dg.matrix.to_dense() if p.port else dg.matrix.densify()), dense)
        return dg.report(), _resilience_counters(p.obs)

    assert run(PKGS[0]) == run(PKGS[1])


# -- the micro-batching engine ------------------------------------------------


@pytest.fixture(scope="module")
def gcn_setup():
    import jax

    from repro.configs.paper_gnn import SMOKE_CONFIG as JCFG
    from repro.models.gnn import build_graph as j_build_graph
    from repro.models.gnn import init_gcn as j_init_gcn
    from repro_torch.configs.paper_gnn import SMOKE_CONFIG as GCFG
    from repro_torch.data.pipeline import random_graph
    from repro_torch.models.gnn import build_graph, gcn_params_from_numpy

    jparams = j_init_gcn(jax.random.PRNGKey(0), JCFG)
    params = gcn_params_from_numpy(
        {k: [np.asarray(x) for x in v] for k, v in jparams.items()}, "cpu")
    adjs = [random_graph(n, avg_degree=4, seed=n) for n in (48, 80)]
    return {True: (GCFG, params, [build_graph(a, GCFG, device="cpu")
                                  for a in adjs]),
            False: (JCFG, jparams, [j_build_graph(a, JCFG) for a in adjs])}


def _batch_engine(p, setup, **kw):
    from repro.serve.engine import BatchServeConfig as JConfig
    from repro.serve.engine import BatchServingEngine as JEngine
    from repro_torch.serve.engine import BatchServeConfig, BatchServingEngine

    _, params, _ = setup[p.port]
    if p.port:
        return BatchServingEngine.for_gcn(
            params, scfg=BatchServeConfig(device="cpu", **kw))
    return JEngine.for_gcn(params, scfg=JConfig(**kw))


def test_batch_engine_worker_death_restarts(gcn_setup):
    def run(p):
        p.obs.reset()
        cfg, _, graphs = gcn_setup[p.port]
        plan = p.plan(dict(site="serve.worker", kind="die", at=1, times=1))
        with p.chaos.active(plan), _batch_engine(
                p, gcn_setup, max_batch=4, max_delay_ms=1.0) as eng:
            deadline = time.monotonic() + 10
            while eng._sup.alive() and time.monotonic() < deadline:
                time.sleep(0.005)  # the first loop iteration dies
            x = np.zeros((graphs[0].n_nodes, cfg.in_features), np.float32)
            y = eng.infer(graphs[0], p.feats(x))
            assert y.shape == (graphs[0].n_nodes, cfg.n_classes)
            restarts = eng.report()["resilience"]["worker_restarts"]
        return restarts, _resilience_counters(p.obs)

    assert run(PKGS[0]) == run(PKGS[1])
    assert run(PKGS[0])[0] == 1


def test_batch_engine_poison_bisection(gcn_setup):
    def run(p):
        p.obs.reset()
        cfg, _, graphs = gcn_setup[p.port]
        plan = p.plan(dict(site="serve.flush", kind="poison", times=None,
                           match={"tags": "bad"}))
        retry = p.res.RetryPolicy(max_attempts=3, base_ms=0.1, max_ms=1.0)
        with p.chaos.active(plan), _batch_engine(
                p, gcn_setup, max_batch=4, max_delay_ms=200.0,
                retry=retry) as eng:
            g = graphs[0]
            x = p.feats(np.zeros((g.n_nodes, cfg.in_features), np.float32))
            futs = [eng.submit(g, x, tag="bad" if i == 1 else None)
                    for i in range(4)]
            eng.drain(timeout=60)
            quarantined = eng.report()["resilience"]["quarantined"]
        return ([type(f.exception()).__name__ if f.exception() else
                 f.result().shape for f in futs], quarantined,
                _resilience_counters(p.obs), list(plan.events))

    got = run(PKGS[0])
    assert got == run(PKGS[1])
    assert got[0][1] == "PoisonRequestError" and got[1] == 1


def test_batch_engine_infer_timeout(gcn_setup):
    for p in PKGS:
        cfg, _, graphs = gcn_setup[p.port]
        plan = p.plan(dict(site="serve.worker", kind="die", times=None))
        with p.chaos.active(plan), _batch_engine(
                p, gcn_setup, max_batch=2, max_delay_ms=1.0,
                max_worker_restarts=0) as eng:
            time.sleep(0.05)
            x = np.zeros((graphs[0].n_nodes, cfg.in_features), np.float32)
            with pytest.raises(p.res.DeadlineExceededError):
                eng.infer(graphs[0], p.feats(x), timeout=0.3)


def test_batch_engine_close_paths_resolve_everything(gcn_setup):
    for p in PKGS:
        cfg, _, graphs = gcn_setup[p.port]
        eng = _batch_engine(p, gcn_setup, max_batch=4, max_delay_ms=1.0)
        x = p.feats(np.zeros((graphs[0].n_nodes, cfg.in_features),
                             np.float32))
        fut = eng.submit(graphs[0], x)
        eng.close()
        eng.close()  # idempotent
        assert fut.done() and fut.exception() is None
        with pytest.raises(p.res.EngineClosedError):
            eng.submit(graphs[0], x)
        eng = _batch_engine(p, gcn_setup, max_batch=4, max_delay_ms=1.0)
        futs = [eng.submit(g, p.feats(np.zeros(
            (g.n_nodes, cfg.in_features), np.float32)))
            for g in graphs for _ in range(2)]
        closers = [threading.Thread(target=eng.close) for _ in range(3)]
        for t in closers:
            t.start()
        for t in closers:
            t.join(timeout=30.0)
        assert all(f.done() for f in futs)


# ---------------------------------------------------------------------------
# A kernel fault is never retried and never routed around (port only: the
# reference has no hand-written kernel to fail).  On the card the same
# case runs through K1's real launch check (tests/test_torch_cuda.py).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["batch", "continuous"])
def test_kernel_error_fails_the_request_and_keeps_ell_in_service(
        monkeypatch, engine):
    """A 48-node graph at density 0.3 on 16 x 16 blocks, for which
    ``form="auto"`` plans ell: while K1 raises ``KernelError`` every
    request fails with it, more times than ``degrade_after``, and no
    retry, degrade or quarantine happens; the next request is served on
    ell again."""
    from repro_torch.kernels.spmm import kernel as k1
    from repro_torch.resilience.errors import KernelError
    from repro_torch.serve.engine import BatchServeConfig, BatchServingEngine

    rng = np.random.default_rng(3)
    dense = np.where(rng.random((48, 48)) < 0.3, rng.normal(size=(48, 48)),
                     0.0).astype(np.float32)
    m = SparseMatrix.from_dense(dense, formats=("ell", "csr"), block=BLOCK,
                                device="cpu")
    h = rng.normal(size=(48, D)).astype(np.float32)

    def broken(*args, **kw):
        raise KernelError("K1 spmm_blockell: CUDA launch failed with "
                          "cudaError_t 700")

    eng = BatchServingEngine(scfg=BatchServeConfig(
        device="cpu", max_batch=2, max_delay_ms=0.0)) if engine == "batch" \
        else t_runtime.ContinuousBatchEngine(cfg=PKGS[0].cfg())
    with eng:
        real = k1.spmm_blockell_ref
        monkeypatch.setattr(k1, "spmm_blockell_ref", broken)
        for _ in range(eng.executor.degrade_after + 1):
            with pytest.raises(KernelError):
                eng.infer(m, h)
        monkeypatch.setattr(k1, "spmm_blockell_ref", real)
        np.testing.assert_allclose(eng.infer(m, h), dense @ h, **TOL)
        assert not eng.executor._degraded
        assert {p.path for p in eng.executor._bucket_plans.values()} \
            == {"ell"}
        failed = eng.report()["failed"]
    assert failed == eng.executor.degrade_after + 1
    assert _resilience_counters(obs) == {}

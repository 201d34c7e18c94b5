"""Port parity: ``repro_torch.obs`` against ``repro.obs``.

The same call sequences against both packages give the same
``snapshot()`` (spans by count and schema, not by time), the same
Prometheus and JSON-lines text apart from times, and the same sentry
lanes and events; ``instrumented_jit`` counts the compiles ``jax.jit``
would make for the same sequence of input shapes; and the port's
dispatcher and plan memo feed the same counters as the reference's.
"""
import json
import re
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as j_obs
from repro.dispatch import dispatcher as j_dispatcher
from repro.sparse import SparseMatrix as JSparseMatrix
from repro.sparse import matmul as j_matmul
from repro.sparse import plan as j_plan
from repro_torch import obs
from repro_torch.dispatch import dispatcher
from repro_torch.sparse import plan
from repro_torch.sparse.matrix import SparseMatrix
from repro_torch.sparse.ops import matmul

BLOCK = (16, 16)


@pytest.fixture(autouse=True)
def _fresh_obs():
    """Every test sees empty process-wide instruments in both packages,
    with the port's span ring on (the reference's always records)."""
    obs.reset()
    j_obs.reset()
    obs.TRACER.enable()
    yield
    obs.TRACER.disable()
    obs.reset()
    j_obs.reset()


def _drive(o):
    """One call sequence through every instrument of an ``obs`` package."""
    o.counter("reqs", engine="a").inc()
    o.counter("reqs", engine="a").inc(4)
    o.counter("reqs", engine="b").inc()
    o.counter("odd name-x", route="spmm/ell").inc(2)
    o.gauge("depth").set(3.5)
    o.gauge("depth").dec(1.0)
    o.gauge("queue", lane="0").inc(2.0)
    for v in (1.0, 2.0, 3.0, 4.0, 10.0):
        o.histogram("lat_ms", route="x").observe(v)
    with o.span("serve.flush", bucket=4):
        with o.span("serve.compose"):
            pass
        with o.span("serve.execute", lane="l0"):
            pass
    with o.span("train.step", step=1):
        pass
    o.SENTRY.record_call("lane-a")
    o.SENTRY.record_compile("lane-a")
    o.SENTRY.record_call("lane-a")
    o.SENTRY.record_compile("lane-a", note="shape drift")
    o.SENTRY.forget("lane-b")
    o.SENTRY.record_compile("lane-b")
    for _ in range(3):
        o.AUDIT.record_raw(op="spmm", path="csr", measured_ms=5.0,
                           bucket="b0", costs={"csr": 1.0, "ell": 2.0},
                           policy="auto")
        o.AUDIT.record_raw(op="spmm", path="ell", measured_ms=1.0,
                           bucket="b0", costs={"csr": 1.0, "ell": 2.0,
                                               "dense": float("inf")},
                           policy="auto")


def _untimed(snap):
    """A snapshot with the span-duration series reduced to their counts
    and schema (their values are times)."""
    snap = json.loads(json.dumps(snap))
    hists = snap["metrics"]["histograms"]
    for label, summ in hists.pop("span_ms", {}).items():
        hists.setdefault("span_ms", {})[label] = (summ["count"],
                                                  sorted(summ))
    snap["spans"] = {name: (row["count"], sorted(row))
                     for name, row in snap["spans"].items()}
    return snap


def test_snapshot_matches_reference():
    _drive(obs)
    _drive(j_obs)
    got, want = obs.snapshot(), j_obs.snapshot()
    assert sorted(got) == sorted(want) \
        == ["audit", "metrics", "sentry", "spans"]
    assert _untimed(got) == _untimed(want)
    assert got["sentry"]["unexpected_retraces"] == 1
    assert len(got["audit"]["mispredictions"]) == 1


_TIMES = re.compile(r"^(span_ms\S*) \S+$", re.M)


def test_prometheus_and_jsonl_match_reference_apart_from_times():
    _drive(obs)
    _drive(j_obs)
    prom, jprom = obs.to_prometheus(), j_obs.to_prometheus()
    assert _TIMES.sub(r"\1 T", prom) == _TIMES.sub(r"\1 T", jprom)
    assert 'reqs{engine="a"} 5' in prom
    assert "odd_name_x" in prom

    def untimed(line):
        rec = json.loads(line)
        if rec.get("name") == "span_ms" or "span_id" in rec:
            return sorted(rec)  # a span record or a span-time series
        return rec

    got = [untimed(ln) for ln in obs.to_jsonl().splitlines()]
    want = [untimed(ln) for ln in j_obs.to_jsonl().splitlines()]
    assert got == want


def test_span_parentage_matches_reference():
    _drive(obs)
    _drive(j_obs)

    def tree(o):
        spans = o.TRACER.spans()
        by_id = {s.span_id: s.name for s in spans}
        return [(s.name, by_id.get(s.parent_id), tuple(sorted(s.tags)))
                for s in spans]

    assert tree(obs) == tree(j_obs)


def test_sentry_lanes_and_events_match_reference():
    _drive(obs)
    _drive(j_obs)
    assert obs.SENTRY.lanes() == j_obs.SENTRY.lanes()
    assert [e.as_dict() for e in obs.SENTRY.events()] \
        == [e.as_dict() for e in j_obs.SENTRY.events()]
    assert obs.SENTRY.unexpected("lane-a") == 1


@pytest.mark.parametrize("shapes", [
    [(4,), (4,), (8,)],
    [(4,), (8,), (4,), (8,), (8, 2)],
    [(3, 5)] * 5,
], ids=["drift", "alternating", "steady"])
def test_instrumented_jit_counts_match_reference(shapes):
    sen = obs.RetraceSentry(registry=obs.MetricsRegistry(), warmup=1)
    jsen = j_obs.RetraceSentry(registry=j_obs.MetricsRegistry(), warmup=1)
    fn = obs.instrumented_jit(lambda x: x * 2, "lane-j", sentry=sen)
    jfn = j_obs.instrumented_jit(lambda x: x * 2, "lane-j", sentry=jsen)
    for shape in shapes:
        np.testing.assert_array_equal(fn(torch.ones(shape)).numpy(),
                                      np.asarray(jfn(jnp.ones(shape))))
    assert sen.report() == jsen.report()
    assert sen.registry.snapshot() == jsen.registry.snapshot()


def test_instrumented_jit_signature_is_shape_dtype_and_other_args():
    sen = obs.RetraceSentry(warmup=1)
    fn = obs.instrumented_jit(lambda x, scale=1: x * scale, "lane",
                              sentry=sen)
    fn(torch.ones(4))
    fn(torch.zeros(4))                       # same signature: no compile
    fn(torch.ones(4, dtype=torch.float64))   # dtype: a compile
    fn(torch.ones(4), scale=2)               # another argument: a compile
    assert sen.report()["compiles"] == 3 and sen.report()["calls"] == 4


def test_default_sentry_is_the_process_one():
    fn = obs.instrumented_jit(lambda x: x + 1, "lane-default")
    fn(torch.ones(2))
    assert obs.snapshot()["sentry"]["lanes"]["lane-default"] == {
        "compiles": 1, "calls": 1, "budget": 1}


def test_registry_rejects_negative_and_kind_conflict_as_reference():
    for o in (obs, j_obs):
        reg = o.MetricsRegistry()
        reg.counter("x").inc()
        with pytest.raises(ValueError):
            reg.counter("x").inc(-1)
        with pytest.raises(ValueError):
            reg.gauge("x")


def test_registry_thread_safety():
    reg = obs.MetricsRegistry()

    def work():
        for _ in range(1000):
            reg.counter("n").inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert reg.value("n") == 8000


def test_renamed_keys_match_reference():
    for o in (obs, j_obs):
        rep = o.renamed_keys({"p50_ms": 1.0}, {"p50": "p50_ms"})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert rep["p50"] == 1.0 and "p50" in rep
        assert caught and caught[0].category is DeprecationWarning
        assert json.dumps(rep) == '{"p50_ms": 1.0}'
        with pytest.raises(KeyError):
            o.renamed_keys({"a": 1}, {"old": "missing"})


def test_stats_bucket_matches_reference():
    from repro.dispatch.stats import MatrixStats as JMatrixStats
    from repro_torch.dispatch.stats import MatrixStats

    rng = np.random.default_rng(3)
    r, c = rng.integers(0, 100, 300), rng.integers(0, 100, 300)
    for shape in ((100, 100), (120, 120), (1000, 40)):
        assert obs.stats_bucket(MatrixStats.from_coords(shape, r, c)) \
            == j_obs.stats_bucket(JMatrixStats.from_coords(shape, r, c))
    assert obs.stats_bucket(None) == j_obs.stats_bucket(None)


# ---------------------------------------------------------------------------
# The wiring into the dispatcher and the plan memo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["auto", "ell", "csr"])
def test_planned_spmm_counters_match_reference(policy):
    rng = np.random.default_rng(0)
    a = np.where(rng.random((48, 48)) < 0.1, rng.normal(size=(48, 48)),
                 0.0).astype(np.float32)
    h = rng.normal(size=(48, 8)).astype(np.float32)
    mat = SparseMatrix.from_dense(a, formats=("ell", "csr"), block=BLOCK,
                                  device="cpu")
    jmat = JSparseMatrix.from_dense(a, formats=("ell", "csr"), block=BLOCK)
    for _ in range(2):  # a miss, then a hit
        matmul(mat, torch.from_numpy(h), policy=policy)
        j_matmul(jmat, jnp.asarray(h), policy=policy)
    got = obs.snapshot()["metrics"]["counters"]
    assert got == j_obs.snapshot()["metrics"]["counters"]
    assert got["plan_cache_hits_total"] == {"": 1}
    assert got["plan_cache_misses_total"] == {"": 1}
    assert sum(got["dispatch_plans_total"].values()) == 2


def test_plan_cache_stats_reset_as_reference():
    for p in (plan, j_plan):
        p.reset_plan_cache_stats()
        cache = p.PlanCache()
        cache.get("k")
        cache.put("k", "plan")
        cache.get("k")
        assert p.plan_cache_stats() == {"hits": 1, "misses": 1}
        p.reset_plan_cache_stats()
        assert p.plan_cache_stats() == {"hits": 0, "misses": 0}
    assert obs.snapshot()["metrics"]["counters"] \
        == j_obs.snapshot()["metrics"]["counters"]


def test_dispatch_log_capacity_as_reference():
    # the reference's Plan also records whether Pallas ran interpreted
    extra = {dispatcher: {}, j_dispatcher: {"interpret": False}}
    for d in (dispatcher, j_dispatcher):
        old = d.log_capacity()
        try:
            d.clear_log()
            for i in range(5):
                d.record_plan(d.Plan(op="spmm", path="ell", policy="auto",
                                     reason=f"r{i}", use_kernel=False,
                                     **extra[d]))
            d.set_log_capacity(3)
            assert d.log_capacity() == 3
            assert [p.reason for p in d.dispatch_log()] == ["r2", "r3",
                                                            "r4"]
            with pytest.raises(ValueError):
                d.set_log_capacity(0)
        finally:
            d.set_log_capacity(old)
            d.clear_log()
        assert d.log_capacity() == old
    assert obs.snapshot()["metrics"]["counters"] \
        == j_obs.snapshot()["metrics"]["counters"]


# ---------------------------------------------------------------------------
# The serving stack's reports and instruments (the engine cases of
# tests/test_obs.py), on the same traffic in both packages
# ---------------------------------------------------------------------------

D = 8


def _requests(rng, sizes):
    """The same graphs and features for both packages."""
    mats, jmats, hs = [], [], []
    for n in sizes:
        dense = np.where(rng.random((n, n)) < 0.1, rng.normal(size=(n, n)),
                         0.0).astype(np.float32)
        mats.append(SparseMatrix.from_dense(dense, formats=("ell", "csr"),
                                            block=BLOCK, device="cpu"))
        jmats.append(JSparseMatrix.from_dense(dense, formats=("ell", "csr"),
                                              block=BLOCK))
        hs.append(rng.normal(size=(n, D)).astype(np.float32))
    return mats, jmats, hs


def _serve_counters(o):
    """The counters a serving run feeds, apart from the plan log's (the
    reference plans once per jit trace, the port once per call), with each
    lane's executor id dropped (ids count the executors a process made)."""
    return {k: {re.sub(r"lane=x\d+/", "lane=x/", label): n
                for label, n in v.items()}
            for k, v in o.snapshot()["metrics"]["counters"].items()
            if not k.startswith(("dispatch_plans", "plan_cache"))}


def test_executor_report_schema(rng):
    from repro.batch.executor import BucketedExecutor as JExecutor
    from repro_torch.batch.executor import BucketedExecutor

    mats, jmats, hs = _requests(rng, (32, 48))
    ex, jex = BucketedExecutor(policy="csr"), JExecutor(policy="csr")
    ex.run(mats, hs)
    jex.run(jmats, [jnp.asarray(h) for h in hs])
    rep, jrep = ex.report(), jex.report()
    assert set(rep) == set(jrep)
    assert {"requests", "calls", "compiles", "executors_cached",
            "evictions", "buckets", "waste"} <= set(rep)
    assert rep["waste"] == jrep["waste"]
    with pytest.warns(DeprecationWarning):
        assert rep["padding"] is rep["waste"]
    assert _serve_counters(obs) == _serve_counters(j_obs)
    assert obs.SENTRY.report()["compiles"] \
        == j_obs.SENTRY.report()["compiles"] == ex.compiles


def test_engine_reports_use_canonical_latency_keys(rng):
    from repro_torch.serve.engine import BatchServeConfig, BatchServingEngine
    from repro_torch.serve.runtime import (ContinuousBatchEngine,
                                           ContinuousConfig)

    mats, _, hs = _requests(rng, (32, 48, 32))
    with BatchServingEngine(scfg=BatchServeConfig(
            max_batch=4, adaptive=True, device="cpu")) as eng:
        futs = [eng.submit(m, h) for m, h in zip(mats, hs)]
        eng.drain()
        [f.result(timeout=60) for f in futs]
        rep = eng.report()
    assert {"completed", "p50_ms", "p99_ms", "executor"} <= set(rep)
    with pytest.warns(DeprecationWarning):
        assert rep["latency_ms_p50"] == rep["p50_ms"]

    with ContinuousBatchEngine(cfg=ContinuousConfig(
            slots=2, adaptive=False, max_wait_ms=0.0,
            device="cpu")) as ceng:
        futs = [ceng.submit(m, h) for m, h in zip(mats, hs)]
        ceng.drain()
        [f.result(timeout=60) for f in futs]
        rep = ceng.report()
    assert {"submitted", "completed", "p50_ms", "p99_ms", "lanes",
            "executor"} <= set(rep)
    with pytest.warns(DeprecationWarning):
        assert rep["latency_ms_p99"] == rep["p99_ms"]


def test_ladder_and_delta_report_schemas(rng):
    from repro.serve.runtime import AdaptiveBucketLadder as JLadder
    from repro.serve.runtime import DeltaGraph as JDeltaGraph
    from repro_torch.serve.runtime import AdaptiveBucketLadder, DeltaGraph

    mats, jmats, _ = _requests(rng, (32,))
    lad, jlad = AdaptiveBucketLadder(), JLadder()
    lad.observe(mats[0].stats)
    jlad.observe(jmats[0].stats)
    assert lad.report() == jlad.report()
    assert {"fitted", "observed", "refits", "drift_checks", "last_drift",
            "fallbacks", "snapped_rungs", "rungs"} <= set(lad.report())
    assert obs.REGISTRY.total("ladder_observed_total") == 1

    dense = mats[0].to_dense()
    dg, jdg = DeltaGraph(dense, form="csr", device="cpu"), \
        JDeltaGraph(dense, form="csr")
    r, c = np.nonzero(dense)
    for g in (dg, jdg):
        g.delete(int(r[0]), int(c[0]))
    assert dg.report() == jdg.report()
    assert {"form", "live_nnz", "capacity", "free_slots", "deltas_applied",
            "repacks", "stats_invalidations",
            "background_repack_running"} <= set(dg.report())
    assert obs.REGISTRY.value("graph_deltas_total", op="delete") == 1
    assert _serve_counters(obs) == _serve_counters(j_obs)


def test_single_adaptive_run_populates_snapshot(rng):
    from repro_torch.serve.engine import BatchServeConfig, BatchServingEngine

    with BatchServingEngine(scfg=BatchServeConfig(
            max_batch=4, adaptive=True, device="cpu")) as eng:
        mats, _, hs = _requests(rng, (32, 48, 64, 32, 48, 32, 96, 64))
        futs = [eng.submit(m, h) for m, h in zip(mats, hs)]
        eng.drain(timeout=120.0)
        [f.result(timeout=60) for f in futs]

    snap = obs.snapshot()
    counters = snap["metrics"]["counters"]
    assert sum(counters["dispatch_plans_total"].values()) > 0
    assert sum(counters["executor_compiles_total"].values()) > 0
    assert sum(counters["executor_calls_total"].values()) > 0
    assert counters["padding_rows_padded_total"][""] \
        >= counters["padding_rows_real_total"][""] > 0
    assert sum(counters["ladder_observed_total"].values()) == 8
    lat = snap["metrics"]["histograms"]["serve_latency_ms"]["engine=batch"]
    assert lat["count"] == 8 and lat["p50"] > 0
    assert {"serve.admit", "serve.bucket", "serve.flush", "serve.compose",
            "serve.execute", "serve.complete"} <= set(snap["spans"])
    rows = snap["audit"]["rows"]
    assert rows and all(r["op"] == "spmm" and r["measured_ms"] > 0
                        for r in rows)
    assert any(r["predicted"] is not None for r in rows)
    assert snap["sentry"]["unexpected_retraces"] == 0
    assert snap["sentry"]["compiles"] > 0


def test_injected_shape_drift_flags_unexpected_retrace(rng):
    from repro_torch.batch.executor import BucketedExecutor

    ex = BucketedExecutor(policy="csr")
    mats, _, hs = _requests(rng, (32, 32))
    ex.run(mats, hs)
    assert obs.SENTRY.report()["unexpected_retraces"] == 0
    key = next(iter(ex._executors))
    exe = ex.executor_for(key)
    # a drifted shape through the cached lane executor is a new signature
    # past the lane's warmup: the sentry flags it
    m = _requests(rng, (2 * key.bucket.rows,))[0][0]
    exe(m, torch.from_numpy(rng.normal(size=(m.shape[1], D))
                            .astype(np.float32)))
    rep = obs.SENTRY.report()
    assert rep["unexpected_retraces"] == 1
    assert rep["events"][0]["lane"] == ex.lane_label(key)
    assert obs.REGISTRY.value("unexpected_retrace_total",
                              lane=ex.lane_label(key)) == 1


def test_steady_state_continuous_run_is_retrace_free(rng):
    from repro.serve.runtime import ContinuousBatchEngine as JEngine
    from repro.serve.runtime import ContinuousConfig as JConfig
    from repro_torch.serve.runtime import (ContinuousBatchEngine,
                                           ContinuousConfig)

    kw = dict(slots=2, adaptive=False, max_wait_ms=0.0)
    with ContinuousBatchEngine(cfg=ContinuousConfig(device="cpu", **kw)) \
            as eng, JEngine(cfg=JConfig(**kw)) as jeng:
        for _ in range(4):       # same shapes, wave after wave
            mats, jmats, hs = _requests(rng, (48, 48, 80, 80))
            futs = [eng.submit(m, h) for m, h in zip(mats, hs)]
            jfuts = [jeng.submit(m, jnp.asarray(h))
                     for m, h in zip(jmats, hs)]
            eng.drain(timeout=120.0)
            jeng.drain(timeout=120.0)
            for f, jf in zip(futs, jfuts):
                np.testing.assert_allclose(f.result(timeout=60),
                                           jf.result(timeout=60),
                                           rtol=2e-4, atol=2e-4)
    rep, jrep = obs.SENTRY.report(), j_obs.SENTRY.report()
    assert rep["calls"] > rep["compiles"] > 0
    assert rep["unexpected_retraces"] == 0
    assert (rep["calls"], rep["compiles"]) \
        == (jrep["calls"], jrep["compiles"])

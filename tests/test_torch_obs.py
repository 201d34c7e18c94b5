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
    """Every test sees empty process-wide instruments in both packages."""
    obs.reset()
    j_obs.reset()
    yield
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

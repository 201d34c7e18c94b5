"""Port parity: ``repro_torch.serve.runtime`` (the bucket ladder and the
continuous batching engine) against ``repro.serve.runtime`` (mirrors
``tests/test_runtime.py``).

The ladder is numpy only: on the same observed stream the port's rungs,
reports and buckets equal the reference's exactly.  The continuous engine
serves the same seeded graphs as the reference's: outputs within the
reference tests' f32 tolerance (rtol = atol = 2e-4, multi-step 5e-4),
the same compiles, lanes, steps, occupancy and waste ledger.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.batch.bucketing import DEFAULT_BUCKETING as J_DEFAULT_BUCKETING
from repro.batch.bucketing import bucket_for as j_bucket_for
from repro.dispatch.stats import MatrixStats as JMatrixStats
from repro.serve import runtime as jr
from repro.sparse import SparseMatrix as JSparseMatrix
from repro_torch.batch.bucketing import DEFAULT_BUCKETING, bucket_for
from repro_torch.dispatch.stats import MatrixStats
from repro_torch.serve import runtime as tr
from repro_torch.sparse.matrix import SparseMatrix

BLOCK = (16, 16)
D = 8
TOL = dict(rtol=2e-4, atol=2e-4)


def _stats(n: int, nnz: int, pkg=MatrixStats) -> MatrixStats:
    rng = np.random.default_rng(nnz)
    r = rng.integers(0, n, size=nnz)
    c = rng.integers(0, n, size=nnz)
    return pkg.from_coords((n, n), r, c, *BLOCK)


def _both(n: int, nnz: int):
    return _stats(n, nnz), _stats(n, nnz, JMatrixStats)


def _ladders(**kw):
    return (tr.AdaptiveBucketLadder(tr.LadderConfig(**kw)),
            jr.AdaptiveBucketLadder(jr.LadderConfig(**kw)))


def _observe(lads, n, nnz, times=1):
    s, js = _both(n, nnz)
    for _ in range(times):
        lads[0].observe(s)
        lads[1].observe(js)
    return s, js


def _same(lads, n=None, nnz=None):
    assert lads[0].report() == lads[1].report()
    assert lads[0].rungs() == lads[1].rungs()
    if n is not None:
        s, js = _both(n, nnz)
        assert dataclasses.asdict(lads[0].bucket_for(s)) \
            == dataclasses.asdict(lads[1].bucket_for(js))


def _graph(rng, n: int, sparsity: float = 0.9):
    dense = np.where(rng.random((n, n)) < (1.0 - sparsity),
                     rng.normal(size=(n, n)), 0.0).astype(np.float32)
    if not dense.any():
        dense[0, 0] = 1.0
    return (dense,
            SparseMatrix.from_dense(dense, formats=("ell", "csr"),
                                    block=BLOCK, device="cpu"),
            JSparseMatrix.from_dense(dense, formats=("ell", "csr"),
                                     block=BLOCK))


# ---------------------------------------------------------------------------
# AdaptiveBucketLadder
# ---------------------------------------------------------------------------


def test_ladder_prefit_serves_geometric_fallback():
    lads = _ladders(min_fit=16)
    s, js = _both(100, 400)
    assert not lads[0].fitted
    got, want = lads[0].bucket_for(s), lads[1].bucket_for(js)
    assert got == bucket_for(s, DEFAULT_BUCKETING)
    assert dataclasses.asdict(got) == dataclasses.asdict(want) \
        == dataclasses.asdict(j_bucket_for(js, J_DEFAULT_BUCKETING))
    _same(lads)
    assert lads[0].report()["fallbacks"] == 1


def test_ladder_parks_rungs_on_hot_shapes():
    lads = _ladders(min_fit=8, n_rungs=4)
    hot, _ = _observe(lads, 100, 400, times=12)
    assert lads[0].fitted
    b = lads[0].bucket_for(hot)
    assert b.rows == 112  # 100 rounded up to the 16-block
    assert b.rows <= bucket_for(hot, DEFAULT_BUCKETING).rows
    assert b.nnz >= hot.nnz
    _same(lads, 100, 400)


def test_ladder_never_truncates_above_top_rung():
    lads = _ladders(min_fit=8)
    _observe(lads, 64, 200, times=10)
    big, _ = _both(500, 3000)
    b = lads[0].bucket_for(big)
    assert b.rows >= 500 and b.nnz >= big.nnz and b.rows % BLOCK[0] == 0
    _same(lads, 500, 3000)


def test_ladder_refits_on_drift_and_snaps_stable_rungs():
    lads = _ladders(min_fit=8, refit_interval=8, window=64,
                    drift_threshold=0.1)
    _observe(lads, 64, 200, times=16)
    fits0 = lads[0].refits
    assert fits0 >= 1
    _observe(lads, 64, 200, times=16)
    assert lads[0].refits == fits0
    _same(lads)
    _observe(lads, 512, 4000, times=64)
    rep = lads[0].report()
    assert rep["refits"] > fits0 and rep["drift_checks"] >= 1
    assert lads[0].bucket_for(_both(512, 4000)[0]).rows == 512
    _same(lads, 512, 4000)
    before = rep["snapped_rungs"]
    for lad in lads:
        lad.refit()
    assert lads[0].report()["snapped_rungs"] > before
    _same(lads)


def test_ladder_forced_refit():
    lads = _ladders(min_fit=1024)
    _observe(lads, 96, 300)
    assert not lads[0].fitted
    for lad in lads:
        lad.refit()
    assert lads[0].fitted
    _same(lads, 96, 300)


# ---------------------------------------------------------------------------
# ContinuousBatchEngine
# ---------------------------------------------------------------------------


def _cfg(pkg=tr, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("adaptive", False)
    kw.setdefault("max_wait_ms", 0.0)  # tests step deterministically
    if pkg is tr:
        kw.setdefault("device", "cpu")
    return pkg.ContinuousConfig(**kw)


def _engines(**kw):
    return (tr.ContinuousBatchEngine(cfg=_cfg(tr, **kw)),
            jr.ContinuousBatchEngine(cfg=_cfg(jr, **kw)))


def _same_reports(eng, jeng):
    rep, jrep = eng.report(), jeng.report()
    for key in ("submitted", "completed", "failed", "pending"):
        assert rep[key] == jrep[key], key
    assert {k: {f: v for f, v in lane.items()}
            for k, lane in rep["lanes"].items()} == jrep["lanes"]
    for key in ("requests", "calls", "compiles", "executors_cached",
                "buckets", "waste"):
        assert rep["executor"][key] == jrep["executor"][key], key
    return rep


def test_continuous_parity_and_trace_pin(rng):
    eng, jeng = _engines()
    with eng, jeng:
        futs, jfuts, refs = [], [], []
        for n in (48, 48, 80, 48, 80, 48, 80, 48):
            dense, mat, jmat = _graph(rng, n)
            h = rng.normal(size=(n, D)).astype(np.float32)
            futs.append(eng.submit(mat, h))
            jfuts.append(jeng.submit(jmat, jnp.asarray(h)))
            refs.append(dense @ h)
        eng.drain()
        jeng.drain()
        for f, jf, ref in zip(futs, jfuts, refs):
            np.testing.assert_allclose(f.result(), ref, **TOL)
            np.testing.assert_allclose(f.result(), jf.result(), **TOL)
        rep = _same_reports(eng, jeng)
        # occupancy is data, not shape: exactly one compile per lane
        assert rep["executor"]["compiles"] == len(rep["lanes"])
        assert rep["completed"] == 8 and rep["failed"] == 0


def test_continuous_slot_recycling_and_occupancy(rng):
    with tr.ContinuousBatchEngine(cfg=_cfg(slots=2)) as eng:
        dense, mat, _ = _graph(rng, 48)
        h = rng.normal(size=(48, D)).astype(np.float32)
        futs = [eng.submit(mat, h) for _ in range(7)]
        lane = next(iter(eng._lanes.values()))
        assert lane.occupancy == 2 and len(lane.queue) == 5
        assert eng.step(force=True) == 2
        assert lane.occupancy == 2 and len(lane.queue) == 3
        eng.drain()
        assert all(f.done() for f in futs)
        (lane_rep,) = eng.report()["lanes"].values()
        assert lane_rep["steps"] == 4            # ceil(7 / 2)
        assert lane_rep["occupancy"] == pytest.approx(7 / 8)


def test_continuous_multistep_propagation(rng):
    eng, jeng = _engines()
    with eng, jeng:
        dense, mat, jmat = _graph(rng, 48)
        h = rng.normal(size=(48, D)).astype(np.float32)
        y = eng.infer(mat, h, steps=3)
        ref = dense @ (dense @ (dense @ h))
        np.testing.assert_allclose(y, ref, rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(y, jeng.infer(jmat, jnp.asarray(h),
                                                 steps=3),
                                   rtol=5e-4, atol=5e-4)


def test_continuous_batching_window_holds_partial_lanes(rng):
    with tr.ContinuousBatchEngine(cfg=_cfg(max_wait_ms=60_000.0)) as eng:
        _, mat, _ = _graph(rng, 48)
        fut = eng.submit(mat, rng.normal(size=(48, D)).astype(np.float32))
        assert eng.step() == 0
        assert eng.step(force=True) == 1
        assert fut.done()


def test_continuous_close_resolves_everything(rng):
    eng = tr.ContinuousBatchEngine(cfg=_cfg())
    dense, mat, _ = _graph(rng, 48)
    h = rng.normal(size=(48, D)).astype(np.float32)
    futs = [eng.submit(mat, h) for _ in range(6)]
    eng.close()
    for f in futs:
        np.testing.assert_allclose(f.result(timeout=1.0), dense @ h, **TOL)
    with pytest.raises(RuntimeError):
        eng.submit(mat, h)


def test_continuous_rejects_stat_less_and_mismatched(rng):
    with tr.ContinuousBatchEngine(cfg=_cfg()) as eng:
        _, mat, _ = _graph(rng, 48)
        with pytest.raises(ValueError):
            eng.submit(mat, np.zeros((40, D), np.float32))
        with pytest.raises(ValueError):
            eng.submit(mat, np.zeros((48, D), np.float32), steps=0)
        stat_less = SparseMatrix({"csr": mat.form("csr")}, mat.shape, None)
        with pytest.raises(ValueError, match="stats"):
            eng.submit(stat_less, np.zeros((48, D), np.float32))


def test_continuous_adaptive_ladder_feeds_executor(rng):
    from repro_torch.serve.runtime import LadderConfig

    cfg = _cfg(adaptive=True, ladder=LadderConfig(min_fit=4, n_rungs=4))
    with tr.ContinuousBatchEngine(cfg=cfg) as eng:
        _, mat, _ = _graph(rng, 100)
        h = rng.normal(size=(100, D)).astype(np.float32)
        for _ in range(6):
            eng.infer(mat, h)
        rep = eng.report()["executor"]
        assert rep["ladder"]["fitted"]
        assert any(k.startswith("r112x") for k in rep["padding"]
                   .get("per_bucket", {}))


def test_per_bucket_waste_sums_to_aggregate(rng):
    eng, jeng = _engines()
    with eng, jeng:
        for n in (48, 80, 48, 130):
            _, mat, jmat = _graph(rng, n)
            h = rng.normal(size=(n, D)).astype(np.float32)
            eng.submit(mat, h)
            jeng.submit(jmat, jnp.asarray(h))
        eng.drain()
        jeng.drain()
        _same_reports(eng, jeng)
        padding = eng.report()["executor"]["waste"]
        per = padding["per_bucket"]
        assert len(per) >= 2
        for field in ("real_rows", "padded_rows", "real_nnz", "padded_nnz"):
            assert sum(v[field] for v in per.values()) == padding[field]


# ---------------------------------------------------------------------------
# BatchServingEngine integration (adaptive opt-in + close regression)
# ---------------------------------------------------------------------------


def test_micro_engine_adaptive_opt_in(rng):
    from repro_torch.serve.engine import BatchServeConfig, BatchServingEngine
    from repro_torch.serve.runtime import LadderConfig

    scfg = BatchServeConfig(max_batch=8, max_delay_ms=2.0, adaptive=True,
                            ladder=LadderConfig(min_fit=4, n_rungs=4),
                            device="cpu")
    with BatchServingEngine(scfg=scfg) as eng:
        dense, mat, _ = _graph(rng, 100)
        h = rng.normal(size=(100, D)).astype(np.float32)
        futs = [eng.submit(mat, h) for _ in range(12)]
        eng.drain()
        for f in futs:
            np.testing.assert_allclose(f.result(), dense @ h, **TOL)
        assert eng.report()["executor"]["ladder"]["fitted"]


def test_micro_engine_close_drains_inflight(rng):
    from repro_torch.serve.engine import BatchServeConfig, BatchServingEngine

    eng = BatchServingEngine(scfg=BatchServeConfig(
        max_batch=4, max_delay_ms=1.0, device="cpu"))
    dense, mat, _ = _graph(rng, 48)
    h = rng.normal(size=(48, D)).astype(np.float32)
    futs = [eng.submit(mat, h) for _ in range(10)]
    eng.close()  # must drain, not strand
    for f in futs:
        assert f.done()
        np.testing.assert_allclose(f.result(timeout=1.0), dense @ h, **TOL)
    with pytest.raises(RuntimeError):
        eng.submit(mat, h)

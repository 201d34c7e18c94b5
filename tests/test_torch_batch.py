"""Port parity: ``repro_torch.batch`` and ``BatchServingEngine`` against
``repro.batch`` and the reference's engine (mirrors ``tests/test_batch.py``).

The same seeded numpy graphs and features go through both packages on the
CPU (the reference as its own tests run it).  Composition arrays (csr
triplets, ELL indices / blocks / nblocks, SELL slot and tile arrays),
``Segment``s, buckets, canonical stats, padded forms, executor compile /
eviction counts and ``PaddingWaste.as_dict()`` are equal exactly; products,
samples, GCN logits and gradients agree within the reference tests' f32
tolerance (rtol = atol = 2e-4; GCN logits 2e-3).  The sell composition's
row view, which the reference does not carry, is held to the dense
block-diagonal product.
"""
import dataclasses
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import batch as jb
from repro.sparse import SparseMatrix as JSparseMatrix
from repro_torch import batch as tb
from repro_torch.core.formats import SELL_HEAVY_ROW_NNZ
from repro_torch.kernels.spmm.sell import spmm_sell_slots_ref
from repro_torch.sparse.matrix import SparseMatrix
from repro_torch.sparse.ops import matmul

SWEEP = [0.5, 0.9, 0.99]
BLOCK = (16, 16)
SIZES = [48, 80, 33]  # deliberately not block-aligned (33)
D = 8
TOL = dict(rtol=2e-4, atol=2e-4)
GCN_TOL = dict(rtol=2e-3, atol=2e-3)


def _uniform_sparse(rng, n, sparsity):
    mask = rng.random((n, n)) < (1.0 - sparsity)
    dense = np.where(mask, rng.normal(size=(n, n)), 0.0).astype(np.float32)
    if not dense.any():  # keep at least one nonzero at 0.99 sparsity
        dense[0, 0] = 1.0
    return dense


def _pair(dense, formats=("ell", "csr"), block=BLOCK):
    return (SparseMatrix.from_dense(dense, formats=formats, block=block,
                                    device="cpu"),
            JSparseMatrix.from_dense(dense, formats=formats, block=block))


def _family(rng, sparsity, formats=("ell", "csr")):
    denses = [_uniform_sparse(rng, n, sparsity) for n in SIZES]
    pairs = [_pair(a, formats) for a in denses]
    hs = [rng.normal(size=(a.shape[1], D)).astype(np.float32)
          for a in denses]
    return denses, [p for p, _ in pairs], [j for _, j in pairs], hs


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _form_arrays(name, form):
    if name == "csr":
        return list(form)
    return [getattr(form, f.name) for f in dataclasses.fields(form)
            if not isinstance(getattr(form, f.name), (int, tuple))]


def _same_form(name, got, want):
    for g, w in zip(_form_arrays(name, got), _form_arrays(name, want)):
        _eq(g, w)
    if name != "csr":
        assert got.shape == want.shape


# ---------------------------------------------------------------------------
# block-diagonal composition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sparsity", SWEEP)
@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_blockdiag_matmul_matches_pergraph(rng, sparsity, fmt):
    denses, mats, jmats, hs = _family(rng, sparsity)
    B = tb.BatchedSparseMatrix.from_matrices(mats, formats=(fmt,))
    JB = jb.BatchedSparseMatrix.from_matrices(jmats, formats=(fmt,))
    _same_form(fmt, B.matrix.form(fmt), JB.matrix.form(fmt))
    assert B.segments == tuple(tb.Segment(**dataclasses.asdict(s))
                               for s in JB.segments)
    ys = tb.batch_matmul(mats, hs, formats=(fmt,), policy=fmt)
    jys = jb.batch_matmul(jmats, [jnp.asarray(h) for h in hs],
                          formats=(fmt,), policy=fmt)
    for y, jy, a, h in zip(ys, jys, denses, hs):
        np.testing.assert_allclose(y.numpy(), a @ h, **TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def test_blockdiag_multiform_auto_policy(rng):
    denses, mats, jmats, hs = _family(rng, 0.9)
    B = tb.BatchedSparseMatrix.from_matrices(mats)
    JB = jb.BatchedSparseMatrix.from_matrices(jmats)
    assert B.formats == JB.formats == ("ell", "csr") and B.n_graphs == 3
    assert all(seg.rows % BLOCK[0] == 0 for seg in B.segments)
    assert dataclasses.asdict(B.stats) == dataclasses.asdict(JB.stats)
    ys = B.unbatch(B @ B.batch_features(hs))
    for y, a, h in zip(ys, denses, hs):
        np.testing.assert_allclose(y.numpy(), a @ h, **TOL)


def test_unbatch_roundtrip(rng):
    _, mats, jmats, hs = _family(rng, 0.9)
    B = tb.BatchedSparseMatrix.from_matrices(mats)
    H = B.batch_features(hs)
    _eq(H, jb.BatchedSparseMatrix.from_matrices(jmats).batch_features(
        [jnp.asarray(h) for h in hs]))
    for h, back in zip(hs, B.unbatch(H, space="cols")):
        _eq(back, h)
    # values split recovers each graph's stored values (both forms)
    for fmt in ("csr", "ell"):
        Bf = tb.BatchedSparseMatrix.from_matrices(mats, formats=(fmt,))
        parts = Bf.unbatch_values(Bf.matrix.data, form=fmt)
        for m, part in zip(mats, parts):
            vals = m.form(fmt)[2] if fmt == "csr" else m.form(fmt).blocks
            _eq(part, vals)


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_batch_sddmm_matches_pergraph(rng, fmt):
    denses, mats, jmats, hs = _family(rng, 0.9)
    bs = [rng.normal(size=(a.shape[0], 4)).astype(np.float32)
          for a in denses]
    cs = [rng.normal(size=(4, a.shape[1])).astype(np.float32)
          for a in denses]
    B = tb.BatchedSparseMatrix.from_matrices(mats, formats=(fmt,))
    got = tb.batch_sddmm(B, bs, cs, policy=fmt)
    JB = jb.BatchedSparseMatrix.from_matrices(jmats, formats=(fmt,))
    want = jb.batch_sddmm(JB, [jnp.asarray(b) for b in bs],
                          [jnp.asarray(c) for c in cs], policy=fmt)
    for v, jv, m, b, c in zip(got, want, mats, bs, cs):
        ref = m.to(fmt).sddmm(torch.from_numpy(b), torch.from_numpy(c),
                              policy=fmt).data
        np.testing.assert_allclose(v.numpy(), ref.numpy(), **TOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def test_blockdiag_gradients_match_pergraph(rng):
    """The reference's gradient test, both packages: the batched loss's
    gradients split per graph equal the per-graph gradients, and the
    port's equal the reference's."""
    denses, mats, jmats, hs = _family(rng, 0.9, formats=("csr",))
    B = tb.BatchedSparseMatrix.from_matrices(mats)
    vals = B.matrix.data.clone().requires_grad_(True)
    H = B.batch_features(hs).requires_grad_(True)
    torch.tanh(matmul(B.matrix.with_data(vals), H)).sum().backward()
    gv_parts = B.unbatch_values(vals.grad)
    gh_parts = B.unbatch(H.grad, space="cols")

    JB = jb.BatchedSparseMatrix.from_matrices(jmats)
    jgv, jgh = jax.grad(
        lambda v, h: jnp.sum(jnp.tanh(JB.matrix.with_data(v) @ h)),
        argnums=(0, 1))(JB.matrix.data, JB.batch_features(
            [jnp.asarray(h) for h in hs]))
    for gvp, ghp, jgvp, jghp, m, h in zip(
            gv_parts, gh_parts, JB.unbatch_values(jgv),
            JB.unbatch(jgh, space="cols"), mats, hs):
        np.testing.assert_allclose(gvp.numpy(), np.asarray(jgvp), **TOL)
        np.testing.assert_allclose(ghp.numpy(), np.asarray(jghp), **TOL)
        v1 = m.data.clone().requires_grad_(True)
        h1 = torch.from_numpy(h).requires_grad_(True)
        torch.tanh(matmul(m.with_data(v1), h1)).sum().backward()
        np.testing.assert_allclose(gvp.numpy(), v1.grad.numpy(), **TOL)
        np.testing.assert_allclose(ghp.numpy(), h1.grad.numpy(), **TOL)


def test_from_matrices_rejects_mismatches(rng):
    _, mats, _, _ = _family(rng, 0.9)
    with pytest.raises(ValueError, match="at least one matrix"):
        tb.BatchedSparseMatrix.from_matrices([])
    with pytest.raises(ValueError, match="carry no 'ell'"):
        tb.BatchedSparseMatrix.from_matrices(
            [mats[0], mats[1].to("csr")], formats=("ell",))
    B = tb.BatchedSparseMatrix.from_matrices(mats)
    with pytest.raises(ValueError, match="feature blocks"):
        B.batch_features([np.zeros((SIZES[0], D), np.float32)])


def test_block_diag_sell_composition(rng):
    """Sell forms compose block-diagonally as the reference's do (every
    slot and tile array equal); the port's row view is offset so K2's
    plain version over it gives the dense block-diagonal product, and one
    planned SpMM equals the per-graph products."""
    mats, jmats, denses, hs = [], [], [], []
    for n, s in ((40, 0.97), (64, 0.99), (24, 0.9)):
        dense = np.where(rng.random((n, n)) < (1 - s),
                         rng.normal(size=(n, n)), 0).astype(np.float32)
        denses.append(dense)
        m, jm = _pair(dense, ("sell", "csr"), (8, 8))
        mats.append(m)
        jmats.append(jm)
        hs.append(rng.normal(size=(n, 6)).astype(np.float32))
    B = tb.BatchedSparseMatrix.from_matrices(mats)
    JB = jb.BatchedSparseMatrix.from_matrices(jmats)
    assert "sell" in B.formats
    sell, jsell = B.matrix.form("sell"), JB.matrix.form("sell")
    for f in ("slot_cols", "slot_rows", "slot_vals", "out_gather", "perm",
              "tile_rows", "tile_cols", "tile_slot_map", "slot_tile_pos",
              "tile_out_gather"):
        _eq(getattr(sell, f), getattr(jsell, f))
    for f in ("shape", "c", "sigma", "buckets", "block",
              "n_live_block_rows"):
        assert getattr(sell, f) == getattr(jsell, f), f
    # the row view: each graph's rows shifted by its slot offset
    offs = np.cumsum([0] + [m.form("sell").n_slots for m in mats])
    want_slot = np.concatenate([m.form("sell").tile_row_slot.numpy() + o
                                for m, o in zip(mats, offs)])
    _eq(sell.tile_row_slot, want_slot)
    _eq(sell.tile_heavy_rows, np.nonzero(
        sell.tile_row_nnz.numpy() > SELL_HEAVY_ROW_NNZ)[0])
    H = B.batch_features(hs)
    blockdiag = np.zeros(B.shape, np.float32)
    for seg, d in zip(B.segments, denses):
        blockdiag[seg.row_start:seg.row_start + d.shape[0],
                  seg.col_start:seg.col_start + d.shape[1]] = d
    compact = spmm_sell_slots_ref(sell.tile_row_slot, sell.tile_row_nnz,
                                  sell.slot_cols, sell.slot_vals, H)
    perm = sell.perm.numpy()
    real = perm < B.shape[0]
    np.testing.assert_allclose(compact.numpy()[real],
                               (blockdiag @ H.numpy())[perm[real]], **TOL)
    outs = B.unbatch(matmul(B.matrix, H, policy="sell"))
    jouts = JB.unbatch(JB.matrix @ JB.batch_features(
        [jnp.asarray(h) for h in hs]))
    for o, jo, d, h in zip(outs, jouts, denses, hs):
        np.testing.assert_allclose(o.numpy(), d @ h, rtol=5e-4, atol=5e-4)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    assert [int(v.shape[0]) for v in B.unbatch_values(
        sell.slot_vals, form="sell")] == [m.form("sell").n_slots
                                          for m in mats]
    assert B.stats.sell_stored_elements == JB.stats.sell_stored_elements


def test_concat_sell_heavy_rows_offset(rng):
    """A heavy row (more than SELL_HEAVY_ROW_NNZ nonzeros) in the second
    graph is listed at its compact row in the composition."""
    light = _uniform_sparse(rng, 40, 0.97)
    heavy = _uniform_sparse(rng, 200, 0.99)
    heavy[3, :160] = 1.0
    mats = [SparseMatrix.from_dense(a, formats=("sell",), block=(8, 8),
                                    device="cpu") for a in (light, heavy)]
    sell = tb.BatchedSparseMatrix.from_matrices(mats).matrix.form("sell")
    first, second = mats[0].form("sell"), mats[1].form("sell")
    local = second.tile_heavy_rows.numpy()
    want = local + first.n_live_block_rows * 8
    assert len(want) == 1
    _eq(sell.tile_heavy_rows, want)
    assert int(sell.tile_row_nnz[want[0]]) \
        == int(second.tile_row_nnz[local[0]]) >= 160


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------


def test_quantize_up_grid():
    for base, growth in ((32, 2.0), (64, 4.0), (1, 1.5)):
        for x in range(1, 2000, 7):
            assert tb.quantize_up(x, base, growth) \
                == jb.quantize_up(x, base, growth)
    assert tb.quantize_up(129, 32, 2.0) == 256
    with pytest.raises(ValueError):
        tb.quantize_up(5, 4, 1.0)


def test_bucket_padding_preserves_product_and_canonical_stats(rng):
    a = _uniform_sparse(rng, 70, 0.9)
    A, JA = _pair(a)
    h = rng.normal(size=(70, D)).astype(np.float32)
    bucket = tb.bucket_for(A.stats)
    jbucket = jb.bucket_for(JA.stats)
    assert dataclasses.asdict(bucket) == dataclasses.asdict(jbucket)
    assert bucket.label == jbucket.label
    assert dataclasses.asdict(tb.canonical_stats(bucket)) \
        == dataclasses.asdict(jb.canonical_stats(jbucket))
    for form in ("csr", "ell"):
        P = tb.pad_to_bucket(A, bucket, form=form)
        JP = jb.pad_to_bucket(JA, jbucket, form=form)
        _same_form(form, P.form(form), JP.form(form))
        assert P.stats == tb.canonical_stats(bucket)
        hp = np.zeros((bucket.cols, D), np.float32)
        hp[:70] = h
        y = matmul(P, torch.from_numpy(hp)).numpy()[:70]
        np.testing.assert_allclose(y, a @ h, **TOL)
        E = tb.empty_in_bucket(bucket, form=form, device="cpu")
        _same_form(form, E.form(form),
                   jb.empty_in_bucket(jbucket, form=form).form(form))
        assert matmul(E, torch.from_numpy(hp)).abs().max() == 0.0


def _mixed_traffic(rng, n_requests):
    mats, jmats, hs, refs = [], [], [], []
    for _ in range(n_requests):
        n = int(rng.integers(20, 150))
        a = _uniform_sparse(rng, n, 0.92)
        m, jm = _pair(a)
        mats.append(m)
        jmats.append(jm)
        h = rng.normal(size=(n, D)).astype(np.float32)
        hs.append(h)
        refs.append(a @ h)
    return mats, jmats, hs, refs


def test_executor_trace_count_pin_100_mixed_requests(rng):
    """>= 100 mixed-shape requests make O(#buckets) executors; compiles,
    buckets and the waste ledger equal the reference executor's."""
    ex = tb.BucketedExecutor(max_batch=16,
                             bucketing=tb.BucketingConfig(growth=2.0))
    jex = jb.BucketedExecutor(max_batch=16,
                              bucketing=jb.BucketingConfig(growth=2.0))
    mats, jmats, hs, refs = _mixed_traffic(rng, 104)
    for lo in range(0, len(mats), 16):  # serve in micro-batches of 16
        outs = ex.run(mats[lo:lo + 16], hs[lo:lo + 16])
        jouts = jex.run(jmats[lo:lo + 16],
                        [jnp.asarray(h) for h in hs[lo:lo + 16]])
        for o, jo, r in zip(outs, jouts, refs[lo:lo + 16]):
            np.testing.assert_allclose(o, r, **TOL)
            np.testing.assert_allclose(o, jo, **TOL)
    rep, jrep = ex.report(), jex.report()
    assert rep["requests"] == 104
    for key in ("requests", "calls", "compiles", "executors_cached",
                "evictions", "buckets"):
        assert rep[key] == jrep[key], key
    assert rep["waste"] == jrep["waste"]
    assert rep["compiles"] == rep["executors_cached"] <= 22
    assert rep["compiles"] < rep["requests"] // 4
    assert rep["buckets"] <= 8
    assert set(ex._executors) == {
        tb.ExecutorKey(bucket=tb.Bucket(**dataclasses.asdict(k.bucket)),
                       batch=k.batch, d=k.d, form=k.form)
        for k in jex._executors}
    # identical traffic replay: zero new compiles
    before = ex.compiles
    ex.run(mats[:16], hs[:16])
    assert ex.compiles == before
    waste = rep["waste"]
    assert waste["padded_nnz"] >= waste["real_nnz"] > 0
    assert 0.0 <= waste["waste_fraction"] < 1.0


def test_executor_lru_eviction(rng):
    ex = tb.BucketedExecutor(max_batch=1, max_executors=2)
    jex = jb.BucketedExecutor(max_batch=1, max_executors=2)
    for n in (30, 60, 120, 240):
        m, jm = _pair(_uniform_sparse(rng, n, 0.9))
        ex.run([m], [np.zeros((n, D), np.float32)])
        jex.run([jm], [jnp.zeros((n, D), jnp.float32)])
    rep, jrep = ex.report(), jex.report()
    assert rep["executors_cached"] == jrep["executors_cached"] <= 2
    assert rep["evictions"] == jrep["evictions"] >= 2
    assert rep["compiles"] == jrep["compiles"] == 4


# ---------------------------------------------------------------------------
# serving engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gcn_setup():
    from repro.configs.paper_gnn import SMOKE_CONFIG as JCFG
    from repro.models.gnn import build_graph as j_build_graph
    from repro.models.gnn import init_gcn as j_init_gcn
    from repro_torch.configs.paper_gnn import SMOKE_CONFIG as GCFG
    from repro_torch.data.pipeline import random_graph
    from repro_torch.models.gnn import build_graph, gcn_params_from_numpy

    jparams = j_init_gcn(jax.random.PRNGKey(0), JCFG)
    params = gcn_params_from_numpy(
        {k: [np.asarray(x) for x in v] for k, v in jparams.items()}, "cpu")
    adjs = [random_graph(n, avg_degree=4, seed=n) for n in (48, 80, 33)]
    graphs = [build_graph(a, GCFG, device="cpu") for a in adjs]
    jgraphs = [j_build_graph(a, JCFG) for a in adjs]
    return GCFG, params, graphs, jparams, jgraphs


def _engine(params, **kw):
    from repro_torch.serve.engine import BatchServeConfig, BatchServingEngine

    return BatchServingEngine.for_gcn(
        params, scfg=BatchServeConfig(device="cpu", **kw))


def test_gcn_forward_batched_matches_pergraph(rng, gcn_setup):
    from repro.models.gnn import batch_graphs as j_batch_graphs
    from repro.models.gnn import gcn_forward_batched as j_forward_batched
    from repro_torch.models.gnn import (batch_graphs, gcn_forward,
                                        gcn_forward_batched)

    cfg, params, graphs, jparams, jgraphs = gcn_setup
    xs = [rng.normal(size=(g.n_nodes, cfg.in_features)).astype(np.float32)
          for g in graphs]
    outs = gcn_forward_batched(params, batch_graphs(graphs), xs)
    jouts = j_forward_batched(jparams, j_batch_graphs(jgraphs),
                              [jnp.asarray(x) for x in xs])
    for o, jo, g, x in zip(outs, jouts, graphs, xs):
        ref = gcn_forward(params, g, torch.from_numpy(x), policy="csr")
        np.testing.assert_allclose(o.numpy(), ref.numpy(), **GCN_TOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **GCN_TOL)


def test_batch_serving_engine_end_to_end(rng, gcn_setup):
    from repro_torch.models.gnn import gcn_forward

    cfg, params, graphs, jparams, jgraphs = gcn_setup
    from repro.models.gnn import gcn_forward as j_gcn_forward

    with _engine(params, max_batch=8, max_delay_ms=2.0) as eng:
        futs, reqs = [], []
        for i in range(24):
            g = graphs[i % len(graphs)]
            x = rng.normal(size=(g.n_nodes, cfg.in_features)) \
                .astype(np.float32)
            reqs.append((i % len(graphs), x))
            futs.append(eng.submit(g, x))
        for f, (gi, x) in zip(futs, reqs):
            y = f.result(timeout=300)
            assert isinstance(y, np.ndarray)
            assert y.shape == (graphs[gi].n_nodes, cfg.n_classes)
            ref = gcn_forward(params, graphs[gi], torch.from_numpy(x),
                              policy="csr")
            np.testing.assert_allclose(y, ref.numpy(), **GCN_TOL)
            jref = j_gcn_forward(jparams, jgraphs[gi], jnp.asarray(x),
                                 policy="csr")
            np.testing.assert_allclose(y, np.asarray(jref), **GCN_TOL)
        eng.drain()
        rep = eng.report()
    assert rep["completed"] == rep["submitted"] == 24
    assert rep["req_per_s"] > 0
    assert rep["latency_ms_p99"] >= rep["latency_ms_p50"] > 0
    assert sum(rep["flushes"].values()) >= 1
    ex = rep["executor"]
    assert ex["compiles"] <= ex["calls"] <= rep["completed"]
    assert 0.0 <= ex["padding"]["waste_fraction"] < 1.0


def test_batch_serving_engine_error_propagates(gcn_setup):
    cfg, params, graphs, _, _ = gcn_setup
    with _engine(params, max_batch=4, max_delay_ms=1.0) as eng:
        bad = np.zeros((graphs[0].n_nodes + 1, cfg.in_features), np.float32)
        with pytest.raises(ValueError, match="do not match"):
            eng.submit(graphs[0], bad).result(timeout=60)
        eng.drain(timeout=60)  # failed requests count as resolved
        assert eng.report()["failed"] == 1
        good = np.zeros((graphs[0].n_nodes, cfg.in_features), np.float32)
        y = eng.infer(graphs[0], good)
        assert y.shape == (graphs[0].n_nodes, cfg.n_classes)
        eng.drain(timeout=60)
        eng.reset_metrics()
        rep = eng.report()
        assert rep["submitted"] == rep["completed"] == rep["failed"] == 0
        # a graph off the engine's device is refused at admission
        eng.device = torch.device("meta")
        with pytest.raises(ValueError, match="engine on meta"):
            eng.submit(graphs[0], good)
        eng.device = torch.device("cpu")


def test_batch_serving_engine_close_fails_queued_futures(gcn_setup):
    cfg, params, graphs, _, _ = gcn_setup
    eng = _engine(params, max_batch=4, max_delay_ms=1.0)
    x = np.zeros((graphs[0].n_nodes, cfg.in_features), np.float32)
    futs = [eng.submit(graphs[0], x) for _ in range(6)]
    eng.close()
    for f in futs:
        try:
            y = f.result(timeout=60)
            assert y.shape == (graphs[0].n_nodes, cfg.n_classes)
        except RuntimeError as exc:
            assert "engine closed" in str(exc)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(graphs[0], x)


def test_per_engine_plan_cache_not_aliased(rng, gcn_setup):
    from repro_torch.data.pipeline import random_graph
    from repro_torch.models.gnn import build_graph
    from repro_torch.serve.engine import GNNServingEngine

    cfg, params, _, _, _ = gcn_setup
    g1 = build_graph(random_graph(48, avg_degree=4, seed=91), cfg,
                     device="cpu")
    g2 = build_graph(random_graph(64, avg_degree=4, seed=92), cfg,
                     device="cpu")
    e1 = GNNServingEngine(params, g1)
    e2 = GNNServingEngine(params, g2)
    e1.infer(rng.normal(size=(48, cfg.in_features)).astype(np.float32))
    s1 = e1.dispatch_report()["plan_cache"]
    assert s1["misses"] > 0
    for _ in range(3):
        e2.infer(rng.normal(size=(64, cfg.in_features)).astype(np.float32))
    assert e1.dispatch_report()["plan_cache"] == s1
    s2 = e2.dispatch_report()["plan_cache"]
    assert s2["misses"] > 0
    g = e1.dispatch_report()["plan_cache_global"]
    assert g["misses"] >= s1["misses"] + s2["misses"]


def test_gnn_serving_engine_width_inference(gcn_setup):
    from repro.serve.engine import _infer_planning_width as j_width
    from repro_torch.models.gnn import init_gat
    from repro_torch.serve.engine import (GNNServeConfig, GNNServingEngine,
                                          _infer_planning_width)

    cfg, params, graphs, _, _ = gcn_setup
    gat_params = init_gat(cfg, seed=1, device="cpu")
    assert _infer_planning_width(gat_params) == cfg.hidden
    assert GNNServingEngine(gat_params, graphs[0]).plan.path \
        in ("ell", "csr")
    for p in ({"w": np.ones((cfg.in_features, 7), np.float32)},
              {"weights": [np.ones((cfg.in_features, 5), np.float32)]}):
        assert _infer_planning_width(p) == j_width(p)
    assert GNNServingEngine({"weights": [np.ones((cfg.in_features, 5),
                                                 np.float32)]},
                            graphs[0]).plan.path in ("ell", "csr")
    with pytest.raises(ValueError, match="planning feature width"):
        _infer_planning_width({"bias": np.ones((3,), np.float32)})
    eng = GNNServingEngine({"bias": np.ones((3,), np.float32)}, graphs[0],
                           GNNServeConfig(d=64))
    assert eng.plan.path in ("ell", "csr")


# ---------------------------------------------------------------------------
# serving-engine worker-loop hardening (deadline clamp regressions)
# ---------------------------------------------------------------------------


def _inject(eng, graph, x, t_submit):
    """Enqueue a request with a forged submit timestamp, bypassing
    ``submit``."""
    from repro_torch.serve.engine import _Request

    req = _Request(matrix=graph.adj, features=x, future=Future(),
                   t_submit=t_submit)
    if eng._t_first is None:
        eng._t_first = req.t_submit
    eng._submitted += 1
    eng._queue.put(req)
    return req.future


def test_slow_request_flushes_on_deadline_immediately(gcn_setup):
    cfg, params, graphs, _, _ = gcn_setup
    g = graphs[0]
    x = np.zeros((g.n_nodes, cfg.in_features), np.float32)
    with _engine(params, max_batch=8, max_delay_ms=50.0) as eng:
        eng.infer(g, x)
        eng.drain(timeout=60)
        before = eng.report()["flushes"]
        fut = _inject(eng, g, x, time.perf_counter() - 1.0)  # long stale
        assert fut.result(timeout=60).shape == (g.n_nodes, cfg.n_classes)
        eng.drain(timeout=60)
        after = eng.report()["flushes"]
        assert after["deadline"] == before["deadline"] + 1
        assert after["full"] == before["full"]
        assert eng._worker.is_alive()
        eng.infer(g, x)


def test_skewed_future_timestamp_wait_is_bounded(gcn_setup):
    cfg, params, graphs, _, _ = gcn_setup
    g = graphs[0]
    x = np.zeros((g.n_nodes, cfg.in_features), np.float32)
    with _engine(params, max_batch=8, max_delay_ms=5.0) as eng:
        eng.infer(g, x)
        fut = _inject(eng, g, x, time.perf_counter() + 30.0)
        assert fut.result(timeout=10).shape == (g.n_nodes, cfg.n_classes)
        assert eng._worker.is_alive()


@pytest.mark.parametrize("delay_ms", [0.0, -3.0])
def test_non_positive_delay_degrades_to_greedy_flushing(gcn_setup,
                                                        delay_ms):
    cfg, params, graphs, _, _ = gcn_setup
    g = graphs[0]
    x = np.zeros((g.n_nodes, cfg.in_features), np.float32)
    with _engine(params, max_batch=4, max_delay_ms=delay_ms) as eng:
        futs = [eng.submit(g, x) for _ in range(6)]
        for f in futs:
            assert f.result(timeout=60).shape == (g.n_nodes, cfg.n_classes)
        eng.drain(timeout=60)
        rep = eng.report()
        assert rep["completed"] == rep["submitted"] == 6
        assert rep["failed"] == 0
        assert eng._worker.is_alive()

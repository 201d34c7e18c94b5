"""Port parity: ``repro_torch.serve.runtime.DeltaGraph`` against the
reference's (mirrors ``tests/test_delta.py``).

The same seeded delta stream goes through both packages' overlays: the
overlay arrays (csr triplets; sell ``slot_cols``, ``slot_vals``,
``tile_slot_map``, ``slot_tile_pos``), repack counts, capacity and exact
stats are equal exactly, and SpMM / SDDMM on the overlay equal a rebuild
from the final dense matrix within the reference's 1e-6.

Port-only checks (the reference reads the tile view, so none of its tests
can see these): the SELL row view that K2, K6, K4 and K8 read covers every
live slot after slack inserts and deletes, ``tile_heavy_rows`` lists
exactly the rows above ``SELL_HEAVY_ROW_NNZ``, and the row view's plain
SpMM equals the rebuild's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dispatch.stats import MatrixStats as JMatrixStats
from repro.serve.runtime import DeltaGraph as JDeltaGraph
from repro.sparse import sddmm as j_sddmm
from repro.sparse import spmm as j_spmm
from repro_torch import obs
from repro_torch.core.formats import SELL_HEAVY_ROW_NNZ
from repro_torch.dispatch.stats import MatrixStats
from repro_torch.kernels.spmm.sell import spmm_sell_slots_ref
from repro_torch.serve.runtime import DeltaGraph
from repro_torch.sparse.matrix import SparseMatrix
from repro_torch.sparse.ops import matmul, sddmm

BLOCK = (8, 8)
N = 64
D = 8
SWEEP = [0.9, 0.99]
EXACT = dict(rtol=1e-6, atol=1e-6)


def _dense(rng, n=N, sparsity=0.9):
    a = np.where(rng.random((n, n)) < (1.0 - sparsity),
                 rng.normal(size=(n, n)), 0.0).astype(np.float32)
    if not a.any():
        a[0, 0] = 1.0
    return a


def _make(rng, form, sparsity, n=N, **kw):
    dense = _dense(rng, n, sparsity)
    kw.setdefault("block", BLOCK)
    if form == "sell":
        kw.setdefault("c", 16)
    return (dense, DeltaGraph(dense, form=form, device="cpu", **kw),
            JDeltaGraph(dense, form=form, **kw))


def _delta_stream(rng, dense, n_deltas, n=N):
    """A mixed insert / update / delete stream (the reference test's
    draws); returns the deltas and the final dense matrix."""
    live = {(int(r), int(c)): float(dense[r, c])
            for r, c in zip(*np.nonzero(dense))}
    deltas = []
    for _ in range(n_deltas):
        op = rng.random()
        if op < 0.4 and len(live) > 1:            # delete an existing edge
            r, c = list(live)[rng.integers(len(live))]
            deltas.append(("delete", r, c, 0.0))
            del live[(r, c)]
        elif op < 0.7:                            # update in place
            r, c = list(live)[rng.integers(len(live))]
            v = float(rng.normal())
            while v == 0.0:
                v = float(rng.normal())
            deltas.append(("insert", r, c, v))
            live[(r, c)] = v
        else:                                     # insert a fresh edge
            r, c = int(rng.integers(n)), int(rng.integers(n))
            v = float(rng.normal())
            while v == 0.0 or (r, c) in live:
                r, c = int(rng.integers(n)), int(rng.integers(n))
                v = float(rng.normal())
            deltas.append(("insert", r, c, v))
            live[(r, c)] = v
    out = np.zeros((n, n), np.float32)
    for (r, c), v in live.items():
        out[r, c] = v
    return deltas, out


def _apply(dgs, deltas):
    for dg in dgs:
        dg.apply(deltas)


def _same_overlay(dg, jdg):
    """The overlay arrays, counters and stats equal the reference's."""
    got, want = dg.matrix.form(dg.form), jdg.matrix.form(jdg.form)
    if dg.form == "csr":
        pairs = zip(got, want)
    else:
        pairs = ((getattr(got, f), getattr(want, f)) for f in (
            "slot_cols", "slot_rows", "slot_vals", "tile_slot_map",
            "slot_tile_pos", "perm", "out_gather", "tile_out_gather"))
    for g, w in pairs:
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert dg.report() == jdg.report()
    assert dg.matrix.stats == MatrixStats(**vars(jdg.matrix.stats))
    assert dg.exact_stats == MatrixStats(**vars(jdg.exact_stats))


def _check_row_view(dg):
    """Every live slot lies in its compact row's view, the heavy-row list
    is exact, and the row view's plain SpMM equals the dense product."""
    ov = dg._overlay
    sell = dg.matrix.form("sell")
    row_slot = sell.tile_row_slot.numpy()
    row_nnz = sell.tile_row_nnz.numpy()
    live = np.nonzero(ov.slot_vals_h)[0]
    rows = ov.slot_compact[live]
    assert (rows >= 0).all()
    assert ((live >= row_slot[rows])
            & (live < row_slot[rows] + row_nnz[rows])).all()
    np.testing.assert_array_equal(
        sell.tile_heavy_rows.numpy(),
        np.nonzero(row_nnz > SELL_HEAVY_ROW_NNZ)[0])
    h = torch.from_numpy(np.random.default_rng(5).normal(
        size=(sell.shape[1], D)).astype(np.float32))
    compact = spmm_sell_slots_ref(sell.tile_row_slot, sell.tile_row_nnz,
                                  sell.slot_cols, sell.slot_vals, h)
    perm = sell.perm.numpy()
    real = perm < sell.shape[0]
    want = dg.matrix.to_dense() @ h.numpy()
    np.testing.assert_allclose(compact.numpy()[real], want[perm[real]],
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# parity: deltas == from-scratch rebuild
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sparsity", SWEEP)
@pytest.mark.parametrize("form", ["csr", "sell"])
def test_delta_sequence_matches_rebuild(rng, form, sparsity):
    dense, dg, jdg = _make(rng, form, sparsity)
    deltas, final = _delta_stream(rng, dense, 120)
    _apply((dg, jdg), deltas)
    _same_overlay(dg, jdg)
    np.testing.assert_array_equal(dg.matrix.to_dense(), final)
    h = rng.normal(size=(N, D)).astype(np.float32)
    rebuild = SparseMatrix.from_dense(final, formats=(form,), block=BLOCK,
                                      device="cpu")
    got = matmul(dg.matrix, torch.from_numpy(h), policy=form)
    want = matmul(rebuild, torch.from_numpy(h), policy=form)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **EXACT)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        j_spmm(jdg.matrix, jnp.asarray(h), policy=form)), **EXACT)
    assert dg.live_nnz == int((final != 0).sum())
    if form == "sell":
        _check_row_view(dg)


@pytest.mark.parametrize("sparsity", SWEEP)
@pytest.mark.parametrize("form", ["csr", "sell"])
def test_delta_sddmm_matches_rebuild(rng, form, sparsity):
    dense, dg, jdg = _make(rng, form, sparsity)
    deltas, final = _delta_stream(rng, dense, 80)
    _apply((dg, jdg), deltas)
    b = rng.normal(size=(N, 4)).astype(np.float32)
    c = rng.normal(size=(4, N)).astype(np.float32)
    rebuild = SparseMatrix.from_dense(final, formats=(form,), block=BLOCK,
                                      device="cpu")
    tb, tc = torch.from_numpy(b), torch.from_numpy(c)
    got = sddmm(dg.matrix, tb, tc, policy=form).to_dense()
    want = sddmm(rebuild, tb, tc, policy=form).to_dense()
    # tombstones sample to exactly zero: parity is dense-wide
    np.testing.assert_allclose(got, want, **EXACT)
    np.testing.assert_allclose(got, np.asarray(j_sddmm(
        jdg.matrix, jnp.asarray(b), jnp.asarray(c), policy=form)
        .densify()), **EXACT)


def test_delete_all_is_zero(rng):
    dense, dg, jdg = _make(rng, "csr", 0.99)
    deltas = [("delete", int(r), int(c), 0.0)
              for r, c in zip(*np.nonzero(dense))]
    _apply((dg, jdg), deltas)
    assert dg.live_nnz == 0
    _same_overlay(dg, jdg)
    h = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    assert torch.equal(matmul(dg.matrix, h, policy="csr"),
                       torch.zeros((N, D)))


# ---------------------------------------------------------------------------
# signature stability (the reference's retrace pin)
# ---------------------------------------------------------------------------


def test_thousand_deltas_zero_retrace(rng):
    """A consumer watched by ``obs.instrumented_jit`` sees one input
    signature across >= 1000 mixed deltas: one "compile", no repack."""
    obs.reset()
    dense, dg, _ = _make(rng, "csr", 0.9, slack=4.0)
    consume = obs.instrumented_jit(lambda m, h: matmul(m, h), "delta-spmm")
    h = torch.from_numpy(rng.normal(size=(N, D)).astype(np.float32))
    consume(dg.matrix, h)
    final = dense
    for _ in range(10):
        deltas, final = _delta_stream(rng, final, 110)
        dg.apply(deltas)
        consume(dg.matrix, h)
    assert dg.deltas_applied >= 1000
    assert dg.repacks == 0
    lane = obs.SENTRY.lanes()["delta-spmm"]
    assert lane["compiles"] == 1 and lane["calls"] == 11
    np.testing.assert_allclose(consume(dg.matrix, h).numpy(),
                               final.astype(np.float64) @ h.numpy(),
                               rtol=1e-4, atol=1e-4)
    dg.repack()  # a repack re-prices: the signature changes once
    consume(dg.matrix, h)
    assert obs.SENTRY.lanes()["delta-spmm"]["compiles"] == 2
    obs.reset()


def test_sell_value_churn_zero_repack(rng):
    dense, dg, jdg = _make(rng, "sell", 0.9)
    edges = list(zip(*np.nonzero(dense)))
    deltas = []
    for i in range(300):
        r, c = edges[i % len(edges)]
        deltas += [("delete", int(r), int(c), 0.0),
                   ("insert", int(r), int(c), float(i + 1))]
    _apply((dg, jdg), deltas)
    assert dg.repacks == 0
    assert dg.deltas_applied == 600
    _same_overlay(dg, jdg)
    _check_row_view(dg)


def test_slack_exhaustion_auto_repacks(rng):
    dense, dg, jdg = _make(rng, "csr", 0.99, slack=0.0)
    free0 = dg.free_slots()
    k = 0
    while dg.repacks == 0:  # keep inserting until the pool runs dry
        r, c = divmod(k, N)
        if dense[r, c] == 0:
            for g in (dg, jdg):
                g.insert(r, c, 1.0)
            dense[r, c] = 1.0
        k += 1
        assert k < N * N, "slack never exhausted"
    assert dg.repacks == jdg.repacks == 1 and dg.free_slots() > 0
    np.testing.assert_array_equal(dg.matrix.to_dense(), dense)
    assert dg.capacity >= free0
    _same_overlay(dg, jdg)


def test_sell_out_of_structure_insert_repacks(rng):
    dense, dg, jdg = _make(rng, "sell", 0.9, width_slack=1)
    r = int(np.argmax((dense != 0).sum(axis=1)))
    for j, c in enumerate(np.flatnonzero(dense[r] == 0)):
        for g in (dg, jdg):
            g.insert(r, int(c), float(j + 1))
        dense[r, c] = float(j + 1)
        if dg.repacks:
            break
        _check_row_view(dg)  # every slack insert stays in the row view
    assert dg.repacks == jdg.repacks >= 1
    np.testing.assert_array_equal(dg.matrix.to_dense(), dense)
    _same_overlay(dg, jdg)
    _check_row_view(dg)


def test_sell_slack_inserts_extend_row_view_to_heavy(rng):
    """Slack inserts into one row past ``SELL_HEAVY_ROW_NNZ`` make it a
    heavy row of the served view, and deleting them all brings it back."""
    dense = np.zeros((256, 256), np.float32)
    dense[5, :140] = 1.0
    dense[7, :120] = 2.0  # a light row in the same slice, 20 slots slack
    dg = DeltaGraph(dense, form="sell", device="cpu", block=(8, 8), c=16)
    assert int(dg.matrix.form("sell").tile_heavy_rows.numel()) == 1
    for c in range(120, 135):
        dg.insert(7, c, 3.0)
        dense[7, c] = 3.0
    assert dg.repacks == 0
    _check_row_view(dg)
    sell = dg.matrix.form("sell")
    assert sell.tile_heavy_rows.numel() == 2
    for c in range(120, 135):
        dg.delete(7, c)
    _check_row_view(dg)
    assert dg.matrix.form("sell").tile_heavy_rows.numel() == 1


# ---------------------------------------------------------------------------
# stats plumbing
# ---------------------------------------------------------------------------


def test_capacity_stats_constant_exact_stats_track(rng):
    dense, dg, jdg = _make(rng, "csr", 0.9)
    served0 = dg.matrix.stats
    assert served0.nnz == dg.capacity  # priced at capacity, not live
    r, c = next(zip(*np.nonzero(dense)))
    for g in (dg, jdg):
        g.delete(int(r), int(c))
    assert dg.stats_invalidations == 1
    assert dg.matrix.stats == served0
    assert dg.exact_stats.nnz == dg.live_nnz
    _same_overlay(dg, jdg)
    for g in (dg, jdg):
        g.repack()
    assert dg.matrix.stats != served0
    _same_overlay(dg, jdg)


def test_with_capacity_validates():
    s = MatrixStats.from_coords((8, 8), np.arange(4), np.arange(4))
    js = JMatrixStats.from_coords((8, 8), np.arange(4), np.arange(4))
    assert s.with_capacity(10) == MatrixStats(**vars(js.with_capacity(10)))
    assert s.with_capacity(10).nnz == 10
    with pytest.raises(ValueError):
        s.with_capacity(2)


def test_insert_zero_and_missing_delete_raise(rng):
    dense, dg, _ = _make(rng, "csr", 0.9)
    with pytest.raises(ValueError):
        dg.insert(0, 0, 0.0)
    r, c = np.nonzero(dense == 0)
    with pytest.raises(KeyError):
        dg.delete(int(r[0]), int(c[0]))


# ---------------------------------------------------------------------------
# background repack
# ---------------------------------------------------------------------------


def test_background_repack_swaps_and_replays(rng):
    dense, dg, _ = _make(rng, "csr", 0.9, slack=0.5)
    deltas, final = _delta_stream(rng, dense, 60)
    dg.apply(deltas)
    assert dg.maybe_repack_async(low_water=1.0)  # force a rebuild start
    # deltas during the rebuild land in the journal and replay on swap
    r, c = next(zip(*np.nonzero(final)))
    dg.delete(int(r), int(c))
    final[r, c] = 0
    assert dg.poll_repack(timeout=30.0)
    assert dg.repacks == 1
    np.testing.assert_array_equal(dg.matrix.to_dense(), final)
    assert dg.matrix.stats.nnz == dg.capacity


def test_served_matrix_is_built_anew_after_a_delta(rng):
    """A delta makes a new container (new tensors), so no memo keyed on
    an earlier container's tensors (the densify memo, the row view of
    Aᵀ) can hit; between deltas the same matrix is served."""
    dense, dg, _ = _make(rng, "sell", 0.9)
    m0 = dg.matrix
    assert dg.matrix is m0
    d0 = m0.densify()
    r, c = next(zip(*np.nonzero(dense)))
    dg.insert(int(r), int(c), 7.0)
    m1 = dg.matrix
    assert m1 is not m0
    assert m1.form("sell").slot_vals is not m0.form("sell").slot_vals
    assert m1.form("sell").slot_cols is not m0.form("sell").slot_cols
    assert float(m1.densify()[r, c]) == 7.0 != float(d0[r, c])

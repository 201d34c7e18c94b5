"""Port parity: sparse formats and matrix stats.

The same numpy matrix is packed by the JAX package and by the port; every
index array of Block-ELL and SELL-C-σ must be identical, the block data
and slot values equal, and every ``MatrixStats`` field equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.formats import BlockELL as JBlockELL
from repro.core.formats import SellCS as JSellCS
from repro.data.pipeline import random_graph as j_random_graph
from repro.dispatch.stats import MatrixStats as JMatrixStats
from repro_torch.core.formats import (SELL_HEAVY_ROW_NNZ, BlockELL, SellCS,
                                      sell_slot_volume)
from repro_torch.data.pipeline import random_graph
from repro_torch.dispatch.stats import MatrixStats
from repro_torch.sparse.matrix import with_values

SELL_INDEX_FIELDS = ("slot_cols", "slot_rows", "out_gather", "perm",
                     "tile_rows", "tile_cols", "tile_slot_map",
                     "slot_tile_pos", "tile_out_gather")


def _uniform(rng, m, n, density):
    mask = rng.random((m, n)) < density
    return np.where(mask, rng.normal(size=(m, n)), 0.0).astype(np.float32)


def _empty_rows(rng):
    dense = _uniform(rng, 96, 80, 0.08)
    dense[::3] = 0.0  # every third row empty
    dense[40:72] = 0.0  # and a whole empty stretch (pruned slices)
    return dense


def _heavy_row(rng):
    dense = _uniform(rng, 150, 300, 0.03)
    dense[5, :250] = rng.normal(size=250) + 5.0  # above SELL_HEAVY_ROW_NNZ
    return dense


CASES = {
    "uniform": lambda rng: _uniform(rng, 128, 128, 0.1),
    "heavy_row": _heavy_row,
    "ragged": lambda rng: _uniform(rng, 100, 70, 0.05),
    "empty_rows": _empty_rows,
    "random_graph": lambda rng: random_graph(256, 2.0, seed=3),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("block", [(16, 16), (8, 16)])
def test_blockell_matches_reference(rng, case, block):
    dense = CASES[case](rng)
    ref = JBlockELL.from_dense(dense, *block)
    ours = BlockELL.from_dense(dense, *block, device="cpu")
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_array_equal(ours.nblocks.numpy(),
                                  np.asarray(ref.nblocks))
    np.testing.assert_array_equal(ours.blocks.numpy(), np.asarray(ref.blocks))
    assert ours.occupancy() == pytest.approx(ref.occupancy())
    np.testing.assert_array_equal(ours.to_dense(), ref.to_dense())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("block,c", [((16, 16), 8), ((8, 16), 4)])
def test_sellcs_matches_reference(rng, case, block, c):
    dense = CASES[case](rng)
    ref = JSellCS.from_dense(dense, c=c, block=block)
    ours = SellCS.from_dense(dense, c=c, block=block, device="cpu")
    for name in SELL_INDEX_FIELDS:
        mine = getattr(ours, name)
        assert mine.dtype == torch.int32, name
        np.testing.assert_array_equal(mine.numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(ours.slot_vals.numpy(),
                                  np.asarray(ref.slot_vals))
    assert ours.buckets == ref.buckets
    assert ours.n_live_block_rows == ref.n_live_block_rows
    assert ours.n_slots == ref.n_slots and ours.n_tiles == ref.n_tiles
    assert (ours.shape, ours.block, ours.c, ours.sigma) == \
        (ref.shape, ref.block, ref.c, ref.sigma)
    np.testing.assert_array_equal(ours.to_dense(), ref.to_dense())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("block,c", [((16, 16), 8), ((8, 16), 4),
                                     ((64, 64), 32)])
def test_sell_row_view_matches_tile_view(rng, case, block, c):
    """Each compact output row's slot range holds exactly the live cells
    of ``tile_slot_map`` in that row, in ascending column; padding rows
    and rows without nonzeros have none."""
    dense = CASES[case](rng)
    sell = SellCS.from_dense(dense, c=c, block=block, device="cpu")
    bm, bn = block
    n_rows = sell.n_live_block_rows * bm
    row_slot, row_nnz = sell.tile_row_slot.numpy(), sell.tile_row_nnz.numpy()
    for name, arr in (("tile_row_slot", sell.tile_row_slot),
                      ("tile_row_nnz", sell.tile_row_nnz)):
        assert arr.dtype == torch.int32 and arr.shape == (n_rows,), name
    cells = [[] for _ in range(n_rows)]  # (column, slot) per compact row
    tmap = sell.tile_slot_map.numpy()
    for t, (tr, tc) in enumerate(zip(sell.tile_rows.numpy(),
                                     sell.tile_cols.numpy())):
        for j, k in zip(*np.nonzero(tmap[t] < sell.n_slots)):
            cells[tr * bm + j].append((tc * bn + k, tmap[t, j, k]))
    perm = sell.perm.numpy()
    slot_cols = sell.slot_cols.numpy()
    for r in range(n_rows):
        want = sorted(cells[r])
        slots = row_slot[r] + np.arange(row_nnz[r])
        assert [s for _, s in want] == slots.tolist(), r
        assert [col for col, _ in want] == slot_cols[slots].tolist(), r
        if perm[r] == dense.shape[0]:  # padding row
            assert row_nnz[r] == 0, r
        else:
            assert row_nnz[r] == np.count_nonzero(dense[perm[r]]), r
    assert int(row_nnz.sum()) == np.count_nonzero(dense)
    heavy = sell.tile_heavy_rows
    assert heavy.dtype == torch.int32
    assert heavy.tolist() == \
        np.nonzero(row_nnz > SELL_HEAVY_ROW_NNZ)[0].tolist()
    assert (heavy.shape[0] > 0) == (case == "heavy_row")


def test_sell_row_view_survives_new_values(rng):
    """``with_values`` keeps the topology, the row view included."""
    sell = SellCS.from_dense(_empty_rows(rng), block=(16, 16), device="cpu")
    moved = with_values("sell", sell, sell.slot_vals * 2)
    assert moved.tile_row_slot is sell.tile_row_slot
    assert moved.tile_row_nnz is sell.tile_row_nnz
    assert moved.tile_heavy_rows is sell.tile_heavy_rows


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("block", [(16, 16), (64, 64)])
def test_matrix_stats_match_reference(rng, case, block):
    dense = CASES[case](rng)
    rows, cols = np.nonzero(dense)
    ref = JMatrixStats.from_coords(dense.shape, rows, cols, *block)
    ours = MatrixStats.from_coords(dense.shape, rows, cols, *block)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("density", "padded_stream_blowup", "ell_stream_estimate",
                 "dense_elements"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    row_nnz = (dense != 0).sum(axis=1)
    assert sell_slot_volume(row_nnz) == ours.sell_stored_elements


def test_random_graph_matches_reference():
    for clustered in (True, False):
        np.testing.assert_array_equal(
            random_graph(300, 4.0, seed=5, clustered=clustered),
            j_random_graph(300, 4.0, seed=5, clustered=clustered))

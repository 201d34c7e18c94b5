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
from repro_torch.core.formats import BlockELL, SellCS, sell_slot_volume
from repro_torch.data.pipeline import random_graph
from repro_torch.dispatch.stats import MatrixStats

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


CASES = {
    "uniform": lambda rng: _uniform(rng, 128, 128, 0.1),
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

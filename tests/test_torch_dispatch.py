"""Port parity: the SpMM planner picks the reference's path at the
reference's costs, over a sparsity sweep that crosses the 0.99 SELL
threshold (0.9898 sits just under it)."""
import numpy as np
import pytest
import torch

from repro.dispatch.dispatcher import plan_spmm as j_plan_spmm
from repro.dispatch.stats import MatrixStats as JMatrixStats
from repro.sparse import SparseMatrix as JSparseMatrix
from repro.sparse.ops import available_paths as j_available_paths
from repro_torch.dispatch.dispatcher import (clear_log, dispatch_log,
                                             last_plan, plan_spmm)
from repro_torch.dispatch.policy import normalize_policy
from repro_torch.dispatch.stats import MatrixStats
from repro_torch.sparse.matrix import SparseMatrix
from repro_torch.sparse.ops import available_paths, matmul

SPARSITIES = (0.5, 0.9, 0.95, 0.98, 0.9898, 0.99, 0.995, 0.999)
CANDIDATES = (None, ("ell", "csr"), ("ell", "sell", "csr"))


def _dense(sparsity, n=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, n)) < 1.0 - sparsity).astype(np.float32)


@pytest.mark.parametrize("sparsity", SPARSITIES)
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("candidates", CANDIDATES)
def test_plan_spmm_matches_reference(sparsity, d, candidates):
    dense = _dense(sparsity)
    rows, cols = np.nonzero(dense)
    ref = j_plan_spmm(JMatrixStats.from_coords(dense.shape, rows, cols,
                                               64, 64),
                      d, candidates=candidates)
    ours = plan_spmm(MatrixStats.from_coords(dense.shape, rows, cols, 64,
                                             64),
                     d, candidates=candidates)
    assert ours.path == ref.path
    assert ours.costs == ref.costs
    assert ours.reason == ref.reason
    assert ours.use_kernel is False  # no device given: nothing on CUDA


@pytest.mark.parametrize("policy", ["ell", "csr", "sell", "auto",
                                    "autotune"])
def test_forced_and_auto_policies_match_reference(policy):
    dense = _dense(0.995)
    rows, cols = np.nonzero(dense)
    ref = j_plan_spmm(JMatrixStats.from_coords(dense.shape, rows, cols, 64,
                                               64), 32, policy=policy)
    ours = plan_spmm(MatrixStats.from_coords(dense.shape, rows, cols, 64,
                                             64), 32, policy=policy)
    assert (ours.path, ours.policy, ours.reason) == \
        (ref.path, ref.policy, ref.reason)


def test_policy_names():
    assert normalize_policy("BlockELL") == "ell"
    assert normalize_policy("sell-c-sigma") == "sell"
    with pytest.raises(ValueError):
        normalize_policy("tpu")
    with pytest.raises(ValueError):
        plan_spmm(MatrixStats.from_coords((8, 8), [0], [0]), 4,
                  policy="sell", candidates=("ell", "csr"))


def test_matmul_plans_memoized_and_logged():
    dense = _dense(0.995, n=128)
    formats = ("ell", "sell", "csr")
    ours = SparseMatrix.from_dense(dense, formats=formats, block=(16, 16),
                                   device="cpu")
    ref = JSparseMatrix.from_dense(dense, formats=formats, block=(16, 16))
    assert available_paths(ours) == j_available_paths(ref)
    h = torch.ones((128, 8))
    clear_log()
    for _ in range(3):
        matmul(ours, h)
    assert ours.plan_cache.stats() == {"hits": 2, "misses": 1, "entries": 1}
    assert len(dispatch_log()) == 3
    assert last_plan("spmm").path == "sell"
    with pytest.raises(ValueError):
        matmul(ours, torch.ones((127, 8)))

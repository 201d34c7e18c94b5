"""``bench/work`` against counts made by hand at the smoke size (32 → 16
→ 16 → 4, as ``paper_gnn.SMOKE_CONFIG``)."""
import pytest

from bench.work import gnn
from bench.work.ops import (Work, dense_mm, flops, fused_attention, least_s,
                            sddmm, spmm, spmm_t)
from bench.work.peaks import PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S

SMOKE = {"n_layers": 3, "in_features": 32, "hidden": 16, "n_classes": 4}
N, NNZ = 100, 1000
SHAPE = {"n": N, "nnz": NNZ}


def test_products_by_hand():
    # 1000 indices and values, H in [100, 16], Y out [100, 16]
    assert spmm(NNZ, N, N, 16) == Work("spmm", 2 * 1000 * 16,
                                       4000 + 4000 + 6400 + 6400)
    assert spmm(NNZ, N, N, 16, values=False).nbytes == 4000 + 12800
    assert spmm_t(NNZ, 50, N, 2).nbytes == 8000 + 50 * 2 * 4 + 100 * 2 * 4
    # indices, B and C [100, 2], one output per nonzero
    assert sddmm(NNZ, N, N, 2) == Work("sddmm", 4000, 4000 + 1600 + 4000)
    # indices, q and k [100, 2], V in and out [100, 16]; no values read
    assert fused_attention(NNZ, N, N, 2, 16) == Work(
        "fused_attention", 2 * 1000 * 2 + 2 * 1000 * 16,
        4000 + 1600 + 6400 + 6400)
    assert dense_mm(100, 32, 16) == Work("mm", 2 * 100 * 32 * 16,
                                         (3200 + 512 + 1600) * 4)


def test_least_time_is_the_larger_bound():
    byte_bound = Work("b", 1, int(PEAK_BYTES_PER_S))  # one second
    flop_bound = Work("f", int(2 * PEAK_F32_FLOP_PER_S), 1)  # two
    assert byte_bound.least_s() == pytest.approx(1.0)
    assert flop_bound.least_s() == pytest.approx(2.0)
    assert least_s([byte_bound, flop_bound]) == pytest.approx(3.0)


def test_gcn_products_by_hand():
    cfg = dict(SMOKE, model="gcn")
    assert gnn.widths(cfg) == [32, 16, 16, 4]
    infer = gnn.sparse_ops(cfg, "infer", SHAPE)
    assert [w.flops for w in infer] == [32000, 32000, 8000]
    train = gnn.sparse_ops(cfg, "train", SHAPE)
    assert [w.flops for w in train] == [32000, 32000, 8000,
                                        8000, 32000, 32000]
    # HW per layer; dW per layer; dH for layers 1 and 2
    assert flops(gnn.dense_ops(cfg, "infer", SHAPE)) == \
        2 * N * (32 * 16 + 16 * 16 + 16 * 4)
    assert flops(gnn.dense_ops(cfg, "train", SHAPE)) == \
        2 * N * (2 * (32 * 16 + 16 * 16 + 16 * 4) + 16 * 16 + 16 * 4)


def test_gat_products_by_hand():
    cfg = dict(SMOKE, model="gat", score_k=2)
    infer = gnn.sparse_ops(cfg, "infer", SHAPE)
    assert [w.flops for w in infer] == [2 * NNZ * 18, 2 * NNZ * 18,
                                        2 * NNZ * 6]
    train = gnn.sparse_ops(cfg, "train", SHAPE)
    assert len(train) == 3 + 5 * 3
    # each layer's backward: scores again (K = 2), dα (K = D), dV (D),
    # dq and dk (width 2): 2·nnz·(2 + D + D + 2 + 2)
    back = [w.flops for w in train[3:]]
    assert sum(back) == 2 * NNZ * ((6 + 2 * 4) + 2 * (6 + 2 * 16))
    # the projections h a_src, h a_dst beside HW
    assert flops(gnn.dense_ops(cfg, "infer", SHAPE)) == \
        2 * N * (32 * 16 + 16 * 16 + 16 * 4) + 2 * 2 * N * (16 + 16 + 4)


def test_graph_a_numbers():
    """The least time of a GCN request on graph (a) (N = 16384, 26.86 M
    nonzeros): ≈ 0.20 ms, byte-bound at every layer."""
    cfg = {"n_layers": 3, "in_features": 256, "hidden": 128,
           "n_classes": 16, "model": "gcn"}
    ops = gnn.sparse_ops(cfg, "infer", {"n": 16384, "nnz": 26_859_867})
    assert least_s(ops) == pytest.approx(2.03e-4, rel=0.01)
    assert all(w.nbytes / PEAK_BYTES_PER_S > w.flops / PEAK_F32_FLOP_PER_S
               for w in ops)

"""Port parity for the slice as a whole: GAT node-classification serving.

On ``SMOKE_CONFIG`` the JAX ``GNNServingEngine(model="gat")`` and the
port's engine (on the CPU) serve the same numpy features over the same
graph with the same weights (JAX's He init, converted through
``gat_params_from_numpy``), fused and unfused: the same plan and path,
and logits within rtol 1e-4, atol 1e-5 (the reference's fused-vs-unfused
GAT tolerance: three layers of exp and f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_gnn import SMOKE_CONFIG as J_SMOKE
from repro.models.gnn import _segment_softmax as j_segment_softmax
from repro.models.gnn import build_graph as j_build_graph
from repro.models.gnn import init_gat as j_init_gat
from repro.serve.engine import GNNServeConfig as JServeConfig
from repro.serve.engine import GNNServingEngine as JEngine
from repro_torch.configs.paper_gnn import SMOKE_CONFIG
from repro_torch.data.pipeline import random_graph
from repro_torch.dispatch.dispatcher import clear_log, dispatch_log
from repro_torch.models.gnn import (Graph, _segment_softmax, build_graph,
                                    gat_forward, gat_params_from_numpy,
                                    graph_candidates, init_gat)
from repro_torch.serve.engine import GNNServeConfig, GNNServingEngine
from repro_torch.sparse.matrix import SparseMatrix

TOL = dict(rtol=1e-4, atol=1e-5)
N = 256


def _adjacency(kind):
    rng = np.random.default_rng(7)
    if kind == "ell":  # uniform density 0.1
        return (rng.random((N, N)) < 0.1).astype(np.float32)
    if kind == "sell":  # skewed, > 99 % sparse
        return random_graph(N, 1.0, seed=1)
    return (rng.random((N, N)) < 0.01).astype(np.float32)  # csr


def _params():
    params = j_init_gat(jax.random.PRNGKey(0), J_SMOKE)
    return params, {k: [np.asarray(x) for x in v] for k, v in params.items()}


@pytest.mark.parametrize("kind", ["ell", "sell", "csr"])
@pytest.mark.parametrize("fuse", [True, False])
def test_engine_matches_reference(kind, fuse):
    adj = _adjacency(kind)
    jparams, nparams = _params()
    ref = JEngine(jparams, j_build_graph(adj, J_SMOKE),
                  JServeConfig(model="gat", fuse=fuse))
    graph = build_graph(adj, SMOKE_CONFIG, device="cpu")
    ours = GNNServingEngine(gat_params_from_numpy(nparams, "cpu"), graph,
                            GNNServeConfig(model="gat", fuse=fuse))
    assert ours.plan.path == ref.plan.path == kind
    assert ours.plan.reason == ref.plan.reason
    assert not ours.plan.use_kernel
    x = np.random.default_rng(2).normal(
        size=(N, SMOKE_CONFIG.in_features)).astype(np.float32)
    clear_log()
    logits = ours.infer(x)
    log = dispatch_log()
    if fuse:  # one fused-attention plan per layer, on the planned path
        assert [(p.op, p.path, p.fused) for p in log] \
            == [("fused_attn", kind, "attn")] * 3
    else:  # sample + matmul per layer, on the element pattern
        assert [p.op for p in log] == ["sddmm", "spmm"] * 3
        assert all(p.path in ("csr", "dense") for p in log)
    want = ref.infer(x)
    assert logits.shape == (N, SMOKE_CONFIG.n_classes)
    np.testing.assert_allclose(logits.numpy(), want, **TOL)
    report, ref_report = ours.dispatch_report(), ref.dispatch_report()
    for key in ("model", "fused", "path", "policy", "plan_op", "reason",
                "density", "occupancy", "padded_stream_blowup"):
        assert report[key] == ref_report[key], key
    assert report["plan_op"] == ("fused_attn" if fuse else "spmm")


def test_fused_and_unfused_agree_and_init_is_seeded():
    graph = build_graph(_adjacency("ell"), SMOKE_CONFIG, device="cpu")
    params = init_gat(SMOKE_CONFIG, seed=4, device="cpu")
    assert [tuple(w.shape) for w in params["w"]] == [(32, 16), (16, 16),
                                                     (16, 4)]
    assert [tuple(a.shape) for a in params["a_src"]] == [(16, 1), (16, 1),
                                                         (4, 1)]
    again = init_gat(SMOKE_CONFIG, seed=4, device="cpu")
    for key in ("w", "a_src", "a_dst"):
        assert all(torch.equal(a, b) for a, b in zip(params[key],
                                                     again[key]))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(N, 32)).astype(np.float32))
    np.testing.assert_allclose(
        gat_forward(params, graph, x, fuse=True).numpy(),
        gat_forward(params, graph, x, fuse=False).numpy(), **TOL)
    with pytest.raises(ValueError, match="a_src"):
        gat_params_from_numpy({"w": []}, "cpu")


def test_segment_softmax_matches_reference():
    rng = np.random.default_rng(8)
    rows = np.sort(rng.integers(0, 10, size=60)).astype(np.int32)
    scores = rng.normal(size=60).astype(np.float32) * 5
    want = j_segment_softmax(jnp.asarray(scores), jnp.asarray(rows), 12)
    got = _segment_softmax(torch.from_numpy(scores), torch.from_numpy(rows),
                           12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("formats,want", [
    (("coo",), ("ell",)),
    (("coo", "csr"), ("ell", "csr")),
    (("ell", "csr"), ("ell", "csr")),
    (("csr",), ("csr",)),
])
def test_graph_candidates_follow_the_reference_rule(formats, want):
    adj = _adjacency("ell")
    block = (SMOKE_CONFIG.block_m, SMOKE_CONFIG.block_n)
    mat = SparseMatrix.from_dense(adj, formats=formats, block=block,
                                  device="cpu")
    assert graph_candidates(mat) == want
    if formats == ("coo",):  # a coo-only graph serves fused GAT on ell
        eng = GNNServingEngine(init_gat(SMOKE_CONFIG, device="cpu"),
                               Graph(adj=mat, n_nodes=N),
                               GNNServeConfig(model="gat"))
        assert eng.plan.path == "ell"
        x = np.random.default_rng(9).normal(size=(N, 32)).astype(np.float32)
        ell = Graph(adj=SparseMatrix.from_dense(adj, formats=("ell",),
                                                block=block, device="cpu"),
                    n_nodes=N)
        np.testing.assert_allclose(
            eng.infer(x).numpy(),
            gat_forward(eng.params, ell, torch.from_numpy(x),
                        policy="ell").numpy(), **TOL)

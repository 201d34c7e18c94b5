"""Port parity for the slice as a whole: GCN node-classification serving.

On ``SMOKE_CONFIG`` the JAX ``GNNServingEngine`` and the port's engine
(on the CPU) serve the same numpy features over the same graph with the
same weights (JAX's He init, converted through ``gcn_params_from_numpy``):
the same plan, the same reported path, and logits within rtol 1e-4,
atol 1e-5 (three layers of f32 sums taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_gnn import SMOKE_CONFIG as J_SMOKE
from repro.models.gnn import build_graph as j_build_graph
from repro.models.gnn import init_gcn as j_init_gcn
from repro.serve.engine import GNNServeConfig as JServeConfig
from repro.serve.engine import GNNServingEngine as JEngine
from repro.sparse import SparseMatrix as JSparseMatrix
from repro.sparse import matmul as j_matmul
from repro_torch.configs.paper_gnn import SMOKE_CONFIG
from repro_torch.data.pipeline import random_graph
from repro_torch.models.gnn import (build_graph, gcn_forward,
                                    gcn_params_from_numpy, init_gat,
                                    init_gcn)
from repro_torch.serve.engine import GNNServeConfig, GNNServingEngine
from repro_torch.sparse.matrix import SparseMatrix
from repro_torch.sparse.ops import matmul

TOL = dict(rtol=1e-4, atol=1e-5)
N = 256


def _adjacency(kind):
    rng = np.random.default_rng(7)
    if kind == "ell":  # uniform density 0.1
        return (rng.random((N, N)) < 0.1).astype(np.float32)
    if kind == "sell":  # skewed, > 99 % sparse
        return random_graph(N, 1.0, seed=1)
    return (rng.random((N, N)) < 0.01).astype(np.float32)  # csr


def _params(bias):
    params = j_init_gcn(jax.random.PRNGKey(0), J_SMOKE, bias=bias)
    if bias:  # non-zero biases, so the epilogue's bias term shows
        rng = np.random.default_rng(1)
        params["b"] = [jnp.asarray(rng.normal(size=b.shape), jnp.float32)
                       for b in params["b"]]
    return params, {k: [np.asarray(x) for x in v] for k, v in params.items()}


@pytest.mark.parametrize("kind", ["ell", "sell", "csr"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("fuse", [True, False])
def test_engine_matches_reference(kind, bias, fuse):
    adj = _adjacency(kind)
    jparams, nparams = _params(bias)
    ref = JEngine(jparams, j_build_graph(adj, J_SMOKE),
                  JServeConfig(fuse=fuse))
    graph = build_graph(adj, SMOKE_CONFIG, device="cpu")
    ours = GNNServingEngine(gcn_params_from_numpy(nparams, "cpu"), graph,
                            GNNServeConfig(fuse=fuse))
    assert ours.plan.path == ref.plan.path == kind
    assert ours.plan.reason == ref.plan.reason
    assert not ours.plan.use_kernel
    x = np.random.default_rng(2).normal(
        size=(N, SMOKE_CONFIG.in_features)).astype(np.float32)
    for _ in range(2):
        logits = ours.infer(x)
        want = ref.infer(x)
    assert logits.shape == (N, SMOKE_CONFIG.n_classes)
    np.testing.assert_allclose(logits.numpy(), want, **TOL)
    np.testing.assert_array_equal(ours.classify(x).numpy(),
                                  np.asarray(want).argmax(-1))
    report, ref_report = ours.dispatch_report(), ref.dispatch_report()
    for key in ("path", "policy", "plan_op", "density", "occupancy",
                "padded_stream_blowup"):
        assert report[key] == ref_report[key], key
    assert report["n_requests"] == 3
    # one plan per (width, epilogue) on the first request, memo hits after
    assert report["plan_cache"] == {"hits": 7, "misses": 2, "entries": 2}


@pytest.mark.parametrize("path", ["ell", "sell", "csr"])
@pytest.mark.parametrize("act", ["identity", "relu", "leaky_relu"])
def test_matmul_epilogue_with_residual_matches_reference(path, act):
    rng = np.random.default_rng(3)
    a = np.where(rng.random((90, 70)) < 0.05, rng.normal(size=(90, 70)),
                 0.0).astype(np.float32)
    h = rng.normal(size=(70, 12)).astype(np.float32)
    bias = rng.normal(size=(12,)).astype(np.float32)
    res = rng.normal(size=(90, 12)).astype(np.float32)
    formats = ("ell", "sell", "csr")
    ref = j_matmul(JSparseMatrix.from_dense(a, formats=formats,
                                            block=(16, 16)),
                   jnp.asarray(h), policy=path, epilogue=act,
                   bias=jnp.asarray(bias), residual=jnp.asarray(res))
    ours = matmul(SparseMatrix.from_dense(a, formats=formats,
                                          block=(16, 16), device="cpu"),
                  torch.from_numpy(h), policy=path, epilogue=act,
                  bias=torch.from_numpy(bias), residual=torch.from_numpy(res))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_numpy_seeded_init_and_fuse_agree():
    graph = build_graph(_adjacency("ell"), SMOKE_CONFIG, device="cpu")
    params = init_gcn(SMOKE_CONFIG, seed=4, bias=True, device="cpu")
    assert [tuple(w.shape) for w in params["w"]] == [(32, 16), (16, 16),
                                                     (16, 4)]
    again = init_gcn(SMOKE_CONFIG, seed=4, bias=True, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(params["w"], again["w"]))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(N, 32)).astype(np.float32))
    np.testing.assert_allclose(
        gcn_forward(params, graph, x, fuse=True).numpy(),
        gcn_forward(params, graph, x, fuse=False).numpy(), **TOL)


def test_gat_is_a_later_slice():
    """GAT came with the slice after GCN: it is served now, planned as one
    fused-attention pipeline; other models still raise."""
    graph = build_graph(_adjacency("csr"), SMOKE_CONFIG, device="cpu")
    eng = GNNServingEngine(init_gat(SMOKE_CONFIG, device="cpu"), graph,
                           GNNServeConfig(model="gat"))
    report = eng.dispatch_report()
    assert (report["model"], report["plan_op"]) == ("gat", "fused_attn")
    x = np.random.default_rng(6).normal(size=(N, 32)).astype(np.float32)
    assert eng.infer(x).shape == (N, SMOKE_CONFIG.n_classes)
    with pytest.raises(ValueError):
        GNNServingEngine(init_gcn(SMOKE_CONFIG, device="cpu"), graph,
                         GNNServeConfig(model="mlp"))


def test_cuda_requested_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_graph(_adjacency("csr"), SMOKE_CONFIG)
    with pytest.raises(RuntimeError, match="cuda"):
        init_gcn(SMOKE_CONFIG)

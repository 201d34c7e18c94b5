"""GCN on the SpMM substrate — the paper's driving app (the GCN part of
``repro.models.gnn``).

GCN layer:   H' = act( Â (H W) )   — one SpMM per layer; with
             ``fuse=True`` (default) the bias + relu tail rides the
             SpMM's fused epilogue instead of a separate pass.

The adjacency is one :class:`SparseMatrix` carrying the Block-ELL and
element forms (plus SELL-C-σ when it is hyper-sparse), so the dispatcher
can route any of their paths.  Weights are a plain dict
``{"w": [W_0, ...], "b": [b_0, ...]}`` of tensors; ``"b"`` is optional.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.paper_gnn import GNNConfig
from repro_torch.device import resolve_device
from repro_torch.sparse.matrix import SparseMatrix
from repro_torch.sparse.ops import matmul

# adjacency paths a Graph can execute (the densified fallback is
# deliberately excluded from auto planning)
GRAPH_PATHS = ("ell", "sell", "csr")


def graph_candidates(adj: SparseMatrix):
    """Paths an adjacency's carried forms can execute."""
    return tuple(p for p in GRAPH_PATHS if adj.has_form(p))


@dataclasses.dataclass(frozen=True)
class Graph:
    """Normalized adjacency as one ``SparseMatrix``, on one device."""

    adj: SparseMatrix
    n_nodes: int

    @property
    def stats(self):
        return self.adj.stats

    @property
    def device(self) -> torch.device:
        return self.adj.device


def build_graph(adj_dense: np.ndarray, cfg: GNNConfig,
                normalize: bool = True, *, device="cuda") -> Graph:
    """adj_dense: [N, N] 0/1.  GCN normalization Â = D^-1/2 (A+I) D^-1/2."""
    n = adj_dense.shape[0]
    a = adj_dense.astype(np.float32)
    if normalize:
        a = a + np.eye(n, dtype=np.float32)
        deg = a.sum(1)
        dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        a = a * dinv[:, None] * dinv[None, :]
    adj = SparseMatrix.from_dense(a, formats=("ell", "csr"),
                                  block=(cfg.block_m, cfg.block_n),
                                  device=device)
    if adj.stats is not None and adj.stats.sparsity >= 0.99:
        # hyper-sparse adjacency: also pack SELL-C-σ so dispatch can
        # route around the Block-ELL padding cliff
        adj = adj.with_form("sell")
    return Graph(adj=adj, n_nodes=n)


def graph_spmm(graph: Graph, h, *, policy: str = "auto", epilogue=None,
               bias=None, residual=None):
    """One message-passing step A @ H, routed by the dispatch layer over
    the paths the adjacency's forms can run (memoized per graph)."""
    if graph.adj is None or graph.adj.stats is None:
        raise ValueError(
            "graph_spmm: Graph adjacency has no sparsity stats; construct "
            "it with build_graph() to use policy routing")
    cand = graph_candidates(graph.adj)
    return matmul(graph.adj, h, policy=policy,
                  candidates=cand or GRAPH_PATHS, epilogue=epilogue,
                  bias=bias, residual=residual)


def _gcn_dims(cfg: GNNConfig):
    return [cfg.in_features] + [cfg.hidden] * (cfg.n_layers - 1) \
        + [cfg.n_classes]


def init_gcn(cfg: GNNConfig, *, seed: int = 0, bias: bool = False,
             device="cuda") -> Dict:
    """He-initialized GCN weights drawn from ``np.random.default_rng(seed)``
    (the JAX package draws from ``jax.random``; weights cross between the
    two packages through :func:`gcn_params_from_numpy`)."""
    rng = np.random.default_rng(seed)
    dims = _gcn_dims(cfg)
    params = {"w": [(rng.standard_normal((dims[i], dims[i + 1]))
                     / np.sqrt(dims[i])).astype(np.float32)
                    for i in range(cfg.n_layers)]}
    if bias:
        params["b"] = [np.zeros((dims[i + 1],), np.float32)
                       for i in range(cfg.n_layers)]
    return gcn_params_from_numpy(params, device)


def gcn_params_from_numpy(params: Dict, device="cuda") -> Dict:
    """``{"w": [...], "b": [...]}`` of numpy arrays (e.g. the JAX
    package's params through ``np.asarray``) -> the same dict of f32
    tensors on ``device``."""
    device = resolve_device(device)
    return {k: [torch.as_tensor(np.array(x, np.float32), device=device)
                for x in v]
            for k, v in params.items()}


def gcn_forward(params, graph: Graph, x: torch.Tensor, *,
                policy: Optional[str] = "auto", fuse: bool = True):
    """GCN forward pass.

    ``policy`` routes each layer's aggregation through the dispatcher
    ("auto" or a forced path).  ``fuse=True`` (default) folds each
    layer's bias (when the params carry ``"b"``) and the inter-layer relu
    into the aggregation's epilogue; ``fuse=False`` keeps the unfused
    composition as the oracle.
    """
    biases = params.get("b")
    h = x
    n_layers = len(params["w"])
    for i, w in enumerate(params["w"]):
        h = h @ w
        b = biases[i] if biases is not None else None
        inner = i < n_layers - 1
        if fuse:
            h = graph_spmm(graph, h, policy=policy,
                           epilogue="relu" if inner else None, bias=b)
        else:
            h = graph_spmm(graph, h, policy=policy)
            if b is not None:
                h = h + b
            if inner:
                h = torch.relu(h)
    return h

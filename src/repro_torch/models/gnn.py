"""GCN / GAT on the SpMM + SDDMM substrate — the paper's driving app (the
port of ``repro.models.gnn``).

GCN layer:   H' = act( Â (H W) )   — one SpMM per layer; with
             ``fuse=True`` (default) the bias + relu tail rides the
             SpMM's fused epilogue instead of a separate pass.
GAT layer:   e = SDDMM(A, B, C) with K = 2 (paper §4.4: B / C hold the
             source / destination attention scores), a segment softmax
             over each row's edges and an SpMM with the attention-weighted
             adjacency.  With ``fuse=True`` (default) the chain is ONE
             ``fused_graph_attention`` dispatch (kernel K7 or K8).

The adjacency is one :class:`SparseMatrix` carrying the Block-ELL and
element forms (plus SELL-C-σ when it is hyper-sparse), so the dispatcher
can route any of their paths.  GCN weights are a plain dict
``{"w": [W_0, ...], "b": [b_0, ...]}`` of tensors (``"b"`` optional),
GAT weights ``{"w": [...], "a_src": [...], "a_dst": [...]}``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.paper_gnn import GNNConfig
from repro_torch.device import resolve_device
from repro_torch.sparse.matrix import SparseMatrix
from repro_torch.sparse.paths import segment_sums
from repro_torch.sparse.ops import fused_graph_attention, matmul, sample

# adjacency paths a Graph can execute (the densified fallback is
# deliberately excluded from auto planning)
GRAPH_PATHS = ("ell", "sell", "csr")


def graph_candidates(adj: SparseMatrix):
    """Paths an adjacency's carried forms can execute (``ell`` runs on
    an ``ell`` or a ``coo`` form)."""
    return tuple(p for p in GRAPH_PATHS
                 if adj.has_form(p) or (p == "ell" and adj.has_form("coo")))


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

    @property
    def row_ids(self) -> torch.Tensor:
        """Row id of every edge, in the element (csr) order."""
        return self.adj.form("csr")[0]


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


def _he(rng, shape) -> np.ndarray:
    return (rng.standard_normal(shape) / np.sqrt(shape[0])) \
        .astype(np.float32)


def init_gcn(cfg: GNNConfig, *, seed: int = 0, bias: bool = False,
             device="cuda") -> Dict:
    """He-initialized GCN weights drawn from ``np.random.default_rng(seed)``
    (the JAX package draws from ``jax.random``; weights cross between the
    two packages through :func:`gcn_params_from_numpy`)."""
    rng = np.random.default_rng(seed)
    dims = _gcn_dims(cfg)
    params = {"w": [_he(rng, (dims[i], dims[i + 1]))
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


def batch_graphs(graphs):
    """Compose many Graphs' adjacencies block-diagonally: a
    :class:`repro_torch.batch.BatchedSparseMatrix`, whose ``.matrix`` runs
    the whole batch through one planned aggregation per layer."""
    from repro_torch.batch import BatchedSparseMatrix

    return BatchedSparseMatrix.from_matrices([g.adj for g in graphs])


def gcn_forward_batched(params, batch, hs, *, policy: str = "auto"):
    """GCN over N graphs at once through the block-diagonal composition.

    GCN weights are node-independent, so ``diag(A_1..A_N) @ (H W)``
    computes every graph's aggregation in one SpMM per layer.  ``hs``
    holds per-graph features [n_i, in_features]; returns the per-graph
    logits.
    """
    h = batch.batch_features(hs)
    g = Graph(adj=batch.matrix, n_nodes=batch.matrix.shape[0])
    return batch.unbatch(gcn_forward(params, g, h, policy=policy))


# ---------------------------------------------------------------------------
# GAT (single head; attention scores via SDDMM with K = 2, per the paper)
# ---------------------------------------------------------------------------


def init_gat(cfg: GNNConfig, *, seed: int = 0, device="cuda") -> Dict:
    """He-initialized GAT weights drawn from ``np.random.default_rng(seed)``
    (per layer: W, then a_src and a_dst, each [out, 1]); weights of the
    JAX package cross over through :func:`gat_params_from_numpy`."""
    rng = np.random.default_rng(seed)
    dims = _gcn_dims(cfg)
    params = {"w": [], "a_src": [], "a_dst": []}
    for i in range(cfg.n_layers):
        params["w"].append(_he(rng, (dims[i], dims[i + 1])))
        params["a_src"].append(_he(rng, (dims[i + 1], 1)))
        params["a_dst"].append(_he(rng, (dims[i + 1], 1)))
    return gat_params_from_numpy(params, device)


def gat_params_from_numpy(params: Dict, device="cuda") -> Dict:
    """``{"w", "a_src", "a_dst"}`` lists of numpy arrays (e.g. the JAX
    package's GAT params through ``np.asarray``) -> the same dict of f32
    tensors on ``device``."""
    if set(params) != {"w", "a_src", "a_dst"}:
        raise ValueError("GAT params need exactly 'w', 'a_src' and 'a_dst',"
                         f" got {sorted(params)}")
    return gcn_params_from_numpy(params, device)


def _segment_softmax(scores, row_ids, n_rows: int, col_ids=None):
    """Softmax of ``scores`` within each row's edges (``row_ids``).  The
    row max is a shift the softmax does not depend on, so it is detached:
    ``scatter_reduce("amax")`` would split its gradient among ties.  The
    denominators are summed in one fixed order (``paths.segment_sums``,
    its row order memoized on ``row_ids`` beside the triplet's
    ``col_ids``, by default the row ids themselves)."""
    col_ids = row_ids if col_ids is None else col_ids
    idx = row_ids.long()
    mx = scores.detach().new_full((n_rows,), -float("inf")).scatter_reduce(
        0, idx, scores.detach(), "amax")
    ex = torch.exp(scores - mx[idx])
    den = segment_sums(ex, row_ids, col_ids, n_rows)
    return ex / den[idx].clamp_min(1e-12)


def gat_forward(params, graph: Graph, x: torch.Tensor, *,
                policy: Optional[str] = None, fuse: bool = True):
    """GAT forward pass (single head, K = 2 SDDMM scores per the paper).

    ``fuse=True`` (default) runs each layer's attention aggregation as
    ONE planned ``fused_graph_attention`` dispatch over the adjacency's
    carried forms.  ``fuse=False`` keeps the unfused composition (SDDMM
    on the 0/1 element pattern, leaky relu, segment softmax, SpMM) as
    the oracle, routed by the dispatcher under ``policy`` (default
    "auto").
    """
    policy = "auto" if policy is None else policy
    h = x
    n = graph.n_nodes
    cand = graph_candidates(graph.adj) if fuse else None
    # 0/1 edge pattern in element form: the SDDMM sampling operand (the
    # attention scores ignore the normalized adjacency weights)
    patt = None if fuse else graph.adj.to("csr").pattern()
    n_layers = len(params["w"])
    for i, w in enumerate(params["w"]):
        h = h @ w
        s_src = (h @ params["a_src"][i])[:, 0]  # [N]
        s_dst = (h @ params["a_dst"][i])[:, 0]
        # score factors with K = 2: q = [s_src, 1], k = [1, s_dst], so
        # (q kᵀ)[i, j] = s_src[i] + s_dst[j]
        q = torch.stack([s_src, torch.ones_like(s_src)], dim=1)
        if fuse:
            k = torch.stack([torch.ones_like(s_dst), s_dst], dim=1)
            h = fused_graph_attention(graph.adj, q, k, h,
                                      edge_act="leaky_relu",
                                      negative_slope=0.2, policy=policy,
                                      candidates=cand or None)
        else:
            c = torch.stack([torch.ones_like(s_dst), s_dst], dim=0)
            e = sample(patt, q, c, policy=policy).data  # [nnz]
            alpha = _segment_softmax(F.leaky_relu(e, 0.2), graph.row_ids,
                                     n, graph.adj.form("csr")[1])
            h = matmul(patt.with_data(alpha), h, policy=policy)
        if i < n_layers - 1:
            h = F.elu(h)
    return h

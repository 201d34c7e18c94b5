"""Node-classification serving over a fixed graph (the port of
``GNNServingEngine`` from ``repro.serve.engine``).

The aggregation path is chosen once per graph, at construction, by the
dispatch layer from the graph's sparsity stats; every request then runs
the GCN or GAT forward eagerly on that path.  A fused GAT is planned on
the one-pass attention cost surface (``plan_fused_attention``) and served
on that plan's path; an unfused GAT samples on the element pattern, so
it is served under the configured policy.  The engine reports which path
serves traffic and why.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.dispatch.dispatcher import plan_fused_attention, plan_spmm
from repro_torch.models.gnn import (GRAPH_PATHS, Graph, gat_forward,
                                    gcn_forward, graph_candidates)
from repro_torch.sparse.plan import plan_cache_stats


@dataclasses.dataclass
class GNNServeConfig:
    policy: str = "auto"   # dispatch policy for the aggregation SpMM
    d: Optional[int] = None  # planning feature width (inferred if None)
    model: str = "gcn"     # "gcn" | "gat"
    fuse: bool = True      # fused epilogue (GCN) / one-pass attention (GAT)


def _infer_planning_width(params) -> int:
    """Feature width the SpMM plan prices: the first layer's output
    width under the ``{"w": [...]}`` convention, else the first 2-D
    tensor found in the params (any layer's width ranks the paths the
    same way)."""
    ws = params.get("w") if isinstance(params, dict) else None
    if isinstance(ws, (list, tuple)):
        ws = ws[0] if ws else None
    if ws is not None and getattr(ws, "ndim", 0) == 2:
        return int(ws.shape[1])
    stack = [params]
    while stack:
        leaf = stack.pop(0)
        if isinstance(leaf, dict):
            stack.extend(leaf.values())
        elif isinstance(leaf, (list, tuple)):
            stack.extend(leaf)
        elif getattr(leaf, "ndim", 0) == 2:
            return int(leaf.shape[1])
    raise ValueError(
        "could not infer a planning feature width from the params "
        "(no 2-D weight leaf); pass GNNServeConfig(d=...) explicitly")


class GNNServingEngine:
    """Serves GCN or GAT node classification over a fixed graph, on the
    graph's device (``build_graph(..., device=...)``; the card by
    default)."""

    def __init__(self, params, graph: Graph,
                 scfg: Optional[GNNServeConfig] = None):
        self.params = params
        self.graph = graph
        self.scfg = scfg or GNNServeConfig()
        if graph.adj is None or graph.adj.stats is None:
            raise ValueError(
                "GNNServingEngine: Graph adjacency has no sparsity stats; "
                "construct it with build_graph()")
        if self.scfg.model not in ("gcn", "gat"):
            raise ValueError(
                f"GNNServeConfig.model must be 'gcn' or 'gat', got "
                f"{self.scfg.model!r}")
        d = self.scfg.d if self.scfg.d is not None \
            else _infer_planning_width(params)
        cand = graph_candidates(graph.adj) or GRAPH_PATHS
        fuse = self.scfg.fuse
        if self.scfg.model == "gat" and fuse:
            # one-pass attention: priced as a single stream of the
            # topology at the combined (score + value) width
            self.plan = plan_fused_attention(
                graph.adj.stats, 2, d, policy=self.scfg.policy,
                device=graph.device, candidates=cand)
        else:
            self.plan = plan_spmm(graph.adj.stats, d,
                                  policy=self.scfg.policy,
                                  device=graph.device, candidates=cand)
        # an unfused GAT samples on the element pattern, so the layout
        # plan applies to the fused pipeline and to GCN only
        self._policy = self.scfg.policy \
            if self.scfg.model == "gat" and not fuse else self.plan.path
        self.n_requests = 0

    @property
    def device(self) -> torch.device:
        return self.graph.device

    def infer(self, x) -> torch.Tensor:
        """x: [n_nodes, in_features] (numpy or tensor) -> logits
        [n_nodes, n_classes] on the engine's device."""
        self.n_requests += 1
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        forward = gat_forward if self.scfg.model == "gat" else gcn_forward
        with torch.no_grad():
            return forward(self.params, self.graph, x, policy=self._policy,
                           fuse=self.scfg.fuse)

    def classify(self, x) -> torch.Tensor:
        return self.infer(x).argmax(dim=-1)

    def dispatch_report(self) -> Dict:
        """Which path serves this graph's traffic, and why."""
        stats = self.graph.adj.stats
        return {
            "model": self.scfg.model,
            "fused": self.scfg.fuse,
            "plan_op": self.plan.op,
            "path": self.plan.path,
            "policy": self.plan.policy,
            "reason": self.plan.reason,
            "use_kernel": self.plan.use_kernel,
            "density": stats.density,
            "occupancy": stats.occupancy,
            "padded_stream_blowup": stats.padded_stream_blowup,
            "n_requests": self.n_requests,
            "plan_cache": self.graph.adj.plan_cache.stats(),
            "plan_cache_global": plan_cache_stats(),
        }

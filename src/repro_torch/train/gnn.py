"""Full-batch GNN training, the paper's driving application (the port of
``examples/gnn_train.py``).

Trains the 3-layer GCN or GAT of ``configs/paper_gnn.py`` (feature dim
256, hidden 128) on a synthetic random graph with planted community
labels: a full-batch NLL loss, and a plain SGD step ``p -= lr * g``.
Gradients flow through the SpMM <-> SDDMM backward rules of
``repro_torch.sparse.autodiff``, so on the card every step runs the
forward kernels (K5 / K6 and K1 / K2 for GCN, K7 / K8 for GAT) and, for
GAT, the backward's SDDMM and SpMM kernels (K3 / K4, K1 / K2).

    python -m repro_torch.train.gnn [--kind gat] [--n 512] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and raises where
there is no card.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs.paper_gnn import CONFIG, GNNConfig
from repro_torch.data.pipeline import random_graph
from repro_torch.device import resolve_device
from repro_torch.dispatch.dispatcher import last_plan
from repro_torch.models.gnn import (Graph, build_graph, gat_forward,
                                    gcn_forward, init_gat, init_gcn)
from repro_torch.sparse.plan import plan_cache_stats

Params = Dict[str, List[torch.Tensor]]
FORWARD: Dict[str, Callable] = {"gcn": gcn_forward, "gat": gat_forward}


def planted_labels(n: int, n_classes: int) -> np.ndarray:
    """Contiguous communities of equal size, so the task is learnable."""
    return (np.arange(n) * n_classes // n).astype(np.int64)


def init_params(kind: str, cfg: GNNConfig = CONFIG, *, seed: int = 0,
                device="cuda") -> Params:
    """Seeded He weights of ``kind``'s model, each requiring grad."""
    init = {"gcn": init_gcn, "gat": init_gat}[kind]
    return trainable(init(cfg, seed=seed, device=device))


def trainable(params: Params) -> Params:
    """Mark every parameter tensor as requiring grad (in place)."""
    for _, p in named_parameters(params):
        p.requires_grad_(True)
    return params


def named_parameters(params: Params) -> List[Tuple[str, torch.Tensor]]:
    """``("w[0]", tensor)`` for every parameter, keys in sorted order."""
    return [(f"{key}[{i}]", p) for key in sorted(params)
            for i, p in enumerate(params[key])]


def nll_and_accuracy(logits: torch.Tensor,
                     labels: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Mean NLL of the labels under ``log_softmax(logits)`` and the
    accuracy of the argmax."""
    nll = F.cross_entropy(logits, labels)
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return nll, acc


def loss_and_grads(params: Params, graph: Graph, x: torch.Tensor,
                   labels: torch.Tensor, *, kind: str = "gcn",
                   fuse: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """Forward and backward of one full batch: (loss, accuracy, the
    gradients in ``params``' layout)."""
    with obs.span("train.forward"):
        logits = FORWARD[kind](params, graph, x, fuse=fuse)
        nll, acc = nll_and_accuracy(logits, labels)
    with obs.span("train.backward"):
        grads = iter(torch.autograd.grad(
            nll, [p for _, p in named_parameters(params)]))
    return nll.detach(), acc, {key: [next(grads) for _ in params[key]]
                               for key in sorted(params)}


def sgd_update(params: Params, grads: Params, lr: float) -> None:
    """``p -= lr * g`` for every parameter, in place."""
    with torch.no_grad():
        for key, ps in params.items():
            for p, g in zip(ps, grads[key]):
                p.sub_(lr * g)


def train_step(params: Params, graph: Graph, x: torch.Tensor,
               labels: torch.Tensor, *, kind: str = "gcn", lr: float = 0.05,
               fuse: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """One full-batch SGD step; returns the loss and accuracy before it.
    The step is a ``train.step`` span holding ``train.forward``,
    ``train.backward`` and ``train.update``."""
    with obs.span("train.step"):
        loss, acc, grads = loss_and_grads(params, graph, x, labels,
                                          kind=kind, fuse=fuse)
        with obs.span("train.update"):
            sgd_update(params, grads, lr)
    return loss, acc


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", default="gcn", choices=tuple(FORWARD))
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    adj = random_graph(args.n, avg_degree=8, seed=1)
    graph = build_graph(adj, CONFIG, device=device)
    print(f"graph: {args.n} nodes, {int(adj.sum())} edges; adjacency "
          f"{graph.adj} on {device}")
    x = torch.from_numpy(rng.normal(size=(args.n, CONFIG.in_features))
                         .astype(np.float32)).to(device)
    labels = torch.from_numpy(planted_labels(args.n, CONFIG.n_classes)) \
        .to(device)
    params = init_params(args.kind, seed=0, device=device)

    t0 = time.perf_counter()
    for i in range(args.steps):
        loss, acc = train_step(params, graph, x, labels, kind=args.kind,
                               lr=args.lr)
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(loss):.4f}  acc "
                  f"{float(acc):.3f}")
    print(f"{args.kind} trained {args.steps} steps in "
          f"{time.perf_counter() - t0:.1f}s")
    plan = last_plan("spmm")
    print(f"last spmm plan: {plan.describe() if plan else None}; plan cache "
          f"{plan_cache_stats()}")


if __name__ == "__main__":
    main()

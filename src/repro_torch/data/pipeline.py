"""Synthetic graph generator (the port's copy of
``repro.data.pipeline.random_graph``; numpy only, same draws for the
same seed)."""
from __future__ import annotations

import numpy as np


def random_graph(n_nodes: int, avg_degree: float, seed: int = 0,
                 clustered: bool = True) -> np.ndarray:
    """Synthetic adjacency with power-law-ish degree skew (GNN-like)."""
    rng = np.random.default_rng(seed)
    if not clustered:
        density = avg_degree / n_nodes
        return (rng.random((n_nodes, n_nodes)) < density).astype(np.float32)
    # preferential-attachment-ish skewed degrees
    w = rng.pareto(2.0, n_nodes) + 1.0
    w /= w.sum()
    nnz = int(avg_degree * n_nodes)
    rows = rng.choice(n_nodes, size=nnz, p=w)
    cols = rng.integers(0, n_nodes, size=nnz)
    a = np.zeros((n_nodes, n_nodes), np.float32)
    a[rows, cols] = 1.0
    return a

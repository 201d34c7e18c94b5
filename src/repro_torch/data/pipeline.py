"""Synthetic sparse matrices and graphs (the port's copy of
``repro.data.pipeline.random_sparse_dense`` and ``random_graph``; numpy
only, same draws for the same seed)."""
from __future__ import annotations

from typing import Optional

import numpy as np


def random_sparse_dense(n: int, density: float, seed: int = 0,
                        m: Optional[int] = None) -> np.ndarray:
    """Random N x N (or M x N) matrix with the given density — the paper's
    synthetic workload ("random sparse and dense matrices, K=N")."""
    m = m or n
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n)) < density
    vals = rng.normal(size=(m, n)).astype(np.float32)
    return np.where(mask, vals, 0.0).astype(np.float32)


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

"""Deterministic synthetic data (the port of ``repro.data.pipeline``):
the LM token batches and the sparse matrices and graphs of the paper's
evaluation.  numpy draws, the same for the same seed (and step) as the
reference's; LM batches are returned as tensors on a device.

Per-host sharding: each host materializes only its slice of the global
batch (``host_index``/``host_count``), and batches are pure functions of
(seed, step), so a restarted host regenerates identical data.  Modality
frontends are stubs: ``vision_embeds`` / ``enc_embeds`` are
pseudo-random patch / frame embeddings of the right shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    # synthetic LM stream: a noisy long-range copy task so losses can
    # actually decrease (pure uniform noise has no learnable signal)
    structure: str = "ngram"  # ngram | uniform


def _host_slice(global_batch: int, dcfg: DataConfig):
    return global_batch // dcfg.host_count


def make_lm_batch(cfg: ModelConfig, seq_len: int, global_batch: int,
                  step: int, dcfg: DataConfig, *,
                  device="cuda") -> Dict[str, torch.Tensor]:
    b = _host_slice(global_batch, dcfg)
    rng = np.random.default_rng(
        (dcfg.seed * 1_000_003 + step) * 65_537 + dcfg.host_index)
    n_text = seq_len - cfg.vision_tokens
    if dcfg.structure == "ngram":
        # Markov-ish stream: next token = (3 * prev + noise) mod V
        toks = np.empty((b, n_text + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, b)
        noise = rng.integers(0, 7, (b, n_text))
        for t in range(n_text):
            toks[:, t + 1] = (3 * toks[:, t] + noise[:, t]) % cfg.vocab_size
    else:
        toks = rng.integers(0, cfg.vocab_size, (b, n_text + 1),
                            dtype=np.int32)
    batch = {
        "tokens": toks[:, :-1],
        "targets": toks[:, 1:],
        "mask": np.ones((b, n_text), np.float32),
    }
    if cfg.vision_tokens:
        batch["vision_embeds"] = rng.normal(
            size=(b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        batch["enc_embeds"] = rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def lm_data_iter(cfg: ModelConfig, shape: ShapeConfig,
                 dcfg: Optional[DataConfig] = None,
                 start_step: int = 0, *,
                 device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    dcfg = dcfg or DataConfig()
    step = start_step
    while True:
        yield make_lm_batch(cfg, shape.seq_len, shape.global_batch, step,
                            dcfg, device=device)
        step += 1


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

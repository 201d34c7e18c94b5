"""Sparse-weight transformer inference: magnitude pruning + conversion (the
port of ``repro.models.pruning``).

The paper's DLMC motivation in model form: transformer MLP weights are
magnitude-pruned at block granularity and shipped as planned
:class:`~repro_torch.sparse.matrix.SparseMatrix` operands, so every MLP
product in ``models.transformer`` runs through the sparsity-adaptive
dispatch front-end (``x @ W`` is ``(Wᵀ xᵀ)ᵀ``; on an ell plan that is
kernel N1, the transposed Block-ELL SpMM).

``sparsify_lm`` rewrites an ``init_lm`` params tree:

  * period blocks are *unstacked* (each period's leaves indexed out of
    the stacked ones, views) because each pruned weight carries its own
    structure;
  * every MLP ``wi``/``wg``/``wo`` becomes a ``SparseMatrix`` built on the
    weight's device from the pruned dense weight (pruned in numpy on the
    host, as the reference does, so the same tiles are kept);
  * everything else (embeddings, attention, norms) stays dense.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import tree_leaves, tree_map

# MLP weight leaves that get pruned + converted
_MLP_KEYS = ("wi", "wg", "wo")


def magnitude_prune(w, sparsity: float, block: Tuple[int, int] = (1, 1)
                    ) -> np.ndarray:
    """Zero the smallest-magnitude blocks of a [d_in, d_out] weight.

    ``block = (1, 1)`` is unstructured pruning; larger blocks score each
    tile by its L2 norm and drop whole tiles.  Keeps the
    ceil((1-sparsity) * n_blocks) highest-scoring blocks, so realized
    sparsity is within one block of the request.  ``w`` is a numpy array
    or a tensor (copied to the host).
    """
    if not 0.0 <= sparsity < 1.0:
        raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float32)
    m, n = w.shape
    bm, bn = block
    if m % bm or n % bn:
        raise ValueError(
            f"weight shape {w.shape} not divisible by prune block {block}")
    gm, gn = m // bm, n // bn
    tiles = w.reshape(gm, bm, gn, bn).transpose(0, 2, 1, 3)
    score = np.sqrt((tiles.astype(np.float64) ** 2).sum(axis=(2, 3)))
    keep = int(np.ceil((1.0 - sparsity) * gm * gn))
    if keep >= gm * gn:
        return w
    # stable cutoff: keep the `keep` largest tile norms
    flat = score.reshape(-1)
    order = np.argsort(-flat, kind="stable")
    mask = np.zeros(gm * gn, bool)
    mask[order[:keep]] = True
    tiles = tiles * mask.reshape(gm, gn, 1, 1)
    return tiles.transpose(0, 2, 1, 3).reshape(m, n).astype(np.float32)


def _to_sparse(w, *, sparsity: float, prune_block: Tuple[int, int],
               formats: Optional[Tuple[str, ...]], format: str,
               block: Tuple[int, int]):
    from repro_torch.sparse.matrix import SparseMatrix

    pruned = magnitude_prune(w, sparsity, prune_block)
    return SparseMatrix.from_dense(pruned, formats=formats, format=format,
                                   block=block, device=w.device)


def _sparsify_block(blk: Dict[str, Any], **kw) -> Dict[str, Any]:
    out = dict(blk)
    if "mlp" in blk:
        out["mlp"] = {
            k: (_to_sparse(v, **kw) if k in _MLP_KEYS else v)
            for k, v in blk["mlp"].items()
        }
    return out


def sparsify_lm(params: Dict[str, Any], cfg: ModelConfig, *,
                sparsity: float = 0.9,
                prune_block: Tuple[int, int] = (8, 8),
                formats: Optional[Tuple[str, ...]] = ("ell", "csr"),
                format: str = "auto",
                block: Tuple[int, int] = (64, 64)) -> Dict[str, Any]:
    """Prune every MLP weight of an ``init_lm`` params tree to
    ``SparseMatrix`` form; returns a new params dict with unstacked
    periods (safe to feed straight to ``forward_hidden`` /
    ``decode_step`` / ``lm_loss``).

    ``prune_block`` is the pruning granule (tile-norm magnitude
    pruning); ``block`` the Block-ELL storage tile of the converted
    operand; ``formats``/``format`` pass through to
    ``SparseMatrix.from_dense``.
    """
    kw = dict(sparsity=sparsity, prune_block=prune_block, formats=formats,
              format=format, block=block)
    out = dict(params)
    if cfg.n_periods and params["periods"]:
        unstacked = []
        for i in range(cfg.n_periods):
            period = tree_map(lambda a, i=i: a[i], params["periods"])
            unstacked.append(tuple(_sparsify_block(b, **kw)
                                   for b in period))
        out["periods"] = tuple(unstacked)
    out["remainder"] = tuple(_sparsify_block(b, **kw)
                             for b in params["remainder"])
    return out


def _is_sparse(x) -> bool:
    from repro_torch.sparse.matrix import SparseMatrix

    return isinstance(x, SparseMatrix)


def weight_sparsity_report(params: Dict[str, Any]) -> Dict[str, float]:
    """Measured structure of the sparse weights in a params tree.

    Returns aggregate counts over every ``SparseMatrix`` leaf:
    ``n_sparse`` operands, true ``nnz`` vs logical ``elements``, and
    the realized global ``sparsity``.
    """
    n_sparse, nnz, elements = 0, 0, 0
    for leaf in tree_leaves(params, is_leaf=_is_sparse):
        if _is_sparse(leaf):
            n_sparse += 1
            nnz += leaf.stats.nnz
            elements += leaf.stats.dense_elements
    return {
        "n_sparse": n_sparse,
        "nnz": nnz,
        "elements": elements,
        "sparsity": 1.0 - nnz / elements if elements else 0.0,
    }


def dense_reference(params: Dict[str, Any]) -> Dict[str, Any]:
    """Densify every ``SparseMatrix`` weight back to a dense tensor on its
    device — the numerical oracle for sparse-vs-dense parity.  The dense
    tensors are new and not memoized (``SparseMatrix.dense_copy``): they
    are freed with the tree, while the sparse model lives on."""
    return tree_map(
        lambda x: x.dense_copy() if _is_sparse(x) else x,
        params, is_leaf=_is_sparse)

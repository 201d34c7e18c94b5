"""The products one GCN or GAT request or training step performs, at the
widths each has, from the model's equations (not from the kernels that run
them).

GCN layer ``i``: ``Z = Â (H W)``; its backward ``Âᵀ dZ`` (for ``dW``; the
input layer too, whose ``dX`` is not needed) and ``dH = dZ Wᵀ``.

GAT layer ``i`` (one head, K = ``score_k`` = 2 scores ``q = [s_src, 1]``,
``k = [1, s_dst]``): the fused attention; its backward needs the attention
weights again (the scores' SDDMM at K: the forward keeps no per-edge array),
``dα = ḡ Vᵀ`` at the pattern (SDDMM at K = D), ``dV = αᵀ ḡ``, ``dq = dE
k`` and ``dk = dEᵀ q`` (SpMMs at width 2 over the per-edge ``dE``).  The
softmax's per-edge elementwise passes are not products and are not
counted.

The size of a run comes as ``shape``: ``n`` nodes and ``nnz`` nonzeros of
``A + I``, as the window's driver reports them.
"""
from __future__ import annotations

from typing import List

from bench.work.ops import (Work, dense_mm, fused_attention, sddmm, spmm,
                            spmm_t)


def widths(cfg: dict) -> List[int]:
    """Feature widths into and out of each layer."""
    return [cfg["in_features"]] + [cfg["hidden"]] * (cfg["n_layers"] - 1) \
        + [cfg["n_classes"]]


def sparse_ops(cfg: dict, op: str, shape: dict) -> List[Work]:
    """The sparse products of one request (``op="infer"``) or one
    training step (``op="train"``)."""
    n, nnz = shape["n"], shape["nnz"]
    dims = widths(cfg)
    out: List[Work] = []
    for i in range(cfg["n_layers"]):
        d = dims[i + 1]
        if cfg["model"] == "gcn":
            out.append(spmm(nnz, n, n, d, what=f"L{i} A@(HW)"))
        else:
            out.append(fused_attention(nnz, n, n, cfg["score_k"], d,
                                       what=f"L{i} attention"))
    if op == "train":
        k = cfg.get("score_k")
        for i in reversed(range(cfg["n_layers"])):
            d = dims[i + 1]
            if cfg["model"] == "gcn":
                out.append(spmm_t(nnz, n, n, d, what=f"L{i} A^T dZ"))
            else:
                out += [
                    sddmm(nnz, n, n, k, what=f"L{i} scores again"),
                    sddmm(nnz, n, n, d, what=f"L{i} dalpha"),
                    spmm_t(nnz, n, n, d, what=f"L{i} dV"),
                    spmm(nnz, n, n, k, what=f"L{i} dq"),
                    spmm_t(nnz, n, n, k, what=f"L{i} dk"),
                ]
    return out


def dense_ops(cfg: dict, op: str, shape: dict) -> List[Work]:
    """The dense products of one request or step: ``H W`` (and GAT's
    score projections ``h a``); in training also ``dW = Hᵀ dZ`` and
    ``dH = dZ Wᵀ`` (not for the input layer), and GAT's ``da`` and
    ``dh`` of the projections."""
    n, dims = shape["n"], widths(cfg)
    out: List[Work] = []
    gat = cfg["model"] == "gat"
    for i in range(cfg["n_layers"]):
        a, b = dims[i], dims[i + 1]
        out.append(dense_mm(n, a, b, what=f"L{i} HW"))
        if gat:
            out += [dense_mm(n, b, 1, what=f"L{i} h a_src"),
                    dense_mm(n, b, 1, what=f"L{i} h a_dst")]
        if op == "train":
            out.append(dense_mm(a, n, b, what=f"L{i} dW"))
            if i > 0:
                out.append(dense_mm(n, b, a, what=f"L{i} dH"))
            if gat:
                out += [dense_mm(b, n, 1, what=f"L{i} da_src"),
                        dense_mm(b, n, 1, what=f"L{i} da_dst"),
                        dense_mm(n, 1, b, what=f"L{i} dh from s_src"),
                        dense_mm(n, 1, b, what=f"L{i} dh from s_dst")]
    return out

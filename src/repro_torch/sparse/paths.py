"""Execution paths of the sparse front-end (the port of the SpMM half of
``repro.sparse.paths``).

Planning (which path runs) lives in ``repro_torch.sparse.ops``; these
functions only execute.  The ``ell`` and ``sell`` paths go through the
kernel wrappers, which launch the CUDA kernels for CUDA tensors and run
their plain versions for CPU tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.formats import BlockELL, SellCS
from repro_torch.kernels.spmm.ops import spmm_blockell
from repro_torch.kernels.spmm.sell import spmm_sell_blocked


def spmm_elements(row_ids, col_ids, values, h, num_rows: int):
    """Y = A @ H via gather + ``index_add_`` (element-granular, f32)."""
    gathered = values[:, None].float() * h[col_ids].float()
    out = torch.zeros((num_rows, h.shape[1]), dtype=torch.float32,
                      device=h.device)
    return out.index_add_(0, row_ids, gathered).to(h.dtype)


def spmm_ell(ell: BlockELL, h):
    """Y = A @ H with A in Block-ELL; H already padded to ell.shape[1]."""
    return spmm_blockell(ell, h)


def spmm_sell(sell: SellCS, h):
    """Y = A @ H with A in SELL-C-σ; h carries the logical N rows."""
    return spmm_sell_blocked(sell, h)


def spmm_dense(a_dense, h):
    """Dense baseline (the paper's Fig. 2 failure mode)."""
    return a_dense @ h


def densify_elements(row_ids, col_ids, values, shape: Tuple[int, int]):
    out = values.new_zeros(shape)
    return out.index_put_((row_ids.long(), col_ids.long()), values,
                          accumulate=True)


def densify_ell(ell: BlockELL):
    nbr, w, bm, bn = ell.blocks.shape
    out = ell.blocks.new_zeros((nbr, ell.shape[1] // bn, bm, bn))
    rows = torch.arange(nbr, device=ell.device)[:, None].expand(nbr, w)
    out.index_put_((rows, ell.indices.long()), ell.blocks, accumulate=True)
    return out.permute(0, 2, 1, 3).reshape(ell.shape)


def densify_sell(sell: SellCS):
    return densify_elements(sell.slot_rows, sell.slot_cols, sell.slot_vals,
                            sell.shape)


def pad_rows(x, target: int):
    """Zero-pad x's leading dim up to ``target`` (no-op when equal)."""
    if x.shape[0] == target:
        return x
    return F.pad(x, (0, 0) * (x.ndim - 1) + (0, target - x.shape[0]))

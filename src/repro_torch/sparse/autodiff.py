"""Execution of one planned SpMM path, with or without a fused epilogue
(the forward half of ``repro.sparse.autodiff``).

Serving takes no gradient, so there is no ``torch.autograd.Function``
here yet; the training slice adds the SpMM <-> SDDMM backward rules.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dispatch.policy import (PATH_CSR, PATH_DENSE, PATH_ELL,
                                         PATH_SELL)
from repro_torch.kernels.fused.epilogue import Epilogue, apply_epilogue
from repro_torch.kernels.fused.spmm import (spmm_blockell_fused,
                                            spmm_sell_fused)
from repro_torch.sparse import paths
from repro_torch.sparse.matrix import SparseMatrix


def spmm_exec(path: str, a: SparseMatrix, h: torch.Tensor) -> torch.Tensor:
    """Run one planned SpMM path; h: [N, D] logical rows; returns [M, D]."""
    m = a.shape[0]
    if path == PATH_ELL:
        ell = a.form("ell")
        return paths.spmm_ell(ell, paths.pad_rows(h, ell.shape[1]))[:m]
    if path == PATH_SELL:
        return paths.spmm_sell(a.form("sell"), h)
    if path == PATH_CSR:
        r, c, v = a.form("csr")
        return paths.spmm_elements(r, c, v, h, m)
    if path == PATH_DENSE:
        return paths.spmm_dense(a.densify(), h)
    raise ValueError(f"unknown spmm path {path!r}")


def spmm_epilogue_exec(path: str, epi: Epilogue, a: SparseMatrix,
                       h: torch.Tensor, bias: Optional[torch.Tensor],
                       residual: Optional[torch.Tensor]) -> torch.Tensor:
    """Run one planned SpMM path with its epilogue fused.

    The ell and sell paths apply the epilogue inside the kernel (K5, K6)
    before the output store; the other paths compose the product with
    the plain epilogue.  The result is the same either way.
    """
    if path == PATH_ELL:
        ell = a.form("ell")
        y = spmm_blockell_fused(ell, paths.pad_rows(h, ell.shape[1]), epi,
                                bias, residual)
        return y[: a.shape[0]]
    if path == PATH_SELL:
        return spmm_sell_fused(a.form("sell"), h, epi, bias, residual)
    return apply_epilogue(spmm_exec(path, a, h), epi, bias, residual)

"""Execution of one planned path: SpMM with or without a fused epilogue,
SDDMM, and the fused graph attention (the forward half of
``repro.sparse.autodiff``).

Serving takes no gradient, so there is no ``torch.autograd.Function``
here yet; the training slice adds the SpMM <-> SDDMM backward rules,
which call the same ``sample_exec`` (kernels K3 and K4) in the backward.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dispatch.policy import (PATH_CSR, PATH_DENSE, PATH_ELL,
                                         PATH_SELL)
from repro_torch.kernels.fused import attention as fat
from repro_torch.kernels.fused.epilogue import Epilogue, apply_epilogue
from repro_torch.kernels.fused.spmm import (spmm_blockell_fused,
                                            spmm_sell_fused)
from repro_torch.sparse import paths
from repro_torch.sparse.matrix import SparseMatrix, values_of


def form_read_by(a: SparseMatrix, path: str) -> str:
    """Which carried form a given execution path reads."""
    if path == PATH_CSR:
        return "csr"
    if path == PATH_ELL:
        return "ell" if a.has_form("ell") else "coo"
    if path == PATH_SELL:
        return "sell"
    return a.format  # the dense path densifies the primary form


def spmm_exec(path: str, a: SparseMatrix, h: torch.Tensor) -> torch.Tensor:
    """Run one planned SpMM path; h: [N, D] logical rows; returns [M, D]."""
    m = a.shape[0]
    if path == PATH_ELL:
        if a.has_form("ell"):
            ell = a.form("ell")
            return paths.spmm_ell(ell, paths.pad_rows(h, ell.shape[1]))[:m]
        coo = a.form("coo")
        return paths.spmm_coo(coo, paths.pad_rows(h, coo.shape[1]))[:m]
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
    if path == PATH_ELL and a.has_form("ell"):
        ell = a.form("ell")
        y = spmm_blockell_fused(ell, paths.pad_rows(h, ell.shape[1]), epi,
                                bias, residual)
        return y[: a.shape[0]]
    if path == PATH_SELL:
        return spmm_sell_fused(a.form("sell"), h, epi, bias, residual)
    return apply_epilogue(spmm_exec(path, a, h), epi, bias, residual)


def sample_exec(path: str, a: SparseMatrix, b: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """Raw sampled dots (B @ C at A's stored slots), in the layout of the
    form the path reads: the unweighted SDDMM.

    The ell path samples every cell of the Block-COO view of the form with
    K3 and no mask (the reference builds an all-ones block array here; the
    port builds none), in ``result_type(blocks, b)`` as the ones array
    gave; the sell path samples its structural slots (K4).  The caller
    multiplies by the stored values.
    """
    form_name = form_read_by(a, path)
    form = a.form(form_name)
    if path == PATH_CSR:
        return paths.sddmm_element_dots(form[0], form[1], b, c)
    if path == PATH_SELL:
        # K4 returns f32, as the reference's tile route does; cast once to
        # the dtype of the element dots, which the reference's sell path
        # returns when it runs no kernel, so every path agrees
        return paths.sample_sell(form, b, c).to(b.dtype)
    if path == PATH_ELL:
        coo = paths.ell_to_coo(form) if form_name == "ell" else form
        out = paths.sddmm_blocked(
            coo, paths.pad_rows(b, coo.shape[0]),
            paths.pad_cols(c, coo.shape[1]), weighted=False).blocks
        return out.reshape(form.blocks.shape)
    if path == PATH_DENSE:
        full = b.float() @ c.float()
        if form_name == "csr":
            return full[form[0].long(), form[1].long()].to(b.dtype)
        if form_name == "sell":
            return full[form.slot_rows.long(),
                        form.slot_cols.long()].to(b.dtype)
        coo = paths.ell_to_coo(form) if form_name == "ell" else form
        full = paths.pad_cols(paths.pad_rows(full, coo.shape[0]),
                              coo.shape[1])
        out = paths.sample_blocks(full, coo.rows, coo.cols, coo.bm, coo.bn)
        return out.reshape(form.blocks.shape).to(b.dtype)
    raise ValueError(f"unknown sddmm path {path!r}")


def sddmm_values(path: str, a: SparseMatrix, b: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """S = A ⊙ (B @ C): the values, in the layout of the form the path
    reads (the forward of the reference's ``sddmm_values``).

    The ell path is one K3 launch with A's values (the form's blocks) as
    its mask; K3 rounds each dot to the output dtype before the values
    multiply it, so this equals the raw dots times the values, as the
    other paths compose them, bit for bit.
    """
    form_name = form_read_by(a, path)
    form = a.form(form_name)
    if path == PATH_ELL:
        coo = paths.ell_to_coo(form) if form_name == "ell" else form
        out = paths.sddmm_blocked(coo, paths.pad_rows(b, coo.shape[0]),
                                  paths.pad_cols(c, coo.shape[1])).blocks
        return out.reshape(form.blocks.shape)
    raw = sample_exec(path, a, b, c)
    vals = values_of(form_name, form)
    out = vals.float() * raw.float()
    return out.to(torch.promote_types(vals.dtype, b.dtype))


def fused_attention_exec(path: str, a: SparseMatrix, q: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor, act: str,
                         slope: float) -> torch.Tensor:
    """One-pass SDDMM -> edge act -> softmax -> SpMM over A's structural
    nonzeros; ``q`` [M, dk], ``k`` [N, dk] score factors, ``v`` [N, D]
    values.  A's stored values contribute their nonzero pattern only."""
    m = a.shape[0]
    kt = k.T
    if path == PATH_ELL:
        if a.has_form("ell"):
            return fat.fused_attn_blockell(a.form("ell"), q, kt, v, act=act,
                                           slope=slope)[:m]
        coo = a.form("coo")
        return fat.fused_attn_blockcoo_ref(
            coo, paths.pad_rows(q, coo.shape[0]),
            paths.pad_cols(kt, coo.shape[1]),
            paths.pad_rows(v, coo.shape[1]), act=act, slope=slope)[:m]
    if path == PATH_SELL:
        return fat.fused_attn_sell(a.form("sell"), q, kt, v, act=act,
                                   slope=slope)
    if path == PATH_CSR:
        r, c, vals = a.form("csr")
        return fat.fused_attn_elements(r, c, vals, q, kt, v, m, act=act,
                                       slope=slope)
    if path == PATH_DENSE:
        return fat.fused_attn_dense(a.densify(), q, kt, v, act=act,
                                    slope=slope)
    raise ValueError(f"unknown fused-attention path {path!r}")

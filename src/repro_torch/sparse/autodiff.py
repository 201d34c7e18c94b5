"""The SpMM <-> SDDMM backward rules as ``torch.autograd.Function``s, and
the execution of one planned path they share with the forward (the port
of ``repro.sparse.autodiff``).

SpMM and SDDMM are transpose/backward duals (Gale et al., *Sparse GPU
Kernels for Deep Learning*): for ``Y = A @ H``,

  * ``dH = Aᵀ @ ḡ``            — another SpMM, on the transposed operand;
  * ``dA = pattern(A) ⊙ (ḡ Hᵀ)`` — SDDMM sampled on A's nonzero topology;

and for ``S = A ⊙ (B C)``,

  * ``dA = ḡ ⊙ (B C)``          — elementwise on the stored values;
  * ``dB = (A ⊙ ḡ) @ Cᵀ``       — an SpMM with the cotangent-weighted A;
  * ``dC = ((A ⊙ ḡ)ᵀ @ B)ᵀ``    — the transposed SpMM.

Each rule runs through the path the forward ran (ell / sell / csr /
dense), so on the card the backward launches the same kernels: K3 / K4
for every sampled product, K1 / K2 for every SpMM on A's own form.  The
products the rules sample are masked with A's pattern straight after, so
they go through ``sample_pattern_exec``: on the ell path at K >=
``PATTERN_MIN_K`` that is K3 at the pattern, which computes only A's
structural nonzeros.  The
transposed products (``dH``, ``dk``, ``dV``, ``dC``) run on ``A.T``: on
the ell path N1 reads A's Block-ELL blocks in place, transposed; on the
sell path K2 reads Aᵀ's row view; each sums in one fixed order, so two
runs give equal bits (the reference's segment sums are deterministic
too).  A transpose of a Block-COO form runs ``paths.spmm_coo``.  Each
rule that runs records a plan with ``policy="vjp"`` in the dispatch log.

Gradient semantics: each Function takes the *values tensor of the form
the path reads* as an explicit input beside the path and the matrix, so a
gradient reaches ``v`` in ``A.with_data(v)``; structural zeros (padding
slots, element zeros) receive zero gradient, and the integer topology is
not an input.  A rule whose output no input needs is skipped
(``ctx.needs_input_grad``): ``jax.jit`` removes those rules from the
reference's traced step as dead code, so the log records only the rules
that ran (the reference records every rule when it runs unjitted).  The
backward works on tensors it owns and updates them in place where that
saves a copy of an E-length array.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.dispatch.dispatcher import Plan, record_plan
from repro_torch.dispatch.policy import (PATH_CSR, PATH_DENSE, PATH_ELL,
                                         PATH_SELL)
from repro_torch.kernels.fused import attention as fat
from repro_torch.kernels.fused.epilogue import (Epilogue, act_grad_from_out,
                                                apply_act, apply_epilogue)
from repro_torch.kernels.fused.spmm import (spmm_blockell_fused,
                                            spmm_sell_fused)
from repro_torch.kernels.sddmm.kernel import sddmm_pattern_kernel
from repro_torch.memo import Table, memoized
from repro_torch.sparse import paths
from repro_torch.sparse.matrix import SparseMatrix, single_form, values_of


def form_read_by(a: SparseMatrix, path: str) -> str:
    """Which carried form a given execution path reads."""
    if path == PATH_CSR:
        return "csr"
    if path == PATH_ELL:
        return "ell" if a.has_form("ell") else "coo"
    if path == PATH_SELL:
        # the transpose of a sell operand carries the slot triplet as an
        # element form; the sell path falls back to it (see spmm_exec)
        return "sell" if a.has_form("sell") else "csr"
    return a.format  # the dense path densifies the primary form


def read_values(a: SparseMatrix, path: str) -> torch.Tensor:
    """The values tensor of the form ``path`` reads: the input through
    which a Function's gradient reaches A."""
    name = form_read_by(a, path)
    return values_of(name, a.form(name))


def spmm_exec(path: str, a: SparseMatrix, h: torch.Tensor) -> torch.Tensor:
    """Run one planned SpMM path; h: [N, D] logical rows; returns [M, D]."""
    m = a.shape[0]
    if path == PATH_ELL:
        if a.has_form("ell"):
            ell = a.form("ell")
            return paths.spmm_ell(ell, paths.pad_rows(h, ell.shape[1]))[:m]
        ell = a.transposed_form("ell")
        if ell is not None:  # Aᵀ of a Block-ELL A: N1, A's blocks in place
            return paths.spmm_ell_t(ell, paths.pad_rows(h, ell.shape[0]))[:m]
        coo = a.form("coo")
        return paths.spmm_coo(coo, paths.pad_rows(h, coo.shape[1]))[:m]
    if path == PATH_SELL and a.has_form("sell"):
        return paths.spmm_sell(a.form("sell"), h)
    if path == PATH_SELL and a.transposed_form("sell") is not None:
        return paths.spmm_sell_t(a.transposed_form("sell"), h)
    if path in (PATH_CSR, PATH_SELL):  # sell: a transposed sell operand
        r, c, v = a.form("csr")
        return paths.spmm_elements(r, c, v, h, m)
    if path == PATH_DENSE:
        return paths.spmm_dense(a.densify(), h)
    raise ValueError(f"unknown spmm path {path!r}")


def spmv_exec(path: str, a: SparseMatrix, x: torch.Tensor) -> torch.Tensor:
    """Run one planned SpMV path; x: [N] logical entries; returns [M].

    Each layout of A runs its direct reduction (``paths.spmv_*``).  A
    transpose (``A.T``, the backward's dx) whose source form the path
    reads in place runs the transposed SpMM at D = 1, as ``spmm_exec``
    routes it: N1 over A's Block-ELL blocks on the ell path, K2 over Aᵀ's
    row view on the sell path, each summing in one fixed order (the
    reference reduces a transposed Block-COO, which on CUDA would add
    with atomics)."""
    m = a.shape[0]
    if path == PATH_ELL:
        if a.has_form("ell"):
            ell = a.form("ell")
            return paths.spmv_ell(ell, paths.pad_rows(x, ell.shape[1]))[:m]
        ell = a.transposed_form("ell")
        if ell is not None:
            return paths.spmm_ell_t(
                ell, paths.pad_rows(x[:, None], ell.shape[0]))[:m, 0]
        coo = a.form("coo")
        return paths.spmv_coo(coo, paths.pad_rows(x, coo.shape[1]))[:m]
    if path == PATH_SELL and a.has_form("sell"):
        return paths.spmv_sell(a.form("sell"), x)
    if path == PATH_SELL and a.transposed_form("sell") is not None:
        return paths.spmm_sell_t(a.transposed_form("sell"), x[:, None])[:, 0]
    if path in (PATH_CSR, PATH_SELL):  # sell: a transposed sell operand
        r, c, v = a.form("csr")
        return paths.spmv_elements(r, c, v, x, m)
    if path == PATH_DENSE:
        return paths.spmm_dense(a.densify(), x)
    raise ValueError(f"unknown spmv path {path!r}")


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
    if path == PATH_CSR or (path == PATH_SELL and form_name == "csr"):
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


# The ell path samples at A's pattern (K3's pattern kernel) from this K
# up, and every cell (K3's streaming kernel) below it: on graph (a) of
# chip_smoke.py the pattern kernel is the faster at K = 16, the streaming
# kernel at K = 2, 4 and 8 (PERF.md, findings)
PATTERN_MIN_K = 16


def sample_pattern_exec(path: str, a: SparseMatrix, b: torch.Tensor,
                        c: torch.Tensor) -> torch.Tensor:
    """Raw sampled dots for a caller that masks them with A's pattern
    (``read_values(a, path) != 0``): at every stored nonzero they equal
    ``sample_exec``'s, bit for bit; elsewhere they are 0 or the dot.

    On the ell path at K >= ``PATTERN_MIN_K`` K3 at the pattern computes
    only the cells of ``a.tile_occupancy()`` (built once per matrix) and
    writes 0 elsewhere; otherwise this is ``sample_exec``.  ``c`` may be
    a transposed view (the rules pass ``h.T``, ``v.T``): the pattern
    kernel reads its transpose without a copy.
    """
    if path != PATH_ELL or b.shape[1] < PATTERN_MIN_K:
        return sample_exec(path, a, b, c)
    form_name = form_read_by(a, path)
    form = a.form(form_name)
    coo = paths.ell_to_coo(form) if form_name == "ell" else form
    out = sddmm_pattern_kernel(
        coo.rows, coo.cols, a.tile_occupancy(),
        paths.pad_rows(b, coo.shape[0]).contiguous(),
        paths.pad_rows(c.T, coo.shape[1]).T, block=(coo.bm, coo.bn),
        out_dtype=torch.promote_types(coo.blocks.dtype, b.dtype))
    return out.reshape(form.blocks.shape)


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


# ---------------------------------------------------------------------------
# Helpers of the backward rules
# ---------------------------------------------------------------------------


def _mask_structural(vals: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """Zero the gradient at structural zeros (padding, pruned entries)."""
    return torch.where(vals != 0, grad, 0.0).to(vals.dtype)


def _record_vjp(op: str, path: str, reason: str, a: SparseMatrix) -> None:
    with obs.span("sparse.dispatch"):
        record_plan(Plan(op=op, path=path, policy="vjp", reason=reason,
                         use_kernel=a.device.type == "cuda"))


def _form_broadcast_rows(a: SparseMatrix, form_name: str,
                         vec: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-logical-row vector onto a form's values layout."""
    form = a.form(form_name)
    if form_name == "csr":
        return vec[form[0].long()]
    if form_name == "sell":
        return vec[form.slot_rows.long()]
    by_row = paths.pad_rows(vec, form.shape[0]).reshape(-1, form.bm)
    if form_name == "ell":
        return by_row[:, None, :, None]  # -> [nbr, W, bm, bn]
    return by_row[form.rows.long()][:, :, None]  # coo: [nnzb, bm, 1]


# each packed row's slot count (its width bucket's width), per SELL
# structure
_SELL_ROW_WIDTHS: Table = {}


def _sell_row_sums(sell, vals: torch.Tensor) -> torch.Tensor:
    """Each logical row's sum of its slot values [M], in a fixed order: a
    packed row's slots are contiguous, so one segmented sum over the
    packed rows' widths (``segment_reduce``: no atomics, unlike
    ``index_add_`` on CUDA); rows in pruned slices read an appended 0."""
    if not sell.buckets:  # no nonzero at all
        return vals.new_zeros((sell.shape[0],))
    widths = memoized(_SELL_ROW_WIDTHS, sell.slot_cols,
                      (id(sell.out_gather), sell.buckets),
                      lambda: torch.tensor(
                          [w for _, n, w in sell.buckets for _ in range(n)],
                          dtype=torch.long).to(vals.device))
    packed = torch.segment_reduce(vals, "sum", lengths=widths)
    return torch.cat([packed, packed.new_zeros(1)])[sell.out_gather.long()]


def _form_row_softmax(a: SparseMatrix, form_name: str, e: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Row softmax of masked scores ``e`` laid out like one form's values.

    ``e`` is f32 with masked (structural-zero) entries already at
    ``NEG_INF``; the result carries exact zeros there.  Matches
    ``models.gnn._segment_softmax`` (the same ``EPS`` denominator guard).
    ``e`` is consumed: the exponentials are taken in its storage.
    """
    form = a.form(form_name)
    if form_name in ("csr", "sell"):
        rows = (form[0] if form_name == "csr" else form.slot_rows).long()
        m = a.shape[0]
        mx = e.new_full((m,), fat.NEG_INF).scatter_reduce(0, rows, e, "amax")
        ex = e.sub_(mx[rows]).exp_().mul_(mask)
        den = _sell_row_sums(form, ex) if form_name == "sell" \
            else paths.segment_sums(ex, form[0], form[1], m)
        return ex.div_(den[rows].clamp_min(fat.EPS))
    if form_name == "ell":
        mx = e.amax(dim=(1, 3))  # [nbr, bm]
        ex = e.sub_(mx[:, None, :, None]).exp_().mul_(mask)
        den = ex.sum(dim=(1, 3)).clamp_min(fat.EPS)
        return ex.div_(den[:, None, :, None])
    # coo: segments over the block-row coordinate
    rows = form.rows.long()
    nbr = form.shape[0] // form.bm
    mx = e.new_full((nbr, form.bm), fat.NEG_INF).scatter_reduce(
        0, rows[:, None].expand(-1, form.bm), e.amax(dim=2), "amax")
    ex = e.sub_(mx[rows][:, :, None]).exp_().mul_(mask)
    den = paths.segment_sums(ex.sum(dim=2), form.rows, form.cols, nbr)
    return ex.div_(den[rows][:, :, None].clamp_min(fat.EPS))


# ---------------------------------------------------------------------------
# SpMM: Y = A @ H
# ---------------------------------------------------------------------------


class SpMM(torch.autograd.Function):
    """``Y = A @ H`` on one planned path; inputs ``(path, a, vals, h)``
    with ``vals = read_values(a, path)``.

    Backward: ``dH = Aᵀ @ ḡ`` (an SpMM on the transpose) and ``dA =
    pattern(A) ⊙ (ḡ Hᵀ)`` (an SDDMM, K3 / K4 on the card), each only
    where its input needs it."""

    @staticmethod
    def forward(ctx, path: str, a: SparseMatrix, vals: torch.Tensor,
                h: torch.Tensor) -> torch.Tensor:
        ctx.path, ctx.a = path, a
        ctx.save_for_backward(vals, h)
        return spmm_exec(path, a, h)

    @staticmethod
    def backward(ctx, g):
        vals, h = ctx.saved_tensors
        path, a = ctx.path, ctx.a
        g = g.contiguous()
        dvals = dh = None
        if ctx.needs_input_grad[3]:
            dh = spmm_exec(path, a.T, g).to(h.dtype)
            _record_vjp("spmm", path, "vjp: dH = Aᵀ @ ḡ (spmm backward)", a)
        if ctx.needs_input_grad[2]:
            raw = sample_pattern_exec(path, a, g, h.T)
            _record_vjp("sddmm", path, "vjp: dA = pattern(A) ⊙ (ḡ @ Hᵀ) "
                        "(spmm backward is sddmm)", a)
            dvals = _mask_structural(vals, raw)
        return None, None, dvals, dh


# ---------------------------------------------------------------------------
# SpMV: y = A @ x  (the same duality at d = 1)
# ---------------------------------------------------------------------------


class SpMV(torch.autograd.Function):
    """``y = A @ x`` for a [N] vector on one planned path; inputs ``(path,
    a, vals, x)`` with ``vals = read_values(a, path)``.

    Backward: ``dx = Aᵀ ḡ`` (``spmv_exec`` on the transpose: N1 or K2 at
    D = 1 on the card) and ``dA = pattern(A) ⊙ (ḡ xᵀ)``, a rank-1 SDDMM
    (K3 or K4 at K = 1), each only where its input needs it."""

    @staticmethod
    def forward(ctx, path: str, a: SparseMatrix, vals: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        ctx.path, ctx.a = path, a
        ctx.save_for_backward(vals, x)
        return spmv_exec(path, a, x)

    @staticmethod
    def backward(ctx, g):
        vals, x = ctx.saved_tensors
        path, a = ctx.path, ctx.a
        g = g.contiguous()
        dvals = dx = None
        if ctx.needs_input_grad[3]:
            dx = spmv_exec(path, a.T, g).to(x.dtype)
            _record_vjp("spmv", path, "vjp: dx = Aᵀ @ ḡ (spmv backward)", a)
        if ctx.needs_input_grad[2]:
            raw = sample_pattern_exec(path, a, g[:, None], x[None, :])
            _record_vjp("sddmm", path, "vjp: dA = pattern(A) ⊙ (ḡ xᵀ) (spmv "
                        "backward is sddmm)", a)
            dvals = _mask_structural(vals, raw)
        return None, None, dvals, dx


# ---------------------------------------------------------------------------
# SDDMM: S = A ⊙ (B @ C)  (values in the layout of the form the path reads)
# ---------------------------------------------------------------------------


class SDDMMValues(torch.autograd.Function):
    """``S = A ⊙ (B @ C)`` at A's stored entries, in the layout of the
    form ``path`` reads; inputs ``(path, a, vals, b, c)``.

    Where A's values need a gradient the forward keeps the raw dots
    (``dA = ḡ ⊙ (B C)``) and composes values × dots; otherwise it is the
    path's one product (one K3 launch on the ell path).  Backward: ``dB``
    and ``dC`` as SpMMs on ``A ⊙ ḡ`` and on its transpose."""

    @staticmethod
    def forward(ctx, path: str, a: SparseMatrix, vals: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        ctx.path, ctx.a = path, a
        raw = None
        if ctx.needs_input_grad[2]:
            raw = sample_pattern_exec(path, a, b, c)
            out = (vals.float() * raw.float()).to(
                torch.promote_types(vals.dtype, b.dtype))
        else:
            out = sddmm_values(path, a, b, c)
        ctx.save_for_backward(vals, b, c, raw)
        return out

    @staticmethod
    def backward(ctx, g):
        vals, b, c, raw = ctx.saved_tensors
        path, a = ctx.path, ctx.a
        dvals = db = dc = None
        if ctx.needs_input_grad[2]:
            dvals = _mask_structural(vals, g.float() * raw.float())
        if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
            # M = A ⊙ ḡ shares A's topology; both remaining grads are SpMMs
            mg = single_form(a, form_read_by(a, path),
                                   (vals.float() * g.float()).to(vals.dtype))
            if ctx.needs_input_grad[3]:
                db = spmm_exec(path, mg, c.T.contiguous()).to(b.dtype)
                _record_vjp("spmm", path, "vjp: dB = (A ⊙ ḡ) @ Cᵀ (sddmm "
                            "backward is spmm)", a)
            if ctx.needs_input_grad[4]:
                dc = spmm_exec(path, mg.T, b.contiguous()).T.to(c.dtype)
                _record_vjp("spmm", path, "vjp: dC = ((A ⊙ ḡ)ᵀ @ B)ᵀ (sddmm "
                            "backward is spmm)", a)
        return None, None, dvals, db, dc


# ---------------------------------------------------------------------------
# Fused SpMM + epilogue: Y = act(A @ H + bias + residual)
# ---------------------------------------------------------------------------


class SpMMEpilogue(torch.autograd.Function):
    """``Y = act(A @ H + bias + residual)`` on one planned path (K5 / K6
    on the card); inputs ``(path, epi, a, vals, h, bias, residual)``.

    The forward keeps ``out`` and no pre-activation: relu and leaky relu
    keep the sign, so ``act'`` is read from ``out``.  Backward: ``dz = ḡ
    ⊙ act'(out)``, then ``dbias``, ``dresidual`` and the SpMM duality on
    ``dz``."""

    @staticmethod
    def forward(ctx, path: str, epi: Epilogue, a: SparseMatrix,
                vals: torch.Tensor, h: torch.Tensor,
                bias: Optional[torch.Tensor],
                residual: Optional[torch.Tensor]) -> torch.Tensor:
        out = spmm_epilogue_exec(path, epi, a, h, bias, residual)
        ctx.path, ctx.epi, ctx.a = path, epi, a
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.residual_dtype = None if residual is None else residual.dtype
        ctx.save_for_backward(vals, h, out)
        return out

    @staticmethod
    def backward(ctx, g):
        vals, h, out = ctx.saved_tensors
        path, epi, a = ctx.path, ctx.epi, ctx.a
        needs = ctx.needs_input_grad
        dz = g.float() * act_grad_from_out(out.float(), epi.act,
                                           epi.negative_slope)
        dvals = dh = dbias = dres = None
        if epi.has_bias and needs[5]:
            dbias = dz.sum(dim=0).to(ctx.bias_dtype)
        if epi.has_residual and needs[6]:
            dres = dz.to(ctx.residual_dtype)
        # past the elementwise tail the rules are the SpMM duality
        if needs[4]:
            dh = spmm_exec(path, a.T, dz).to(h.dtype)
            _record_vjp("spmm", path, "vjp: dH = Aᵀ @ (ḡ ⊙ act') "
                        "(fused-epilogue spmm backward)", a)
        if needs[3]:
            raw = sample_pattern_exec(path, a, dz, h.T)
            _record_vjp("sddmm", path, "vjp: dA = pattern(A) ⊙ ((ḡ ⊙ act') "
                        "@ Hᵀ) (fused-epilogue spmm backward is sddmm)", a)
            dvals = _mask_structural(vals, raw)
        return None, None, None, dvals, dh, dbias, dres


# ---------------------------------------------------------------------------
# Fused graph attention: Y = softmax_row(act(q kᵀ ⊙ pattern(A))) @ V
# ---------------------------------------------------------------------------


def _attention_backward_k7b(ctx, g: torch.Tensor, need_q: bool,
                            need_k: bool, need_v: bool):
    """The fused attention's backward on the ell path over a Block-ELL form
    at a score width below ``PATTERN_MIN_K``: K7b gives α, de and dq in
    one launch (the score recompute, dα, the softmax JVP and dq, with no
    other array in the block layout), then dk = deᵀ q and dV = αᵀ ḡ run on
    N1 as in the composed rule.  Returns (dq, dk, dv)."""
    vals, q, k, v, out = ctx.saved_tensors
    path, a = ctx.path, ctx.a
    rowdot = (g.float() * out.float()).sum(dim=-1)
    alpha, de, dq = fat.fused_attn_blockell_bwd(
        a.form("ell"), a.tile_occupancy(), q, k.T, v, g, rowdot,
        act=ctx.act, slope=ctx.slope)
    _record_vjp("attention", path, "vjp: fused attention backward (K7b)", a)
    del rowdot
    dq = dq.to(q.dtype) if need_q else None
    dk = dv = None
    if need_k:
        de_mat = single_form(a, "ell", de.to(vals.dtype))
        dk = spmm_exec(path, de_mat.T, q.contiguous()).to(k.dtype)
        _record_vjp("spmm", path, "vjp: dk = (P ⊙ de)ᵀ q (fused attn "
                    "backward is spmm)", a)
        del de_mat
    del de
    if need_v:
        alpha_mat = single_form(a, "ell", alpha.to(vals.dtype))
        dv = spmm_exec(path, alpha_mat.T, g).to(v.dtype)
        _record_vjp("spmm", path, "vjp: dV = αᵀ ḡ (fused attn backward "
                    "is spmm)", a)
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """The one-pass graph attention (K7 / K8 on the card); inputs
    ``(path, a, vals, q, k, v, act, slope)``.

    With α = softmax(act(e)) and O = α V, the backward assembles the
    kernel duality:

      * α and the raw scores are recomputed in the form's layout (one
        SDDMM at K = dk and a row softmax), so the forward never spills
        them;
      * dα = ḡ Vᵀ sampled at the pattern — an SDDMM at K = D;
      * the softmax JVP: de = α ⊙ (dα − rowdot) ⊙ act'(e), with rowdot_i
        = ḡ_i · O_i read from the forward output;
      * dq = (P ⊙ de) k and dk = (P ⊙ de)ᵀ q — the SDDMM backward's two
        SpMMs; dV = αᵀ ḡ — an SpMM on the transposed α.

    On the ell path over a Block-ELL form at a score width below
    ``PATTERN_MIN_K`` the recompute, dα, the JVP and dq are one launch of
    K7b (``_attention_backward_k7b``), which leaves only α and de in the
    block layout; every other case runs the composition.  A's values
    contribute their pattern only and get zero gradient."""

    @staticmethod
    def forward(ctx, path: str, a: SparseMatrix, vals: torch.Tensor,
                q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                act: str, slope: float) -> torch.Tensor:
        out = fused_attention_exec(path, a, q, k, v, act, slope)
        ctx.path, ctx.a, ctx.act, ctx.slope = path, a, act, slope
        ctx.save_for_backward(vals, q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, g):
        vals, q, k, v, out = ctx.saved_tensors
        path, a, act, slope = ctx.path, ctx.a, ctx.act, ctx.slope
        _, _, need_vals, need_q, need_k, need_v = ctx.needs_input_grad[:6]
        dvals = torch.zeros_like(vals) if need_vals else None
        dq = dk = dv = None
        if not (need_q or need_k or need_v):
            return None, None, dvals, dq, dk, dv, None, None
        form_name = form_read_by(a, path)
        g = g.contiguous()
        if (path == PATH_ELL and form_name == "ell"
                and q.shape[1] < PATTERN_MIN_K):
            dq, dk, dv = _attention_backward_k7b(ctx, g, need_q, need_k,
                                                 need_v)
            return None, None, dvals, dq, dk, dv, None, None
        mask = vals != 0
        raw = sample_pattern_exec(path, a, q, k.T).float()
        _record_vjp("sddmm", path, "vjp: recompute e = act(q kᵀ) at pattern "
                    "(fused attn backward)", a)
        e = torch.where(mask, apply_act(raw, act, slope), fat.NEG_INF)
        alpha = _form_row_softmax(a, form_name, e, mask)
        del e
        if need_q or need_k:
            dalpha = sample_pattern_exec(path, a, g, v.T).float()
            _record_vjp("sddmm", path, "vjp: dα = ḡ Vᵀ at pattern (fused "
                        "attn backward is sddmm)", a)
            rowdot = (g.float() * out.float()).sum(dim=-1)
            de = dalpha.sub_(_form_broadcast_rows(a, form_name, rowdot))
            de.mul_(alpha).mul_(act_grad_from_out(raw, act, slope))
            de.mul_(mask)
            de_mat = single_form(a, form_name, de.to(vals.dtype))
            del raw, dalpha, de
            if need_q:
                dq = spmm_exec(path, de_mat, k.contiguous()).to(q.dtype)
                _record_vjp("spmm", path, "vjp: dq = (P ⊙ de) k (fused attn "
                            "backward is spmm)", a)
            if need_k:
                dk = spmm_exec(path, de_mat.T, q.contiguous()).to(k.dtype)
                _record_vjp("spmm", path, "vjp: dk = (P ⊙ de)ᵀ q (fused "
                            "attn backward is spmm)", a)
            del de_mat
        if need_v:
            alpha_mat = single_form(a, form_name, alpha.to(vals.dtype))
            dv = spmm_exec(path, alpha_mat.T, g).to(v.dtype)
            _record_vjp("spmm", path, "vjp: dV = αᵀ ḡ (fused attn backward "
                        "is spmm)", a)
        return None, None, dvals, dq, dk, dv, None, None

"""One-pass fused graph attention, SDDMM → edge act → softmax → SpMM: the
wrappers of kernels K7 and K8 (the port of
``repro.kernels.fused.attention``).

K7 replaces the Pallas kernel ``fused_attn_blockell_kernel`` and K8
replaces ``fused_attn_sell_kernel``.  Both are ``csrc/fused_attention.cu``:
one CTA per (block-row, D-tile) sweeps the row's slots once, keeping the
running row max ``m``, the exp-sum ``l`` and the accumulator on chip, so
the edge scores never exist in device memory:

  per slot:  s = act(q_tile @ kT_tile);  m' = max(m, rowmax(s))
             l = l * exp(m - m') + rowsum(exp(s - m'))
             acc = acc * exp(m - m') + exp(s - m') @ V_tile
  flush:     out = acc / max(l, EPS)

Masked entries score the finite ``NEG_INF`` and weigh exactly 0, so an
edge-less row comes out exactly 0.  The plain versions beside the
wrappers are the reference's two-sweep (an explicit max pass, then the
exp / sum / accumulate pass), so kernel-vs-plain parity also pins the
online rescaling.  The csr and dense paths are plain compositions.
Each wrapper runs its plain version for CPU tensors and its kernel for
CUDA tensors, and counts launches in ``<wrapper>.launches``.  Every path
takes f32, bf16 or f16 operands, computes in f32 and returns the
reference's default output dtype, ``result_type(q, v)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.formats import BlockCOO, BlockELL, SellCS
from repro_torch.kernels import _build
from repro_torch.kernels.fused.epilogue import apply_act
from repro_torch.kernels.spmm.kernel import (ACT_CODES, check_geometry,
                                             check_operand, require_cuda,
                                             result_dtype)
from repro_torch.kernels.spmm.sell import sell_row_ptr, sell_tile_blocks

NEG_INF = -1e30   # finite: masked - masked stays nan-free
EPS = 1e-12       # the segment-softmax denominator guard


def _two_sweep(s, mask, row_of, n_rows, vb):
    """The reference's blocked two-sweep over tiles t of block-row
    ``row_of[t]``: s, mask [T, bm, bn] scores and pattern, vb [T, bn, D];
    returns [n_rows, bm, D]."""
    t_count, bm, _ = s.shape
    d = vb.shape[2]
    idx = row_of.long()
    mx = s.new_full((n_rows, bm), NEG_INF).scatter_reduce(
        0, idx[:, None].expand(t_count, bm), s.amax(dim=2), "amax")
    p = torch.where(mask, torch.exp(s - mx[idx][:, :, None]), 0.0)
    den = s.new_zeros((n_rows, bm)).index_add_(0, idx, p.sum(dim=2))
    y = s.new_zeros((n_rows, bm, d)).index_add_(
        0, idx, torch.einsum("tmn,tnd->tmd", p, vb))
    return y / den.clamp_min(EPS)[:, :, None]


def _scores(qb, ktb, mask, act, slope):
    s = torch.einsum("tmk,tkn->tmn", qb, ktb)
    return torch.where(mask, apply_act(s, act, slope), NEG_INF)


def launch_attention(row_ptr, cols, blocks, q, kt, v, n_rows: int, w: int,
                     act: str, slope: float, what: str) -> torch.Tensor:
    """Check the operands and launch ``csrc/fused_attention.cu`` on the
    current stream (``row_ptr`` None: Block-ELL of width ``w``); returns
    Y [n_rows*bm, D] in ``result_type(q, v)``.  The kernel loads f32:
    narrower operands are promoted to f32 here (exact for bf16 and f16)
    and Y is cast after the launch, which gives what a kernel loading them
    natively and computing in f32 gives."""
    dev = v.device
    bm, bn = blocks.shape[-2:]
    dk = q.shape[1]
    n, d = v.shape
    check_geometry(bm, bn, n)
    out = result_dtype(q, v)
    result_dtype(blocks, kt)  # raises on a dtype the kernel does not take
    check_operand(cols, "cols", torch.int32, tuple(blocks.shape[:-2]), dev)
    check_operand(blocks, "blocks", None, tuple(blocks.shape), dev)
    check_operand(q, "q", None, (n_rows * bm, dk), dev)
    check_operand(kt, "kt", None, (dk, n), dev)
    check_operand(v, "v", None, (n, d), dev)
    blocks, q, kt, v = blocks.float(), q.float(), kt.float(), v.float()
    y = torch.empty((n_rows * bm, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry("fused_attention")(
            None if row_ptr is None else row_ptr.data_ptr(),
            cols.data_ptr(), blocks.data_ptr(), q.data_ptr(), kt.data_ptr(),
            v.data_ptr(), y.data_ptr(), n_rows, w, bm, bn, dk, n, d,
            ACT_CODES[act], float(slope),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, what)
    return y.to(out)


# ---------------------------------------------------------------------------
# Block-ELL fused attention (K7)
# ---------------------------------------------------------------------------


def fused_attn_blockell_ref(indices, blocks, q, kt, v, *,
                            act: str = "leaky_relu",
                            slope: float = 0.2) -> torch.Tensor:
    """Plain version of K7, [nbr*bm, D]: the blocked two-sweep (sweep 1:
    row max; sweep 2: exp / sum / accumulate) over [nbr, W, bm, bn] score
    tiles, never an E-length vector."""
    nbr, _, bm, bn = blocks.shape
    dk = q.shape[1]
    n, d = v.shape
    check_geometry(bm, bn, n)
    qb = q.reshape(nbr, bm, dk).float()
    ktb = kt.reshape(dk, n // bn, bn).permute(1, 0, 2)[indices].float()
    vb = v.reshape(n // bn, bn, d)[indices].float()  # [nbr, W, bn, D]
    mask = blocks != 0
    s = torch.einsum("imk,iwkn->iwmn", qb, ktb)
    s = torch.where(mask, apply_act(s, act, slope), NEG_INF)
    mx = s.amax(dim=(1, 3))                                   # sweep 1
    p = torch.where(mask, torch.exp(s - mx[:, None, :, None]), 0.0)
    den = p.sum(dim=(1, 3))                                   # sweep 2
    y = torch.einsum("iwmn,iwnd->imd", p, vb)
    y = y / den.clamp_min(EPS)[:, :, None]
    return y.reshape(nbr * bm, d).to(torch.promote_types(q.dtype, v.dtype))


def fused_attn_blockell_kernel(indices: torch.Tensor, blocks: torch.Tensor,
                               q: torch.Tensor, kt: torch.Tensor,
                               v: torch.Tensor, *, act: str = "leaky_relu",
                               slope: float = 0.2) -> torch.Tensor:
    """K7: softmax_row(act(q kᵀ) at the Block-ELL pattern) @ V, one pass;
    ``q`` [nbr*bm, dk], ``kt`` [dk, Np], ``v`` [Np, D] on the block grid."""
    if v.device.type == "cpu":
        return fused_attn_blockell_ref(indices, blocks, q, kt, v, act=act,
                                       slope=slope)
    require_cuda(v, "fused_attn_blockell_kernel")
    y = launch_attention(None, indices, blocks, q, kt, v,
                         blocks.shape[0], blocks.shape[1], act, slope,
                         "K7 fused_attn_blockell")
    fused_attn_blockell_kernel.launches += 1
    return y


fused_attn_blockell_kernel.launches = 0


def fused_attn_blockell(ell: BlockELL, q, kt, v, *, act: str = "leaky_relu",
                        slope: float = 0.2) -> torch.Tensor:
    """Fused attention over a Block-ELL topology, [Mp, D] (padded rows;
    the caller trims).  ``q`` [M, dk], ``kt`` [dk, N], ``v`` [N, D] carry
    logical shapes and are padded to the block grid here."""
    mp, np_ = ell.shape
    q = F.pad(q, (0, 0, 0, mp - q.shape[0])).contiguous()
    kt = F.pad(kt, (0, np_ - kt.shape[1])).contiguous()
    v = F.pad(v, (0, 0, 0, np_ - v.shape[0])).contiguous()
    return fused_attn_blockell_kernel(ell.indices, ell.blocks, q, kt, v,
                                      act=act, slope=slope)


def fused_attn_blockcoo_ref(coo: BlockCOO, q, kt, v, *,
                            act: str = "leaky_relu",
                            slope: float = 0.2) -> torch.Tensor:
    """Blocked two-sweep over Block-COO, [Mp, D]: the ELL algebra with
    segment reductions over the block-row coordinate.  Inputs are padded
    to the block grid already."""
    _, bm, bn = coo.blocks.shape
    mp, np_ = coo.shape
    dk = q.shape[1]
    d = v.shape[1]
    qb = q.reshape(mp // bm, bm, dk).float()[coo.rows]
    ktb = kt.reshape(dk, np_ // bn, bn).permute(1, 0, 2)[coo.cols].float()
    vb = v.reshape(np_ // bn, bn, d)[coo.cols].float()
    mask = coo.blocks != 0
    s = _scores(qb, ktb, mask, act, slope)
    return _two_sweep(s, mask, coo.rows, mp // bm, vb).reshape(mp, d).to(
        torch.promote_types(q.dtype, v.dtype))


# ---------------------------------------------------------------------------
# SELL-C-σ fused attention (K8)
# ---------------------------------------------------------------------------


def fused_attn_sell_tiles_ref(tile_rows, tile_cols, mask_blocks, q_perm, kt,
                              v, *, n_live_block_rows: int,
                              act: str = "leaky_relu",
                              slope: float = 0.2) -> torch.Tensor:
    """Plain version of K8's compact output [n_live*bm, D]: the blocked
    two-sweep over the live tiles, segment reductions over
    ``tile_rows``."""
    _, bm, bn = mask_blocks.shape
    dk = q_perm.shape[1]
    n, d = v.shape
    check_geometry(bm, bn, n)
    qb = q_perm.reshape(n_live_block_rows, bm, dk).float()[tile_rows]
    ktb = kt.reshape(dk, n // bn, bn).permute(1, 0, 2)[tile_cols].float()
    vb = v.reshape(n // bn, bn, d)[tile_cols].float()
    mask = mask_blocks != 0
    s = _scores(qb, ktb, mask, act, slope)
    return _two_sweep(s, mask, tile_rows, n_live_block_rows, vb) \
        .reshape(n_live_block_rows * bm, d) \
        .to(torch.promote_types(q_perm.dtype, v.dtype))


def fused_attn_sell_kernel(tile_rows: torch.Tensor, tile_cols: torch.Tensor,
                           mask_blocks: torch.Tensor, q_perm: torch.Tensor,
                           kt: torch.Tensor, v: torch.Tensor, *,
                           n_live_block_rows: int, act: str = "leaky_relu",
                           slope: float = 0.2) -> torch.Tensor:
    """K8: K7 over the SELL live tiles, compact [n_live*bm, D];
    ``q_perm`` is q in packed row order [n_live*bm, dk]."""
    if v.device.type == "cpu":
        return fused_attn_sell_tiles_ref(
            tile_rows, tile_cols, mask_blocks, q_perm, kt, v,
            n_live_block_rows=n_live_block_rows, act=act, slope=slope)
    require_cuda(v, "fused_attn_sell_kernel")
    check_operand(tile_rows, "tile_rows", torch.int32, tile_cols.shape,
                  v.device)
    y = launch_attention(sell_row_ptr(tile_rows, n_live_block_rows),
                         tile_cols, mask_blocks, q_perm, kt, v,
                         n_live_block_rows, 0, act, slope,
                         "K8 fused_attn_sell")
    fused_attn_sell_kernel.launches += 1
    return y


fused_attn_sell_kernel.launches = 0


def fused_attn_sell(sell: SellCS, q, kt, v, *, act: str = "leaky_relu",
                    slope: float = 0.2) -> torch.Tensor:
    """Fused attention over a SELL-packed topology, logical [M, D].

    K8 walks the live tiles only; rows in pruned slices have no edges,
    so their output is exactly zero, which the final gather's appended
    zero row restores.  With no live tile nothing is launched.
    """
    m, n = sell.shape
    dk = q.shape[1]
    d = v.shape[1]
    if sell.n_tiles == 0:
        return v.new_zeros((m, d), dtype=torch.promote_types(q.dtype,
                                                             v.dtype))
    n_pad = -(-n // sell.bn) * sell.bn
    q_perm = torch.cat([q, q.new_zeros((1, dk))])[sell.perm]
    kt = F.pad(kt, (0, n_pad - kt.shape[1])).contiguous()
    v = F.pad(v, (0, 0, 0, n_pad - v.shape[0])).contiguous()
    mask = (sell_tile_blocks(sell) != 0).to(torch.float32)
    y = fused_attn_sell_kernel(sell.tile_rows, sell.tile_cols, mask,
                               q_perm.contiguous(), kt, v,
                               n_live_block_rows=sell.n_live_block_rows,
                               act=act, slope=slope)
    y_ext = torch.cat([y, y.new_zeros((1, d))])
    return y_ext[sell.tile_out_gather]


def fused_attn_sell_slots_ref(sell: SellCS, q, kt, v, *,
                              act: str = "leaky_relu",
                              slope: float = 0.2) -> torch.Tensor:
    """Slot-granular reference: the element path at the packed slot
    coordinates (padding slots carry zero values and mask out)."""
    return fused_attn_elements(sell.slot_rows, sell.slot_cols,
                               sell.slot_vals, q, kt, v, sell.shape[0],
                               act=act, slope=slope)


# ---------------------------------------------------------------------------
# Element (csr) and dense paths
# ---------------------------------------------------------------------------


def fused_attn_elements(row_ids, col_ids, values, q, kt, v, m: int, *,
                        act: str = "leaky_relu",
                        slope: float = 0.2) -> torch.Tensor:
    """The csr path (element-granular, E-length by nature)."""
    from repro_torch.sparse.paths import sddmm_element_dots, spmm_elements

    dots = sddmm_element_dots(row_ids, col_ids, q, kt).float()
    mask = values != 0
    e = torch.where(mask, apply_act(dots, act, slope), NEG_INF)
    idx = row_ids.long()
    mx = e.new_full((m,), NEG_INF).scatter_reduce(0, idx, e, "amax")
    ex = torch.where(mask, torch.exp(e - mx[idx]), 0.0)
    den = e.new_zeros((m,)).index_add_(0, idx, ex)
    alpha = ex / den[idx].clamp_min(EPS)
    return spmm_elements(row_ids, col_ids, alpha.to(v.dtype), v, m).to(
        torch.promote_types(q.dtype, v.dtype))


def fused_attn_dense(a_dense, q, kt, v, *, act: str = "leaky_relu",
                     slope: float = 0.2) -> torch.Tensor:
    """Densified path: masked row softmax over the full product."""
    s = q.float() @ kt.float()
    mask = a_dense != 0
    e = torch.where(mask, apply_act(s, act, slope), NEG_INF)
    mx = e.amax(dim=1, keepdim=True)
    p = torch.where(mask, torch.exp(e - mx), 0.0)
    den = p.sum(dim=1, keepdim=True).clamp_min(EPS)
    return ((p / den) @ v.float()).to(torch.promote_types(q.dtype, v.dtype))

"""One-pass fused graph attention, SDDMM → edge act → softmax → SpMM: the
wrappers of kernels K7 and K8 (the port of
``repro.kernels.fused.attention``).

K7 replaces the Pallas kernel ``fused_attn_blockell_kernel`` and K8
replaces ``fused_attn_sell_kernel``; both are ``csrc/fused_attention.cu``
and work on A's nonzeros only, keeping each row's running max ``m``, its
exp-sum ``l`` and the accumulator on chip, so the edge scores never exist
in device memory:

  per batch of a row's nonzeros j:
             s_j = act(q[r] · kT[:, j]);  m' = max(m, max_j s_j)
             l = l * exp(m - m') + Σ_j exp(s_j - m')
             acc = acc * exp(m - m') + Σ_j exp(s_j - m') V[j]
  flush:     out = acc / max(l, EPS)

K7 streams each Block-ELL block once (A's values are the mask); K8 walks
``SellCS``'s row view (``tile_row_slot`` / ``tile_row_nnz`` over
``slot_cols`` / ``slot_vals``, the heavy rows ``tile_heavy_rows`` a CTA
each), so it takes no tile data, row pointer or host sync per call.
Masked entries (a zero value, stored or not) weigh exactly 0, so an
edge-less row comes out exactly 0.  The plain versions beside the
wrappers are the reference's two-sweep (an explicit max pass, then the
exp / sum / accumulate pass), so kernel-vs-plain parity also pins the
online rescaling; ``fused_attn_sell_tiles_ref`` is the tile-granular
counterpart of the Pallas K8, a second check of the row-view plain
version.  The csr and dense paths are plain compositions.  Each wrapper
runs its plain version for CPU tensors and its kernel for CUDA tensors,
and counts launches in ``<wrapper>.launches``.  Every path takes f32,
bf16 or f16 operands, computes in f32 and returns the reference's default
output dtype, ``result_type(q, v)``; the kernels read narrow operands
natively and round once, at the store.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.formats import (SELL_HEAVY_ROW_NNZ, BlockCOO, BlockELL,
                                      SellCS)
from repro_torch.kernels import _build
from repro_torch.kernels.fused.epilogue import apply_act
from repro_torch.kernels.spmm.kernel import (ACT_CODES, KERNEL_DTYPES,
                                             check_geometry, check_operand,
                                             require_cuda, result_dtype)
from repro_torch.kernels.spmm.sell import sell_row_operands

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


def _kernel_operands(q, kt, v):
    """q, kᵀ and V in their common dtype (the kernels read one element
    type; the promotion is exact), that dtype, and the output dtype
    ``result_type(q, v)``."""
    out = result_dtype(q, v)
    common = torch.promote_types(out, result_dtype(kt))
    return q.to(common), kt.to(common), v.to(common), common, out


def _mask_bytes(values: torch.Tensor) -> int:
    """Bytes of a mask element: the kernels read A's values only as
    ``!= 0``, from their bits, so bf16 and f16 read alike."""
    result_dtype(values)  # raises on a dtype the kernels do not take
    return values.element_size()


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


def launch_blockell_attention(indices, blocks, q, kt, v, act: str,
                              slope: float) -> torch.Tensor:
    """Check the operands and launch K7 (``csrc/fused_attention.cu``) on
    the current stream; returns Y [nbr*bm, D] in ``result_type(q, v)``."""
    dev = v.device
    nbr, w, bm, bn = blocks.shape
    dk = q.shape[1]
    n, d = v.shape
    check_geometry(bm, bn, n)
    check_operand(indices, "indices", torch.int32, (nbr, w), dev)
    check_operand(blocks, "blocks", None, (nbr, w, bm, bn), dev)
    check_operand(q, "q", None, (nbr * bm, dk), dev)
    check_operand(kt, "kt", None, (dk, n), dev)
    check_operand(v, "v", None, (n, d), dev)
    a_es = _mask_bytes(blocks)
    q, kt, v, common, out = _kernel_operands(q, kt, v)
    y = torch.empty((nbr * bm, d), dtype=common, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry("fused_attention")(
            KERNEL_DTYPES[common], a_es, indices.data_ptr(),
            blocks.data_ptr(), q.data_ptr(), kt.data_ptr(), v.data_ptr(),
            y.data_ptr(), nbr, w, bm, bn, dk, n, d, ACT_CODES[act],
            float(slope), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K7 fused_attn_blockell")
    return y.to(out)


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
    y = launch_blockell_attention(indices, blocks, q, kt, v, act, slope)
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
    """Tile-granular plain version of K8's compact output [n_live*bm, D]
    (the Pallas kernel's function, over its operands): the blocked
    two-sweep over the live tiles and their 0/1 masks, segment reductions
    over ``tile_rows``."""
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


def fused_attn_sell_operands(sell: SellCS) -> Tuple[torch.Tensor, ...]:
    """K8's topology operands, the row view K2 / K6 read too:
    (``tile_row_slot``, ``tile_row_nnz``, ``slot_cols``, ``slot_vals``)."""
    return sell_row_operands(sell)


def fused_attn_sell_rows_ref(row_slot, row_nnz, slot_cols, slot_vals, q_perm,
                             kt, v, *, act: str = "leaky_relu",
                             slope: float = 0.2) -> torch.Tensor:
    """Plain version of K8 over the row view: compact row r attends over
    its nonzeros, slots ``row_slot[r]`` .. ``+ row_nnz[r]`` (live where
    ``slot_vals`` is nonzero), with the two-sweep softmax; ``q_perm``
    [R, dk] in compact row order, ``kt`` [dk, N], ``v`` [N, D]; returns
    [R, D] in ``result_type(q_perm, v)``, edge-less rows exactly 0."""
    n_rows, d = row_slot.shape[0], v.shape[1]
    dev = v.device
    counts = row_nnz.long()
    rows = torch.repeat_interleave(torch.arange(n_rows, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts  # row -> its first nonzero
    slots = torch.arange(rows.shape[0], device=dev) \
        + (row_slot.long() - first)[rows]
    cols = slot_cols[slots].long()
    mask = slot_vals[slots] != 0
    s = (q_perm[rows].float() * kt.T[cols].float()).sum(dim=-1)
    e = torch.where(mask, apply_act(s, act, slope), NEG_INF)
    mx = e.new_full((n_rows,), NEG_INF).scatter_reduce(0, rows, e, "amax")
    p = torch.where(mask, torch.exp(e - mx[rows]), 0.0)        # sweep 2
    den = e.new_zeros((n_rows,)).index_add_(0, rows, p)
    y = e.new_zeros((n_rows, d)).index_add_(
        0, rows, p[:, None] * v[cols].float())
    return (y / den.clamp_min(EPS)[:, None]).to(
        torch.promote_types(q_perm.dtype, v.dtype))


def launch_sell_attention(row_slot, row_nnz, slot_cols, slot_vals, q_perm,
                          kt, v, heavy_rows, act: str,
                          slope: float) -> torch.Tensor:
    """Check the operands and launch K8 (``csrc/fused_attention.cu``) on
    the current stream; returns the compact Y [R, D] in
    ``result_type(q_perm, v)``.  ``kt`` may be any strided view (the
    kernel reads it through its strides: ``k.T`` needs no copy).  Every
    ``slot_cols`` entry a row reads must
    be below N, and ``heavy_rows`` must list exactly the rows with more
    than ``SELL_HEAVY_ROW_NNZ`` nonzeros (``SellCS`` guarantees both;
    checking them here would cost a host sync)."""
    dev = v.device
    n_rows, s_count = row_slot.shape[0], slot_cols.shape[0]
    dk = q_perm.shape[1]
    n, d = v.shape
    check_operand(row_slot, "row_slot", torch.int32, (n_rows,), dev)
    check_operand(row_nnz, "row_nnz", torch.int32, (n_rows,), dev)
    check_operand(heavy_rows, "heavy_rows", torch.int32,
                  (heavy_rows.shape[0],), dev)
    check_operand(slot_cols, "slot_cols", torch.int32, (s_count,), dev)
    check_operand(slot_vals, "slot_vals", None, (s_count,), dev)
    check_operand(q_perm, "q_perm", None, (n_rows, dk), dev)
    check_operand(kt, "kt", None, (dk, n), dev, contiguous=False)
    check_operand(v, "v", None, (n, d), dev)
    v_es = _mask_bytes(slot_vals)
    q_perm, kt, v, common, out = _kernel_operands(q_perm, kt, v)
    y = torch.empty((n_rows, d), dtype=common, device=dev)
    with torch.cuda.device(dev):
        err = _build.entry("fused_attn_sell")(
            KERNEL_DTYPES[common], v_es, row_slot.data_ptr(),
            row_nnz.data_ptr(), heavy_rows.data_ptr(), slot_cols.data_ptr(),
            slot_vals.data_ptr(), q_perm.data_ptr(), kt.data_ptr(),
            kt.stride(0), kt.stride(1), v.data_ptr(), y.data_ptr(), n_rows,
            heavy_rows.shape[0],
            SELL_HEAVY_ROW_NNZ, dk, n, d, ACT_CODES[act], float(slope),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K8 fused_attn_sell")
    return y.to(out)


def fused_attn_sell_kernel(row_slot: torch.Tensor, row_nnz: torch.Tensor,
                           slot_cols: torch.Tensor, slot_vals: torch.Tensor,
                           q_perm: torch.Tensor, kt: torch.Tensor,
                           v: torch.Tensor, *, heavy_rows: torch.Tensor,
                           act: str = "leaky_relu",
                           slope: float = 0.2) -> torch.Tensor:
    """K8: the compact Y [R, D], one row per entry of ``row_slot``, over
    the row view (``fused_attn_sell_operands``); ``q_perm`` is q in
    compact row order [R, dk]; ``heavy_rows`` (``SellCS.tile_heavy_rows``)
    is read by the kernel only: it schedules, it does not change the
    function."""
    if v.device.type == "cpu":
        return fused_attn_sell_rows_ref(row_slot, row_nnz, slot_cols,
                                        slot_vals, q_perm, kt, v, act=act,
                                        slope=slope)
    require_cuda(v, "fused_attn_sell_kernel")
    y = launch_sell_attention(row_slot, row_nnz, slot_cols, slot_vals,
                              q_perm, kt, v, heavy_rows, act, slope)
    fused_attn_sell_kernel.launches += 1
    return y


fused_attn_sell_kernel.launches = 0


def fused_attn_sell(sell: SellCS, q, kt, v, *, act: str = "leaky_relu",
                    slope: float = 0.2) -> torch.Tensor:
    """Fused attention over a SELL-packed topology, logical [M, D].

    K8 walks the live block-rows' compact rows only; rows in pruned
    slices have no edges, so their output is exactly zero, which the
    final gather's appended zero row restores.  With no live block-row
    nothing is launched.
    """
    m, _ = sell.shape
    dk = q.shape[1]
    d = v.shape[1]
    if sell.n_live_block_rows == 0:
        return v.new_zeros((m, d), dtype=torch.promote_types(q.dtype,
                                                             v.dtype))
    q_perm = torch.cat([q, q.new_zeros((1, dk))])[sell.perm]
    y = fused_attn_sell_kernel(*fused_attn_sell_operands(sell), q_perm, kt,
                               v.contiguous(),
                               heavy_rows=sell.tile_heavy_rows, act=act,
                               slope=slope)
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

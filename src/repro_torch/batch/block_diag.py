"""Block-diagonal batching of many ``SparseMatrix`` graphs (the port of
``repro.batch.block_diag``).

Serving traffic arrives as streams of small, variably-shaped graphs; one
kernel launch per tiny graph leaves the card idle between dispatches.
Composing N graphs into one block-diagonal operand

    B = diag(A_1, ..., A_N)

runs the whole batch as a single planned SpMM / SDDMM.  Every stored entry
of B lies inside one diagonal block, so ``B @ H`` and ``B.sddmm(b, c)`` are
exact: there is no cross-graph mixing to correct for.

``BatchedSparseMatrix`` carries the composed ``SparseMatrix`` (csr, ell
and / or sell forms, concatenated with index offsets on the device, never
densified) plus per-graph ``Segment`` offsets, so results split back out
(``unbatch`` / ``unbatch_values``).  Offsets use each graph's padded shape
(``stats.shape``, a multiple of the block size), so the element and blocked
forms of one batch agree on where graph i's rows and columns live.

The sell composition also offsets the port's row view of ``SellCS``
(``tile_row_slot`` by the slot offset, ``tile_heavy_rows`` by the compact
row offset; ``tile_row_nnz`` is carried), which K2, K6, K4 and K8 read.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import BlockELL, SellCS
from repro_torch.dispatch.stats import MatrixStats
from repro_torch.sparse import paths
from repro_torch.sparse.matrix import FORMATS, SparseMatrix


@dataclasses.dataclass(frozen=True)
class Segment:
    """Where one graph lives inside the batched (block-diagonal) space.

    ``row_start`` / ``col_start`` are offsets in the padded composition;
    ``rows`` / ``cols`` are the graph's padded extents, ``rows_logical`` /
    ``cols_logical`` its true extents.  ``nnz``, ``block_rows`` /
    ``ell_width`` and ``sell_slots`` (-1: no sell form) drive the per-form
    value splits.
    """

    row_start: int
    col_start: int
    rows: int
    cols: int
    rows_logical: int
    cols_logical: int
    nnz: int
    block_rows: int
    ell_width: int
    sell_slots: int = -1


def _padded_shape(a: SparseMatrix) -> Tuple[int, int]:
    if a.stats is not None:
        return a.stats.shape
    return a.shape


def _common_formats(mats: Sequence[SparseMatrix]) -> Tuple[str, ...]:
    common = [f for f in FORMATS if all(m.has_form(f) for m in mats)]
    return tuple(f for f in ("ell", "sell", "csr") if f in common)


def _concat_csr(mats: Sequence[SparseMatrix],
                segments: Sequence[Segment]):
    rows, cols, vals = [], [], []
    for m, seg in zip(mats, segments):
        r, c, v = m.form("csr")
        rows.append(r + seg.row_start)
        cols.append(c + seg.col_start)
        vals.append(v)
    return torch.cat(rows), torch.cat(cols), torch.cat(vals)


def pad_ell_width(indices: torch.Tensor, blocks: torch.Tensor, width: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Widen ELL (indices, blocks) to ``width`` slots per block-row.

    Pad slots point at the row's slot-0 column and carry zero data (the
    Block-ELL padding contract): a column repeats in its block-row.
    """
    pad = width - indices.shape[1]
    if pad <= 0:
        return indices, blocks
    return (torch.cat([indices, indices[:, :1].repeat(1, pad)], dim=1),
            torch.cat([blocks, blocks.new_zeros(
                blocks.shape[:1] + (pad,) + blocks.shape[2:])], dim=1))


def _concat_ell(mats: Sequence[SparseMatrix], segments: Sequence[Segment],
                shape: Tuple[int, int]) -> BlockELL:
    ells = [m.form("ell") for m in mats]
    bms = {(e.bm, e.bn) for e in ells}
    if len(bms) != 1:
        raise ValueError(
            f"block-diagonal ELL needs one block size, got {sorted(bms)}")
    (_, bn) = bms.pop()
    width = max(e.ell_width for e in ells)
    indices, blocks, nblocks = [], [], []
    for e, seg in zip(ells, segments):
        idx, blk = pad_ell_width(e.indices, e.blocks, width)
        indices.append(idx + seg.col_start // bn)
        blocks.append(blk)
        nblocks.append(e.nblocks)
    return BlockELL(indices=torch.cat(indices), blocks=torch.cat(blocks),
                    nblocks=torch.cat(nblocks), shape=shape)


def _remap(x: torch.Tensor, sentinel: int, new_sentinel: int,
           offset: int) -> torch.Tensor:
    """``x + offset``, with every ``sentinel`` entry set to
    ``new_sentinel``."""
    return torch.where(x == sentinel, torch.full_like(x, new_sentinel),
                       x + offset)


def _concat_sell(mats: Sequence[SparseMatrix], segments: Sequence[Segment],
                 shape: Tuple[int, int]) -> SellCS:
    """Block-diagonal SELL-C-σ composition: index arithmetic only.

    Each graph keeps its own slice packing; slot, tile and row-view
    descriptors are concatenated with row / column / slot / compact-row
    offsets and every sentinel is remapped to the composed sentinel.
    """
    sells = [m.form("sell") for m in mats]
    blocks = {(s.bm, s.bn) for s in sells}
    if len(blocks) != 1:
        raise ValueError(
            f"block-diagonal sell needs one tile size, got {sorted(blocks)}")
    (bm, bn) = blocks.pop()
    for seg in segments:
        if seg.col_start % bn:
            raise ValueError(
                f"column offset {seg.col_start} not aligned to bn={bn}")
    n_slots_total = sum(s.n_slots for s in sells)
    n_packed_total = sum(s.n_packed_rows for s in sells)
    n_live_total = sum(s.n_live_block_rows for s in sells)
    n_cells_total = sum(s.n_tiles for s in sells) * bm * bn
    m_total, _ = shape
    dev = sells[0].device

    buckets = []
    parts: Dict[str, List[torch.Tensor]] = {k: [] for k in (
        "slot_cols", "slot_rows", "slot_vals", "perm", "tile_rows",
        "tile_cols", "tile_slot_map", "slot_tile_pos", "tile_row_slot",
        "tile_row_nnz", "tile_heavy_rows")}
    out_gather = torch.full((m_total,), n_packed_total, dtype=torch.int32,
                            device=dev)
    tile_out_gather = torch.full((m_total,), n_live_total * bm,
                                 dtype=torch.int32, device=dev)
    row_off = slot_off = live_off = cell_off = 0
    for s, seg in zip(sells, segments):
        m_g = s.shape[0]
        for b_off, b_rows, b_width in s.buckets:
            buckets.append((b_off + row_off, b_rows, b_width))
        parts["slot_cols"].append(s.slot_cols + seg.col_start)
        parts["slot_rows"].append(s.slot_rows + seg.row_start)
        parts["slot_vals"].append(s.slot_vals)
        parts["perm"].append(_remap(s.perm, m_g, m_total, seg.row_start))
        parts["tile_rows"].append(s.tile_rows + live_off)
        parts["tile_cols"].append(s.tile_cols + seg.col_start // bn)
        parts["tile_slot_map"].append(
            _remap(s.tile_slot_map, s.n_slots, n_slots_total, slot_off))
        parts["slot_tile_pos"].append(_remap(
            s.slot_tile_pos, s.n_tiles * bm * bn, n_cells_total, cell_off))
        # the row view: compact rows concatenate in the tile view's order
        parts["tile_row_slot"].append(s.tile_row_slot + slot_off)
        parts["tile_row_nnz"].append(s.tile_row_nnz)
        parts["tile_heavy_rows"].append(s.tile_heavy_rows + live_off * bm)
        out_gather[seg.row_start:seg.row_start + m_g] = _remap(
            s.out_gather, s.n_packed_rows, n_packed_total, row_off)
        tile_out_gather[seg.row_start:seg.row_start + m_g] = _remap(
            s.tile_out_gather, s.n_live_block_rows * bm, n_live_total * bm,
            live_off * bm)
        row_off += s.n_packed_rows
        slot_off += s.n_slots
        live_off += s.n_live_block_rows
        cell_off += s.n_tiles * bm * bn

    return SellCS(
        **{k: torch.cat(v) for k, v in parts.items()},
        out_gather=out_gather, tile_out_gather=tile_out_gather, shape=shape,
        c=sells[0].c, sigma=sells[0].sigma, buckets=tuple(buckets),
        block=(bm, bn), n_live_block_rows=n_live_total)


def _combined_stats(mats: Sequence[SparseMatrix],
                    shape: Tuple[int, int]) -> Optional[MatrixStats]:
    stats = [m.stats for m in mats]
    if any(s is None for s in stats):
        return None
    width = max(s.ell_width for s in stats)
    nbr = sum(s.n_block_rows for s in stats)
    # slot occupancy of the composed layout (block-diagonal concatenation
    # adds no padding beyond width alignment)
    occ = sum(s.occupancy * s.n_block_rows * max(s.ell_width, 1)
              for s in stats) / max(nbr * max(width, 1), 1)
    # sell slots concatenate exactly; unknown in any part poisons the sum
    sell_known = all(s.sell_stored_elements > 0 or s.nnz == 0
                     for s in stats)
    return MatrixStats(
        shape=shape,
        nnz=sum(s.nnz for s in stats),
        stored_elements=sum(s.stored_elements for s in stats),
        block_m=max(s.block_m for s in stats),
        block_n=max(s.block_n for s in stats),
        n_block_rows=nbr,
        ell_width=width,
        occupancy=occ,
        sell_stored_elements=(sum(s.sell_stored_elements for s in stats)
                              if sell_known else 0),
    )


class BatchedSparseMatrix:
    """N sparse graphs composed block-diagonally into one operand.

    ``B.matrix`` is a regular :class:`SparseMatrix`: every planned operator
    (``B @ H``, ``B.sddmm(b, c)``, gradients through both) runs on the
    whole batch in one dispatch.  ``B.segments`` records the per-graph
    offsets for ``batch_features`` / ``unbatch``.
    """

    __slots__ = ("matrix", "segments")

    def __init__(self, matrix: SparseMatrix, segments: Tuple[Segment, ...]):
        self.matrix = matrix
        self.segments = tuple(segments)

    @classmethod
    def from_matrices(cls, mats: Sequence[SparseMatrix], *,
                      formats: Optional[Tuple[str, ...]] = None,
                      stats: Optional[MatrixStats] = None,
                      ) -> "BatchedSparseMatrix":
        """Compose N matrices (on one device) block-diagonally.

        ``formats`` picks which carried forms to compose (default: every
        form all inputs share, among ell, sell and csr).  ``stats``
        overrides the derived combined stats: a continuous serving lane
        composes the same bucket geometry every step and passes the same
        canonical stats each time.
        """
        mats = list(mats)
        if not mats:
            raise ValueError("from_matrices needs at least one matrix")
        if formats is None:
            formats = _common_formats(mats)
            if not formats:
                raise ValueError(
                    "matrices share no common form; convert with .to() "
                    f"first (carried: {[m.formats for m in mats]})")
        for f in formats:
            missing = [i for i, m in enumerate(mats) if not m.has_form(f)]
            if missing:
                raise ValueError(f"matrices {missing} carry no {f!r} form")
        segments: List[Segment] = []
        r0 = c0 = 0
        for m in mats:
            mp, np_ = _padded_shape(m)
            s = m.stats
            segments.append(Segment(
                row_start=r0, col_start=c0, rows=mp, cols=np_,
                rows_logical=m.shape[0], cols_logical=m.shape[1],
                nnz=s.nnz if s is not None else -1,
                block_rows=s.n_block_rows if s is not None else -1,
                ell_width=(m.form("ell").ell_width
                           if m.has_form("ell") else 0),
                sell_slots=(m.form("sell").n_slots
                            if m.has_form("sell") else -1),
            ))
            r0 += mp
            c0 += np_
        shape = (r0, c0)
        forms: Dict[str, Any] = {}
        for f in formats:
            if f == "csr":
                forms["csr"] = _concat_csr(mats, segments)
            elif f == "ell":
                forms["ell"] = _concat_ell(mats, segments, shape)
            elif f == "sell":
                forms["sell"] = _concat_sell(mats, segments, shape)
            else:
                raise ValueError(
                    f"cannot compose {f!r} block-diagonally; supported "
                    "forms: ('ell', 'sell', 'csr')")
        if stats is None:
            stats = _combined_stats(mats, shape)
        elif stats.shape != shape:
            raise ValueError(
                f"stats override has shape {stats.shape} but the "
                f"composition is {shape}")
        return cls(SparseMatrix(forms, shape, stats), tuple(segments))

    # -- metadata -----------------------------------------------------------

    @property
    def n_graphs(self) -> int:
        return len(self.segments)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.matrix.shape

    @property
    def stats(self):
        return self.matrix.stats

    @property
    def formats(self) -> Tuple[str, ...]:
        return self.matrix.formats

    @property
    def device(self) -> torch.device:
        return self.matrix.device

    def __repr__(self) -> str:
        return (f"BatchedSparseMatrix(n_graphs={self.n_graphs}, "
                f"shape={self.shape}, formats={self.formats})")

    # -- feature stacking / result splitting --------------------------------

    def batch_features(self, hs: Sequence[Any]) -> torch.Tensor:
        """Stack per-graph feature blocks [n_i, d] (tensors or numpy) into
        the batched column space on the matrix's device (zero rows fill
        each graph's block padding)."""
        if len(hs) != self.n_graphs:
            raise ValueError(
                f"got {len(hs)} feature blocks for {self.n_graphs} graphs")
        out = []
        for h, seg in zip(hs, self.segments):
            h = torch.as_tensor(h, device=self.device)
            if h.ndim != 2:
                raise ValueError(
                    f"batch_features expects [n_i, d] blocks, got "
                    f"{tuple(h.shape)}")
            if h.shape[0] != seg.cols_logical:
                raise ValueError(
                    f"feature block has {h.shape[0]} rows; graph has "
                    f"{seg.cols_logical} nodes")
            out.append(paths.pad_rows(h, seg.cols))
        return torch.cat(out)

    def unbatch(self, y, *, space: str = "rows") -> List[Any]:
        """Split a batched row-space result (e.g. ``B @ H``) back into
        per-graph parts, trimming each graph's padding."""
        if space not in ("rows", "cols"):
            raise ValueError(f"space must be 'rows' or 'cols', got {space!r}")
        if space == "rows":
            return [y[s.row_start:s.row_start + s.rows_logical]
                    for s in self.segments]
        return [y[s.col_start:s.col_start + s.cols_logical]
                for s in self.segments]

    def unbatch_values(self, vals, *, form: Optional[str] = None
                       ) -> List[Any]:
        """Split a batched values tensor (``B.matrix.data``, an SDDMM
        result, or a gradient of the batched values) per graph.

        ``form`` names the layout the values are in (default: the batch's
        primary form): csr splits by per-graph nnz, ell by block-rows with
        each graph's width padding trimmed off, sell by slot count.
        """
        form = form or self.matrix.format
        if form == "csr":
            if any(seg.nnz < 0 for seg in self.segments):
                raise ValueError(
                    "cannot split element values: a graph was composed "
                    "without stats (unknown nnz)")
            offs = np.cumsum([0] + [seg.nnz for seg in self.segments])
            return [vals[offs[i]:offs[i + 1]] for i in range(self.n_graphs)]
        if form == "ell":
            if any(seg.block_rows < 0 for seg in self.segments):
                raise ValueError(
                    "cannot split blocked values: a graph was composed "
                    "without stats (unknown block-row count)")
            width = self.matrix.form("ell").ell_width
            out = []
            row = 0
            for seg in self.segments:
                blk = vals[row:row + seg.block_rows]
                out.append(blk[:, :seg.ell_width] if seg.ell_width < width
                           else blk)
                row += seg.block_rows
            return out
        if form == "sell":
            if any(seg.sell_slots < 0 for seg in self.segments):
                raise ValueError(
                    "cannot split sell values: a graph was composed "
                    "without a sell form (unknown slot count)")
            offs = np.cumsum([0] + [seg.sell_slots for seg in self.segments])
            return [vals[offs[i]:offs[i + 1]] for i in range(self.n_graphs)]
        raise ValueError(f"cannot split values of form {form!r}")

    # -- batched operators --------------------------------------------------

    def __matmul__(self, h):
        return self.matmul(h)

    def matmul(self, h, **kw):
        """``B @ h``: one planned SpMM for the batch (``ops.matmul``'s
        keywords)."""
        from repro_torch.sparse import ops

        return ops.matmul(self.matrix, h, **kw)

    def sddmm(self, b, c, **kw) -> SparseMatrix:
        """Batched ``B ⊙ (b @ c)``: one planned SDDMM for the batch."""
        return self.matrix.sddmm(b, c, **kw)


def batch_matmul(mats: Sequence[SparseMatrix], hs: Sequence[Any], *,
                 formats: Optional[Tuple[str, ...]] = None,
                 **kw) -> List[torch.Tensor]:
    """One-shot helper: block-diagonal compose, one SpMM, split back."""
    B = BatchedSparseMatrix.from_matrices(mats, formats=formats)
    return B.unbatch(B.matmul(B.batch_features(hs), **kw))


def batch_sddmm(B: BatchedSparseMatrix, bs: Sequence[Any],
                cs: Sequence[Any], **kw) -> List[torch.Tensor]:
    """Batched attention scoring: one SDDMM over the block-diagonal
    composition, split back into per-graph sampled values.

    ``bs[i]``: [m_i, K] row factors; ``cs[i]``: [K, n_i] column factors.
    Every stored entry of B lies inside a diagonal block, so the batched
    sample equals each graph's ``A_i ⊙ (b_i @ c_i)`` exactly.
    """
    if len(bs) != B.n_graphs or len(cs) != B.n_graphs:
        raise ValueError(
            f"got {len(bs)}/{len(cs)} factor blocks for {B.n_graphs} graphs")
    brows = []
    for b, seg in zip(bs, B.segments):
        b = torch.as_tensor(b, device=B.device)
        if b.shape[0] != seg.rows_logical:
            raise ValueError(f"row factor has {b.shape[0]} rows; graph has "
                             f"{seg.rows_logical}")
        brows.append(paths.pad_rows(b, seg.rows))
    ccols = []
    for c, seg in zip(cs, B.segments):
        c = torch.as_tensor(c, device=B.device)
        if c.shape[1] != seg.cols_logical:
            raise ValueError(f"column factor has {c.shape[1]} columns; graph "
                             f"has {seg.cols_logical}")
        ccols.append(paths.pad_cols(c, seg.cols))
    s = B.sddmm(torch.cat(brows), torch.cat(ccols, dim=1), **kw)
    return B.unbatch_values(s.data, form=s.format)

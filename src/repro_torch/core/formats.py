"""Sparse storage formats (the port of ``repro.core.formats``).

Host packing is numpy and follows the JAX package line for line, so the
index arrays of both packages are identical for the same input; the
device fields are torch tensors on the requested device.

  * ``CSR``      — host-side (numpy) baseline container.
  * ``BlockELL`` — A tiled into (bm x bn) blocks; each block-row keeps its
                   nonzero blocks left-aligned and is padded to one width
                   W with zero blocks whose index repeats a valid column.
  * ``BlockCOO`` — the nonzero (bm x bn) blocks as a coordinate list (the
                   SDDMM-side format).
  * ``SellCS``   — SELL-C-σ: rows sorted by nnz within σ-windows, packed
                   into width-adaptive slices, plus the tile-pruned block
                   view the SELL kernels iterate.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _to(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


# ---------------------------------------------------------------------------
# CSR (host-side baseline; mirrors scipy.sparse.csr_matrix layout)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row; host-side (numpy) container, int32 indices."""

    indptr: np.ndarray  # int32[M+1]
    indices: np.ndarray  # int32[nnz]
    values: np.ndarray  # dtype[nnz]
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @staticmethod
    def from_dense(dense: np.ndarray) -> "CSR":
        dense = np.asarray(dense)
        m, n = dense.shape
        mask = dense != 0
        counts = mask.sum(axis=1)
        indptr64 = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr64[1:])
        nnz = int(indptr64[-1])
        if nnz >= np.iinfo(np.int32).max:
            raise ValueError(
                f"nnz={nnz} overflows the int32 index space; shard the "
                "matrix before building CSR")
        idx = np.nonzero(mask)
        return CSR(indptr=indptr64.astype(np.int32),
                   indices=idx[1].astype(np.int32), values=dense[idx],
                   shape=(m, n))

    def to_dense(self) -> np.ndarray:
        m, n = self.shape
        out = np.zeros((m, n), dtype=self.values.dtype)
        rows = np.repeat(np.arange(m), np.diff(self.indptr))
        out[rows, self.indices] = self.values
        return out


# ---------------------------------------------------------------------------
# Block-ELL
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockELL:
    """Block-ELL sparse matrix.

    indices: int32[nbr, W]   block-column ids; padded slots repeat slot 0's
                             block column and carry zero data.
    blocks:  f32[nbr, W, bm, bn]  block data; padded slots are all-zero.
    nblocks: int32[nbr]      true (unpadded) block count per block-row.
    shape:   (M, N) dense shape padded to multiples of (bm, bn).
    """

    indices: torch.Tensor
    blocks: torch.Tensor
    nblocks: torch.Tensor
    shape: Tuple[int, int]

    @property
    def bm(self) -> int:
        return self.blocks.shape[2]

    @property
    def bn(self) -> int:
        return self.blocks.shape[3]

    @property
    def n_block_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def ell_width(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @staticmethod
    def from_dense(dense: np.ndarray, bm: int, bn: int,
                   ell_width: int | None = None, *,
                   device="cuda") -> "BlockELL":
        """Tile ``dense`` into (bm, bn) blocks and keep nonzero blocks.

        The dense input is zero-padded up to multiples of (bm, bn).  If
        ``ell_width`` is given, block-rows with more nonzero blocks raise.
        """
        device = resolve_device(device)
        dense = np.asarray(dense)
        m, n = dense.shape
        mp, np_ = _cdiv(m, bm) * bm, _cdiv(n, bn) * bn
        if (mp, np_) != (m, n):
            pad = np.zeros((mp, np_), dtype=dense.dtype)
            pad[:m, :n] = dense
            dense = pad
        nbr, nbc = mp // bm, np_ // bn
        tiles = dense.reshape(nbr, bm, nbc, bn).transpose(0, 2, 1, 3)
        nz = tiles.reshape(nbr, nbc, -1).any(axis=-1)  # bool[nbr, nbc]
        counts = nz.sum(axis=1).astype(np.int32)
        width = int(counts.max()) if ell_width is None else int(ell_width)
        width = max(width, 1)
        if (counts > width).any():
            raise ValueError(
                f"ell_width={width} < max nonzero blocks per row "
                f"({int(counts.max())})")
        indices = np.zeros((nbr, width), dtype=np.int32)
        blocks = np.zeros((nbr, width, bm, bn), dtype=dense.dtype)
        for i in range(nbr):
            cols = np.nonzero(nz[i])[0]
            indices[i, : len(cols)] = cols
            blocks[i, : len(cols)] = tiles[i, cols]
            # padded slots: index 0 (or first real col), zero data
            if len(cols) == 0:
                indices[i, :] = 0
            else:
                indices[i, len(cols):] = cols[0]
        return BlockELL(indices=_to(indices, device),
                        blocks=_to(blocks, device),
                        nblocks=_to(counts, device), shape=(mp, np_))

    def to_dense(self) -> np.ndarray:
        """Inverse of from_dense (padded shape), on the host."""
        indices = self.indices.cpu().numpy()
        blocks = self.blocks.cpu().numpy()
        nblocks = self.nblocks.cpu().numpy()
        nbr = indices.shape[0]
        bm, bn = self.bm, self.bn
        out = np.zeros((nbr, self.shape[1] // bn, bm, bn), dtype=blocks.dtype)
        for i in range(nbr):
            for s in range(int(nblocks[i])):
                out[i, indices[i, s]] += blocks[i, s]
        return out.transpose(0, 2, 1, 3).reshape(self.shape)

    def occupancy(self) -> float:
        """Fraction of ELL slots that hold real blocks (1.0 = no padding)."""
        total = self.n_block_rows * self.ell_width
        return float(self.nblocks.sum()) / max(total, 1)


# ---------------------------------------------------------------------------
# Block-COO (SDDMM-side format)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockCOO:
    """Coordinate list of nonzero (bm x bn) blocks.

    rows/cols: int32[nnzb] block coordinates (padded entries repeat entry
               0 and carry an all-zero block, so they contribute nothing).
    blocks:    f32[nnzb, bm, bn] block data (for SDDMM, the sampling
               values of A).
    shape:     (M, N) dense shape padded to multiples of (bm, bn).
    """

    rows: torch.Tensor
    cols: torch.Tensor
    blocks: torch.Tensor
    shape: Tuple[int, int]

    @property
    def bm(self) -> int:
        return self.blocks.shape[1]

    @property
    def bn(self) -> int:
        return self.blocks.shape[2]

    @property
    def nnzb(self) -> int:
        return self.rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    @staticmethod
    def from_dense(dense: np.ndarray, bm: int, bn: int,
                   pad_to: int | None = None, *,
                   device="cuda") -> "BlockCOO":
        """Keep the nonzero (bm, bn) blocks of ``dense`` (zero-padded up
        to the block grid), block-row-major; an all-zero matrix keeps one
        zero block at (0, 0).  ``pad_to`` appends zero blocks."""
        device = resolve_device(device)
        dense = np.asarray(dense)
        m, n = dense.shape
        mp, np_ = _cdiv(m, bm) * bm, _cdiv(n, bn) * bn
        if (mp, np_) != (m, n):
            pad = np.zeros((mp, np_), dtype=dense.dtype)
            pad[:m, :n] = dense
            dense = pad
        nbr, nbc = mp // bm, np_ // bn
        tiles = dense.reshape(nbr, bm, nbc, bn).transpose(0, 2, 1, 3)
        nz = tiles.reshape(nbr, nbc, -1).any(axis=-1)
        ridx, cidx = np.nonzero(nz)
        nnzb = len(ridx)
        if nnzb == 0:
            ridx, cidx = np.zeros(1, np.int64), np.zeros(1, np.int64)
            blocks = np.zeros((1, bm, bn), dtype=dense.dtype)
            nnzb = 1
        else:
            blocks = tiles[ridx, cidx]
        if pad_to is not None and pad_to > nnzb:
            padn = pad_to - nnzb
            ridx = np.concatenate([ridx, np.full(padn, ridx[0])])
            cidx = np.concatenate([cidx, np.full(padn, cidx[0])])
            blocks = np.concatenate(
                [blocks, np.zeros((padn, bm, bn), dtype=blocks.dtype)])
        return BlockCOO(rows=_to(ridx.astype(np.int32), device),
                        cols=_to(cidx.astype(np.int32), device),
                        blocks=_to(blocks, device), shape=(mp, np_))

    def to_dense(self) -> np.ndarray:
        """Inverse of from_dense (padded shape), on the host; padded
        duplicates carry zero blocks, so the sum leaves them harmless."""
        bm, bn = self.bm, self.bn
        blocks = self.blocks.cpu().numpy()
        out = np.zeros((self.shape[0] // bm, self.shape[1] // bn, bm, bn),
                       dtype=blocks.dtype)
        np.add.at(out, (self.rows.cpu().numpy(), self.cols.cpu().numpy()),
                  blocks)
        return out.transpose(0, 2, 1, 3).reshape(self.shape)


# ---------------------------------------------------------------------------
# SELL-C-σ (tile-pruned, row-sorted packing for the hyper-sparse regime)
# ---------------------------------------------------------------------------

# Defaults shared by the packer and the stats layer (they must agree so
# the cost model prices exactly the layout the packer would build).
SELL_C = 8          # slice height (rows per width-adaptive slice)
SELL_SIGMA = 0      # sort-window size in rows; 0 = sort the whole matrix
# rows with more nonzeros than this are listed in ``tile_heavy_rows``: K2
# and K6 give each a whole CTA instead of a few lanes
SELL_HEAVY_ROW_NNZ = 128


# Geometric width ladder (~1.5x growth): slice widths round *up* onto it,
# so padding is bounded (<= 50 %, typically ~10 %) while the number of
# distinct widths stays O(log nnz).
def _width_ladder(upto: int) -> np.ndarray:
    vals = [1]
    while vals[-1] < upto:
        q = vals[-1]
        vals.append(q + 1 if q < 2 else q * 3 // 2)
    return np.array(vals, dtype=np.int64)


def _sell_row_order(row_nnz: np.ndarray, c: int, sigma: int,
                    width_slack: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(row order, quantized slice widths) of the SELL-C-σ packing.

    Rows are sorted by nnz (descending, stable) within ``sigma``-row
    windows, grouped into slices of ``c`` rows, and each slice's width is
    the quantized max nnz of its rows (plus ``width_slack`` reserved
    slots per row of every non-empty slice).  A pure function of the
    per-row counts, so ``MatrixStats`` prices the layout without packing.
    """
    m = len(row_nnz)
    mp = _cdiv(max(m, 1), c) * c
    padded = np.zeros(mp, dtype=np.int64)
    padded[:m] = row_nnz
    sigma = sigma if sigma and sigma > 0 else mp
    order = np.concatenate([
        w0 + np.argsort(-padded[w0:w0 + sigma], kind="stable")
        for w0 in range(0, mp, sigma)
    ]) if mp else np.zeros(0, np.int64)
    slice_max = padded[order].reshape(-1, c).max(axis=1) if mp \
        else np.zeros(0, np.int64)
    target = np.where(slice_max > 0, slice_max + int(width_slack), 0)
    ladder = _width_ladder(int(target.max()) if len(target) else 1)
    widths = np.where(
        target > 0,
        ladder[np.searchsorted(ladder, target, side="left")
               .clip(max=len(ladder) - 1)],
        0)
    return order, widths


def sell_slot_volume(row_nnz: np.ndarray, c: int = SELL_C,
                     sigma: int = SELL_SIGMA) -> int:
    """Padded slot count of the SELL-C-σ packing (empty slices pruned)."""
    _, widths = _sell_row_order(np.asarray(row_nnz), c, sigma)
    return int(widths.sum()) * c


@dataclasses.dataclass(frozen=True)
class SellCS:
    """SELL-C-σ sparse matrix with a tile-pruned block companion view.

    **Slot view** (element-granular): ``slot_cols``/``slot_rows`` int32
    [n_slots] original coordinates, ``slot_vals`` f32[n_slots] (padding
    slots are zeros), ``out_gather`` int32[M] original row -> packed row
    (``n_packed`` for rows in pruned slices).

    **Tile view** (what the SELL kernels iterate): ``perm`` int32
    [n_live*bm] live packed row -> original row (M for padding rows);
    ``tile_rows``/``tile_cols`` int32[T] live-tile coordinates (compacted
    block-row, ascending; original block-column); ``tile_slot_map`` int32
    [T, bm, bn] tile cell -> slot id (``n_slots`` for dead cells);
    ``slot_tile_pos`` int32[n_slots] slot -> flat tile-cell position;
    ``tile_out_gather`` int32[M] original row -> row of the compact kernel
    output (``n_live*bm`` for pruned rows); ``tile_row_slot`` /
    ``tile_row_nnz`` int32[n_live*bm] compact output row -> first slot of
    its packed row and its count of structural nonzeros (0 for padding
    rows); ``tile_heavy_rows`` int32[n_heavy] the compact rows with more
    than ``SELL_HEAVY_ROW_NNZ`` nonzeros, ascending.  The nonzeros of a
    row are its first slots, in ascending column, so K2/K6 read
    ``slot_cols``/``slot_vals`` through these (derived data the
    reference does not carry).

    Static: ``shape``, slice height ``c``, sort window ``sigma``,
    ``buckets`` ((row_offset, n_rows, width) per width bucket), the tile
    ``block`` and the live block-row count.
    """

    slot_cols: torch.Tensor
    slot_rows: torch.Tensor
    slot_vals: torch.Tensor
    out_gather: torch.Tensor
    perm: torch.Tensor
    tile_rows: torch.Tensor
    tile_cols: torch.Tensor
    tile_slot_map: torch.Tensor
    slot_tile_pos: torch.Tensor
    tile_out_gather: torch.Tensor
    tile_row_slot: torch.Tensor
    tile_row_nnz: torch.Tensor
    tile_heavy_rows: torch.Tensor
    shape: Tuple[int, int]
    c: int
    sigma: int
    buckets: Tuple[Tuple[int, int, int], ...]
    block: Tuple[int, int]
    n_live_block_rows: int

    @property
    def bm(self) -> int:
        return self.block[0]

    @property
    def bn(self) -> int:
        return self.block[1]

    @property
    def n_slots(self) -> int:
        return sum(r * w for _, r, w in self.buckets)

    @property
    def n_packed_rows(self) -> int:
        return sum(r for _, r, _ in self.buckets)

    @property
    def n_tiles(self) -> int:
        return int(self.tile_rows.shape[0])

    @property
    def device(self) -> torch.device:
        return self.slot_vals.device

    @staticmethod
    def from_dense(dense: np.ndarray, *, c: int = SELL_C,
                   sigma: int = SELL_SIGMA,
                   block: Tuple[int, int] = (64, 64),
                   width_slack: int = 0, device="cuda") -> "SellCS":
        """Pack a dense host matrix into SELL-C-σ (see ``repro``'s
        ``SellCS.from_dense``; the packing is identical)."""
        device = resolve_device(device)
        dense = np.asarray(dense)
        m, n = dense.shape
        bm, bn = block
        row_nnz = (dense != 0).sum(axis=1)
        order, widths = _sell_row_order(row_nnz, c, sigma, width_slack)

        # group equal-width slices into buckets (ascending width); the
        # packed row order is bucket-major, slice-order-preserving
        by_width: Dict[int, list] = {}
        for s, w in enumerate(widths):
            if w > 0:
                by_width.setdefault(int(w), []).append(s)
        buckets = []
        packed_rows = []  # original (padded) row id per packed row
        for w in sorted(by_width):
            slices = by_width[w]
            buckets.append((len(packed_rows), len(slices) * c, w))
            for s in slices:
                packed_rows.extend(order[s * c:(s + 1) * c])
        n_packed = len(packed_rows)

        # slot view (one nonzero scan per row, reused by the tile view)
        n_slots = sum(r * w for _, r, w in buckets)
        slot_cols = np.zeros(n_slots, np.int32)
        slot_rows = np.zeros(n_slots, np.int32)
        slot_vals = np.zeros(n_slots, dense.dtype)
        out_gather = np.full(m, n_packed, np.int32)
        slot_start = {}  # packed row -> offset of its first slot
        row_cols = {}    # packed row -> its nonzero column indices
        off = 0
        for row_off, n_rows, w in buckets:
            for i in range(n_rows):
                r = packed_rows[row_off + i]
                lo = off + i * w
                slot_start[row_off + i] = lo
                if r < m:
                    cc = np.nonzero(dense[r])[0]
                    row_cols[row_off + i] = cc
                    k = len(cc)
                    slot_cols[lo:lo + w] = cc[0] if k else 0
                    slot_cols[lo:lo + k] = cc
                    slot_rows[lo:lo + w] = r
                    slot_vals[lo:lo + k] = dense[r, cc]
                    out_gather[r] = row_off + i
                # rows >= m are slice padding: zero slots at (0, 0)
            off += n_rows * w

        # tile view: block the packed row axis, keep live tiles only
        tiles: Dict[Tuple[int, int], np.ndarray] = {}
        for p, cc in row_cols.items():
            lo = slot_start[p]
            for k, col in enumerate(cc):
                key = (p // bm, col // bn)
                cell = tiles.get(key)
                if cell is None:
                    cell = np.full((bm, bn), n_slots, np.int32)
                    tiles[key] = cell
                cell[p % bm, col % bn] = lo + k

        live_brs = sorted({br for br, _ in tiles})
        br_compact = {br: i for i, br in enumerate(live_brs)}
        n_live = len(live_brs)
        keys = sorted(tiles)  # block-row-major, then block-column
        t_count = len(keys)
        tile_rows = np.zeros(t_count, np.int32)
        tile_cols = np.zeros(t_count, np.int32)
        tile_slot_map = np.full((t_count, bm, bn), n_slots, np.int32)
        for t, (br, bc) in enumerate(keys):
            tile_rows[t] = br_compact[br]
            tile_cols[t] = bc
            tile_slot_map[t] = tiles[(br, bc)]
        slot_tile_pos = np.full(n_slots, t_count * bm * bn, np.int32)
        flat = tile_slot_map.reshape(-1)
        live = flat < n_slots
        slot_tile_pos[flat[live]] = np.nonzero(live)[0].astype(np.int32)

        # perm: live packed row -> original row (M for padding rows); the
        # nonzero-granular row view over the same compact rows
        perm = np.full(n_live * bm, m, np.int32)
        tile_out_gather = np.full(m, n_live * bm, np.int32)
        tile_row_slot = np.zeros(n_live * bm, np.int32)
        tile_row_nnz = np.zeros(n_live * bm, np.int32)
        for i, br in enumerate(live_brs):
            for j in range(bm):
                p = br * bm + j
                if p < n_packed and packed_rows[p] < m:
                    perm[i * bm + j] = packed_rows[p]
                    tile_out_gather[packed_rows[p]] = i * bm + j
                    tile_row_slot[i * bm + j] = slot_start[p]
                    tile_row_nnz[i * bm + j] = len(row_cols[p])

        return SellCS(
            slot_cols=_to(slot_cols, device),
            slot_rows=_to(slot_rows, device),
            slot_vals=_to(slot_vals, device),
            out_gather=_to(out_gather, device),
            perm=_to(perm, device),
            tile_rows=_to(tile_rows, device),
            tile_cols=_to(tile_cols, device),
            tile_slot_map=_to(tile_slot_map, device),
            slot_tile_pos=_to(slot_tile_pos, device),
            tile_out_gather=_to(tile_out_gather, device),
            tile_row_slot=_to(tile_row_slot, device),
            tile_row_nnz=_to(tile_row_nnz, device),
            tile_heavy_rows=_to(np.nonzero(
                tile_row_nnz > SELL_HEAVY_ROW_NNZ)[0].astype(np.int32),
                device),
            shape=(m, n), c=c, sigma=sigma, buckets=tuple(buckets),
            block=(bm, bn), n_live_block_rows=n_live,
        )

    def to_dense(self) -> np.ndarray:
        """Host densification (scatter the slots; padding adds zeros)."""
        out = np.zeros(self.shape, self.slot_vals.cpu().numpy().dtype)
        np.add.at(out, (self.slot_rows.cpu().numpy(),
                        self.slot_cols.cpu().numpy()),
                  self.slot_vals.cpu().numpy())
        return out


# ---------------------------------------------------------------------------
# Paper-faithful SELLPACK-like stream accounting (the paper's Fig. 8)
# ---------------------------------------------------------------------------


def sellpack_stream_elements(
    csr: CSR, max_y_chunk: int, max_v_per_pe: int
) -> int:
    """Total (index,value)-pair count streamed in the paper's SELLPACK-like
    format.

    The host slices A into chunks of ``max_y_chunk`` rows.  Within a chunk,
    the nonzeros of each row are re-bucketed by worker-row column range
    (``max_v_per_pe`` wide).  Every bucket's stream carries one END_ROW
    marker per *run* of row terminations (run-length encoded: consecutive
    empty rows collapse into a single END_ROW pair), and all streams in a
    chunk are padded with NULLs to the chunk's longest stream.
    """
    m, n = csr.shape
    n_buckets = _cdiv(n, max_v_per_pe)
    total = 0
    for c0 in range(0, m, max_y_chunk):
        c1 = min(c0 + max_y_chunk, m)
        # per-bucket stream length for this chunk
        lengths = np.zeros(n_buckets, dtype=np.int64)
        # nonzero counts: bucket each row's column indices
        prev_emitted_end = np.zeros(n_buckets, dtype=bool)
        for r in range(c0, c1):
            lo, hi = csr.indptr[r], csr.indptr[r + 1]
            cols = csr.indices[lo:hi]
            counts = np.bincount(cols // max_v_per_pe, minlength=n_buckets)
            lengths += counts
            # END_ROW run-length coding: a bucket that receives nonzeros for
            # this row must emit an END_ROW afterwards; a bucket receiving
            # nothing extends the previous END_ROW run (no new element).
            has_data = counts > 0
            new_end = has_data | ~prev_emitted_end
            lengths += new_end.astype(np.int64)
            prev_emitted_end = np.ones(n_buckets, dtype=bool)
        total += int(lengths.max()) * n_buckets  # NULL-padded to equal length
    return total


def blockell_stream_elements(ell: BlockELL) -> int:
    """Elements (index or value words) resident in the Block-ELL layout —
    the blocked analog of the paper's streamed-element count."""
    return int(np.prod(ell.blocks.shape)) + int(np.prod(ell.indices.shape))

"""DeltaGraph: a mutable overlay applying edge deltas in place (the port
of ``repro.serve.runtime.delta``).

Serving workloads over evolving graphs (recommendation, streaming GNNs)
see a trickle of edge inserts/deletes between queries.  Rebuilding the
packed layout per delta is O(nnz) host work and, because ``MatrixStats``
ride the consumers' executor keys, a new "compile" of every consumer.
``DeltaGraph`` absorbs deltas by **patching slots in place**:

* **Slack slots**: the overlay reserves spare zero slots at pack time
  (a slack fraction of extra triplet rows for csr; ``width_slack``
  extra slots per row of every kept SELL slice).  An insert claims a
  free slot and writes the new coordinate/value into it.
* **Tombstones**: a delete zeroes its slot's value.  Every consuming
  path multiplies or masks by the stored value (the element routes; K2,
  K4, K6, K8 and their plain versions), so a tombstone contributes
  exactly 0: no compaction is needed until repack.
* **Sentinel remap (sell)**: the tile view mirrors each patch: an insert
  maps its tile cell to the claimed slot (``tile_slot_map`` /
  ``slot_tile_pos``), a delete resets cell and slot back to the layout's
  dead sentinels.  Slot count, tile count and all static fields stay the
  same, so the kernel route stays valid.
* **Row view (sell, the port's own)**: K2, K6, K4 and K8 read row r's
  nonzeros as slots ``tile_row_slot[r] .. + tile_row_nnz[r]``.  An insert
  claims the row's last free slack slot, past its original nonzeros, so
  every container recounts ``tile_row_nnz`` to reach each row's last live
  slot (the free slots between hold 0 and add nothing) and re-lists
  ``tile_heavy_rows``.

Between repacks the served matrix carries **capacity stats**
(:meth:`MatrixStats.with_capacity`, constant whatever the live edge
count), so a consumer's input signature never changes on a delta.  The
price is that the planner keeps pricing the overlay at capacity;
:attr:`exact_stats` (lazily recomputed, ``stats_invalidations`` counter)
exposes the live structure, and every **repack** re-stamps fresh
measured stats and a fresh plan memo.

Every container is built anew from the host arrays (new tensors on the
overlay's device), as the reference's is, so no memo keyed on a tensor of
an earlier container can hit.

A repack runs when slack is exhausted (an insert finds no free slot; for
sell also: target row pruned, or target tile absent), or in the
background via :meth:`maybe_repack_async` once free slots fall under a
low-water mark: the new packing is built from a snapshot on a worker
thread while the old overlay keeps serving, deltas landing meanwhile are
journaled, and the swap replays the journal onto the new packing.
"""
from __future__ import annotations

import threading
from dataclasses import replace
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.formats import SELL_HEAVY_ROW_NNZ, SellCS, _to
from repro_torch.device import device_scope, resolve_device
from repro_torch.dispatch.stats import MatrixStats
from repro_torch.resilience import chaos
from repro_torch.sparse.matrix import SparseMatrix

Delta = Tuple[str, int, int, float]  # ("insert"|"delete", row, col, value)


class _CsrOverlay:
    """Element-triplet storage with a global free-slot pool.

    The triplet layout is row-agnostic (any slot can hold any row's
    entry; the element route sums by the stored row id), so slack is
    pooled globally instead of per row.
    """

    form = "csr"

    def __init__(self, dense: np.ndarray, slack: float,
                 device: torch.device):
        r, c = np.nonzero(dense)
        nnz = len(r)
        cap = nnz + max(int(np.ceil(nnz * slack)), 16)
        self.device = device
        self.rows_h = np.zeros(cap, np.int32)
        self.cols_h = np.zeros(cap, np.int32)
        self.vals_h = np.zeros(cap, dense.dtype)
        self.rows_h[:nnz] = r
        self.cols_h[:nnz] = c
        self.vals_h[:nnz] = dense[r, c]
        self.free: List[int] = list(range(cap - 1, nnz - 1, -1))
        self.edge_map: Dict[Tuple[int, int], int] = dict(
            zip(zip(r.tolist(), c.tolist()), range(nnz)))
        self.shape = dense.shape

    @property
    def capacity(self) -> int:
        return len(self.vals_h)

    def free_slots(self) -> int:
        return len(self.free)

    def insert(self, r: int, c: int, v: float) -> bool:
        slot = self.edge_map.get((r, c))
        if slot is not None:
            self.vals_h[slot] = v
            return True
        if not self.free:
            return False
        slot = self.free.pop()
        self.rows_h[slot] = r
        self.cols_h[slot] = c
        self.vals_h[slot] = v
        self.edge_map[(r, c)] = slot
        return True

    def delete(self, r: int, c: int) -> None:
        slot = self.edge_map.pop((r, c))
        # tombstone: value 0 contributes nothing; park the coordinate at
        # (0, 0) so the pattern stays tidy
        self.vals_h[slot] = 0
        self.rows_h[slot] = 0
        self.cols_h[slot] = 0
        self.free.append(slot)

    def container(self):
        return (_to(self.rows_h, self.device), _to(self.cols_h, self.device),
                _to(self.vals_h, self.device))

    def live_coords(self):
        live = self.vals_h != 0
        return self.rows_h[live], self.cols_h[live]

    def densify(self) -> np.ndarray:
        out = np.zeros(self.shape, self.vals_h.dtype)
        np.add.at(out, (self.rows_h, self.cols_h), self.vals_h)
        return out


class _SellOverlay:
    """SELL-C-σ storage patched through its synchronized views (slots,
    tiles, and the port's row view).

    Slack is **per row**: ``width_slack`` extra slots per row of every
    kept slice (reserved by ``SellCS.from_dense``).  Inserts must land in
    an existing row span *and* an existing tile: a row in a pruned slice,
    an exhausted row span, or a cell in a tile the packing never
    materialized force a repack, because creating them would change array
    extents.
    """

    form = "sell"

    def __init__(self, dense: np.ndarray, width_slack: int, *,
                 c: int, sigma: int, block: Tuple[int, int],
                 device: torch.device):
        self.device = device
        self.sell0 = SellCS.from_dense(dense, c=c, sigma=sigma, block=block,
                                       width_slack=width_slack,
                                       device=device)
        s = self.sell0
        self.shape = dense.shape
        self.bm, self.bn = s.bm, s.bn
        self.n_slots = s.n_slots
        self.n_tiles = s.n_tiles
        self.slot_cols_h = s.slot_cols.cpu().numpy().copy()
        self.slot_vals_h = s.slot_vals.cpu().numpy().copy()
        self.tile_slot_map_h = s.tile_slot_map.cpu().numpy().copy()
        self.slot_tile_pos_h = s.slot_tile_pos.cpu().numpy().copy()

        # packed-row spans from the bucket descriptors (the slots lie in
        # packed-row order)
        self.slot_start: Dict[int, int] = {}
        self.row_width: Dict[int, int] = {}
        off = 0
        for row_off, n_rows, w in s.buckets:
            for i in range(n_rows):
                self.slot_start[row_off + i] = off + i * w
                self.row_width[row_off + i] = w
            off += n_rows * w
        n_packed = s.n_packed_rows
        starts = np.array([self.slot_start[p] for p in range(n_packed)],
                          np.int64)
        self.slot_packed = np.repeat(
            np.arange(n_packed),
            np.array([self.row_width[p] for p in range(n_packed)], np.int64))

        og = s.out_gather.cpu().numpy()
        self.out_gather_h = og
        real = np.nonzero(og < n_packed)[0]
        self.packed_to_orig = dict(zip(og[real].tolist(), real.tolist()))
        orig_of_packed = np.full(n_packed, -1, np.int64)
        orig_of_packed[og[real]] = real
        self.slot_orig = orig_of_packed[self.slot_packed]

        # tile index: (compact block-row, block-col) -> tile id, plus the
        # compact id of each *packed* block-row (from its live cells)
        tr = s.tile_rows.cpu().numpy()
        tc = s.tile_cols.cpu().numpy()
        self.tiles_index = dict(zip(zip(tr.tolist(), tc.tolist()),
                                    range(self.n_tiles)))
        cells = self.bm * self.bn
        placed = np.nonzero(self.slot_tile_pos_h < self.n_tiles * cells)[0]
        self.compact_of_pbr: Dict[int, int] = dict(zip(
            (self.slot_packed[placed] // self.bm).tolist(),
            tr[self.slot_tile_pos_h[placed] // cells].tolist()))

        # per-packed-row free slots (ascending) and the live edge map
        slots = np.arange(self.n_slots)
        real_slot = self.slot_orig >= 0
        live = real_slot & (self.slot_vals_h != 0)
        self.edge_map: Dict[Tuple[int, int], int] = dict(zip(
            zip(self.slot_orig[live].tolist(),
                self.slot_cols_h[live].tolist()),
            slots[live].tolist()))
        self.row_free: Dict[int, List[int]] = {p: [] for p in self.slot_start}
        free = slots[real_slot & (self.slot_vals_h == 0)]
        for p, slot in zip(self.slot_packed[free].tolist(), free.tolist()):
            self.row_free[p].append(slot)

        # the row view: each slot's compact row and offset within its row
        compact_of_packed = np.full(n_packed, -1, np.int64)
        for pbr, cr in self.compact_of_pbr.items():
            lo, hi = pbr * self.bm, min((pbr + 1) * self.bm, n_packed)
            compact_of_packed[lo:hi] = cr * self.bm + np.arange(hi - lo)
        self.slot_compact = compact_of_packed[self.slot_packed]
        self.slot_offset = slots - starts[self.slot_packed]
        self.n_compact_rows = s.n_live_block_rows * self.bm

    @property
    def capacity(self) -> int:
        return self.n_slots

    def free_slots(self) -> int:
        return sum(len(v) for v in self.row_free.values())

    def insert(self, r: int, c: int, v: float) -> bool:
        slot = self.edge_map.get((r, c))
        if slot is not None:
            self.slot_vals_h[slot] = v
            return True
        p = int(self.out_gather_h[r])
        if p not in self.slot_start:      # row lives in a pruned slice
            return False
        free = self.row_free[p]
        if not free:                      # row span exhausted
            return False
        t = self.tiles_index.get(
            (self.compact_of_pbr.get(p // self.bm, -1), c // self.bn))
        if t is None:                     # tile never materialized
            return False
        slot = free.pop()
        i, j = p % self.bm, c % self.bn
        self.slot_cols_h[slot] = c
        self.slot_vals_h[slot] = v
        self.tile_slot_map_h[t, i, j] = slot
        self.slot_tile_pos_h[slot] = (t * self.bm + i) * self.bn + j
        self.edge_map[(r, c)] = slot
        return True

    def delete(self, r: int, c: int) -> None:
        slot = self.edge_map.pop((r, c))
        self.slot_vals_h[slot] = 0
        pos = int(self.slot_tile_pos_h[slot])
        dead_cell = self.n_tiles * self.bm * self.bn
        if pos < dead_cell:
            t, ij = divmod(pos, self.bm * self.bn)
            self.tile_slot_map_h[t, ij // self.bn, ij % self.bn] \
                = self.n_slots
            self.slot_tile_pos_h[slot] = dead_cell
        self.row_free[int(self.slot_packed[slot])].append(slot)

    def row_view(self) -> Tuple[np.ndarray, np.ndarray]:
        """(``tile_row_nnz``, ``tile_heavy_rows``) of the current slots:
        each compact row reaches its last live slot."""
        live = (self.slot_vals_h != 0) & (self.slot_compact >= 0)
        nnz = np.zeros(self.n_compact_rows, np.int64)
        np.maximum.at(nnz, self.slot_compact[live],
                      self.slot_offset[live] + 1)
        return (nnz.astype(np.int32),
                np.nonzero(nnz > SELL_HEAVY_ROW_NNZ)[0].astype(np.int32))

    def container(self) -> SellCS:
        # the static fields and the unpatched arrays are reused; the
        # patched arrays are new tensors
        row_nnz, heavy = self.row_view()
        dev = self.device
        return replace(
            self.sell0,
            slot_cols=_to(self.slot_cols_h, dev),
            slot_vals=_to(self.slot_vals_h, dev),
            tile_slot_map=_to(self.tile_slot_map_h, dev),
            slot_tile_pos=_to(self.slot_tile_pos_h, dev),
            tile_row_nnz=_to(row_nnz, dev),
            tile_heavy_rows=_to(heavy, dev))

    def live_coords(self):
        live = np.nonzero(self.slot_vals_h)[0]
        return (self.slot_orig[live],
                self.slot_cols_h[live].astype(np.int64))

    def densify(self) -> np.ndarray:
        return self.container().to_dense()


class DeltaGraph:
    """Mutable sparse graph serving a retrace-stable ``SparseMatrix``.

    ``form`` picks the overlay layout: ``"csr"`` (element triplets,
    global slack pool — absorbs any churn pattern) or ``"sell"``
    (SELL-C-σ with per-row ``width_slack`` — keeps the kernel route live;
    inserts outside the packed structure repack).  ``matrix`` is a dense
    host array or a ``SparseMatrix``; the served matrix lives on
    ``device`` (the card by default).
    """

    def __init__(self, matrix, *, form: str = "csr",
                 slack: float = 0.25, width_slack: int = 2,
                 c: int = 16, sigma: int = 0,
                 block: Tuple[int, int] = (8, 8), device="cuda"):
        if form not in ("csr", "sell"):
            raise ValueError(
                f"DeltaGraph form must be 'csr' or 'sell', got {form!r}")
        self.form = form
        self.device = resolve_device(device)
        self.slack = float(slack)
        self.width_slack = int(width_slack)
        self._sell_cfg = dict(c=c, sigma=sigma, block=block)
        self.repacks = 0
        self.repack_failures = 0
        self.deltas_applied = 0
        self.stats_invalidations = 0
        self._lock = threading.RLock()
        self._bg: Optional[threading.Thread] = None
        self._journal: Optional[List[Delta]] = None
        self._pending_swap = None
        dense = self._to_dense(matrix)
        self._pack(dense)

    @staticmethod
    def _to_dense(matrix) -> np.ndarray:
        if isinstance(matrix, SparseMatrix):
            return matrix.to_dense()
        return np.asarray(matrix)

    # -- packing ------------------------------------------------------------

    def _make_overlay(self, dense: np.ndarray):
        if self.form == "csr":
            return _CsrOverlay(dense, self.slack, self.device)
        return _SellOverlay(dense, self.width_slack, device=self.device,
                            **self._sell_cfg)

    def _pack(self, dense: np.ndarray) -> None:
        """(Re)build the overlay and stamp fresh capacity stats."""
        self._overlay = self._make_overlay(dense)
        r, c = np.nonzero(dense)
        measured = MatrixStats.from_coords(dense.shape, r, c)
        # constant between repacks: consumers' signatures include it
        self._cap_stats = measured.with_capacity(self._overlay.capacity)
        self._exact: Optional[MatrixStats] = measured
        self._matrix: Optional[SparseMatrix] = None

    def repack(self) -> None:
        """Rebuild the packing around the live edges (fresh slack, fresh
        measured stats, fresh plan memo — consumers retrace once)."""
        with self._lock:
            self._pack(self._overlay.densify())
            self.repacks += 1
            obs.counter("graph_repacks_total", kind="forced").inc()

    # -- delta application --------------------------------------------------

    def insert(self, r: int, c: int, v: float) -> None:
        """Insert (or update) edge (r, c) with value ``v``."""
        if v == 0:
            raise ValueError(
                "insert with value 0 is a delete (0 marks tombstones)")
        with self._lock:
            if not self._overlay.insert(int(r), int(c), float(v)):
                # repack *around* the new edge: a plain repack may not
                # materialize the row/tile this insert needs (sell packs
                # only non-empty structure), so bake it into the snapshot
                dense = self._overlay.densify()
                dense[int(r), int(c)] = v
                self._pack(dense)
                self.repacks += 1
                obs.counter("graph_repacks_total", kind="slack").inc()
            self._note_delta(("insert", int(r), int(c), float(v)))

    def delete(self, r: int, c: int) -> None:
        """Delete edge (r, c) (KeyError when absent)."""
        with self._lock:
            self._overlay.delete(int(r), int(c))
            self._note_delta(("delete", int(r), int(c), 0.0))

    def apply(self, deltas: Iterable[Delta]) -> None:
        """Apply a batch of ("insert"|"delete", r, c, v) deltas."""
        for op, r, c, v in deltas:
            if op == "insert":
                self.insert(r, c, v)
            elif op == "delete":
                self.delete(r, c)
            else:
                raise ValueError(f"unknown delta op {op!r}")

    def _note_delta(self, d: Delta) -> None:
        self.deltas_applied += 1
        obs.counter("graph_deltas_total", op=d[0]).inc()
        self._matrix = None
        if self._exact is not None:
            self._exact = None               # lazily recomputed
            self.stats_invalidations += 1
        if self._journal is not None:
            self._journal.append(d)

    # -- served views -------------------------------------------------------

    @property
    def matrix(self) -> SparseMatrix:
        """The served matrix.  Carries **capacity stats**, identical
        between repacks, so a consumer's input signature never changes on
        a delta."""
        with self._lock:
            if self._matrix is None:
                self._matrix = SparseMatrix(
                    {self.form: self._overlay.container()},
                    self._overlay.shape, self._cap_stats)
            return self._matrix

    @property
    def exact_stats(self) -> MatrixStats:
        """Live-edge stats (recomputed on demand after deltas).  The
        planner prices :attr:`matrix` from capacity stats; this is the
        true structure — compare the two to decide when a repack (and its
        re-pricing) is worth taking early."""
        with self._lock:
            if self._exact is None:
                r, c = self._overlay.live_coords()
                self._exact = MatrixStats.from_coords(
                    self._overlay.shape, r, c)
            return self._exact

    @property
    def live_nnz(self) -> int:
        with self._lock:
            return len(self._overlay.edge_map)

    @property
    def capacity(self) -> int:
        return self._overlay.capacity

    def free_slots(self) -> int:
        with self._lock:
            return self._overlay.free_slots()

    # -- background repack --------------------------------------------------

    def maybe_repack_async(self, low_water: float = 0.1) -> bool:
        """Kick off a background repack when free slots fall under
        ``low_water`` (fraction of capacity).  The rebuild runs from a
        snapshot while this overlay keeps serving; call
        :meth:`poll_repack` (or any delta/next call to this) to swap
        the finished packing in.  Returns True when a rebuild started.
        """
        self.poll_repack()
        with self._lock:
            if self._bg is not None:
                return False
            if self.free_slots() > low_water * max(self.capacity, 1):
                return False
            snapshot = self._overlay.densify()
            self._journal = []

            def build():
                try:
                    chaos.hook("delta.repack")
                    with device_scope(self.device):
                        self._pending_swap = self._make_overlay(snapshot)
                except Exception:  # noqa: BLE001 — crash-safe swap: a
                    # failed build publishes nothing; the live overlay
                    # never stopped serving (poll_repack sees swap=None)
                    self.repack_failures += 1
                    obs.counter("graph_repack_failures_total").inc()

            self._bg = threading.Thread(target=build, daemon=True)
            self._bg.start()
            return True

    def poll_repack(self, timeout: Optional[float] = None) -> bool:
        """Swap in a finished background repack (True when swapped)."""
        with self._lock:
            if self._bg is None:
                return False
            self._bg.join(timeout=0.0 if timeout is None else timeout)
            if self._bg.is_alive():
                return False
            self._bg = None
            new = self._pending_swap
            journal, self._journal = self._journal, None
            self._pending_swap = None
            if new is None:
                # the build crashed: nothing was published, the old
                # overlay kept serving throughout — recovery is "do
                # nothing", which is the point of the swap protocol
                obs.counter("resilience_recoveries_total",
                            site="delta.repack").inc()
                return False
            old = self._overlay
            self._overlay = new
            dense = None
            for op, r, c, v in journal:
                ok = (self._overlay.insert(r, c, v) if op == "insert"
                      else (self._overlay.delete(r, c), True)[1])
                if not ok:
                    # replay overflowed the fresh slack: fall back to a
                    # synchronous rebuild from the journaled state
                    dense = old.densify()
                    break
            if dense is not None:
                self._overlay = old
                self._pack(dense)
            else:
                r2, c2 = self._overlay.live_coords()
                measured = MatrixStats.from_coords(
                    self._overlay.shape, r2, c2)
                self._cap_stats = measured.with_capacity(
                    self._overlay.capacity)
                self._exact = measured
                self._matrix = None
            self.repacks += 1
            obs.counter("graph_repacks_total", kind="background").inc()
            return True

    # -- reporting ----------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "form": self.form,
                "live_nnz": self.live_nnz,
                "capacity": self.capacity,
                "free_slots": self.free_slots(),
                "deltas_applied": self.deltas_applied,
                "repacks": self.repacks,
                "repack_failures": self.repack_failures,
                "stats_invalidations": self.stats_invalidations,
                "background_repack_running": self._bg is not None,
            }

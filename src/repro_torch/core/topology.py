"""Load balancing & format-parameter selection (a copy of
``repro.core.topology``: numpy on the host, no JAX).

The paper (§2.4) identifies load balancing across PEs as a first-order
concern: uneven nonzero distribution inflates SELLPACK padding (their Fig. 8
footprint blowup) and idles workers.  The TPU analog is ELL-width padding:
one pathologically dense block-row forces W up for every row.  The standard
SELL fix — sort rows by nonzero count so each slice is uniform — is applied
here as a *block-row permutation*, plus helpers to pick W from an occupancy
target instead of the worst row.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import CSR, _cdiv


def block_row_counts(dense: np.ndarray, bm: int, bn: int) -> np.ndarray:
    """Number of nonzero (bm x bn) blocks in each block-row."""
    m, n = dense.shape
    nbr, nbc = _cdiv(m, bm), _cdiv(n, bn)
    pad = np.zeros((nbr * bm, nbc * bn), dtype=bool)
    pad[:m, :n] = dense != 0
    tiles = pad.reshape(nbr, bm, nbc, bn).transpose(0, 2, 1, 3)
    return tiles.reshape(nbr, nbc, -1).any(-1).sum(-1).astype(np.int64)


def balance_permutation(counts: np.ndarray) -> np.ndarray:
    """Permutation sorting (block-)rows by descending nonzero count.

    Mirrors Sliced-ELLPACK row sorting: after permuting, rows with similar
    work are adjacent, so chunked/sliced processing sees uniform streams.
    Returns ``perm`` such that ``dense[perm]`` is balanced.
    """
    return np.argsort(-counts, kind="stable")


def snake_permutation(counts: np.ndarray, n_parts: int) -> np.ndarray:
    """Snake (boustrophedon) assignment of rows to ``n_parts`` partitions.

    Used by the distributed 1.5D path so every mesh shard receives
    approximately equal nonzero work — the cross-chip version of the
    paper's router column-range balancing.
    """
    order = np.argsort(-counts, kind="stable")
    n = len(counts)
    rows_per = _cdiv(n, n_parts)
    slots = np.empty(n, dtype=np.int64)
    part_fill = np.zeros(n_parts, dtype=np.int64)
    loads = np.zeros(n_parts, dtype=np.int64)
    for r in order:
        p = int(np.argmin(loads + (part_fill >= rows_per) * 10**15))
        slots[r] = p * rows_per + part_fill[p]
        part_fill[p] += 1
        loads[p] += counts[r]
    perm = np.empty(n, dtype=np.int64)
    perm[slots] = np.arange(n)
    # perm maps new position -> old row, as expected by dense[perm]
    out = np.empty(n, dtype=np.int64)
    for new_pos, old in enumerate(perm):
        out[new_pos] = old
    return out


def choose_ell_width(
    counts: np.ndarray, occupancy_target: float = 0.0
) -> int:
    """Pick ELL width W.

    occupancy_target=0 reproduces the paper's behaviour (pad to the worst
    row).  A target in (0, 1] picks the smallest W such that
    kept_blocks / (n_rows * W) >= target, i.e. trades a bounded amount of
    dropped (explicitly handled out-of-band) work for padding reduction —
    exposed for experimentation, not used by default.
    """
    w_max = int(counts.max()) if len(counts) else 1
    if occupancy_target <= 0:
        return max(w_max, 1)
    total = counts.sum()
    for w in range(1, w_max + 1):
        kept = np.minimum(counts, w).sum()
        if kept / max(total, 1) >= occupancy_target:
            return w
    return max(w_max, 1)


def padding_stats(counts: np.ndarray, w: int | None = None) -> dict:
    w = w or int(counts.max())
    total_slots = len(counts) * w
    real = int(np.minimum(counts, w).sum())
    return {
        "ell_width": w,
        "occupancy": real / max(total_slots, 1),
        "padding_ratio": total_slots / max(real, 1),
        "max_count": int(counts.max()) if len(counts) else 0,
        "mean_count": float(counts.mean()) if len(counts) else 0.0,
    }


def csr_row_counts(csr: CSR) -> np.ndarray:
    return np.diff(csr.indptr).astype(np.int64)

"""Host-side matrix statistics that drive dispatch decisions (the port of
``repro.dispatch.stats``; plain Python numbers, computed with numpy).

The central quantity is the padded-stream blow-up: the ratio of elements
the blocked layout streams (real + padding) to the true nonzero count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.formats import _cdiv, sell_slot_volume


def _structure_features(shape: Tuple[int, int], rows: np.ndarray,
                        cols: np.ndarray, row_nnz: np.ndarray
                        ) -> Dict[str, float]:
    """Row-skew and band-locality features from element coordinates.

    ``bandwidth_frac`` is the 95th percentile of the normalized diagonal
    distance |i/(m-1) - j/(n-1)|.  All features are 0 for an empty matrix.
    """
    if len(rows) == 0:
        return {"row_nnz_mean": 0.0, "row_nnz_cv": 0.0, "max_row_nnz": 0,
                "bandwidth_frac": 0.0}
    m, n = shape
    mean = float(row_nnz.mean())
    cv = float(row_nnz.std() / mean) if mean > 0 else 0.0
    r_norm = rows.astype(np.float64) / max(m - 1, 1)
    c_norm = cols.astype(np.float64) / max(n - 1, 1)
    band = float(np.percentile(np.abs(r_norm - c_norm), 95))
    return {"row_nnz_mean": mean, "row_nnz_cv": cv,
            "max_row_nnz": int(row_nnz.max()), "bandwidth_frac": band}


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    """Sparsity-structure summary of one sparse operand."""

    shape: Tuple[int, int]        # logical (padded) dense shape
    nnz: int                      # element-level nonzeros
    stored_elements: int          # elements the blocked layout streams
    block_m: int
    block_n: int
    n_block_rows: int
    ell_width: int                # ELL width W (0 for COO layouts)
    occupancy: float              # real blocks / stored slots (1 = no pad)
    # slots the SELL-C-σ packing would stream at the default (C, σ);
    # 0 = not measured (sell path unpriceable)
    sell_stored_elements: int = 0
    row_nnz_mean: float = 0.0     # nnz per logical row
    row_nnz_cv: float = 0.0       # row-nnz coefficient of variation
    max_row_nnz: int = 0          # heaviest row (hub detection)
    bandwidth_frac: float = 0.0   # p95 normalized diagonal distance

    @property
    def dense_elements(self) -> int:
        return int(self.shape[0]) * int(self.shape[1])

    @property
    def density(self) -> float:
        return self.nnz / max(self.dense_elements, 1)

    @property
    def sparsity(self) -> float:
        return 1.0 - self.density

    @property
    def padded_stream_blowup(self) -> float:
        """Streamed elements per true nonzero (>= 1; inf for empty A)."""
        if self.nnz == 0:
            return float("inf")
        return self.stored_elements / self.nnz

    @property
    def ell_stream_estimate(self) -> int:
        """Elements the ELL path must move, floored by row structure: every
        row streams at least the heaviest row's slot count."""
        if self.max_row_nnz <= 0:
            return self.stored_elements
        m_pad = self.n_block_rows * max(self.block_m, 1)
        return max(self.stored_elements, m_pad * self.max_row_nnz)

    @staticmethod
    def from_coords(shape: Tuple[int, int], rows: np.ndarray,
                    cols: np.ndarray, block_m: int = 1, block_n: int = 1,
                    nnz: Optional[int] = None) -> "MatrixStats":
        """Blocked-layout stats from element coordinates (no blocks built)."""
        m, n = int(shape[0]), int(shape[1])
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        cols = np.asarray(cols, dtype=np.int64).reshape(-1)
        if nnz is None:
            nnz = len(rows)
        bm, bn = int(block_m), int(block_n)
        nbr, nbc = _cdiv(m, bm), _cdiv(n, bn)
        bids = (rows // bm) * nbc + cols // bn
        ub = np.unique(bids)
        counts = np.bincount((ub // nbc).astype(np.int64), minlength=nbr)
        width = max(int(counts.max()) if len(counts) else 0, 1)
        row_nnz = np.bincount(rows, minlength=m)
        return MatrixStats(
            shape=(nbr * bm, nbc * bn),
            nnz=int(nnz),
            stored_elements=int(nbr * width * bm * bn),
            block_m=bm,
            block_n=bn,
            n_block_rows=nbr,
            ell_width=width,
            occupancy=len(ub) / max(nbr * width, 1),
            sell_stored_elements=sell_slot_volume(row_nnz),
            **_structure_features((m, n), rows, cols, row_nnz),
        )


def sparsity_bucket(density: float, per_decade: int = 2) -> int:
    """Discretize density into log10 buckets for autotune cache keys.

    ``per_decade`` buckets per density decade: densities within the same
    bucket share one autotune measurement.  Density 0 maps to the last
    bucket (hyper-sparse).
    """
    if density <= 0:
        return 9 * per_decade
    return int(np.clip(np.floor(-np.log10(density) * per_decade),
                       0, 9 * per_decade))

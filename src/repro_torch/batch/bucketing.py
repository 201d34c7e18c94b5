"""Shape bucketing: quantize variably-shaped graphs onto a compile grid
(the port of ``repro.batch.bucketing``).

Each dimension of a request (node rows, nnz, ELL width) is quantized up
onto a geometric grid (``growth`` per step, floored at the block size);
the graph is padded into its bucket and its measured ``MatrixStats`` are
replaced by the bucket's canonical stats, a function of the bucket alone.
Every request of a bucket then presents the same executor key and the
same plan, so traffic makes O(#buckets) executors, not O(#requests).

:class:`PaddingWaste` accounts the streamed-but-dead volume that bucket
and batch-fill padding cost.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.batch.block_diag import pad_ell_width
from repro_torch.core.formats import BlockELL, _cdiv
from repro_torch.device import resolve_device
from repro_torch.dispatch.stats import MatrixStats
from repro_torch.sparse.matrix import SparseMatrix


@dataclasses.dataclass(frozen=True)
class BucketingConfig:
    """Geometry of the fixed geometric bucket grid (the zero-warm-up
    default; ``repro_torch.serve.runtime.AdaptiveBucketLadder`` fits a
    grid to the traffic instead)."""

    growth: float = 2.0        # geometric step between node-count buckets
    nnz_growth: float = 4.0    # coarser grid for nnz (correlates with n)
    min_rows: int = 32         # floor of the node grid
    min_nnz: int = 64          # floor of the nnz grid
    min_width: int = 1         # floor of the ELL-width grid


DEFAULT_BUCKETING = BucketingConfig()


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One cell of the compile grid (hashable; part of executor keys)."""

    rows: int       # padded node rows (multiple of block_m)
    cols: int       # padded node cols (multiple of block_n)
    nnz: int        # padded element count (csr form)
    width: int      # padded ELL width (ell form)
    block_m: int
    block_n: int

    @property
    def n_block_rows(self) -> int:
        return self.rows // self.block_m

    @property
    def label(self) -> str:
        """Stable human-readable key for per-bucket reporting."""
        return (f"r{self.rows}xc{self.cols}/nnz{self.nnz}/w{self.width}"
                f"/b{self.block_m}x{self.block_n}")


def quantize_up(x: int, base: int, growth: float) -> int:
    """Smallest grid point ``base * growth^k`` (k >= 0) at or above x."""
    if growth <= 1.0:
        raise ValueError(
            f"bucket growth must be > 1 (got {growth}); a growth of 1 "
            "would bucket per exact shape and compile per request")
    x = max(int(x), 1)
    base = max(int(base), 1)
    if x <= base:
        return base
    k = int(np.ceil(np.log(x / base) / np.log(growth)))
    q = int(round(base * growth ** k))
    while q < x:  # guard float rounding at the boundary
        q = int(round(q * growth))
    return q


def _round_to(x: int, mult: int) -> int:
    return _cdiv(max(int(x), 1), mult) * mult


def bucket_for(stats: MatrixStats,
               config: BucketingConfig = DEFAULT_BUCKETING) -> Bucket:
    """The bucket a matrix with these measured stats pads into."""
    bm, bn = stats.block_m, stats.block_n
    return Bucket(
        rows=_round_to(quantize_up(stats.shape[0], config.min_rows,
                                   config.growth), bm),
        cols=_round_to(quantize_up(stats.shape[1], config.min_rows,
                                   config.growth), bn),
        nnz=quantize_up(stats.nnz, config.min_nnz, config.nnz_growth),
        width=quantize_up(max(stats.ell_width, 1), config.min_width,
                          config.growth),
        block_m=bm, block_n=bn)


def canonical_stats(bucket: Bucket) -> MatrixStats:
    """Deterministic stats of a bucket, the same for every request it
    serves, so a bucket's plan and executor key never change."""
    nbr = bucket.n_block_rows
    slots = nbr * bucket.width
    # expected fraction of slots holding a real block if the bucket's nnz
    # were spread one per block (an upper bound on real occupancy)
    occ = min(1.0, bucket.nnz / max(slots, 1))
    return MatrixStats(
        shape=(bucket.rows, bucket.cols),
        nnz=bucket.nnz,
        stored_elements=slots * bucket.block_m * bucket.block_n,
        block_m=bucket.block_m,
        block_n=bucket.block_n,
        n_block_rows=nbr,
        ell_width=bucket.width,
        occupancy=occ,
    )


# ---------------------------------------------------------------------------
# Padding a matrix into its bucket
# ---------------------------------------------------------------------------


def _pad_csr_form(form, bucket: Bucket):
    r, c, v = form
    pad = bucket.nnz - r.shape[0]
    if pad < 0:
        raise ValueError(
            f"matrix has nnz={r.shape[0]} > bucket nnz={bucket.nnz}")
    if pad == 0:
        return form
    # dead entries at (0, 0) with value 0: they add exactly zero to any
    # product and their gradients are masked as structural zeros
    z = r.new_zeros((pad,))
    return torch.cat([r, z]), torch.cat([c, z]), torch.cat(
        [v, v.new_zeros((pad,))])


def _pad_ell_form(ell: BlockELL, bucket: Bucket) -> BlockELL:
    if (ell.bm, ell.bn) != (bucket.block_m, bucket.block_n):
        raise ValueError(
            f"matrix block {(ell.bm, ell.bn)} != bucket block "
            f"{(bucket.block_m, bucket.block_n)}")
    nbr, w = ell.indices.shape
    if nbr > bucket.n_block_rows or w > bucket.width:
        raise ValueError(
            f"matrix ELL geometry ({nbr} rows, width {w}) exceeds bucket "
            f"({bucket.n_block_rows} rows, width {bucket.width})")
    idx, blk = pad_ell_width(ell.indices, ell.blocks, bucket.width)
    nbl = ell.nblocks
    if nbr < bucket.n_block_rows:
        pad = bucket.n_block_rows - nbr
        idx = torch.cat([idx, idx.new_zeros((pad, bucket.width))])
        blk = torch.cat([blk, blk.new_zeros((pad,) + blk.shape[1:])])
        nbl = torch.cat([nbl, nbl.new_zeros((pad,))])
    return BlockELL(indices=idx, blocks=blk, nblocks=nbl,
                    shape=(bucket.rows, bucket.cols))


def pad_to_bucket(a: SparseMatrix, bucket: Bucket, *,
                  form: Optional[str] = None) -> SparseMatrix:
    """Pad one matrix into its bucket (on its device) and stamp the
    canonical stats: the result's shape, nnz, ELL geometry and stats
    depend only on ``bucket``."""
    form = form or a.format
    if form == "csr":
        padded = {"csr": _pad_csr_form(a.form("csr"), bucket)}
    elif form == "ell":
        padded = {"ell": _pad_ell_form(a.form("ell"), bucket)}
    else:
        raise ValueError(
            f"cannot bucket-pad form {form!r}; supported: ('ell', 'csr')")
    return SparseMatrix(padded, (bucket.rows, bucket.cols),
                        canonical_stats(bucket))


def empty_in_bucket(bucket: Bucket, *, form: str,
                    dtype: torch.dtype = torch.float32,
                    device="cuda") -> SparseMatrix:
    """An all-zero matrix padded into the bucket (batch-fill dummy)."""
    dev = resolve_device(device)
    if form == "csr":
        z = torch.zeros((bucket.nnz,), dtype=torch.int32, device=dev)
        padded = {"csr": (z, z, torch.zeros((bucket.nnz,), dtype=dtype,
                                            device=dev))}
    elif form == "ell":
        nbr = bucket.n_block_rows
        padded = {"ell": BlockELL(
            indices=torch.zeros((nbr, bucket.width), dtype=torch.int32,
                                device=dev),
            blocks=torch.zeros((nbr, bucket.width, bucket.block_m,
                                bucket.block_n), dtype=dtype, device=dev),
            nblocks=torch.zeros((nbr,), dtype=torch.int32, device=dev),
            shape=(bucket.rows, bucket.cols))}
    else:
        raise ValueError(f"cannot build an empty {form!r} bucket matrix")
    return SparseMatrix(padded, (bucket.rows, bucket.cols),
                        canonical_stats(bucket))


# ---------------------------------------------------------------------------
# Padding-waste accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PaddingWaste:
    """Streamed-but-dead volume from bucket + batch-fill padding, in
    aggregate and per bucket (keyed by :attr:`Bucket.label`) when ``add``
    is tagged with the bucket served."""

    real_rows: int = 0
    padded_rows: int = 0
    real_nnz: int = 0
    padded_nnz: int = 0
    per_bucket: Dict[str, "PaddingWaste"] = dataclasses.field(
        default_factory=dict)

    def add(self, *, real_rows: int, padded_rows: int, real_nnz: int,
            padded_nnz: int,
            bucket: Optional[Union[Bucket, str]] = None) -> None:
        self.real_rows += int(real_rows)
        self.padded_rows += int(padded_rows)
        self.real_nnz += int(real_nnz)
        self.padded_nnz += int(padded_nnz)
        # every ledger also streams into the process-wide obs counters
        obs.counter("padding_rows_real_total").inc(int(real_rows))
        obs.counter("padding_rows_padded_total").inc(int(padded_rows))
        obs.counter("padding_nnz_real_total").inc(int(real_nnz))
        obs.counter("padding_nnz_padded_total").inc(int(padded_nnz))
        if bucket is not None:
            key = bucket if isinstance(bucket, str) else bucket.label
            sub = self.per_bucket.get(key)
            if sub is None:
                sub = self.per_bucket[key] = PaddingWaste()
            # direct field bumps: a sub-ledger must not stream the volume
            # into the obs counters a second time
            sub.real_rows += int(real_rows)
            sub.padded_rows += int(padded_rows)
            sub.real_nnz += int(real_nnz)
            sub.padded_nnz += int(padded_nnz)

    @property
    def row_blowup(self) -> float:
        return self.padded_rows / max(self.real_rows, 1)

    @property
    def nnz_blowup(self) -> float:
        return self.padded_nnz / max(self.real_nnz, 1)

    @property
    def waste_fraction(self) -> float:
        """Fraction of streamed elements that are padding."""
        if self.padded_nnz == 0:
            return 0.0
        return 1.0 - self.real_nnz / self.padded_nnz

    def as_dict(self, *, per_bucket: bool = True) -> dict:
        out = {
            "real_rows": self.real_rows,
            "padded_rows": self.padded_rows,
            "real_nnz": self.real_nnz,
            "padded_nnz": self.padded_nnz,
            "row_blowup": round(self.row_blowup, 4),
            "nnz_blowup": round(self.nnz_blowup, 4),
            "waste_fraction": round(self.waste_fraction, 4),
        }
        if per_bucket and self.per_bucket:
            out["per_bucket"] = {
                k: self.per_bucket[k].as_dict(per_bucket=False)
                for k in sorted(self.per_bucket)
            }
        return out

"""Synthetic DLMC-style matrix corpus (the port's copy of
``repro.corpus.generators``: numpy only, the same draws for the same
seed).

Uniform-random sparsity is the one structure the paper's target
workloads (GNNs, recommenders, pruned transformers) do *not* have.
This module generates the missing structures behind one
``CorpusSpec -> dense / SparseMatrix`` factory:

  * ``uniform``       — iid Bernoulli mask (the legacy baseline);
  * ``powerlaw``      — Zipf row degrees (hub-heavy graph adjacency,
                        the structure that breaks global-width ELL);
  * ``rmat``          — R-MAT recursive quadrant sampling (skewed AND
                        community-clustered, à la Graph500);
  * ``banded``        — nonzeros confined to a diagonal band, with a
                        diagonal-dominant guarantee (stencils, tridiag
                        systems, tracking graphs);
  * ``block_pruned``  — dense blocks surviving structured magnitude
                        pruning (DLMC transformer-weight patterns).

Generators are deterministic under ``spec.seed`` and hit the requested
global sparsity exactly (up to family-capacity clamps, e.g. a band can
hold only so many nonzeros).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

FAMILIES = ("uniform", "powerlaw", "rmat", "banded", "block_pruned")


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    """One corpus matrix: a family plus its structural knobs."""

    family: str
    shape: Tuple[int, int] = (256, 256)
    sparsity: float = 0.9
    seed: int = 0
    # powerlaw: Zipf exponent of the row-degree distribution (larger =
    # more hub-concentrated)
    alpha: float = 1.2
    # banded: half-bandwidth (nonzeros satisfy |i - j| <= band_width)
    band_width: int = 16
    # block_pruned: granule of the structured pruning mask
    block: Tuple[int, int] = (8, 8)
    # rmat: quadrant probabilities (a, b, c, d), Graph500 defaults
    rmat_probs: Tuple[float, float, float, float] = (0.57, 0.19, 0.19, 0.05)

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(
                f"unknown corpus family {self.family!r}; "
                f"expected one of {FAMILIES}")
        if not 0.0 <= self.sparsity <= 1.0:
            raise ValueError(f"sparsity must be in [0, 1], "
                             f"got {self.sparsity}")

    @property
    def name(self) -> str:
        m, n = self.shape
        return f"{self.family}_{m}x{n}_s{self.sparsity:g}_seed{self.seed}"

    @property
    def target_nnz(self) -> int:
        m, n = self.shape
        return int(round(m * n * (1.0 - self.sparsity)))


def _values(rng: np.random.Generator, k: int) -> np.ndarray:
    v = rng.standard_normal(k).astype(np.float32)
    return np.where(v == 0, np.float32(1.0), v)


def _fill(shape, rows, cols, vals) -> np.ndarray:
    a = np.zeros(shape, np.float32)
    a[rows, cols] = vals
    return a


def _uniform(spec: CorpusSpec, rng: np.random.Generator) -> np.ndarray:
    m, n = spec.shape
    idx = rng.choice(m * n, size=min(spec.target_nnz, m * n), replace=False)
    return _fill(spec.shape, idx // n, idx % n, _values(rng, len(idx)))


def _zipf_row_counts(spec: CorpusSpec, rng: np.random.Generator
                     ) -> np.ndarray:
    """Per-row nnz targets: Zipf weights, exact total, capped at n."""
    m, n = spec.shape
    k = min(spec.target_nnz, m * n)
    w = (np.arange(m, dtype=np.float64) + 1.0) ** (-spec.alpha)
    rng.shuffle(w)  # hubs land on random rows, not row 0..h
    raw = k * w / w.sum()
    counts = np.floor(raw).astype(np.int64)
    # distribute the rounding deficit to the largest remainders, then
    # push any per-row overflow (count > n) down the weight order
    deficit = k - int(counts.sum())
    if deficit > 0:
        order = np.argsort(-(raw - counts), kind="stable")
        counts[order[:deficit]] += 1
    counts = np.minimum(counts, n)
    overflow = k - int(counts.sum())
    while overflow > 0:
        room = np.flatnonzero(counts < n)
        if len(room) == 0:
            break
        take = room[np.argsort(-w[room], kind="stable")][:overflow]
        counts[take] += 1
        overflow = k - int(counts.sum())
    return counts


def _powerlaw(spec: CorpusSpec, rng: np.random.Generator) -> np.ndarray:
    m, n = spec.shape
    counts = _zipf_row_counts(spec, rng)
    rows = np.repeat(np.arange(m, dtype=np.int64), counts)
    cols = np.concatenate([
        rng.choice(n, size=c, replace=False) for c in counts if c
    ]) if counts.sum() else np.zeros(0, np.int64)
    return _fill(spec.shape, rows, cols, _values(rng, len(rows)))


def _rmat(spec: CorpusSpec, rng: np.random.Generator) -> np.ndarray:
    m, n = spec.shape
    k = min(spec.target_nnz, m * n)
    bits_r = max(int(np.ceil(np.log2(max(m, 1)))), 1)
    bits_c = max(int(np.ceil(np.log2(max(n, 1)))), 1)
    bits = max(bits_r, bits_c)
    a, b, c, _ = spec.rmat_probs
    seen: set = set()
    rows, cols = [], []
    # oversample per round; duplicates and out-of-range coords are
    # rejected, so a few rounds converge on the target count
    for _round in range(64):
        need = k - len(rows)
        if need <= 0:
            break
        draw = max(2 * need, 64)
        u = rng.random((draw, bits))
        i = np.zeros(draw, np.int64)
        j = np.zeros(draw, np.int64)
        for lvl in range(bits):
            ul = u[:, lvl]
            right = ((ul >= a) & (ul < a + b)) | (ul >= a + b + c)
            down = ul >= a + b
            i = (i << 1) | down.astype(np.int64)
            j = (j << 1) | right.astype(np.int64)
        ok = (i < m) & (j < n)
        for ii, jj in zip(i[ok], j[ok]):
            key = (int(ii), int(jj))
            if key not in seen:
                seen.add(key)
                rows.append(ii)
                cols.append(jj)
                if len(rows) >= k:
                    break
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    return _fill(spec.shape, rows, cols, _values(rng, len(rows)))


def _banded(spec: CorpusSpec, rng: np.random.Generator) -> np.ndarray:
    m, n = spec.shape
    bw = max(int(spec.band_width), 0)
    i = np.repeat(np.arange(m, dtype=np.int64), 2 * bw + 1)
    j = i + np.tile(np.arange(-bw, bw + 1, dtype=np.int64), m)
    ok = (j >= 0) & (j < n)
    band_i, band_j = i[ok], j[ok]
    k = min(spec.target_nnz, len(band_i))  # band capacity clamp
    diag = band_i == band_j
    diag_idx = np.flatnonzero(diag)
    off_idx = np.flatnonzero(~diag)
    # diagonal first (diagonal dominance), then random in-band fill
    take_diag = diag_idx[:k]
    rest = k - len(take_diag)
    take_off = rng.choice(off_idx, size=rest, replace=False) if rest else \
        np.zeros(0, np.int64)
    sel = np.concatenate([take_diag, take_off])
    vals = _values(rng, len(sel))
    # make the kept diagonal entries dominate their row sums
    vals[: len(take_diag)] = np.abs(vals[: len(take_diag)]) + 2.0 * bw
    return _fill(spec.shape, band_i[sel], band_j[sel], vals)


def _block_pruned(spec: CorpusSpec, rng: np.random.Generator) -> np.ndarray:
    m, n = spec.shape
    bm, bn = spec.block
    if m % bm or n % bn:
        raise ValueError(
            f"block_pruned needs shape divisible by block, got "
            f"{spec.shape} / {spec.block}")
    gm, gn = m // bm, n // bn
    kb = int(round(min(spec.target_nnz, m * n) / (bm * bn)))
    kb = min(kb, gm * gn)
    keep = rng.choice(gm * gn, size=kb, replace=False)
    tiles = np.zeros((gm, gn, bm, bn), np.float32)
    tiles[keep // gn, keep % gn] = _values(rng, kb * bm * bn) \
        .reshape(kb, bm, bn)
    return tiles.transpose(0, 2, 1, 3).reshape(m, n)


_GENERATORS = {
    "uniform": _uniform,
    "powerlaw": _powerlaw,
    "rmat": _rmat,
    "banded": _banded,
    "block_pruned": _block_pruned,
}


def make_dense(spec: CorpusSpec) -> np.ndarray:
    """Concrete dense [M, N] float32 realization of one spec."""
    rng = np.random.default_rng(spec.seed)
    return _GENERATORS[spec.family](spec, rng)


def make_matrix(spec: CorpusSpec, *,
                formats: Optional[Tuple[str, ...]] = ("ell", "sell", "csr"),
                format: str = "auto",
                block: Tuple[int, int] = (64, 64), device="cuda"):
    """``CorpusSpec -> SparseMatrix`` factory, on ``device``.

    Defaults to carrying all three sparse forms so every execution path
    is a dispatch candidate; pass ``formats=None`` to let the auto
    format picker choose a single form from the measured structure.
    """
    from repro_torch.sparse.matrix import SparseMatrix

    return SparseMatrix.from_dense(make_dense(spec), formats=formats,
                                   format=format, block=block,
                                   device=device)


def default_corpus(quick: bool = True, seed: int = 0):
    """The standard sweep: every family at moderate and hyper sparsity."""
    shape = (256, 256) if quick else (1024, 1024)
    bw = 16 if quick else 48
    specs = []
    for sparsity in (0.9, 0.99):
        for family in FAMILIES:
            specs.append(CorpusSpec(
                family=family, shape=shape, sparsity=sparsity, seed=seed,
                band_width=bw))
    return specs

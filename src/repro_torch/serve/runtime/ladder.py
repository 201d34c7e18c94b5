"""Adaptive bucket ladder: a compile grid learned from live traffic (the
port of ``repro.serve.runtime.ladder``; numpy only, the same rungs for
the same observed stream).

The fixed geometric grid (``repro_torch.batch.bucketing``) quantizes
every request up by a constant growth factor, so on mixed traffic much of
the streamed volume is padding.  The ladder
replaces the geometric rungs with **quantiles of the observed request
shapes**: each dimension (rows, nnz, ELL width) keeps ``n_rungs`` rung
values fit to the marginal distribution of a sliding window of traffic,
so the grid is dense exactly where requests actually land and the
expected pad-up per request shrinks from ~(growth+1)/2 to the
inter-quantile gap.

Three serving-specific mechanisms keep the learned grid cheap to run:

* **Drift detection** — the window's log₂ histograms are compared to the
  histograms frozen at fit time with a symmetric KL divergence; the
  ladder re-fits only when the mix has genuinely moved
  (``drift() > drift_threshold``).
* **Hysteresis** — drift is only *checked* every ``refit_interval``
  observations and never before ``min_fit`` observations exist, so a
  brief burst cannot thrash the grid.
* **Warm-executor carryover** — at re-fit, any new rung within
  ``snap_tol`` (relative) of an old rung *snaps to the old value*.
  Buckets are the key of every ``BucketedExecutor`` program, so a
  snapped rung means the re-laddered grid keeps hitting the warm
  executors instead of churning the cache; only rungs that actually
  moved pay a compile.

Requests that overflow the learned grid (larger than the top rung) fall
back to geometric quantization *from* the top rung, so the total number
of distinct buckets stays O(#rungs + log overflow).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.batch.bucketing import (Bucket, BucketingConfig,
                                         DEFAULT_BUCKETING, _round_to,
                                         bucket_for as fixed_bucket_for,
                                         quantize_up)
from repro_torch.dispatch.stats import MatrixStats


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """Knobs of the online quantile fit."""

    n_rungs: int = 8           # rungs per dimension (rows / nnz / width)
    window: int = 512          # sliding observation window
    min_fit: int = 32          # observations before the first fit
    refit_interval: int = 64   # observations between drift checks
    drift_threshold: float = 0.25  # symmetric-KL trigger for a re-fit
    snap_tol: float = 0.25     # relative tol for warm-rung carryover
    fallback: BucketingConfig = DEFAULT_BUCKETING  # pre-fit / overflow


DEFAULT_LADDER = LadderConfig()

_DIMS = ("rows", "nnz", "width")


def _symmetric_kl(p: np.ndarray, q: np.ndarray, eps: float = 1e-9) -> float:
    """Symmetric KL between two (unnormalized) histograms."""
    p = p.astype(np.float64) + eps
    q = q.astype(np.float64) + eps
    p /= p.sum()
    q /= q.sum()
    return float(((p - q) * np.log(p / q)).sum())


def _log_hist(values: np.ndarray, n_bins: int = 24) -> np.ndarray:
    """Histogram of log2(values) over fixed bins [0, 24) (16M ceiling)."""
    lg = np.log2(np.maximum(values.astype(np.float64), 1.0))
    return np.histogram(lg, bins=n_bins, range=(0.0, float(n_bins)))[0]


def _fit_rungs(values: np.ndarray, n_rungs: int) -> np.ndarray:
    """Quantile rung values (ascending, unique, top = observed max)."""
    qs = np.linspace(1.0 / n_rungs, 1.0, n_rungs)
    rungs = np.quantile(values, qs, method="higher")
    return np.unique(rungs.astype(np.int64))


def _snap(new: np.ndarray, old: Optional[np.ndarray], tol: float
          ) -> tuple[np.ndarray, int]:
    """Snap new rungs onto old ones within relative ``tol``.

    Correctness never depends on rung values — selection is "smallest
    rung >= x, else geometric overflow" — so snapping a rung slightly
    up or down only trades a little padding for a warm executor.
    """
    if old is None or not len(old):
        return new, 0
    snapped = []
    carried = 0
    for r in new:
        j = int(np.argmin(np.abs(old - r)))
        if abs(int(old[j]) - int(r)) <= tol * max(int(r), 1):
            snapped.append(int(old[j]))
            carried += 1
        else:
            snapped.append(int(r))
    return np.unique(np.asarray(snapped, np.int64)), carried


class AdaptiveBucketLadder:
    """Online quantile-learned bucket grid over (rows, nnz, width).

    Thread-safe: ``observe``/``bucket_for`` may be called from a serving
    worker while ``report`` reads from another thread.
    """

    def __init__(self, config: LadderConfig = DEFAULT_LADDER):
        self.config = config
        self._obs: Dict[str, Deque[int]] = {
            d: collections.deque(maxlen=config.window) for d in _DIMS}
        self._rungs: Dict[str, Optional[np.ndarray]] = {
            d: None for d in _DIMS}
        self._fit_hist: Dict[str, np.ndarray] = {}
        self._since_check = 0
        self._lock = threading.RLock()
        # counters
        self.observed = 0
        self.refits = 0
        self.drift_checks = 0
        self.fallbacks = 0     # requests bucketed off the geometric grid
        self.snapped_rungs = 0  # rungs carried warm across re-fits
        self.last_drift = 0.0

    # -- observation / fitting ---------------------------------------------

    def observe(self, stats: MatrixStats) -> None:
        """Record one request's shape marginals; re-fit on drift."""
        with self._lock:
            self._obs["rows"].append(int(stats.shape[0]))
            self._obs["nnz"].append(max(int(stats.nnz), 1))
            self._obs["width"].append(max(int(stats.ell_width), 1))
            self.observed += 1
            obs.counter("ladder_observed_total").inc()
            self._since_check += 1
            self._maybe_refit()

    @property
    def fitted(self) -> bool:
        return self._rungs["rows"] is not None

    def drift(self) -> float:
        """Symmetric KL between the window's and the fit-time log₂
        histograms, maxed over the (rows, nnz) marginals."""
        with self._lock:
            if not self.fitted or not self._fit_hist:
                return 0.0
            return max(
                _symmetric_kl(_log_hist(np.asarray(self._obs[d])),
                              self._fit_hist[d])
                for d in ("rows", "nnz"))

    def _maybe_refit(self) -> bool:
        n = len(self._obs["rows"])
        if not self.fitted:
            if n < self.config.min_fit:
                return False
            self._fit()
            return True
        if self._since_check < self.config.refit_interval:
            return False
        self._since_check = 0
        self.drift_checks += 1
        obs.counter("ladder_drift_checks_total").inc()
        self.last_drift = self.drift()
        obs.gauge("ladder_last_drift").set(self.last_drift)
        if self.last_drift <= self.config.drift_threshold:
            return False  # hysteresis: mix hasn't moved, keep the grid
        self._fit()
        return True

    def _fit(self) -> None:
        for d in _DIMS:
            vals = np.asarray(self._obs[d], np.int64)
            new = _fit_rungs(vals, self.config.n_rungs)
            new, carried = _snap(new, self._rungs[d],
                                 self.config.snap_tol)
            self._rungs[d] = new
            self.snapped_rungs += carried
            self._fit_hist[d] = _log_hist(vals)
        self.refits += 1
        obs.counter("ladder_refits_total").inc()
        self._since_check = 0

    def refit(self) -> None:
        """Force an immediate fit from the current window."""
        with self._lock:
            if len(self._obs["rows"]):
                self._fit()

    # -- bucketing ----------------------------------------------------------

    def _pick(self, dim: str, x: int) -> int:
        """Smallest learned rung >= x; geometric overflow past the top."""
        rungs = self._rungs[dim]
        i = int(np.searchsorted(rungs, x, side="left"))
        if i < len(rungs):
            return int(rungs[i])
        # overflow: geometric growth anchored at the top rung keeps the
        # key space O(log overflow) instead of one bucket per shape
        return quantize_up(x, int(rungs[-1]),
                           self.config.fallback.growth)

    def bucket_for(self, stats: MatrixStats) -> Bucket:
        """The learned-grid bucket for these request stats (geometric
        fallback until ``min_fit`` observations have been seen)."""
        with self._lock:
            if not self.fitted:
                self.fallbacks += 1
                obs.counter("ladder_fallbacks_total").inc()
                return fixed_bucket_for(stats, self.config.fallback)
            bm, bn = stats.block_m, stats.block_n
            rows = _round_to(self._pick("rows", stats.shape[0]), bm)
            cols = _round_to(self._pick("rows", stats.shape[1]), bn)
            nnz = self._pick("nnz", max(stats.nnz, 1))
            width = self._pick("width", max(stats.ell_width, 1))
            return Bucket(rows=rows, cols=cols, nnz=nnz, width=width,
                          block_m=bm, block_n=bn)

    # -- reporting ----------------------------------------------------------

    def rungs(self) -> Dict[str, List[int]]:
        with self._lock:
            return {d: ([] if self._rungs[d] is None
                        else [int(x) for x in self._rungs[d]])
                    for d in _DIMS}

    def report(self) -> Dict[str, object]:
        with self._lock:
            return {
                "fitted": self.fitted,
                "observed": self.observed,
                "refits": self.refits,
                "drift_checks": self.drift_checks,
                "last_drift": round(self.last_drift, 4),
                "fallbacks": self.fallbacks,
                "snapped_rungs": self.snapped_rungs,
                "rungs": self.rungs(),
            }

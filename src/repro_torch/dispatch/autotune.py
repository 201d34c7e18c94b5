"""The timed autotune pass: time each candidate path on the operand's
device, cache the winner (the port of ``repro.dispatch.autotune``).

The cache key buckets sparsity by log-density, so one measurement serves
a whole sparsity regime.  Keys are plain tuples, written as the reference
writes them (the dtype as ``"float32"``, not ``"torch.float32"``), so a
cache saved by either package loads in the other and hits; ``save`` /
``load`` keep the reference's JSON schema, and a calibrated
``CostModel`` rides along.

A candidate's time is the minimum over ``iters`` calls, each followed by
``torch.cuda.synchronize`` where its output lies on the card: without the
wait the pass would time kernel launches, not kernels.  A candidate that
cannot run here (a wrapper's ``ValueError`` / ``TypeError``, the card out
of memory) times +inf; any other failure, a ``KernelError`` (a kernel that
failed to build, load or launch) or a CUDA fault above all, propagates:
routing around a broken kernel would hide it.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.dispatch.stats import sparsity_bucket

AutotuneKey = Tuple  # (op, m, n, inner_dim, dtype_str, sparsity_bucket, ...)

# what marks a path as unavailable for these operands (timed as +inf)
UNAVAILABLE = (ValueError, TypeError, torch.cuda.OutOfMemoryError)


def dtype_name(dtype) -> str:
    """The reference's spelling of a dtype: ``str`` of a numpy / jnp
    dtype (``"float32"``, ``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return str(dtype)


def make_key(op: str, shape: Tuple[int, int], inner_dim: int, dtype,
             density: float, *, buckets_per_decade: int = 2) -> AutotuneKey:
    return (
        str(op),
        int(shape[0]),
        int(shape[1]),
        int(inner_dim),
        dtype_name(dtype),
        sparsity_bucket(density, buckets_per_decade),
    )


@dataclasses.dataclass
class Measurement:
    path: str
    timings_us: Dict[str, float]


class AutotuneCache:
    """Thread-safe (key -> winning path) cache with JSON persistence; it
    may also carry one calibrated ``CostModel`` (see :func:`calibrate`),
    which ``save`` / ``load`` round-trip."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[AutotuneKey, Measurement] = {}
        self.cost_model = None  # Optional[CostModel], set by calibrate()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: AutotuneKey) -> Optional[Measurement]:
        with self._lock:
            m = self._entries.get(key)
            if m is None:
                self.misses += 1
            else:
                self.hits += 1
            return m

    def put(self, key: AutotuneKey, m: Measurement) -> None:
        with self._lock:
            self._entries[key] = m

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.cost_model = None
            self.hits = 0
            self.misses = 0

    # -- persistence --------------------------------------------------------

    def to_json(self) -> str:
        with self._lock:
            entries = [
                {"key": list(k), "path": m.path, "timings_us": m.timings_us}
                for k, m in self._entries.items()
            ]
            cm = (dataclasses.asdict(self.cost_model)
                  if self.cost_model is not None else None)
        return json.dumps({"entries": entries, "cost_model": cm},
                          indent=2, sort_keys=True)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def load(self, path: str) -> None:
        from repro_torch.dispatch.cost_model import CostModel

        with open(path) as f:
            payload = json.load(f)
        # legacy payloads were a bare entry list (no calibration)
        entries = payload if isinstance(payload, list) \
            else payload.get("entries", [])
        cm = None if isinstance(payload, list) \
            else payload.get("cost_model")
        with self._lock:
            for row in entries:
                self._entries[tuple(row["key"])] = Measurement(
                    path=row["path"], timings_us=row["timings_us"])
            if cm is not None:
                self.cost_model = CostModel(**cm)


def wait_for(out) -> None:
    """Wait for the card where ``out`` (a tensor, or a tuple or list of
    them) lies on one."""
    if isinstance(out, (tuple, list)):
        for x in out:
            wait_for(x)
    elif isinstance(out, torch.Tensor) and out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def _time_us(fn: Callable[[], object], warmup: int, iters: int) -> float:
    """The fastest of ``iters`` calls of ``fn``, in µs, each waited for."""
    for _ in range(max(warmup, 0)):
        wait_for(fn())
    best = float("inf")
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        wait_for(fn())
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def measure(candidates: Dict[str, Callable[[], object]], *,
            warmup: int = 1, iters: int = 3) -> Measurement:
    """Time each candidate thunk; return the winner and every timing.

    A candidate that raises one of ``UNAVAILABLE`` is recorded as +inf;
    any other exception propagates.
    """
    timings: Dict[str, float] = {}
    last_exc: Optional[Exception] = None
    for name, thunk in candidates.items():
        try:
            timings[name] = _time_us(thunk, warmup, iters)
        except UNAVAILABLE as exc:
            timings[name] = float("inf")
            last_exc = exc
    finite = {p: t for p, t in timings.items() if t != float("inf")}
    if not finite:
        raise RuntimeError(
            "autotune: every candidate path failed") from last_exc
    best = min(finite, key=finite.get)
    return Measurement(path=best, timings_us=timings)


def calibrate(
    *,
    n: int = 512,
    d: int = 64,
    densities: Tuple[float, ...] = (0.5, 0.05, 0.005),
    seed: int = 0,
    warmup: int = 1,
    iters: int = 3,
    cache: Optional[AutotuneCache] = None,
    device="cuda",
):
    """Measure the per-element path costs on ``device`` (the card unless
    the caller asks for the CPU).

    The analytic cost model prices each path as (elements streamed) x (a
    per-element constant); the shipped constants encode the reference's
    TPU.  This pass times every SpMM path (``autodiff.spmm_exec``: on the
    card K1 for ell, K2 for sell, the segmented sum for csr and
    ``torch.matmul`` for dense) on seeded operands at a few densities,
    normalizes each time by the volume its path streams, and expresses it
    relative to the dense path's per-element time: the ``c_ell`` /
    ``c_sell`` / ``c_csr`` constants, measured.

    Returns the tuned ``CostModel`` (median across densities, floored at
    1e-3; a path with no valid measurement keeps its shipped constant).
    With ``cache`` the model is attached to it, so ``save`` / ``load``
    persist it.  ``DEFAULT_COST_MODEL`` is not changed.
    """
    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.dispatch.cost_model import DEFAULT_COST_MODEL, CostModel
    from repro_torch.sparse import autodiff
    from repro_torch.sparse.matrix import SparseMatrix

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) \
        .to(device)
    ratios: Dict[str, list] = {"ell": [], "sell": [], "csr": []}
    for density in densities:
        dense = np.where(rng.random((n, n)) < density,
                         rng.normal(size=(n, n)), 0.0).astype(np.float32)
        a = SparseMatrix.from_dense(dense, formats=("ell", "sell", "csr"),
                                    device=device)
        stats = a.stats
        thunks = {p: (lambda p=p: autodiff.spmm_exec(p, a, h))
                  for p in ("ell", "sell", "csr", "dense")}
        t = measure(thunks, warmup=warmup, iters=iters).timings_us
        if t.get("dense", float("inf")) == float("inf"):
            continue
        per_dense = t["dense"] / max(stats.dense_elements * d, 1)
        streamed = {"ell": stats.stored_elements,
                    "sell": stats.sell_stored_elements,
                    "csr": stats.nnz}
        for p, vol in streamed.items():
            tp = t.get(p, float("inf"))
            if tp != float("inf") and vol > 0 and per_dense > 0:
                ratios[p].append((tp / (vol * d)) / per_dense)

    def _tuned(path: str, shipped: float) -> float:
        if not ratios[path]:
            return shipped
        # floored, so a noisy fast run never prices a path as free
        return max(float(np.median(ratios[path])), 1e-3)

    cm = CostModel(
        c_ell=_tuned("ell", DEFAULT_COST_MODEL.c_ell),
        c_sell=_tuned("sell", DEFAULT_COST_MODEL.c_sell),
        c_csr=_tuned("csr", DEFAULT_COST_MODEL.c_csr),
    )
    if cache is not None:
        cache.cost_model = cm
    return cm


# Process-global cache of the ``autotune`` policy.
GLOBAL_CACHE = AutotuneCache()

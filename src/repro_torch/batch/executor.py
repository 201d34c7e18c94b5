"""Bucketed batch executor: O(#buckets) executors for arbitrary traffic
(the port of ``repro.batch.executor``).

``BucketedExecutor`` takes a micro-batch of (graph, features) requests of
any shapes, groups them by :func:`bucket_for`, pads every graph of a group
into its bucket, fills the group to a quantized batch size with all-zero
dummies, composes it block-diagonally, and runs one executor per (bucket,
batch size, d, form) key.  Executors live in an LRU cache; a compile
counter tells first uses from cache hits, and a :class:`PaddingWaste`
ledger accounts the streamed-but-dead volume.

The port runs eagerly: an executor is the program itself, and a "compile"
is counted where ``jax.jit`` would trace, the first call of a key at a new
input signature (``obs.sentry._signature``: the tensors' shapes, dtypes
and devices, a matrix's shape, stats and forms).  A group's output is
copied to the host once and split there.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.batch.block_diag import BatchedSparseMatrix
from repro_torch.batch.bucketing import (Bucket, BucketingConfig,
                                         DEFAULT_BUCKETING, PaddingWaste,
                                         bucket_for, canonical_stats,
                                         empty_in_bucket, pad_to_bucket)
from repro_torch.dispatch.cost_model import DEFAULT_COST_MODEL, CostModel
from repro_torch.dispatch.dispatcher import plan_spmm
from repro_torch.dispatch.policy import PATH_CSR, PATH_ELL
from repro_torch.obs.sentry import _signature
from repro_torch.resilience import chaos
from repro_torch.resilience.errors import TRANSIENT, KernelError, classify
from repro_torch.sparse import paths
from repro_torch.sparse.matrix import SparseMatrix

# fn(batched_matrix, stacked_features) -> stacked outputs [rows, d_out];
# with a `context` configured, fn(context, batched_matrix, features)
ExecutorFn = Callable[..., torch.Tensor]


def _quantize_batch(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at max_batch."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def synchronize(y: torch.Tensor) -> None:
    """Wait for ``y``'s kernels (a no-op on the CPU).  A fault the card
    reports here raises :class:`KernelError`, which is never retried."""
    if y.is_cuda:
        try:
            torch.cuda.synchronize(y.device)
        except RuntimeError as exc:
            raise KernelError(f"the card faulted: {exc}") from exc


@dataclasses.dataclass(frozen=True)
class ExecutorKey:
    bucket: Bucket
    batch: int
    d: int
    form: str

    @property
    def label(self) -> str:
        """Stable per-cell name; ``BucketedExecutor.lane_label`` prefixes
        it with the owning executor's id to form the sentry lane."""
        return f"{self.bucket.label}/b{self.batch}/d{self.d}/{self.form}"


_EXECUTOR_IDS = itertools.count()


class BucketedExecutor:
    """Shape-bucketed executor cache over block-diagonal batches.

    ``fn(matrix, h)`` is the per-batch program (default: the planned SpMM
    ``matrix @ h`` forced to the bucket's path).  One executor is kept per
    (bucket, quantized batch, d, form) key in an LRU of ``max_executors``.
    ``context`` (e.g. model weights) is passed to ``fn`` as a leading
    argument, shared by every cached executor.
    """

    def __init__(self, fn: Optional[ExecutorFn] = None, *,
                 context: Any = None,
                 form: str = "auto",
                 policy: str = "auto",
                 max_batch: int = 32,
                 max_executors: int = 64,
                 bucketing: BucketingConfig = DEFAULT_BUCKETING,
                 cost_model: CostModel = DEFAULT_COST_MODEL,
                 ladder: Any = None,
                 degrade_after: int = 3):
        if form not in ("auto", "csr", "ell"):
            raise ValueError(
                f"form must be 'auto', 'csr' or 'ell'; got {form!r}")
        if fn is None and context is not None:
            raise ValueError("context without fn has nothing to consume it")
        self._fn = fn
        self.context = context
        self.form = form
        self.policy = policy
        self.max_batch = int(max_batch)
        self.max_executors = int(max_executors)
        self.bucketing = bucketing
        self.cost_model = cost_model
        # opt-in traffic-fitted bucket grid (an AdaptiveBucketLadder); None
        # = the fixed geometric grid
        self.ladder = ladder
        self._executors: "collections.OrderedDict[ExecutorKey, Callable]" \
            = collections.OrderedDict()
        # sentry lanes are namespaced per executor instance: two engines
        # compiling the same cell are two first compiles, not a retrace
        self.uid = next(_EXECUTOR_IDS)
        self.compiles = 0       # first uses at a signature (LRU misses)
        self.calls = 0          # batched dispatches
        self.requests = 0       # individual graphs served
        self.evictions = 0
        self.waste = PaddingWaste()
        # bucket plans made by choose_form, kept for the cost audit
        self._bucket_plans: Dict[Tuple[Bucket, int], Any] = {}
        # degraded mode: a (bucket, d, form) cell that fails
        # `degrade_after` consecutive transient executions is excluded
        # from auto form selection until the process restarts
        self.degrade_after = int(degrade_after)
        self._form_failures: Dict[Tuple[Bucket, int, str], int] = {}
        self._degraded: set = set()

    # -- planning -----------------------------------------------------------

    def bucket_of(self, stats) -> Bucket:
        """The compile-grid cell a request with these stats pads into (the
        learned ladder when one is configured, else the fixed grid)."""
        if self.ladder is not None:
            self.ladder.observe(stats)
            return self.ladder.bucket_for(stats)
        return bucket_for(stats, self.bucketing)

    def choose_form(self, bucket: Bucket, d: int,
                    carried: Sequence[str]) -> Tuple[str, str]:
        """(form to pad, path to run) for one bucket."""
        if self.policy in ("csr", "ell"):
            if self.policy not in carried:
                raise ValueError(
                    f"policy {self.policy!r} forced but the group carries "
                    f"only {tuple(carried)}")
            return self.policy, self.policy
        if self.form in ("csr", "ell"):
            if self.form not in carried:
                raise ValueError(
                    f"form {self.form!r} requested but the group carries "
                    f"only {tuple(carried)}")
            form = self.form
        else:
            cand = tuple(p for p in (PATH_ELL, PATH_CSR) if p in carried)
            if not cand:
                raise ValueError(
                    f"group carries no bucketable form: {tuple(carried)}")
            # degraded mode: skip forms that kept failing in this cell,
            # unless that would leave no candidate at all
            healthy = tuple(p for p in cand
                            if (bucket, d, p) not in self._degraded)
            plan = plan_spmm(canonical_stats(bucket), d, policy=self.policy,
                             cost_model=self.cost_model,
                             candidates=healthy or cand)
            self._bucket_plans[(bucket, d)] = plan
            form = plan.path
        return form, form

    def note_failure(self, bucket: Bucket, d: int, form: str) -> bool:
        """Record one transient execution failure for a cell.  True exactly
        when the cell's form newly crosses ``degrade_after`` consecutive
        failures and enters degraded mode (the caller should replan the
        traffic onto a surviving form)."""
        key = (bucket, d, form)
        if key in self._degraded:
            return False
        n = self._form_failures.get(key, 0) + 1
        self._form_failures[key] = n
        if n < self.degrade_after:
            return False
        self._degraded.add(key)
        obs.counter("resilience_degraded_total", form=form).inc()
        obs.counter("resilience_recoveries_total", site="degrade").inc()
        return True

    def note_success(self, bucket: Bucket, d: int, form: str) -> None:
        """A success resets the consecutive-failure count (a degraded form
        stays degraded)."""
        self._form_failures.pop((bucket, d, form), None)

    def bucket_plan(self, bucket: Bucket, d: int):
        """The cost-model plan made for this (bucket, d) cell, if any
        (forced forms and policies plan nothing)."""
        return self._bucket_plans.get((bucket, d))

    def lane_label(self, key: ExecutorKey) -> str:
        """The retrace-sentry lane of this cell in this executor."""
        return f"x{self.uid}/{key.label}"

    def executor_for(self, key: ExecutorKey) -> Callable:
        """The program serving one (bucket, batch, d, form) cell
        (LRU-cached; a first call at a new signature bumps ``compiles``).
        Public so the continuous engine shares this cache."""
        cached = self._executors.get(key)
        if cached is not None:
            self._executors.move_to_end(key)
            return cached

        path = key.form
        inner = self._fn
        lane = self.lane_label(key)
        seen = set()

        def body(*args):
            if inner is not None:
                return inner(*args)
            mat, h = args
            from repro_torch.sparse import ops

            return ops.matmul(mat, h, policy=path, candidates=(path,))

        def exe(*args):
            sig = _signature(args)
            if sig not in seen:
                # chaos first, so an injected compile failure counts no
                # compile and the next call "traces" again
                chaos.hook("executor.compile", lane=lane)
                self.compiles += 1
                obs.SENTRY.record_compile(lane)
                seen.add(sig)
            with torch.no_grad():
                return body(*args)

        self._executors[key] = exe
        while len(self._executors) > self.max_executors:
            evicted, _ = self._executors.popitem(last=False)
            self.evictions += 1
            obs.counter("executor_evictions_total").inc()
            # an evicted lane legitimately recompiles on its next use
            obs.SENTRY.forget(self.lane_label(evicted))
        return exe

    # -- execution ----------------------------------------------------------

    def run(self, mats: Sequence[SparseMatrix], hs: Sequence[Any]
            ) -> List[np.ndarray]:
        """Serve one micro-batch of (graph, features) requests.

        Groups by bucket, pads, composes block-diagonally, runs one
        executor per group, and returns per-request outputs (host numpy,
        rows trimmed to each graph's node count) in input order.  Features
        (tensors or numpy) go to their graph's device.
        """
        if len(mats) != len(hs):
            raise ValueError(f"{len(mats)} graphs but {len(hs)} features")
        groups: Dict[Tuple[Bucket, int], List[int]] = {}
        hs = [torch.as_tensor(h, device=m.device) for m, h in zip(mats, hs)]
        with obs.span("serve.bucket", requests=len(mats),
                      grid="ladder" if self.ladder is not None else "fixed"):
            for i, (m, h) in enumerate(zip(mats, hs)):
                if m.stats is None:
                    raise ValueError(
                        "bucketed execution needs matrices with stats "
                        "(construct with SparseMatrix.from_dense)")
                if h.ndim != 2 or h.shape[0] != m.shape[1]:
                    raise ValueError(
                        f"request {i}: features {tuple(h.shape)} do not "
                        f"match matrix {m.shape}")
                bucket = self.bucket_of(m.stats)
                groups.setdefault((bucket, int(h.shape[1])), []).append(i)
        out: List[Optional[np.ndarray]] = [None] * len(mats)
        for (bucket, d), idxs in groups.items():
            for lo in range(0, len(idxs), self.max_batch):
                self._run_group(bucket, d, idxs[lo:lo + self.max_batch],
                                mats, hs, out)
        return out  # type: ignore[return-value]

    def _run_group(self, bucket: Bucket, d: int, idxs: List[int],
                   mats, hs, out) -> None:
        carried = [f for f in ("ell", "csr")
                   if all(mats[i].has_form(f) for i in idxs)]
        form, path = self.choose_form(bucket, d, carried)
        bs = _quantize_batch(len(idxs), self.max_batch)
        dtype, dev = hs[idxs[0]].dtype, hs[idxs[0]].device
        key = ExecutorKey(bucket=bucket, batch=bs, d=d, form=path)
        lane = self.lane_label(key)
        with obs.span("serve.compose", lane=lane, n=len(idxs)):
            padded = [pad_to_bucket(mats[i], bucket, form=form)
                      for i in idxs]
            feats = [paths.pad_rows(hs[i], bucket.cols) for i in idxs]
            if len(padded) < bs:
                dummy = empty_in_bucket(bucket, form=form, dtype=dtype,
                                        device=dev)
                zeros = torch.zeros((bucket.cols, d), dtype=dtype,
                                    device=dev)
                padded += [dummy] * (bs - len(padded))
                feats += [zeros] * (bs - len(feats))
            B = BatchedSparseMatrix.from_matrices(padded, formats=(form,))
            h = torch.cat(feats)
        args = (B.matrix, h) if self.context is None \
            else (self.context, B.matrix, h)
        with obs.span("serve.execute", lane=lane):
            t0 = time.perf_counter()
            try:
                chaos.hook("executor.execute", lane=lane, form=path)
                y = self.executor_for(key)(*args)
                synchronize(y)
            except Exception as exc:
                if classify(exc) == TRANSIENT:
                    self.note_failure(bucket, d, path)
                raise
            exec_ms = (time.perf_counter() - t0) * 1e3
        y = chaos.corrupt("executor.output", y, lane=lane)
        self.note_success(bucket, d, path)
        obs.SENTRY.record_call(lane)
        plan = self.bucket_plan(bucket, d)
        obs.AUDIT.record_raw(
            op="spmm", path=path, measured_ms=exec_ms, bucket=bucket.label,
            costs=plan.costs if plan is not None else None,
            policy=plan.policy if plan is not None else self.policy)
        self.calls += 1
        self.requests += len(idxs)
        self.waste.add(real_rows=sum(mats[i].shape[0] for i in idxs),
                       padded_rows=bs * bucket.rows,
                       real_nnz=sum(mats[i].stats.nnz for i in idxs),
                       padded_nnz=bs * bucket.nnz, bucket=bucket)
        with obs.span("serve.complete", lane=lane, n=len(idxs)):
            y_host = y.detach().cpu().numpy()  # one copy for the group
            for slot, i in enumerate(idxs):
                lo = slot * bucket.rows
                out[i] = y_host[lo:lo + mats[i].shape[0]]

    # -- reporting ----------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """Canonical keys; the old ``padding`` spelling resolves through a
        deprecation alias."""
        out = {
            "requests": self.requests,
            "calls": self.calls,
            "compiles": self.compiles,
            "executors_cached": len(self._executors),
            "evictions": self.evictions,
            "buckets": len({k.bucket for k in self._executors}),
            "waste": self.waste.as_dict(),
        }
        if self.ladder is not None:
            out["ladder"] = self.ladder.report()
        if self._degraded:
            out["degraded"] = sorted(
                f"{b.label}/d{d}/{f}" for b, d, f in self._degraded)
        return obs.renamed_keys(out, {"padding": "waste"})

"""Continuous batching: admission into a running block-diagonal batch
(the port of ``repro.serve.runtime.continuous``).

The micro-batching engine (``repro_torch.serve.engine.BatchServingEngine``)
holds every request until a flush fires (batch full or deadline), then
composes and executes the whole window at once — arrivals during an
execution wait a full window, and a straggler bucket delays the flush
for everyone.  ``ContinuousBatchEngine`` removes the window: requests
are admitted *into a running batch* the moment a slot is free.

Mechanics (all shapes static — the engine never "recompiles" on
occupancy):

* Traffic is partitioned into **lanes** keyed by ``(bucket, d)``.  A
  lane owns a fixed pool of ``slots`` request slots, one cached
  all-zero dummy matrix, and one executor (shared with the
  :class:`repro_torch.batch.BucketedExecutor` LRU under the key
  ``ExecutorKey(bucket, slots, d, form)``).
* Every :meth:`step` composes exactly ``slots`` matrices — occupied
  slots contribute their admission-padded matrix, free slots the cached
  dummy.  The occupancy mask is therefore *data* (zero blocks), never
  *shape*: as requests come and go, the executor sees byte-identical
  static metadata (the lane's precomputed combined canonical stats ride
  through :meth:`BatchedSparseMatrix.from_matrices`'s ``stats=``
  override), so its signature never changes.
* Requests complete **per slot**: a finished slot resolves its future
  and is immediately recycled to the lane's wait queue; its neighbors
  keep stepping undisturbed.  Multi-step requests (``steps > 1``, e.g.
  power iteration / multi-hop propagation) feed their padded output
  back in as the next step's features and occupy the slot until done —
  heterogeneous step counts coexist in one lane.

Padding is paid once per request at admission (``pad_to_bucket`` +
feature row padding), not once per flush.

Each step copies the lane's output to the host once; results and the
NaN/Inf guard read that copy, and multi-step requests re-feed from the
device output.  A background stepping thread enters the engine's device.

Resilience: a failed lane step does not fail every co-batched
occupant.  The engine retries the
step (backoff + jitter, bounded by a per-request allowance and an
engine-wide token-bucket budget), then **bisects** the occupants to
isolate the culprit — poison requests are quarantined with
:class:`PoisonRequestError` while innocents complete from the probe
executions.  NaN/Inf output blocks are quarantined instead of returned.
An executor form that keeps failing is *degraded* (the lane rebuilds on
the surviving form), an over-full wait queue sheds the lowest-priority
/ nearest-deadline request with :class:`RequestShedError`, and a dead
background worker restarts under a bounded supervisor.  Every recovery
action moves an ``obs`` counter.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.batch.block_diag import BatchedSparseMatrix
from repro_torch.batch.bucketing import (Bucket, canonical_stats,
                                         empty_in_bucket, pad_to_bucket)
from repro_torch.batch.executor import (BucketedExecutor, ExecutorKey,
                                        synchronize)
from repro_torch.device import device_scope, resolve_device
from repro_torch.dispatch.stats import MatrixStats
from repro_torch.resilience import chaos
from repro_torch.resilience.errors import (FATAL, POISON, TRANSIENT,
                                           DeadlineExceededError,
                                           EngineClosedError, NaNOutputError,
                                           RequestShedError,
                                           TransientExecutorError, classify)
from repro_torch.resilience.retry import RetryBudget, RetryPolicy
from repro_torch.resilience.supervisor import WorkerSupervisor
from repro_torch.serve.runtime.ladder import (AdaptiveBucketLadder,
                                              LadderConfig, DEFAULT_LADDER)
from repro_torch.sparse import paths


@dataclasses.dataclass
class ContinuousConfig:
    """Slot-pool, grid, and resilience knobs of the continuous engine."""

    slots: int = 8             # slot pool per (bucket, d) lane
    policy: str = "auto"       # dispatch policy inside the executor
    form: str = "auto"         # bucket form: auto | csr | ell
    max_executors: int = 64    # LRU cap on cached executors
    queue_depth: int = 1024    # per-lane wait queue bound
    adaptive: bool = True      # learn the bucket grid from traffic
    ladder: LadderConfig = DEFAULT_LADDER
    background: bool = False   # run a stepping thread (else call step())
    idle_sleep_s: float = 0.5e-3
    # a lane executes when its slot pool is full OR its oldest occupant
    # has waited this long — hot lanes run packed, cold lanes still
    # bound their latency (the continuous analog of max_delay_ms)
    max_wait_ms: float = 5.0
    # -- resilience ---------------------------------------------------------
    retry: RetryPolicy = RetryPolicy()  # per-request backoff + allowance
    retry_budget: int = 64              # engine-wide retry tokens
    retry_refill_per_s: float = 8.0
    guard_nonfinite: bool = True        # quarantine NaN/Inf output blocks
    default_deadline_ms: Optional[float] = None  # per-request deadline
    default_timeout_s: Optional[float] = 60.0    # infer() overall deadline
    max_worker_restarts: int = 3
    seed: int = 0                       # backoff-jitter rng
    device: str = "cuda"                # where requests' graphs live


@dataclasses.dataclass
class _SlotReq:
    """One admitted request, padded into its lane's bucket."""

    matrix: Any                # bucket-padded SparseMatrix
    features: Any              # [bucket.cols, d] (padded)
    future: Future
    t_submit: float
    remaining: int             # steps left to run
    rows_logical: int          # rows to trim the final output to
    real_rows: int
    real_nnz: int
    source: Any = None         # unpadded adjacency (lane rebuilds re-pad)
    source_h: Any = None       # unpadded features
    steps_total: int = 1
    attempts: int = 0          # transient retries consumed
    priority: int = 0          # higher = shed later
    deadline: Optional[float] = None  # absolute perf_counter deadline
    tag: Any = None            # chaos/match + caller bookkeeping label


class _Lane:
    """Fixed-capacity slot pool serving one (bucket, d) cell."""

    def __init__(self, bucket: Bucket, d: int, form: str, n_slots: int,
                 dtype, queue_depth: int, device: torch.device):
        self.bucket = bucket
        self.d = d
        self.form = form
        self.dtype = dtype
        self.key = ExecutorKey(bucket=bucket, batch=n_slots, d=d, form=form)
        self.slots: List[Optional[_SlotReq]] = [None] * n_slots
        self.queue: Deque[_SlotReq] = collections.deque()
        self.queue_depth = queue_depth
        self.dummy = empty_in_bucket(bucket, form=form, dtype=dtype,
                                     device=device)
        self.zero_h = torch.zeros((bucket.cols, d), dtype=dtype,
                                  device=device)
        # combined canonical stats of `n_slots` bucket copies — computed
        # once so every step's composition carries byte-identical aux
        cs = canonical_stats(bucket)
        self.stats = MatrixStats(
            shape=(n_slots * bucket.rows, n_slots * bucket.cols),
            nnz=n_slots * cs.nnz,
            stored_elements=n_slots * cs.stored_elements,
            block_m=cs.block_m, block_n=cs.block_n,
            n_block_rows=n_slots * cs.n_block_rows,
            ell_width=cs.ell_width, occupancy=cs.occupancy)
        self.steps = 0
        self.slot_steps = 0        # slots * steps (streamed capacity)
        self.occupied_steps = 0    # occupied slot-steps (useful volume)

    @property
    def occupancy(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def admit(self, req: _SlotReq) -> bool:
        """Seat the request in a free slot, else queue it (False when
        the wait queue is full — caller sheds)."""
        for i, s in enumerate(self.slots):
            if s is None:
                self.slots[i] = req
                return True
        if len(self.queue) >= self.queue_depth:
            return False
        self.queue.append(req)
        return True

    def recycle(self) -> None:
        """Seat queued requests into freed slots."""
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                self.slots[i] = self.queue.popleft()


class ContinuousBatchEngine:
    """Serves (graph, features) traffic by admission into running
    block-diagonal batches (see module docstring).

    ``fn(matrix, h)`` is the per-batch program (default: the planned
    ``matrix @ h``); with ``context`` set it is called
    ``fn(context, matrix, h)`` — the same contract as
    :class:`repro_torch.batch.BucketedExecutor`, whose executor cache
    this engine shares.  Graphs must lie on ``cfg.device`` (the card by
    default).
    """

    def __init__(self, fn: Optional[Callable] = None, *,
                 context: Any = None,
                 cfg: Optional[ContinuousConfig] = None):
        self.cfg = cfg or ContinuousConfig()
        self.device = resolve_device(self.cfg.device)
        self.ladder: Optional[AdaptiveBucketLadder] = (
            AdaptiveBucketLadder(self.cfg.ladder)
            if self.cfg.adaptive else None)
        self.executor = BucketedExecutor(
            fn, context=context,
            form=self.cfg.form, policy=self.cfg.policy,
            max_batch=self.cfg.slots,
            max_executors=self.cfg.max_executors,
            ladder=self.ladder)
        self._lanes: Dict[Tuple[Bucket, int], _Lane] = {}
        self._lock = threading.RLock()
        self._latencies_ms: List[float] = []
        self._rng = np.random.default_rng(self.cfg.seed)
        self._budget = RetryBudget(self.cfg.retry_budget,
                                   self.cfg.retry_refill_per_s)
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.quarantined = 0
        self.shed = 0
        self._stop = threading.Event()
        self._close_once = threading.Lock()
        self._closed = False
        self._sup: Optional[WorkerSupervisor] = None
        if self.cfg.background:
            self._sup = WorkerSupervisor(
                "continuous-serve", self._step_loop,
                max_restarts=self.cfg.max_worker_restarts)
            self._sup.start()

    @classmethod
    def for_gcn(cls, params, *, cfg: Optional[ContinuousConfig] = None
                ) -> "ContinuousBatchEngine":
        """Engine running a shared-weight GCN over each running batch."""
        from repro_torch.models.gnn import Graph, gcn_forward

        c = cfg or ContinuousConfig()
        policy = c.policy

        def fwd(p, mat, h):
            g = Graph(adj=mat, n_nodes=mat.shape[0])
            return gcn_forward(p, g, h, policy=policy)

        return cls(fwd, context=params, cfg=c)

    # -- admission ----------------------------------------------------------

    def submit(self, matrix, features, *, steps: int = 1,
               priority: int = 0, deadline_ms: Optional[float] = None,
               tag: Any = None) -> Future:
        """Admit one request; resolves to [n_nodes, d_out] (numpy).

        ``steps > 1`` re-feeds the output as the next step's features
        (requires a square bucket and ``d_out == d``) — the request
        holds its slot until all steps ran.  ``priority`` orders load
        shedding (lower sheds first); ``deadline_ms`` (default
        ``cfg.default_deadline_ms``) bounds total time in the system —
        an expired queued request fails with
        :class:`DeadlineExceededError`.  When the wait queue is over
        capacity the least valuable request is shed with
        :class:`RequestShedError` (possibly this one: the returned
        future then already holds the error).
        """
        if self._stop.is_set():
            raise EngineClosedError("engine is closed")
        if self._sup is not None:
            self._sup.ensure()
        adj = getattr(matrix, "adj", matrix)
        if adj.device != self.device:
            raise ValueError(f"graph is on {adj.device}, the engine on "
                             f"{self.device}")
        if adj.stats is None:
            raise ValueError(
                "continuous serving needs matrices with stats "
                "(construct with SparseMatrix.from_dense/from_*)")
        h = torch.as_tensor(features, device=self.device)
        if h.ndim != 2 or h.shape[0] != adj.shape[1]:
            raise ValueError(
                f"features {tuple(h.shape)} do not match matrix "
                f"{adj.shape}")
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        ddl_ms = (deadline_ms if deadline_ms is not None
                  else self.cfg.default_deadline_ms)
        fut: Future = Future()
        with self._lock, obs.span("serve.admit", engine="continuous"):
            lane = self._lane_for(adj, int(h.shape[1]), h.dtype)
            if steps > 1 and lane.bucket.rows != lane.bucket.cols:
                raise ValueError(
                    f"steps={steps} needs a square bucket to re-feed the "
                    f"output; got {lane.bucket.rows}x{lane.bucket.cols}")
            t_submit = time.perf_counter()
            req = _SlotReq(
                matrix=pad_to_bucket(
                    adj if adj.has_form(lane.form) else adj.to(lane.form),
                    lane.bucket, form=lane.form),
                features=paths.pad_rows(h.to(lane.dtype),
                                        lane.bucket.cols),
                future=fut, t_submit=t_submit,
                remaining=steps, rows_logical=adj.shape[0],
                real_rows=adj.shape[0], real_nnz=adj.stats.nnz,
                source=adj, source_h=h, steps_total=steps,
                priority=priority, tag=tag,
                deadline=(t_submit + ddl_ms / 1e3)
                if ddl_ms is not None else None)
            self.submitted += 1
            if not lane.admit(req):
                self._shed_for(lane, req)
        if self._stop.is_set():
            # close() may have swept the lanes between our top-of-submit
            # check and the admit above; sweep again so this request
            # cannot strand in a lane nothing will ever step
            self._fail_leftovers()
        return fut

    def _lane_for(self, adj, d: int, dtype) -> _Lane:
        """The (bucket, d) lane serving this request (lock held)."""
        with obs.span("serve.bucket", engine="continuous"):
            bucket = self.executor.bucket_of(adj.stats)
        lane = self._lanes.get((bucket, d))
        if lane is None:
            carried = [f for f in ("ell", "csr") if adj.has_form(f)]
            form, _ = self.executor.choose_form(bucket, d, carried)
            lane = _Lane(bucket, d, form, self.cfg.slots, dtype,
                         self.cfg.queue_depth, self.device)
            self._lanes[(bucket, d)] = lane
        return lane

    def _shed_for(self, lane: _Lane, incoming: _SlotReq) -> None:
        """Wait queue over capacity: shed the least valuable request —
        lowest priority first, nearest deadline breaking ties (lock
        held)."""
        def shed_key(s: _SlotReq):
            return (s.priority,
                    s.deadline if s.deadline is not None else float("inf"))

        victim = min([*lane.queue, incoming], key=shed_key)
        if victim is not incoming:
            lane.queue.remove(victim)
            lane.admit(incoming)
        self.shed += 1
        obs.counter("resilience_shed_total", reason="queue_full").inc()
        self._finish_error(victim, RequestShedError(
            f"lane {lane.bucket.label}/d{lane.d} over capacity "
            f"({lane.queue_depth} queued): request shed "
            f"(priority={victim.priority})"))

    def infer(self, matrix, features, *, steps: int = 1,
              timeout: Optional[float] = None, **submit_kw
              ) -> np.ndarray:
        """Synchronous convenience: submit, step to completion, return.

        ``timeout`` (default ``cfg.default_timeout_s``) bounds the wait;
        expiry raises :class:`DeadlineExceededError` (a
        :class:`TimeoutError`) instead of blocking forever.
        """
        t = self.cfg.default_timeout_s if timeout is None else timeout
        fut = self.submit(matrix, features, steps=steps, **submit_kw)
        if self._sup is not None:
            try:
                return fut.result(t)
            except _FutTimeout as exc:
                if isinstance(exc, DeadlineExceededError):
                    raise
                raise DeadlineExceededError(
                    f"infer: no result within {t}s") from None
        t_deadline = None if t is None else time.perf_counter() + t
        while not fut.done():
            if t_deadline is not None and time.perf_counter() > t_deadline:
                raise DeadlineExceededError(f"infer: no result within {t}s")
            # a step may complete nothing yet still make progress
            # (multi-step requests hold their slot) — stall only
            # when no lane has work at all
            if self.step(force=True) == 0 and not fut.done():
                with self._lock:
                    stalled = all(l.occupancy == 0
                                  for l in self._lanes.values())
                if stalled:
                    raise RuntimeError(
                        "request did not complete but no lane has work")
        return fut.result()

    # -- stepping -----------------------------------------------------------

    def step(self, *, force: bool = False) -> int:
        """Run one execution over every *ready* lane (slot pool full,
        or oldest occupant past ``max_wait_ms`` — ``force`` runs any
        lane with occupants); resolve finished slots and recycle them.
        Expired queued requests fail with DeadlineExceededError.
        Returns requests completed."""
        now = time.perf_counter()
        wait_s = self.cfg.max_wait_ms / 1e3
        expired: List[_SlotReq] = []
        with self._lock:
            lanes = []
            for lane in self._lanes.values():
                if lane.queue and any(s.deadline is not None
                                      and now > s.deadline
                                      for s in lane.queue):
                    keep: Deque[_SlotReq] = collections.deque()
                    for s in lane.queue:
                        if s.deadline is not None and now > s.deadline:
                            expired.append(s)
                        else:
                            keep.append(s)
                    lane.queue = keep
                occupants = [s for s in lane.slots if s is not None]
                if not occupants:
                    continue
                if (force or len(occupants) == len(lane.slots)
                        or now - min(s.t_submit for s in occupants)
                        >= wait_s):
                    lanes.append(lane)
        for s in expired:
            obs.counter("resilience_shed_total", reason="deadline").inc()
            self.shed += 1
            self._finish_error(s, DeadlineExceededError(
                "request deadline expired while queued"))
        done = len(expired)
        for lane in lanes:
            done += self._step_lane(lane)
        return done

    def _step_lane(self, lane: _Lane) -> int:
        with self._lock:
            occupants = [(i, s) for i, s in enumerate(lane.slots)
                         if s is not None]
        if not occupants:
            return 0
        y, exc = self._try_execute(lane, occupants)
        if exc is None:
            done = self._complete_slots(lane, y, occupants)
        else:
            done = self._recover(lane, occupants, exc)
        with self._lock:
            lane.recycle()
        return done

    def _try_execute(self, lane: _Lane, subset) -> Tuple[Any, Any]:
        """Compose + execute the given occupant subset (free and
        excluded slots ride as dummies).  Returns (y, None) on success,
        (None, exc) on failure — never raises."""
        with self._lock:
            mats = [lane.dummy] * len(lane.slots)
            feats: List[Any] = [lane.zero_h] * len(lane.slots)
            for i, s in subset:
                mats[i] = s.matrix
                feats[i] = s.features
        lane_label = self.executor.lane_label(lane.key)
        tags = [s.tag for _, s in subset if s.tag is not None]
        try:
            with obs.span("serve.lane_step", lane=lane_label,
                          occupied=len(subset)):
                with obs.span("serve.compose", lane=lane_label):
                    B = BatchedSparseMatrix.from_matrices(
                        mats, formats=(lane.form,), stats=lane.stats)
                    h = torch.cat(feats)
                exe = self.executor.executor_for(lane.key)
                args = (B.matrix, h) if self.executor.context is None \
                    else (self.executor.context, B.matrix, h)
                with obs.span("serve.execute", lane=lane_label):
                    chaos.hook("continuous.execute", lane=lane_label,
                               tags=tags, form=lane.form)
                    t0 = time.perf_counter()
                    y = exe(*args)
                    synchronize(y)
                    exec_ms = (time.perf_counter() - t0) * 1e3
                y = chaos.corrupt("continuous.output", y,
                                  lane=lane_label, tags=tags)
        except Exception as exc:  # noqa: BLE001 — classified by caller
            return None, exc
        self.executor.note_success(lane.bucket, lane.d, lane.form)
        obs.SENTRY.record_call(lane_label)
        plan = self.executor.bucket_plan(lane.bucket, lane.d)
        obs.AUDIT.record_raw(
            op="spmm", path=lane.form, measured_ms=exec_ms,
            bucket=lane.bucket.label,
            costs=plan.costs if plan is not None else None,
            policy=plan.policy if plan is not None
            else self.cfg.policy)
        with self._lock:
            self.executor.calls += 1
            lane.steps += 1
            lane.slot_steps += len(lane.slots)
            lane.occupied_steps += len(subset)
            self.executor.waste.add(
                real_rows=sum(s.real_rows for _, s in subset),
                padded_rows=len(lane.slots) * lane.bucket.rows,
                real_nnz=sum(s.real_nnz for _, s in subset),
                padded_nnz=len(lane.slots) * lane.bucket.nnz,
                bucket=lane.bucket)
        return y, None

    def _complete_slots(self, lane: _Lane, y, subset) -> int:
        """Resolve finished subset slots from the output ``y`` (copied to
        the host once); multi-step members re-feed from the device output.
        NaN/Inf blocks quarantine."""
        t_done = time.perf_counter()
        bucket = lane.bucket
        done = 0
        y_host = y.detach().cpu().numpy()
        finite = np.isfinite(y_host.reshape(len(lane.slots), bucket.rows,
                                            -1)).all(axis=(1, 2))
        with self._lock:
            for i, s in subset:
                if lane.slots[i] is not s:
                    continue  # already resolved by an earlier probe
                lo = i * bucket.rows
                block = y[lo:lo + bucket.rows]
                if self.cfg.guard_nonfinite and not finite[i]:
                    lane.slots[i] = None
                    done += self._quarantine(s, NaNOutputError(
                        "non-finite output block quarantined "
                        f"(request rows={s.rows_logical})"), kind="nan")
                    continue
                s.remaining -= 1
                if s.remaining <= 0:
                    done += 1
                    lane.slots[i] = None
                    self.executor.requests += 1
                    lat_ms = (t_done - s.t_submit) * 1e3
                    self._latencies_ms.append(lat_ms)
                    obs.histogram("serve_latency_ms",
                                  engine="continuous").observe(lat_ms)
                    self.completed += 1
                    if not s.future.done() and not s.future.cancelled():
                        s.future.set_result(
                            y_host[lo:lo + s.rows_logical])
                    continue
                if tuple(block.shape) != tuple(s.features.shape):
                    done += 1
                    lane.slots[i] = None
                    self.completed += 1
                    self.failed += 1
                    if not s.future.done() and not s.future.cancelled():
                        s.future.set_exception(ValueError(
                            "multi-step request: step output "
                            f"{tuple(block.shape)} cannot re-feed features "
                            f"{tuple(s.features.shape)}"
                            " (d_out must equal d)"))
                    continue
                s.features = block
        return done

    # -- recovery -----------------------------------------------------------

    def _recover(self, lane: _Lane, subset, exc, *,
                 retried: bool = False) -> int:
        """A subset execution failed: retry, bisect, quarantine.

        Transient faults get one same-set retry (backoff + budget),
        then the subset bisects — successful halves complete from the
        probe, the failing singleton is quarantined as poison (or, if
        its failures were transient, failed with a structured
        retries-exhausted error).  A form that trips the degradation
        threshold rebuilds the whole lane on the surviving form.
        """
        kind = classify(exc)
        if kind == FATAL:
            return self._fail_slots(lane, subset, exc)
        if kind == TRANSIENT and \
                self.executor.note_failure(lane.bucket, lane.d, lane.form):
            self._rebuild_lane(lane)
            return 0
        if len(subset) == 1:
            return self._recover_single(lane, subset, exc, kind)
        if kind == TRANSIENT and not retried and self._budget.spend():
            obs.counter("resilience_retries_total",
                        site="continuous.execute", kind=kind).inc()
            time.sleep(self.cfg.retry.backoff_s(2, self._rng))
            y, exc2 = self._try_execute(lane, subset)
            if exc2 is None:
                return self._complete_slots(lane, y, subset)
            exc, kind = exc2, classify(exc2)
            if kind == FATAL:
                return self._fail_slots(lane, subset, exc)
        # bisect: innocents complete from their half's probe, the
        # culprit's half recurses down to a singleton
        mid = len(subset) // 2
        done = 0
        for half in (subset[:mid], subset[mid:]):
            y, exc_h = self._try_execute(lane, half)
            if exc_h is None:
                done += self._complete_slots(lane, y, half)
            else:
                done += self._recover(lane, half, exc_h, retried=True)
        return done

    def _recover_single(self, lane: _Lane, subset, exc, kind: str) -> int:
        (_, s) = subset[0]
        if kind == POISON:
            with self._lock:
                i = subset[0][0]
                if lane.slots[i] is s:
                    lane.slots[i] = None
            return self._quarantine(s, exc, kind="poison")
        s.attempts += 1
        if self.cfg.retry.allows(s.attempts + 1) and self._budget.spend():
            obs.counter("resilience_retries_total",
                        site="continuous.execute", kind=kind).inc()
            time.sleep(self.cfg.retry.backoff_s(s.attempts + 1, self._rng))
            y, exc2 = self._try_execute(lane, subset)
            if exc2 is None:
                return self._complete_slots(lane, y, subset)
            return self._recover(lane, subset, exc2, retried=True)
        return self._fail_slots(lane, subset, TransientExecutorError(
            f"retries exhausted after {s.attempts} attempts "
            f"(last error: {exc!r})"))

    def _quarantine(self, s: _SlotReq, exc, *, kind: str) -> int:
        """Fail one request as the pinned culprit (slot already freed).
        The original exception is preserved — chaos poison already
        raises PoisonRequestError, and a caller's ValueError stays a
        ValueError."""
        self.quarantined += 1
        obs.counter("resilience_quarantined_total", kind=kind).inc()
        self._finish_error(s, exc)
        return 1

    def _fail_slots(self, lane: _Lane, subset, exc) -> int:
        with self._lock:
            for i, s in subset:
                if lane.slots[i] is s:
                    lane.slots[i] = None
        for _, s in subset:
            self._finish_error(s, exc)
        return len(subset)

    def _finish_error(self, s: _SlotReq, exc) -> None:
        with self._lock:
            self.completed += 1
            self.failed += 1
        if not s.future.done() and not s.future.cancelled():
            s.future.set_exception(exc)

    def _rebuild_lane(self, lane: _Lane) -> None:
        """The lane's form was degraded: re-admit every occupant and
        queued request through a fresh lane on the surviving form.
        Partially-run multi-step requests restart from their source
        features (deterministic executors make the redo exact)."""
        key = (lane.bucket, lane.d)
        with self._lock:
            reqs = [s for s in lane.slots if s is not None] \
                + list(lane.queue)
            lane.slots = [None] * len(lane.slots)
            lane.queue.clear()
            if self._lanes.get(key) is lane:
                del self._lanes[key]
        obs.counter("resilience_recoveries_total",
                    site="lane_rebuild").inc()
        for s in reqs:
            try:
                with self._lock:
                    nlane = self._lane_for(s.source,
                                           int(s.source_h.shape[1]),
                                           s.source_h.dtype)
                    src = s.source if s.source.has_form(nlane.form) \
                        else s.source.to(nlane.form)
                    s.matrix = pad_to_bucket(src, nlane.bucket,
                                             form=nlane.form)
                    s.features = paths.pad_rows(
                        s.source_h.to(nlane.dtype), nlane.bucket.cols)
                    s.remaining = s.steps_total
                    if not nlane.admit(s):
                        self._shed_for(nlane, s)
            except Exception as exc:  # noqa: BLE001 — resolve, don't strand
                self._finish_error(s, exc)

    def _step_loop(self) -> None:
        with device_scope(self.device):
            self._step_forever()

    def _step_forever(self) -> None:
        while not self._stop.is_set():
            try:
                chaos.hook("continuous.worker")
            except chaos.WorkerKilled:
                return  # injected death: the supervisor restarts us
            if self.step() == 0:
                # nothing ready (idle, or occupants still inside their
                # batching window) — back off briefly
                time.sleep(self.cfg.idle_sleep_s)

    # -- lifecycle ----------------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return self.submitted - self.completed

    def drain(self, timeout: float = 60.0) -> None:
        """Step (or wait on the background thread) until every admitted
        request has resolved.  A dead background worker is restarted
        (bounded); past the restart budget the drain degrades to
        stepping inline, so the backlog still completes."""
        t0 = time.perf_counter()
        while self.pending() > 0:
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(
                    f"drain: {self.pending()} requests still pending "
                    f"after {timeout}s")
            if self._sup is None or not self._sup.ensure():
                self.step(force=True)
            else:
                time.sleep(0.002)

    def _fail_leftovers(self) -> None:
        """Sweep every occupied slot and queued request into
        EngineClosedError (close path, and the submit-vs-close race)."""
        with self._lock:
            leftovers = []
            for lane in self._lanes.values():
                leftovers += ([s for s in lane.slots if s is not None]
                              + list(lane.queue))
                lane.slots = [None] * len(lane.slots)
                lane.queue.clear()
        for s in leftovers:
            self._finish_error(s, EngineClosedError("engine closed"))

    def close(self) -> None:
        """Drain in-flight work, then stop.  Every future submitted
        before close resolves — with its result when the drain
        succeeds, with an error otherwise; none is left hanging.
        Idempotent, and safe to call concurrently from several threads
        (one closer does the work, the rest wait on its lock)."""
        with self._close_once:
            if self._closed:
                return
            try:
                self.drain()
            except Exception:  # noqa: BLE001 — fail the leftovers below
                pass
            self._stop.set()
            if self._sup is not None:
                self._sup.join(timeout=5.0)
            self._fail_leftovers()
            self._closed = True

    def __enter__(self) -> "ContinuousBatchEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def reset_metrics(self) -> None:
        """Zero traffic counters (keep compiled executors and lanes)."""
        if self.pending():
            raise RuntimeError("reset_metrics with requests in flight; "
                               "drain() first")
        with self._lock:
            self._latencies_ms.clear()
            self.submitted = self.completed = self.failed = 0
            self.quarantined = self.shed = 0
            for lane in self._lanes.values():
                lane.steps = lane.slot_steps = lane.occupied_steps = 0
            self.executor.waste = type(self.executor.waste)()
            self.executor.calls = self.executor.requests = 0

    # -- reporting ----------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """Canonical keys; the old
        ``latency_ms_p50``/``latency_ms_p99`` spellings resolve via
        deprecation aliases."""
        with self._lock:
            lat = np.asarray(self._latencies_ms, np.float64)
            lanes = {}
            for (bucket, d), lane in self._lanes.items():
                lanes[f"{bucket.label}/d{d}"] = {
                    "form": lane.form,
                    "slots": len(lane.slots),
                    "steps": lane.steps,
                    "occupancy": (lane.occupied_steps
                                  / max(lane.slot_steps, 1)),
                    "queued": len(lane.queue),
                }
            return obs.renamed_keys({
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "pending": self.submitted - self.completed,
                "p50_ms": (float(np.percentile(lat, 50))
                           if len(lat) else 0.0),
                "p99_ms": (float(np.percentile(lat, 99))
                           if len(lat) else 0.0),
                "lanes": lanes,
                "executor": self.executor.report(),
                "resilience": {
                    "quarantined": self.quarantined,
                    "shed": self.shed,
                    "retry_tokens": self._budget.remaining(),
                    "worker_restarts": (self._sup.restarts
                                        if self._sup is not None else 0),
                },
            }, {"latency_ms_p50": "p50_ms", "latency_ms_p99": "p99_ms"})

"""Serving engines (the port of ``repro.serve.engine``).

``ServingEngine`` drives the LM's ``prefill`` / ``decode_step`` entry
points (``repro_torch.models.transformer``) for a batch of prompts with
greedy or temperature decoding, eagerly on the params' device; it casts
the dense weights to the compute dtype once, at construction
(``transformer.cast_weights``: the same bits as casting at each use), and
keeps only the cast tree.
``make_prefill_step`` / ``make_serve_step`` are the reference's entry
closures.

``GNNServingEngine`` serves node classification over a fixed graph.

The aggregation path is chosen once per graph, at construction, by the
dispatch layer from the graph's sparsity stats; every request then runs
the GCN or GAT forward eagerly on that path.  A fused GAT is planned on
the one-pass attention cost surface (``plan_fused_attention``) and served
on that plan's path; an unfused GAT samples on the element pattern, so
it is served under the configured policy.  The engine reports which path
serves traffic and why.

``BatchServingEngine`` (the port of the reference's) serves a stream of
variably-shaped graphs: a bounded request queue feeds a micro-batching
worker thread (flush on ``max_batch`` or the ``max_delay_ms`` deadline)
that groups requests by shape bucket and runs each group as one
block-diagonal batch through the bucketed executor cache
(``repro_torch.batch``), with the reference's retry, bisection and
quarantine (``repro_torch.resilience``) and its spans and counters
(``repro_torch.obs``).  Futures resolve to host numpy arrays.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutTimeout
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import device_scope, resolve_device
from repro_torch.dispatch.dispatcher import plan_fused_attention, plan_spmm
from repro_torch.models.gnn import (GRAPH_PATHS, Graph, gat_forward,
                                    gcn_forward, graph_candidates)
from repro_torch.models.transformer import cast_weights, decode_step, prefill
from repro_torch.resilience import chaos
from repro_torch.resilience.errors import (FATAL, POISON, TRANSIENT,
                                           DeadlineExceededError,
                                           EngineClosedError, NaNOutputError,
                                           TransientExecutorError, classify)
from repro_torch.resilience.retry import RetryBudget, RetryPolicy
from repro_torch.resilience.supervisor import WorkerSupervisor
from repro_torch.sparse.plan import plan_cache_stats


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 2048
    temperature: float = 0.0  # 0 => greedy
    seed: int = 0


class ServingEngine:
    """Batched LM generation: ``prefill`` → ``_sample`` → ``decode_step``.

    Greedy sampling is ``argmax`` (the first maximum, as
    ``jnp.argmax``).  A temperature above 0 samples from
    ``softmax(logits / temperature)`` with ``torch.multinomial`` on an
    engine-owned ``torch.Generator`` seeded with ``scfg.seed``: the same
    tokens for the same seed, but not ``jax.random.categorical``'s draws.

    ``params`` is the one weight tree the engine holds and runs: the
    given tree with every dense leaf that the model only reads cast once
    to the compute dtype (``transformer.cast_weights``; the f32 leaves
    and the sparse weights are the given objects).  At f32 it is the
    given tree itself.  The engine keeps no reference to the f32 leaves
    it cast, so they are freed once the caller drops its own.
    """

    def __init__(self, params, cfg: ModelConfig, scfg: ServeConfig):
        self.params = cast_weights(params, cfg)
        self.cfg = cfg
        self.scfg = scfg
        self.device = params["embed"].device
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed)

    def _sample(self, logits):
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].to(
            torch.int32)

    def generate(self, prompts: np.ndarray, n_new: int, *,
                 vision_embeds=None, enc_embeds=None) -> np.ndarray:
        """prompts: [B, S_prompt] int32 -> [B, n_new] generated tokens (a
        host int32 array)."""
        kw = {}
        if vision_embeds is not None:
            kw["vision_embeds"] = torch.as_tensor(vision_embeds,
                                                  device=self.device)
        if enc_embeds is not None:
            kw["enc_embeds"] = torch.as_tensor(enc_embeds, device=self.device)
        toks = torch.as_tensor(np.asarray(prompts), device=self.device)
        logits, cache = prefill(self.params, self.cfg, toks,
                                self.scfg.max_len, **kw)
        out = []
        tok = self._sample(logits)[:, None]
        out.append(tok)
        for _ in range(n_new - 1):
            logits, cache = decode_step(self.params, self.cfg, tok,
                                        cache)
            tok = self._sample(logits)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)


@dataclasses.dataclass
class GNNServeConfig:
    policy: str = "auto"   # dispatch policy for the aggregation SpMM
    d: Optional[int] = None  # planning feature width (inferred if None)
    model: str = "gcn"     # "gcn" | "gat"
    fuse: bool = True      # fused epilogue (GCN) / one-pass attention (GAT)


def _infer_planning_width(params) -> int:
    """Feature width the SpMM plan prices: the first layer's output
    width under the ``{"w": [...]}`` convention, else the first 2-D
    tensor found in the params (any layer's width ranks the paths the
    same way)."""
    ws = params.get("w") if isinstance(params, dict) else None
    if isinstance(ws, (list, tuple)):
        ws = ws[0] if ws else None
    if ws is not None and getattr(ws, "ndim", 0) == 2:
        return int(ws.shape[1])
    stack = [params]
    while stack:
        leaf = stack.pop(0)
        if isinstance(leaf, dict):
            stack.extend(leaf.values())
        elif isinstance(leaf, (list, tuple)):
            stack.extend(leaf)
        elif getattr(leaf, "ndim", 0) == 2:
            return int(leaf.shape[1])
    raise ValueError(
        "could not infer a planning feature width from the params "
        "(no 2-D weight leaf); pass GNNServeConfig(d=...) explicitly")


class GNNServingEngine:
    """Serves GCN or GAT node classification over a fixed graph, on the
    graph's device (``build_graph(..., device=...)``; the card by
    default)."""

    def __init__(self, params, graph: Graph,
                 scfg: Optional[GNNServeConfig] = None):
        self.params = params
        self.graph = graph
        self.scfg = scfg or GNNServeConfig()
        if graph.adj is None or graph.adj.stats is None:
            raise ValueError(
                "GNNServingEngine: Graph adjacency has no sparsity stats; "
                "construct it with build_graph()")
        if self.scfg.model not in ("gcn", "gat"):
            raise ValueError(
                f"GNNServeConfig.model must be 'gcn' or 'gat', got "
                f"{self.scfg.model!r}")
        d = self.scfg.d if self.scfg.d is not None \
            else _infer_planning_width(params)
        cand = graph_candidates(graph.adj) or GRAPH_PATHS
        fuse = self.scfg.fuse
        if self.scfg.model == "gat" and fuse:
            # one-pass attention: priced as a single stream of the
            # topology at the combined (score + value) width
            self.plan = plan_fused_attention(
                graph.adj.stats, 2, d, policy=self.scfg.policy,
                device=graph.device, candidates=cand)
        else:
            self.plan = plan_spmm(graph.adj.stats, d,
                                  policy=self.scfg.policy,
                                  device=graph.device, candidates=cand)
        # an unfused GAT samples on the element pattern, so the layout
        # plan applies to the fused pipeline and to GCN only
        self._policy = self.scfg.policy \
            if self.scfg.model == "gat" and not fuse else self.plan.path
        self.n_requests = 0

    @property
    def device(self) -> torch.device:
        return self.graph.device

    def infer(self, x) -> torch.Tensor:
        """x: [n_nodes, in_features] (numpy or tensor) -> logits
        [n_nodes, n_classes] on the engine's device."""
        with obs.span("serve.infer"):
            self.n_requests += 1
            x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            forward = gat_forward if self.scfg.model == "gat" \
                else gcn_forward
            with torch.no_grad():
                return forward(self.params, self.graph, x,
                               policy=self._policy, fuse=self.scfg.fuse)

    def classify(self, x) -> torch.Tensor:
        return self.infer(x).argmax(dim=-1)

    def dispatch_report(self) -> Dict:
        """Which path serves this graph's traffic, and why."""
        stats = self.graph.adj.stats
        return {
            "model": self.scfg.model,
            "fused": self.scfg.fuse,
            "plan_op": self.plan.op,
            "path": self.plan.path,
            "policy": self.plan.policy,
            "reason": self.plan.reason,
            "use_kernel": self.plan.use_kernel,
            "density": stats.density,
            "occupancy": stats.occupancy,
            "padded_stream_blowup": stats.padded_stream_blowup,
            "n_requests": self.n_requests,
            "plan_cache": self.graph.adj.plan_cache.stats(),
            "plan_cache_global": plan_cache_stats(),
        }


# ---------------------------------------------------------------------------
# Batched multi-graph serving (micro-batching over the bucketed executor)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchServeConfig:
    """Micro-batching window and bucketed-executor knobs."""

    max_batch: int = 32        # flush when this many requests are queued
    max_delay_ms: float = 5.0  # ... or when the oldest waits this long
    queue_depth: int = 1024    # bounded admission queue
    policy: str = "auto"       # dispatch policy inside the executor
    form: str = "auto"         # bucket form: auto | csr | ell
    max_executors: int = 64    # LRU cap on cached executors
    growth: float = 2.0        # bucket grid growth factor
    fuse: bool = True          # fused epilogue inside the GCN executor
    # opt into the traffic-fitted bucket grid (an AdaptiveBucketLadder;
    # ``ladder`` overrides its LadderConfig)
    adaptive: bool = False
    ladder: Any = None
    # -- resilience -----------------------------------------------------------
    retry: RetryPolicy = RetryPolicy()  # per-request backoff + allowance
    retry_budget: int = 64              # engine-wide retry tokens
    retry_refill_per_s: float = 8.0
    guard_nonfinite: bool = True        # quarantine NaN/Inf outputs
    default_timeout_s: Optional[float] = 60.0  # infer() deadline
    max_worker_restarts: int = 3
    seed: int = 0                       # backoff-jitter rng
    device: str = "cuda"                # where requests' graphs live


@dataclasses.dataclass
class _Request:
    matrix: Any                # SparseMatrix adjacency
    features: Any              # [n_nodes, d]
    future: Future
    t_submit: float
    attempts: int = 0          # transient retries consumed
    tag: Any = None            # chaos/match + caller bookkeeping label


class BatchServingEngine:
    """Serves a stream of (graph, features) requests with micro-batching.

    Requests enter a bounded queue; a worker thread drains it into
    micro-batches (flushing on ``max_batch`` or the ``max_delay_ms``
    deadline), groups each flush by shape bucket, and runs every group as
    one block-diagonal batch through a
    :class:`repro_torch.batch.BucketedExecutor`.

    ``fn(matrix, h)`` is the per-batch program (default: the planned
    ``matrix @ h``); with ``context`` set (e.g. model weights) it is
    called ``fn(context, matrix, h)``.  :meth:`for_gcn` serves GCN node
    classification with shared weights.  Graphs must lie on
    ``scfg.device`` (the card by default).
    """

    def __init__(self, fn: Optional[Callable] = None, *,
                 context: Any = None,
                 scfg: Optional[BatchServeConfig] = None):
        from repro_torch.batch import BucketedExecutor
        from repro_torch.batch.bucketing import BucketingConfig

        self.scfg = scfg or BatchServeConfig()
        self.device = resolve_device(self.scfg.device)
        ladder = None
        if self.scfg.adaptive:
            from repro_torch.serve.runtime.ladder import (
                AdaptiveBucketLadder, LadderConfig)

            lcfg = self.scfg.ladder
            if lcfg is None:
                lcfg = LadderConfig()
            ladder = (lcfg if isinstance(lcfg, AdaptiveBucketLadder)
                      else AdaptiveBucketLadder(lcfg))
        self.executor = BucketedExecutor(
            fn,
            context=context,
            form=self.scfg.form,
            policy=self.scfg.policy,
            max_batch=self.scfg.max_batch,
            max_executors=self.scfg.max_executors,
            bucketing=BucketingConfig(growth=self.scfg.growth),
            ladder=ladder,
        )
        self._queue: "queue_mod.Queue[_Request]" = queue_mod.Queue(
            maxsize=self.scfg.queue_depth)
        self._latencies_ms: List[float] = []
        self._flushes = {"full": 0, "deadline": 0}
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._close_lock = threading.Lock()
        self._close_once = threading.Lock()
        self._stop = threading.Event()
        self._rng = np.random.default_rng(self.scfg.seed)
        self._budget = RetryBudget(self.scfg.retry_budget,
                                   self.scfg.retry_refill_per_s)
        self._quarantined = 0
        self._sup = WorkerSupervisor(
            "batch-serve", self._serve_loop,
            max_restarts=self.scfg.max_worker_restarts)
        self._sup.start()

    @property
    def _worker(self) -> threading.Thread:
        """The current serving thread (restarts under the supervisor)."""
        return self._sup._thread

    @classmethod
    def for_gcn(cls, params, *, scfg: Optional[BatchServeConfig] = None,
                ) -> "BatchServingEngine":
        """Engine running a shared-weight GCN over each batch.

        The block-diagonal composition makes the batched forward exact:
        the weights are node-independent, so ``diag(A_1..A_N) @ (H W)``
        aggregates every graph at once.
        """
        cfg = scfg or BatchServeConfig()
        policy, fuse = cfg.policy, cfg.fuse

        def fwd(p, mat, h):
            g = Graph(adj=mat, n_nodes=mat.shape[0])
            return gcn_forward(p, g, h, policy=policy, fuse=fuse)

        return cls(fwd, context=params, scfg=scfg)

    # -- submission ---------------------------------------------------------

    def submit(self, matrix, features, *, tag: Any = None) -> Future:
        """Enqueue one request; resolves to [n_nodes, d_out] (numpy).

        ``matrix`` is the graph's (normalized) adjacency as a
        ``SparseMatrix``, or a ``Graph``, whose adjacency is taken; it
        must lie on the engine's device.  Blocks while the admission queue
        is full.  A dead serving worker is restarted here (bounded by
        ``max_worker_restarts``).
        """
        if self._stop.is_set():
            raise EngineClosedError("engine is closed")
        self._sup.ensure()
        adj = getattr(matrix, "adj", matrix)
        if adj.device != self.device:
            raise ValueError(f"graph is on {adj.device}, the engine on "
                             f"{self.device}")
        with obs.span("serve.admit", engine="batch"):
            req = _Request(matrix=adj, features=features, future=Future(),
                           t_submit=time.perf_counter(), tag=tag)
            if self._t_first is None:
                self._t_first = req.t_submit
            self._submitted += 1
            self._queue.put(req)
        if self._stop.is_set():
            # close() may have drained between our check and the put;
            # sweep again so no request can strand in a dead queue
            self._fail_queued()
        return req.future

    def infer(self, matrix, features, *,
              timeout: Optional[float] = None) -> np.ndarray:
        """Synchronous :meth:`submit`.  ``timeout`` (default
        ``scfg.default_timeout_s``) bounds the wait; expiry raises
        :class:`DeadlineExceededError` (a :class:`TimeoutError`)."""
        t = self.scfg.default_timeout_s if timeout is None else timeout
        try:
            return self.submit(matrix, features).result(t)
        except DeadlineExceededError:
            raise
        except (TimeoutError, _FutTimeout):
            raise DeadlineExceededError(
                f"infer: no result within {t}s") from None

    # -- worker -------------------------------------------------------------

    def _serve_loop(self) -> None:
        with device_scope(self.device):
            self._serve()

    def _serve(self) -> None:
        while not self._stop.is_set():
            # chaos fires before any request is picked up, so an injected
            # worker death strands nothing
            try:
                chaos.hook("serve.worker")
            except chaos.WorkerKilled:
                return  # injected death: the supervisor restarts us
            except Exception:
                continue  # any other injected fault: keep serving
            try:
                first = self._queue.get(timeout=0.05)
            except queue_mod.Empty:
                continue
            batch = [first]
            try:
                self._collect_and_flush(batch)
            except BaseException as exc:  # noqa: BLE001 — worker dying
                # must not strand the futures it already picked up
                for r in batch:
                    with self._close_lock:
                        self._completed += 1
                        self._failed += 1
                    if not r.future.done() and not r.future.cancelled():
                        r.future.set_exception(
                            RuntimeError(f"serving worker died: {exc!r}"))
                raise

    def _collect_and_flush(self, batch: List[_Request]) -> None:
        # a negative max_delay_ms degrades to greedy flushing; it must
        # never reach Queue.get as a negative timeout (ValueError)
        window_s = max(self.scfg.max_delay_ms, 0.0) / 1e3
        # the window anchors at the oldest request's submit time; requests
        # already queued are always taken, the deadline only bounds how
        # long we wait for more
        deadline = batch[0].t_submit + window_s
        while len(batch) < self.scfg.max_batch:
            try:
                batch.append(self._queue.get_nowait())
                continue
            except queue_mod.Empty:
                pass
            # clamped to [0, window]: a request that sat queued past its
            # window flushes now, and skewed timestamps wait one window
            remaining = min(deadline - time.perf_counter(), window_s)
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue_mod.Empty:
                break
        self._flushes["full" if len(batch) >= self.scfg.max_batch
                      else "deadline"] += 1
        self._flush(batch)

    def _flush(self, batch: List[_Request]) -> None:
        outs, exc = self._try_run(batch)
        if exc is None:
            self._complete(batch, outs)
        else:
            self._recover(batch, exc)

    def _try_run(self, batch: List[_Request]):
        """Run the batch; returns (outs, None) or (None, exc)."""
        tags = [r.tag for r in batch if r.tag is not None]
        try:
            with obs.span("serve.flush", engine="batch", n=len(batch)):
                chaos.hook("serve.flush", tags=tags, n=len(batch))
                outs = self.executor.run([r.matrix for r in batch],
                                         [r.features for r in batch])
            return outs, None
        except Exception as exc:  # noqa: BLE001 — classified by _recover
            return None, exc

    def _complete(self, batch: List[_Request], outs) -> None:
        t_done = time.perf_counter()
        self._t_last = t_done
        lat_hist = obs.histogram("serve_latency_ms", engine="batch")
        for r, y in zip(batch, outs):
            if self.scfg.guard_nonfinite and not np.isfinite(y).all():
                self._fail_requests([r], NaNOutputError(
                    "non-finite output quarantined "
                    f"(request rows={np.shape(y)[0]})"), quarantine="nan")
                continue
            lat_ms = (t_done - r.t_submit) * 1e3
            self._latencies_ms.append(lat_ms)
            lat_hist.observe(lat_ms)
            with self._close_lock:
                self._completed += 1
            if not r.future.cancelled():
                r.future.set_result(y)

    def _recover(self, batch: List[_Request], exc, *,
                 retried: bool = False) -> None:
        """A flush failed: retry, bisect, quarantine.  Innocent co-batched
        requests complete from the bisection probes; only the pinned
        culprit fails."""
        kind = classify(exc)
        if kind == FATAL:
            self._fail_requests(batch, exc)
            return
        if len(batch) == 1:
            r = batch[0]
            if kind == POISON:
                self._fail_requests(batch, exc, quarantine="poison")
                return
            r.attempts += 1
            if self.scfg.retry.allows(r.attempts + 1) \
                    and self._budget.spend():
                obs.counter("resilience_retries_total",
                            site="serve.flush", kind=kind).inc()
                time.sleep(self.scfg.retry.backoff_s(
                    r.attempts + 1, self._rng))
                outs, exc2 = self._try_run(batch)
                if exc2 is None:
                    self._complete(batch, outs)
                else:
                    self._recover(batch, exc2, retried=True)
                return
            self._fail_requests(batch, TransientExecutorError(
                f"retries exhausted after {r.attempts} attempts "
                f"(last error: {exc!r})"))
            return
        if kind == TRANSIENT and not retried and self._budget.spend():
            obs.counter("resilience_retries_total",
                        site="serve.flush", kind=kind).inc()
            time.sleep(self.scfg.retry.backoff_s(2, self._rng))
            outs, exc2 = self._try_run(batch)
            if exc2 is None:
                self._complete(batch, outs)
                return
            exc, kind = exc2, classify(exc2)
            if kind == FATAL:
                self._fail_requests(batch, exc)
                return
        mid = len(batch) // 2
        for half in (batch[:mid], batch[mid:]):
            outs, exc_h = self._try_run(half)
            if exc_h is None:
                self._complete(half, outs)
            else:
                self._recover(half, exc_h, retried=True)

    def _fail_requests(self, batch: List[_Request], exc, *,
                       quarantine: Optional[str] = None) -> None:
        self._t_last = time.perf_counter()
        for r in batch:
            if quarantine is not None:
                self._quarantined += 1
                obs.counter("resilience_quarantined_total",
                            kind=quarantine).inc()
            with self._close_lock:
                self._completed += 1  # resolved (with an error): drain
                self._failed += 1     # must not wait on these
            if not r.future.done() and not r.future.cancelled():
                r.future.set_exception(exc)

    # -- lifecycle ----------------------------------------------------------

    def drain(self, timeout: float = 60.0) -> None:
        """Block until everything submitted so far has completed."""
        t0 = time.perf_counter()
        while self._completed < self._submitted:
            if not self._stop.is_set() and not self._sup.ensure():
                # the worker is dead beyond its restart budget: fail the
                # queued futures now instead of spinning to the timeout
                self._fail_queued()
                if self._completed < self._submitted:
                    raise RuntimeError(
                        "drain: serving worker died with "
                        f"{self._submitted - self._completed} requests "
                        "in flight")
                return
            if time.perf_counter() - t0 > timeout:
                raise TimeoutError(
                    f"drain: {self._submitted - self._completed} requests "
                    f"still pending after {timeout}s")
            time.sleep(0.002)

    def reset_metrics(self) -> None:
        """Zero the traffic counters (e.g. after a warm-up pass); executor
        state is kept.  Call with no work in flight (after :meth:`drain`).
        """
        if self._completed < self._submitted:
            raise RuntimeError("reset_metrics with requests in flight; "
                               "drain() first")
        self._latencies_ms.clear()
        self._flushes = {"full": 0, "deadline": 0}
        self._t_first = self._t_last = None
        self._submitted = self._completed = self._failed = 0
        self._quarantined = 0

    def _fail_queued(self) -> None:
        """Fail everything still queued so no future blocks forever."""
        while True:
            try:
                req = self._queue.get_nowait()
            except queue_mod.Empty:
                return
            with self._close_lock:
                self._completed += 1
                self._failed += 1
            if not req.future.cancelled():
                req.future.set_exception(EngineClosedError("engine closed"))

    def close(self) -> None:
        """Shut down, leaving no future unresolved: everything admitted
        before close is drained (results, not errors); only if the drain
        cannot finish are the leftovers failed.  Idempotent and safe under
        concurrent callers."""
        with self._close_once:
            if not self._stop.is_set():
                try:
                    self.drain()
                except Exception:  # noqa: BLE001 — still sweep below
                    pass
            self._stop.set()
            self._sup.join(timeout=5.0)
            self._fail_queued()

    def __enter__(self) -> "BatchServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reporting ----------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """Throughput, latency percentiles, compile and padding counters
        (canonical keys ``p50_ms`` / ``p99_ms``; ``latency_ms_p50`` /
        ``latency_ms_p99`` resolve through deprecation aliases)."""
        lat = np.asarray(self._latencies_ms, np.float64)
        elapsed = ((self._t_last - self._t_first)
                   if (self._t_first is not None
                       and self._t_last is not None) else 0.0)
        return obs.renamed_keys({
            "submitted": self._submitted,
            "completed": self._completed,
            "failed": self._failed,
            "req_per_s": (self._completed / elapsed) if elapsed > 0 else 0.0,
            "p50_ms": float(np.percentile(lat, 50)) if len(lat) else 0.0,
            "p99_ms": float(np.percentile(lat, 99)) if len(lat) else 0.0,
            "flushes": dict(self._flushes),
            "executor": self.executor.report(),
            "resilience": {
                "quarantined": self._quarantined,
                "retry_tokens": self._budget.remaining(),
                "worker_restarts": self._sup.restarts,
            },
        }, {"latency_ms_p50": "p50_ms", "latency_ms_p99": "p99_ms"})


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """The prefill entry (the prefill_* cells).  Takes the batch as a dict
    so modality side-inputs can never be positionally confused."""

    def prefill_step(params, batch):
        kw = {}
        if cfg.vision_tokens and "vision_embeds" in batch:
            kw["vision_embeds"] = batch["vision_embeds"]
        if cfg.encoder_layers and "enc_embeds" in batch:
            kw["enc_embeds"] = batch["enc_embeds"]
        logits, cache = prefill(params, cfg, batch["tokens"], max_len, **kw)
        return logits, cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """The single-token decode entry (the decode_* cells)."""

    def serve_step(params, token, cache):
        return decode_step(params, cfg, token, cache)

    return serve_step

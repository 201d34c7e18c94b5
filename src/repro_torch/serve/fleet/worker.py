"""The fleet worker loop: one engine, one carrier, one heartbeat (the port
of ``repro.serve.fleet.worker``).

A :class:`FleetWorker` runs inside its handle's thread or process and
hosts a private serving engine on ``WorkerConfig.device`` (the card by
default; a worker that names CUDA and finds none raises, it never serves
on the CPU) — by default a foreground
:class:`~repro_torch.serve.runtime.continuous.ContinuousBatchEngine`
(``background=False``, ``adaptive=False``: the worker steps it inline,
and a fixed bucket grid keeps every worker's dispatch byte-identical so
failover can't change results).  The loop:

* admits ``("req", rid, payload)`` into the engine, steps it, and ships
  each resolved future back as ``("res", rid, ok, value)`` — ``value`` a
  host numpy array (never a tensor) or an encoded error;
* emits ``("hb", seq, pending)`` from a side thread every
  ``heartbeat_interval_s`` — the parent's missed-heartbeat detection
  watches these;
* honors ``("hang", seconds)`` by wedging both the loop and the
  heartbeat thread (chaos uses this to simulate a live-but-stuck
  worker: the process is alive, the heartbeats are not);
* pre-compiles lanes on ``("warm", payloads)`` and answers ``("ready",)``
  once hot — a spawned worker joins the rotation already compiled;
* tracks ``("cancel", rid)`` so a hedged request's loser is dropped at
  the worker instead of shipped back as a duplicate.

``WorkerConfig`` is deliberately primitives-only: it must pickle into a
``spawn`` child.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.serve.fleet import rpc


@dataclasses.dataclass
class WorkerConfig:
    """Engine + cadence knobs for one fleet worker (picklable)."""

    engine: str = "continuous"    # "continuous" | "batch"
    slots: int = 4                # continuous: slot pool per lane
    policy: str = "auto"
    form: str = "auto"
    max_wait_ms: float = 2.0      # lane age-out (continuous)
    max_batch: int = 8            # batch engine flush size
    max_delay_ms: float = 2.0     # batch engine window
    retry_attempts: int = 3
    heartbeat_interval_s: float = 0.02
    poll_interval_s: float = 0.002
    block_m: int = 16             # SparseMatrix rebuild geometry
    block_n: int = 16
    formats: Tuple[str, ...] = ("ell", "csr")
    seed: int = 0
    device: str = "cuda"          # where the worker's engine and graphs live


def _plain(obj):
    """Recursively strip report dicts / numpy scalars / tensors to
    picklable builtins (worker reports cross the process boundary, and
    no tensor may)."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, (torch.device, torch.dtype)):
        return str(obj)
    return obj


class FleetWorker:
    """The loop run by a worker thread/process (see module docstring)."""

    def __init__(self, cfg: WorkerConfig, name: str = "worker"):
        self.cfg = cfg
        self.name = name
        self._pending: Dict[int, Any] = {}     # rid -> future
        self._cancelled: Set[int] = set()
        self._stop = False
        self._hang_until: Optional[float] = None  # monotonic deadline
        self._hang_lock = threading.Lock()
        self._engine = None

    # -- engine -------------------------------------------------------------

    def _build_engine(self):
        from repro_torch.resilience.retry import RetryPolicy
        retry = RetryPolicy(max_attempts=self.cfg.retry_attempts,
                            base_ms=0.5, max_ms=5.0)
        if self.cfg.engine == "batch":
            from repro_torch.serve.engine import (BatchServeConfig,
                                                  BatchServingEngine)
            return BatchServingEngine(scfg=BatchServeConfig(
                max_batch=self.cfg.max_batch,
                max_delay_ms=self.cfg.max_delay_ms,
                policy=self.cfg.policy, form=self.cfg.form,
                retry=retry, seed=self.cfg.seed, device=self.cfg.device))
        from repro_torch.serve.runtime.continuous import (
            ContinuousBatchEngine, ContinuousConfig)
        return ContinuousBatchEngine(cfg=ContinuousConfig(
            slots=self.cfg.slots, policy=self.cfg.policy,
            form=self.cfg.form, max_wait_ms=self.cfg.max_wait_ms,
            adaptive=False, background=False,
            retry=retry, seed=self.cfg.seed, device=self.cfg.device))

    def _submit(self, payload) -> Any:
        mat, h, steps = rpc.decode_request(
            payload, formats=self.cfg.formats,
            block=(self.cfg.block_m, self.cfg.block_n),
            device=self._engine.device)
        if self.cfg.engine == "batch":
            if steps != 1:
                raise ValueError("batch engine serves single-step only")
            return self._engine.submit(mat, h)
        return self._engine.submit(mat, h, steps=steps)

    # -- hang plumbing ------------------------------------------------------

    def _hanging(self) -> bool:
        with self._hang_lock:
            if self._hang_until is None:
                return False
            if time.monotonic() >= self._hang_until:
                self._hang_until = None
                return False
            return True

    def _hang(self, seconds: Optional[float]) -> None:
        with self._hang_lock:
            self._hang_until = time.monotonic() + (
                float(seconds) if seconds else 3600.0)

    # -- heartbeat side thread ---------------------------------------------

    def _hb_loop(self, ep: rpc.Endpoint) -> None:
        seq = 0
        while not self._stop and not ep.killed():
            if not self._hanging():
                seq += 1
                try:
                    ep.send(("hb", seq, len(self._pending)))
                except Exception:  # noqa: BLE001 — carrier died; loop exits
                    return
            time.sleep(self.cfg.heartbeat_interval_s)

    # -- result shipping ----------------------------------------------------

    def _flush(self, ep: rpc.Endpoint) -> None:
        done = [rid for rid, f in self._pending.items() if f.done()]
        for rid in done:
            fut = self._pending.pop(rid)
            if rid in self._cancelled:
                self._cancelled.discard(rid)
                exc = fut.exception()  # consume; loser result is dropped
                del exc
                continue
            exc = fut.exception()
            if exc is None:
                # the engines resolve to host arrays; a tensor would be
                # copied here, since no tensor may cross the carrier
                ep.send(("res", rid, True, rpc.to_host(fut.result())))
            else:
                ep.send(("res", rid, False, rpc.encode_error(exc)))

    def _step_engine(self) -> None:
        if self.cfg.engine == "continuous":
            self._engine.step()
        # the batch engine runs its own serve thread; nothing to step

    def _drain_engine(self, ep: rpc.Endpoint, timeout: float = 30.0) -> None:
        t0 = time.monotonic()
        while self._pending and time.monotonic() - t0 < timeout \
                and not ep.killed():
            if self.cfg.engine == "continuous":
                self._engine.step(force=True)
            else:
                time.sleep(self.cfg.poll_interval_s)
            self._flush(ep)

    def _warm(self, payloads) -> None:
        futs = []
        for payload in payloads:
            try:
                futs.append(self._submit(payload))
            except Exception:  # noqa: BLE001 — a bad sample must not
                pass           # keep the worker from coming up
        t0 = time.monotonic()
        while any(not f.done() for f in futs) \
                and time.monotonic() - t0 < 30.0:
            if self.cfg.engine == "continuous":
                self._engine.step(force=True)
            else:
                time.sleep(self.cfg.poll_interval_s)

    # -- main loop ----------------------------------------------------------

    def run(self, ep: rpc.Endpoint) -> None:
        # heartbeats start before the engine exists: building it pays
        # the CUDA start-up, and a worker must not read as dead while it
        # is warming up
        hb = threading.Thread(target=self._hb_loop, args=(ep,), daemon=True,
                              name=f"fleet-{self.name}-hb")
        hb.start()
        self._engine = self._build_engine()
        ep.send(("ready",))
        try:
            while not self._stop and not ep.killed():
                if self._hanging():
                    time.sleep(self.cfg.poll_interval_s)
                    continue
                msg = ep.recv(timeout=self.cfg.poll_interval_s)
                if msg is not None:
                    self._handle(ep, msg)
                    if self._stop:
                        break
                self._step_engine()
                self._flush(ep)
        finally:
            self._stop = True
            try:
                self._engine.close()
            except Exception:  # noqa: BLE001
                pass
            # the beat loop ends within one interval of _stop: a spawned
            # worker must not exit with it still running (a CUDA process
            # whose daemon thread is torn down at exit can abort)
            hb.join(timeout=1.0)

    def _handle(self, ep: rpc.Endpoint, msg: rpc.Message) -> None:
        kind = msg[0]
        if kind == "req":
            _, rid, payload = msg
            try:
                self._pending[rid] = self._submit(payload)
            except Exception as e:  # noqa: BLE001 — decode/admit failure
                ep.send(("res", rid, False, rpc.encode_error(e)))
        elif kind == "cancel":
            rid = msg[1]
            if rid in self._pending:
                self._cancelled.add(rid)
        elif kind == "warm":
            self._warm(msg[1])
            ep.send(("ready",))
        elif kind == "hang":
            self._hang(msg[1])
        elif kind == "report":
            try:
                report = _plain(dict(self._engine.report()))
            except Exception as e:  # noqa: BLE001
                report = {"error": str(e)}
            ep.send(("report_res", msg[1], report))
        elif kind == "drain":
            self._drain_engine(ep)
            ep.send(("drained", msg[1]))
        elif kind == "stop":
            self._drain_engine(ep, timeout=5.0)
            ep.send(("bye",))
            self._stop = True


def _process_main(name: str, cfg_dict: Dict[str, Any], in_q, out_q) -> None:
    """Spawn-child entry point (top-level so it pickles by name)."""
    cfg_dict = dict(cfg_dict)
    cfg_dict["formats"] = tuple(cfg_dict.get("formats", ("ell", "csr")))
    cfg = WorkerConfig(**cfg_dict)
    ep = rpc.Endpoint(in_q, out_q)
    FleetWorker(cfg, name=name).run(ep)


__all__ = ["FleetWorker", "WorkerConfig"]

"""Transport shim between the fleet parent and its workers (the port of
``repro.serve.fleet.rpc``).

One protocol, two carriers:

* :class:`ThreadHandle` — the worker loop runs on a daemon thread in
  this process, messages move over two in-process queues, and ``kill()``
  flips an event the worker polls (simulating SIGKILL: the loop stops
  mid-iteration and anything it had not yet sent is lost).  This is the
  deterministic backend tier-1 tests use.
* :class:`ProcessHandle` — the worker runs in a real ``spawn`` child
  process with two ``multiprocessing`` queues, and ``kill()`` is an
  actual SIGKILL.  Same protocol, real failure surface; exercised by
  the slow tests, the fleet benchmark, and the CI soak.

Messages are plain picklable tuples (``(kind, *args)``):

====================================  ====================================
parent → worker                       worker → parent
====================================  ====================================
``("req", rid, payload)``             ``("ready",)`` — warmup done
``("cancel", rid)``                   ``("hb", seq, pending)``
``("warm", [payload, ...])``          ``("res", rid, ok, value)``
``("hang", seconds | None)``          ``("report_res", token, report)``
``("report", token)``                 ``("drained", token)``
``("drain", token)``                  ``("bye",)`` — clean exit
``("stop",)``
====================================  ====================================

``payload`` is the :func:`encode_request` dict (dense adjacency +
features + steps, all numpy) — workers rebuild the
:class:`~repro_torch.sparse.matrix.SparseMatrix` themselves, on their own
device, so no tensor (and no CUDA tensor) crosses the pipe; results come
back as host numpy arrays.  A failed request's ``value`` is the
:func:`encode_error` pair, decoded parent-side against the
:mod:`repro_torch.resilience.errors` taxonomy (a failed kernel arrives as
``KernelError``, which nothing retries).

Process workers start with ``spawn`` only: a forked child of a parent
that has touched CUDA cannot use the card.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.resilience import errors as _errors

Message = Tuple[Any, ...]


class TransportError(RuntimeError):
    """The carrier to/from a worker is broken (dead process, closed
    pipe, unpicklable frame).  The fleet treats it as a worker death."""


# ---------------------------------------------------------------------------
# Request / error codecs
# ---------------------------------------------------------------------------


def to_host(x, dtype=None) -> np.ndarray:
    """``x`` as a host numpy array: a tensor on any device is copied to
    the host once; anything else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def encode_request(matrix, features, steps: int = 1) -> Dict[str, Any]:
    """Flatten a request to numpy so it survives pickling to a worker.

    ``matrix`` may be a SparseMatrix (or anything with ``to_dense()``),
    a Graph-like object carrying ``.matrix``, or a dense array or tensor;
    ``features`` an array or a tensor on any device.
    """
    if hasattr(matrix, "matrix"):  # Graph-like wrapper
        matrix = matrix.matrix
    if hasattr(matrix, "to_dense"):  # SparseMatrix, or a torch tensor
        matrix = matrix.to_dense()
    return {"dense": to_host(matrix, np.float32),
            "h": to_host(features, np.float32),
            "steps": int(steps)}


def decode_request(payload: Dict[str, Any], *, formats=("ell", "csr"),
                   block=(16, 16), device="cuda"):
    """Worker-side: rebuild (SparseMatrix on ``device``, features,
    steps); raises if ``device`` names CUDA and there is none."""
    from repro_torch.sparse.matrix import SparseMatrix
    mat = SparseMatrix.from_dense(payload["dense"], formats=tuple(formats),
                                  block=tuple(block), device=device)
    return mat, payload["h"], payload["steps"]


def lane_key(payload: Dict[str, Any]) -> Tuple[int, int]:
    """Affinity key of a request: (pow2-quantized rows, feature dim).

    Matches the engine's bucket quantization closely enough that two
    requests with equal keys land in the same compiled lane, which is
    what router stickiness exists to exploit.
    """
    rows = int(payload["dense"].shape[0])
    d = int(payload["h"].shape[1])
    b = 1
    while b < rows:
        b <<= 1
    return (b, d)


def encode_error(exc: BaseException) -> Tuple[str, str]:
    return (type(exc).__name__, str(exc))


def decode_error(pair: Tuple[str, str]) -> Exception:
    """Map a (class-name, message) pair back onto the taxonomy; unknown
    names decode as TransientExecutorError (the safe retry class)."""
    name, msg = pair
    cls = getattr(_errors, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException):
        return cls(msg)
    return _errors.TransientExecutorError(f"{name}: {msg}")


# ---------------------------------------------------------------------------
# Worker-side endpoint (constructed inside the worker thread/process)
# ---------------------------------------------------------------------------


class Endpoint:
    """The worker's two-way view of its carrier."""

    def __init__(self, inbox, outbox, killed=None):
        self._in = inbox
        self._out = outbox
        self._killed = killed or (lambda: False)

    def recv(self, timeout: float) -> Optional[Message]:
        try:
            return self._in.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    def send(self, msg: Message) -> None:
        if self._killed():
            return  # a SIGKILLed process can't speak either
        self._out.put(msg)

    def killed(self) -> bool:
        return self._killed()


# ---------------------------------------------------------------------------
# Parent-side handles
# ---------------------------------------------------------------------------


class ThreadHandle:
    """In-process worker on a daemon thread; ``kill()`` flips an event
    the worker polls every iteration — messages already queued outbound
    may still arrive (exactly like a real kill racing the pipe), which
    is why the router's journal dedupes completions."""

    backend = "thread"

    def __init__(self, name: str, worker_cfg) -> None:
        from repro_torch.serve.fleet.worker import FleetWorker
        self.name = name
        self._in: queue_mod.Queue = queue_mod.Queue()
        self._out: queue_mod.Queue = queue_mod.Queue()
        self._kill_evt = threading.Event()
        ep = Endpoint(self._in, self._out, self._kill_evt.is_set)
        worker = FleetWorker(worker_cfg, name=name)
        self._thread = threading.Thread(
            target=worker.run, args=(ep,), daemon=True,
            name=f"fleet-{name}")
        self._thread.start()

    @property
    def pid(self) -> Optional[int]:
        return None

    def send(self, msg: Message) -> None:
        if self._kill_evt.is_set():
            raise TransportError(f"worker {self.name} is killed")
        self._in.put(msg)

    def poll(self, timeout: float) -> Optional[Message]:
        try:
            return self._out.get(timeout=timeout)
        except queue_mod.Empty:
            return None

    def alive(self) -> bool:
        return self._thread.is_alive() and not self._kill_evt.is_set()

    def kill(self) -> None:
        self._kill_evt.set()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout=timeout)


class ProcessHandle:
    """Real ``spawn`` child process; ``kill()`` is SIGKILL.  The child
    starts in :mod:`repro_torch.serve.fleet_child`, which beats while the
    worker (and torch) import."""

    backend = "process"

    def __init__(self, name: str, worker_cfg) -> None:
        import dataclasses

        from repro_torch.serve import fleet_child
        self.name = name
        ctx = mp.get_context("spawn")
        self._in = ctx.Queue()
        self._out = ctx.Queue()
        self._proc = ctx.Process(
            target=fleet_child.main,
            args=(name, dataclasses.asdict(worker_cfg), self._in, self._out),
            daemon=True, name=f"fleet-{name}")
        self._proc.start()

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid

    def send(self, msg: Message) -> None:
        if not self._proc.is_alive():
            raise TransportError(f"worker {self.name} process is dead")
        try:
            self._in.put(msg)
        except (ValueError, OSError) as e:  # closed queue / broken pipe
            raise TransportError(str(e)) from e

    def poll(self, timeout: float) -> Optional[Message]:
        try:
            return self._out.get(timeout=timeout)
        except queue_mod.Empty:
            return None
        except (EOFError, OSError, ValueError) as e:
            raise TransportError(str(e)) from e

    def alive(self) -> bool:
        return self._proc.is_alive()

    def kill(self) -> None:
        try:
            self._proc.kill()
        except (ValueError, AttributeError):
            pass  # already reaped
        # a killed worker's inbox may still hold frames its feeder
        # thread can never flush into the dead reader's full pipe; the
        # queue's atexit handler would join that stuck feeder forever
        # and block interpreter shutdown — cancel the join
        for q in (self._in, self._out):
            try:
                q.cancel_join_thread()
            except (OSError, ValueError):
                pass

    def join(self, timeout: Optional[float] = None) -> None:
        self._proc.join(timeout=timeout)


def make_handle(backend: str, name: str, worker_cfg):
    if backend == "thread":
        return ThreadHandle(name, worker_cfg)
    if backend == "process":
        return ProcessHandle(name, worker_cfg)
    raise ValueError(f"unknown fleet backend {backend!r}; "
                     "one of ('thread', 'process')")


__all__ = [
    "Endpoint", "Message", "ProcessHandle", "ThreadHandle", "TransportError",
    "decode_error", "decode_request", "encode_error", "encode_request",
    "lane_key", "make_handle",
]

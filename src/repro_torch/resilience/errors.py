"""Structured error taxonomy for the serving and training paths.

Every failure an engine can surface is one of these classes, so callers
(and the retry machinery) can tell *what kind* of failure happened and
therefore what to do about it:

* :class:`PoisonRequestError` — the request itself is the cause
  (malformed structure, non-finite output).  Retrying it anywhere would
  fail again; the request is quarantined and its co-batched neighbors
  are re-admitted.
* :class:`TransientExecutorError` — the infrastructure hiccuped (an
  executor exception, a latency blip, a dead thread).  The request is
  innocent; it is retried with backoff up to its retry budget.
* :class:`RequestShedError` — load shedding dropped the request before
  execution (queue over capacity, deadline already hopeless).
* :class:`DeadlineExceededError` — the request's deadline (or an
  ``infer(timeout=...)``) expired.  Subclasses :class:`TimeoutError` so
  plain ``except TimeoutError`` works.
* :class:`EngineClosedError` — the engine shut down; subclasses
  :class:`RuntimeError` for compatibility with pre-taxonomy callers.

``classify()`` maps an arbitrary exception onto the retry decision.
"""
from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class of every structured serving/training failure."""


class PoisonRequestError(ResilienceError):
    """The request itself is the deterministic cause of the failure.

    Not retryable: the request is quarantined (its future fails with
    this error) and any innocent co-batched requests are re-admitted.
    """


class NaNOutputError(PoisonRequestError):
    """The request's output contained NaN/Inf; the result is withheld
    (quarantined) instead of returned as garbage."""


class TransientExecutorError(ResilienceError):
    """Infrastructure failure independent of any one request; the work
    is retryable (with backoff, up to the retry budget)."""


class WorkerLostError(TransientExecutorError):
    """A fleet worker died with this request in flight and no survivor
    (or restart) could take it over within the failover budget.  The
    request itself is innocent — resubmitting it is safe."""


class RequestShedError(ResilienceError):
    """Load shedding dropped this request before execution."""


class DeadlineExceededError(TimeoutError, ResilienceError):
    """The request's deadline (or an ``infer`` timeout) expired."""


class EngineClosedError(ResilienceError):
    """The engine was closed; the request cannot be (or was not) run."""


#: classification tags returned by :func:`classify`
POISON = "poison"
TRANSIENT = "transient"
FATAL = "fatal"  # do not retry, do not blame the request (closed, ...)


def classify(exc: BaseException) -> str:
    """Retry decision for an exception raised during request execution.

    Unknown exceptions classify as *transient*: an executor blowing up
    under a co-batched workload is an infrastructure event until
    bisection pins it on a single request (which re-raises it wrapped
    in :class:`PoisonRequestError`).
    """
    if isinstance(exc, PoisonRequestError):
        return POISON
    if isinstance(exc, (EngineClosedError, DeadlineExceededError,
                        RequestShedError)):
        return FATAL
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return FATAL
    if isinstance(exc, (ValueError, TypeError)):
        # malformed request data (shape mismatch, bad dtype, ...) is
        # deterministic — retrying would fail identically, so the
        # request is quarantined with its original exception
        return POISON
    return TRANSIENT


__all__ = [
    "DeadlineExceededError", "EngineClosedError", "FATAL", "NaNOutputError",
    "POISON", "PoisonRequestError", "RequestShedError", "ResilienceError",
    "TRANSIENT", "TransientExecutorError", "WorkerLostError", "classify",
]

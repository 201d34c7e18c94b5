"""Retry policy (exponential backoff + jitter) and retry budget.

The policy decides *how long* to wait between attempts; the budget
decides *whether* a retry may run at all.  The budget is a token bucket
shared by an engine: under a fault storm it drains and further failures
fail fast as :class:`~repro_torch.resilience.errors.TransientExecutorError`
instead of amplifying load with synchronized retries.  Both are
deterministic given their seed.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch import obs
from repro_torch.resilience.errors import POISON, TRANSIENT, classify


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with decorrelating jitter.

    ``max_attempts`` counts *executions* (first try included): 3 means
    one try plus up to two retries.
    """

    max_attempts: int = 3
    base_ms: float = 1.0
    max_ms: float = 50.0
    multiplier: float = 2.0
    jitter: float = 0.5      # fraction of the backoff randomized away

    def backoff_s(self, attempt: int, rng: np.random.Generator) -> float:
        """Sleep before attempt ``attempt`` (attempt 2 = first retry)."""
        raw = self.base_ms * self.multiplier ** max(attempt - 2, 0)
        raw = min(raw, self.max_ms)
        if self.jitter > 0.0:
            raw *= 1.0 - self.jitter * float(rng.random())
        return raw / 1e3

    def allows(self, attempt: int) -> bool:
        return attempt <= self.max_attempts


class RetryBudget:
    """Token bucket bounding total retries an engine may run.

    Starts full at ``capacity``; each retry spends one token; tokens
    refill at ``refill_per_s``.  An exhausted budget makes ``spend()``
    return False — the caller fails fast instead of retrying.
    """

    def __init__(self, capacity: int = 64, refill_per_s: float = 8.0):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._tokens = float(capacity)
        self._t_last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = time.monotonic()
        self._tokens = min(
            self.capacity,
            self._tokens + (now - self._t_last) * self.refill_per_s)
        self._t_last = now

    def spend(self, n: int = 1) -> bool:
        with self._lock:
            self._refill()
            if self._tokens < n:
                return False
            self._tokens -= n
            return True

    def remaining(self) -> float:
        with self._lock:
            self._refill()
            return self._tokens


def call_with_retry(fn: Callable, *, policy: Optional[RetryPolicy] = None,
                    budget: Optional[RetryBudget] = None,
                    rng: Optional[np.random.Generator] = None,
                    site: str = "call",
                    sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` with classified retries.

    Poison and fatal errors propagate immediately; transient errors are
    retried (with backoff) while the policy and budget allow.  Every
    retry bumps ``resilience_retries_total{site,kind}``.
    """
    policy = policy or RetryPolicy()
    rng = rng if rng is not None else np.random.default_rng(0)
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 — classified below
            kind = classify(exc)
            if kind != TRANSIENT or not policy.allows(attempt + 1):
                raise
            if budget is not None and not budget.spend():
                raise
            obs.counter("resilience_retries_total",
                        site=site, kind=kind).inc()
            sleep(policy.backoff_s(attempt + 1, rng))


__all__ = ["POISON", "RetryBudget", "RetryPolicy", "TRANSIENT",
           "call_with_retry"]

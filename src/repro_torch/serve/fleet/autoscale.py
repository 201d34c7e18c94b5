"""Elastic fleet sizing from backlog depth and tail latency (the port of
``repro.serve.fleet.autoscale``: the same decisions).

Pure decision logic — :meth:`Autoscaler.decide` looks at the current
backlog-per-worker and recent p99 and answers ``"up"``, ``"down"`` or
``None``; the fleet supervisor actuates (spawn a warm worker / drain
and retire one).  Keeping the policy side-effect free makes it unit-
testable with an injected clock, and keeps its hysteresis honest:

* **up** when backlog per live worker exceeds ``up_pending_per_worker``
  (or p99 exceeds ``up_p99_ms`` when set) and the fleet is below
  ``max_workers``;
* **down** when backlog per worker has stayed below
  ``down_pending_per_worker`` for ``idle_grace_s`` and the fleet is
  above ``min_workers`` — the grace window stops one idle tick from
  retiring a worker a bursty trace will want back;
* at most one action per ``cooldown_s`` so the controller cannot
  flap faster than a spawned worker can warm up.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class AutoscaleConfig:
    enabled: bool = False
    min_workers: int = 1
    max_workers: int = 4
    up_pending_per_worker: float = 8.0
    up_p99_ms: Optional[float] = None
    down_pending_per_worker: float = 0.5
    idle_grace_s: float = 1.0
    cooldown_s: float = 2.0


class Autoscaler:
    """Hysteresis-guarded scale decisions (no side effects)."""

    def __init__(self, cfg: Optional[AutoscaleConfig] = None):
        self.cfg = cfg if cfg is not None else AutoscaleConfig()
        self._last_action_t: Optional[float] = None
        self._low_since: Optional[float] = None

    def decide(self, now: float, *, pending: int, live_workers: int,
               p99_ms: Optional[float] = None) -> Optional[str]:
        cfg = self.cfg
        if not cfg.enabled or live_workers <= 0:
            return None
        if self._last_action_t is not None \
                and now - self._last_action_t < cfg.cooldown_s:
            return None
        per = pending / live_workers
        hot = per > cfg.up_pending_per_worker or (
            cfg.up_p99_ms is not None and p99_ms is not None
            and p99_ms > cfg.up_p99_ms)
        if hot:
            self._low_since = None
            if live_workers < cfg.max_workers:
                self._last_action_t = now
                return "up"
            return None
        if per < cfg.down_pending_per_worker \
                and live_workers > cfg.min_workers:
            if self._low_since is None:
                self._low_since = now
            elif now - self._low_since >= cfg.idle_grace_s:
                self._last_action_t = now
                self._low_since = None
                return "down"
        else:
            self._low_since = None
        return None


__all__ = ["AutoscaleConfig", "Autoscaler"]

"""Straggler detection & failure handling policy (the port of
``repro.ft.health``: pure Python, the same decisions on the same timings).

On a multi-host deployment each host runs this monitor; the decisions
(flag, hot-spare swap, checkpoint-restart) are driven from per-step wall
times and heartbeats.  The detection logic is hardware-independent and is
exercised by unit tests with synthetic timings; the *actuation* is
simulated (``SimulatedCluster``).  The serving fleet
(``repro_torch.serve.fleet``) uses :class:`Heartbeat` for missed-beat
detection and :class:`StragglerDetector` for slow workers.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class HealthConfig:
    window: int = 50  # ring buffer of recent step times
    straggler_sigma: float = 3.0  # flag if mean-step > mu + sigma*std
    straggler_ratio: float = 1.5  # ... or > ratio * median
    heartbeat_timeout_s: float = 60.0


class StragglerDetector:
    """Per-step wall-time ring buffer with robust outlier detection.

    ``cfg=None`` builds a private :class:`HealthConfig` — a shared
    module-level default instance would alias mutable config state
    across every detector in the process (the classic
    mutable-dataclass-default bug: tuning one detector's thresholds
    silently retunes all of them).
    """

    def __init__(self, cfg: Optional[HealthConfig] = None):
        self.cfg = cfg if cfg is not None else HealthConfig()
        self.times: Deque[float] = collections.deque(
            maxlen=self.cfg.window)
        self.flags: List[int] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler event."""
        is_straggler = False
        if len(self.times) >= 8:
            xs = sorted(self.times)
            med = xs[len(xs) // 2]
            mu = sum(self.times) / len(self.times)
            var = sum((t - mu) ** 2 for t in self.times) / len(self.times)
            sd = var ** 0.5
            if dt > max(self.cfg.straggler_ratio * med,
                        mu + self.cfg.straggler_sigma * sd):
                is_straggler = True
                self.flags.append(step)
        self.times.append(dt)
        return is_straggler

    @property
    def median(self) -> Optional[float]:
        if not self.times:
            return None
        xs = sorted(self.times)
        return xs[len(xs) // 2]


class Heartbeat:
    """Host-level liveness: worker marks, coordinator checks."""

    def __init__(self, cfg: Optional[HealthConfig] = None):
        self.cfg = cfg if cfg is not None else HealthConfig()
        # keyed by host id — an int rank or a fleet worker name
        self.last: Dict[Any, float] = {}

    def beat(self, host: Any, now: Optional[float] = None):
        self.last[host] = now if now is not None else time.monotonic()

    def forget(self, host: Any) -> None:
        """Drop a retired host so it can never read as dead."""
        self.last.pop(host, None)

    def dead_hosts(self, now: Optional[float] = None) -> List[Any]:
        now = now if now is not None else time.monotonic()
        return [h for h, t in self.last.items()
                if now - t > self.cfg.heartbeat_timeout_s]


class SimulatedCluster:
    """Failure-injection harness used by fault-tolerance tests.

    Models hosts with hot spares: on failure the coordinator swaps in a
    spare (or shrinks the mesh if none remain — elastic path) and the run
    resumes from the latest checkpoint.
    """

    def __init__(self, n_hosts: int, n_spares: int = 1):
        self.active = list(range(n_hosts))
        self.spares = list(range(n_hosts, n_hosts + n_spares))
        self.events: List[Tuple[str, int]] = []

    def fail(self, host: int) -> str:
        """Returns the recovery decision: 'swap' or 'shrink'."""
        self.active.remove(host)
        if self.spares:
            spare = self.spares.pop(0)
            self.active.append(spare)
            self.events.append(("swap", spare))
            return "swap"
        self.events.append(("shrink", host))
        return "shrink"

    @property
    def world_size(self) -> int:
        return len(self.active)

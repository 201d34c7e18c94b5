"""Deterministic fault injection for the serve + train paths (the port of
``repro.resilience.chaos``: the same seed fires the same schedule).

A :class:`FaultPlan` is a seed-driven schedule of faults at named
**sites** — fixed hook points the reference threads through the
executor, the serving engines, the train loop, the checkpointer, and the
DeltaGraph repack thread (the port's modules take them as they are
ported):

========================  ====================================================
site                      where it fires
========================  ====================================================
``executor.compile``      inside the traced executor body (= compile time)
``executor.execute``      before a bucketed-executor group execution
``executor.output``       on a group's output tensor (``corrupt`` site)
``serve.worker``          top of ``BatchServingEngine._serve_loop``
``serve.flush``           before a micro-batch flush (ctx carries ``tags``)
``continuous.worker``     top of ``ContinuousBatchEngine._step_loop``
``continuous.execute``    before a lane-step execution (ctx carries ``tags``)
``continuous.output``     on a lane-step output tensor (``corrupt`` site)
``train.step``            before each training step (ctx carries ``step``)
``checkpoint.write``      between the temp-dir write and the atomic rename
``delta.repack``          inside the background repack build
``fleet.worker``          fleet dispatch / monitor tick (ctx: ``worker``,
                          ``phase``) — ``kill_proc``/``hang`` act here
``fleet.heartbeat``       parent-side heartbeat intake (ctx: ``worker``)
``fleet.rpc``             fleet send/recv boundary (ctx: ``worker``,
                          ``phase``)
========================  ====================================================

Faults trigger on exact hit counts (``at``/``times``) or with a
seed-driven probability (``p``) — either way the schedule is a pure
function of the plan's seed and the sequence of hook calls, so a chaos
run replays bit-identically.  A ``match`` dict restricts a fault to
hook calls whose context carries a value (e.g. a poison request's tag),
which is how tests mark one request of a co-batched lane as the culprit.

When no plan is installed every hook is a cheap module-global ``None``
check — zero overhead on the production path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.resilience.errors import (PoisonRequestError,
                                           TransientExecutorError)

#: fault kinds a spec can carry
RAISE = "raise"      # raise TransientExecutorError (or the payload exc)
POISON = "poison"    # raise PoisonRequestError
DELAY = "delay"      # sleep payload seconds (latency spike)
DIE = "die"          # raise WorkerKilled — kills a worker thread
NAN = "nan"          # corrupt an output array with NaN (corrupt sites)
KILL_PROC = "kill_proc"  # raise ProcessKillRequested — the fleet layer
#                          catches it and SIGKILLs the worker process
HANG = "hang"        # raise WorkerHangRequested — the fleet layer catches
#                      it and freezes the worker's loop (heartbeats stop)

KINDS = (RAISE, POISON, DELAY, DIE, NAN, KILL_PROC, HANG)


class WorkerKilled(TransientExecutorError):
    """Injected worker-thread death (``kind="die"``)."""


class ProcessKillRequested(Exception):
    """Control signal of ``kind="kill_proc"``: the hook site (a
    ``fleet.*`` site) must hard-kill the worker process it names.  Not
    an error surface — only the fleet layer catches it."""


class WorkerHangRequested(Exception):
    """Control signal of ``kind="hang"``: the hook site must wedge the
    worker's loop (payload = seconds, ``None`` = until killed), so its
    heartbeats stop and the fleet's missed-heartbeat detection fires."""

    def __init__(self, msg: str, payload: Any = None):
        super().__init__(msg)
        self.payload = payload


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.

    ``at`` is the 1-based hit count of the site at which the fault
    starts firing; it fires for ``times`` consecutive matching hits
    (``None`` = forever).  ``p`` (0..1) makes it probabilistic instead,
    drawn from the plan's seeded rng.  ``match`` filters on the hook's
    context: each key must equal the context value, or be contained in
    it when the context value is a sequence (how a poison *tag* matches
    a lane whose occupant list carries it).
    """

    site: str
    kind: str = RAISE
    at: int = 1
    times: Optional[int] = 1
    p: float = 0.0
    payload: Any = None
    match: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")

    def matches_ctx(self, ctx: Dict[str, Any]) -> bool:
        if not self.match:
            return True
        for k, want in self.match.items():
            got = ctx.get(k)
            if got == want:
                continue
            if isinstance(got, (list, tuple, set, frozenset)) and want in got:
                continue
            return False
        return True


class FaultPlan:
    """A deterministic, seed-driven schedule of injected faults."""

    def __init__(self, faults: Sequence[FaultSpec] = (), *, seed: int = 0):
        self.seed = seed
        self.faults = list(faults)
        self.rng = np.random.default_rng(seed)
        self.events: List[Tuple[str, str, int]] = []  # (site, kind, hit)
        self._hits: Dict[int, int] = {}  # per-spec matching-hit counters
        self._lock = threading.Lock()

    # -- scheduling ---------------------------------------------------------

    def _armed(self, site: str, ctx: Dict[str, Any]) -> List[FaultSpec]:
        """The specs firing on this hook call (advances hit counters)."""
        out = []
        with self._lock:
            for idx, spec in enumerate(self.faults):
                if spec.site != site or not spec.matches_ctx(ctx):
                    continue
                hit = self._hits.get(idx, 0) + 1
                self._hits[idx] = hit
                if spec.p > 0.0:
                    fire = bool(self.rng.random() < spec.p)
                else:
                    fire = hit >= spec.at and (
                        spec.times is None or hit < spec.at + spec.times)
                if fire:
                    self.events.append((site, spec.kind, hit))
                    obs.counter("chaos_faults_total",
                                site=site, kind=spec.kind).inc()
                    out.append(spec)
        return out

    # -- firing -------------------------------------------------------------

    @staticmethod
    def _act(site: str, spec: FaultSpec) -> None:
        if spec.kind == DELAY:
            time.sleep(float(spec.payload) if spec.payload else 0.05)
        elif spec.kind == DIE:
            raise WorkerKilled(f"chaos: worker killed at {site}")
        elif spec.kind == KILL_PROC:
            raise ProcessKillRequested(f"chaos: kill_proc at {site}")
        elif spec.kind == HANG:
            raise WorkerHangRequested(f"chaos: hang at {site}",
                                      payload=spec.payload)
        elif spec.kind == POISON:
            raise PoisonRequestError(f"chaos: poison at {site}")
        elif spec.kind == RAISE:
            if isinstance(spec.payload, BaseException):
                raise spec.payload
            raise TransientExecutorError(f"chaos: fault at {site}")
        # NAN specs only act at corrupt() sites

    def fire(self, site: str, ctx: Dict[str, Any]) -> None:
        """Run this hook call's scheduled faults (may raise / sleep)."""
        for spec in self._armed(site, ctx):
            self._act(site, spec)

    def corrupt_value(self, site: str, value, ctx: Dict[str, Any]):
        """Apply NaN-corruption faults scheduled at this site (other
        kinds also work here — a corrupt site is a hook site too)."""
        for spec in self._armed(site, ctx):
            if spec.kind != NAN:
                self._act(site, spec)
                continue
            idx = spec.payload if spec.payload is not None else (0, 0)
            if idx == "all":
                value = value * np.nan
            elif isinstance(value, torch.Tensor):  # a copy, as .at[].set
                value = value.clone()
                value[tuple(idx)] = np.nan
            else:  # plain numpy
                value = np.array(value, copy=True)
                value[tuple(idx)] = np.nan
        return value


# ---------------------------------------------------------------------------
# Global arm/disarm (the hooks below are the only production touch points)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> None:
    """Arm a plan process-wide (one at a time)."""
    global _ACTIVE
    _ACTIVE = plan


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


@contextlib.contextmanager
def active(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Arm ``plan`` for the duration of the block."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def hook(site: str, **ctx) -> None:
    """Fault-injection point: no-op (one ``None`` check) when disarmed."""
    plan = _ACTIVE
    if plan is not None:
        plan.fire(site, ctx)


def corrupt(site: str, value, **ctx):
    """Output-corruption point: returns ``value`` unchanged when
    disarmed, else with any scheduled NaN faults applied."""
    plan = _ACTIVE
    if plan is not None:
        return plan.corrupt_value(site, value, ctx)
    return value


__all__ = [
    "DELAY", "DIE", "FaultPlan", "FaultSpec", "HANG", "KILL_PROC", "KINDS",
    "NAN", "POISON", "ProcessKillRequested", "RAISE", "WorkerHangRequested",
    "WorkerKilled", "active", "active_plan", "corrupt", "hook",
    "install", "uninstall",
]

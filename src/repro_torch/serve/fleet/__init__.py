"""repro_torch.serve.fleet — fault-tolerant multi-worker serving (the port
of ``repro.serve.fleet``: the same names, decisions and ``fleet_*``
metrics; workers serve on ``WorkerConfig.device``, the card by default).

A :class:`ServingFleet` puts N supervised workers (daemon threads or
real ``spawn`` processes — same protocol, see
:mod:`repro_torch.serve.fleet.rpc`) behind the familiar
submit/infer/report surface:

* :mod:`~repro_torch.serve.fleet.router` — lane-sticky placement for
  warm-executor locality plus the request journal that makes failover
  **at-most-once** (a future resolves exactly once no matter how many
  workers raced on the request);
* :mod:`~repro_torch.serve.fleet.supervisor` — worker lifecycle states,
  the atomically-claimed death/restart guard, heartbeat + straggler
  tracking through :mod:`repro_torch.ft.health`;
* :mod:`~repro_torch.serve.fleet.worker` — the loop each worker runs: a
  private foreground :class:`ContinuousBatchEngine`, heartbeats, warm
  pre-compilation, hedged-duplicate cancellation;
* :mod:`~repro_torch.serve.fleet.autoscale` — queue-depth/p99 elastic
  sizing with hysteresis;
* :mod:`~repro_torch.serve.fleet.fleet` — the facade wiring it together,
  including the parent-side chaos sites (``fleet.worker``,
  ``fleet.heartbeat``, ``fleet.rpc``).

Everything observable lands in ``obs.snapshot()`` under ``fleet_*``
counters/gauges; ``ServingFleet.report()`` speaks the canonical
``p50_ms``/``p99_ms``/``waste`` vocabulary.
"""
from repro_torch.serve.fleet.autoscale import AutoscaleConfig, Autoscaler
from repro_torch.serve.fleet.fleet import FleetConfig, ServingFleet
from repro_torch.serve.fleet.router import JournalEntry, Router
from repro_torch.serve.fleet.rpc import (ProcessHandle, ThreadHandle,
                                         TransportError)
from repro_torch.serve.fleet.supervisor import FleetSupervisor, WorkerState
from repro_torch.serve.fleet.worker import FleetWorker, WorkerConfig

__all__ = [
    "AutoscaleConfig", "Autoscaler", "FleetConfig", "FleetSupervisor",
    "FleetWorker", "JournalEntry", "ProcessHandle", "Router",
    "ServingFleet", "ThreadHandle", "TransportError", "WorkerConfig",
    "WorkerState",
]

"""repro_torch.resilience — fault injection, retry, shedding, recovery
(the port of ``repro.resilience``; the same seeds give the same retry
delays and fault schedules).

The layer that turns a fast demo into a system that stays up:

* :mod:`repro_torch.resilience.chaos` — deterministic, seed-driven
  :class:`FaultPlan` injected at named sites across the executor, both
  serving engines, the train loop, the checkpointer, and the DeltaGraph
  repack thread.  Zero overhead when disarmed.
* :mod:`repro_torch.resilience.errors` — the structured error taxonomy
  (poison vs transient vs shed vs deadline vs closed) every engine
  speaks, plus :func:`classify` for the retry decision.
* :mod:`repro_torch.resilience.retry` — exponential backoff with jitter and
  a token-bucket :class:`RetryBudget` so fault storms fail fast instead
  of amplifying load.
* :mod:`repro_torch.resilience.supervisor` — bounded worker-thread restarts
  for the serving loops.

Recovery actions are visible in ``obs.snapshot()`` via
``resilience_retries_total{site,kind}``, ``resilience_shed_total``,
``resilience_quarantined_total{kind}``, ``resilience_degraded_total``,
``resilience_worker_restarts_total{worker}`` and
``resilience_recoveries_total{site}``; injected faults count in
``chaos_faults_total{site,kind}``.
"""
from repro_torch.resilience import chaos
from repro_torch.resilience.chaos import (FaultPlan, FaultSpec,
                                          ProcessKillRequested,
                                          WorkerHangRequested, WorkerKilled)
from repro_torch.resilience.errors import (DeadlineExceededError,
                                           EngineClosedError, KernelError,
                                           NaNOutputError,
                                           PoisonRequestError,
                                           RequestShedError, ResilienceError,
                                           TransientExecutorError,
                                           WorkerLostError, classify)
from repro_torch.resilience.retry import (RetryBudget, RetryPolicy,
                                          call_with_retry)
from repro_torch.resilience.supervisor import WorkerSupervisor

__all__ = [
    "DeadlineExceededError", "EngineClosedError", "FaultPlan", "FaultSpec",
    "KernelError", "NaNOutputError", "PoisonRequestError", "ProcessKillRequested",
    "RequestShedError", "ResilienceError", "RetryBudget", "RetryPolicy",
    "TransientExecutorError", "WorkerHangRequested", "WorkerKilled",
    "WorkerLostError", "WorkerSupervisor", "call_with_retry", "chaos",
    "classify",
]

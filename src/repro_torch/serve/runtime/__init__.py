"""Adaptive serving runtime (the port of ``repro.serve.runtime``).

* :class:`AdaptiveBucketLadder` — quantile-learned bucket grid fit from
  observed request shapes, re-fit on traffic drift with hysteresis and
  warm-executor carryover.
* :class:`ContinuousBatchEngine` — admission into a running
  block-diagonal batch: fixed slot pools, per-slot completion, freed
  slots recycled without a new executor signature.
* :class:`DeltaGraph` — mutable CSR / SELL overlay absorbing edge
  insert / delete deltas in place (slack slots, tombstones, sentinel
  remap, and the SELL row view the kernels read), with stats
  invalidation and background repack.
"""
from repro_torch.serve.runtime.continuous import (ContinuousBatchEngine,
                                                  ContinuousConfig)
from repro_torch.serve.runtime.delta import DeltaGraph
from repro_torch.serve.runtime.ladder import (AdaptiveBucketLadder,
                                              DEFAULT_LADDER, LadderConfig)

__all__ = [
    "AdaptiveBucketLadder",
    "ContinuousBatchEngine",
    "ContinuousConfig",
    "DEFAULT_LADDER",
    "DeltaGraph",
    "LadderConfig",
]

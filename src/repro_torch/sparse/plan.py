"""Per-instance plan memoization for ``SparseMatrix`` (the port of
``repro.sparse.plan``).

The first ``A @ H`` for a given (op, width, policy, dtype, candidates,
epilogue) key resolves a dispatch ``Plan`` and memoizes it on the matrix;
every later call with the same key skips re-planning.  Each cache keeps
its own hit/miss counters; the module-level counters aggregate them, and
``obs`` counts them as ``plan_cache_hits_total`` /
``plan_cache_misses_total``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Hashable, Optional

from repro_torch import obs


@dataclasses.dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0


# Process-global counters (all SparseMatrix instances).
GLOBAL_STATS = PlanCacheStats()


def plan_cache_stats() -> Dict[str, int]:
    """Aggregate plan-cache counters across every SparseMatrix."""
    return {"hits": GLOBAL_STATS.hits, "misses": GLOBAL_STATS.misses}


def reset_plan_cache_stats() -> None:
    GLOBAL_STATS.hits = 0
    GLOBAL_STATS.misses = 0


class PlanCache:
    """Mutable (key -> Plan) memo of one matrix."""

    __slots__ = ("entries", "hits", "misses")

    def __init__(self):
        self.entries: Dict[Hashable, Any] = {}
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable) -> Optional[Any]:
        plan = self.entries.get(key)
        if plan is None:
            self.misses += 1
            GLOBAL_STATS.misses += 1
            obs.counter("plan_cache_misses_total").inc()
        else:
            self.hits += 1
            GLOBAL_STATS.hits += 1
            obs.counter("plan_cache_hits_total").inc()
        return plan

    def put(self, key: Hashable, plan: Any) -> None:
        self.entries[key] = plan

    def stats(self) -> Dict[str, int]:
        """This instance's counters (see ``plan_cache_stats`` for the
        process-wide aggregate)."""
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self.entries)}

    def __len__(self) -> int:
        return len(self.entries)

    def __repr__(self) -> str:
        return f"PlanCache({len(self.entries)} plans)"

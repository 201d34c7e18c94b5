"""Analytic cost model for SpMM / SDDMM path selection (the port of
``repro.dispatch.cost_model``).

Costs are relative: elements each path must stream and multiply, times a
per-element constant.  The constants are the JAX package's defaults, so
the port picks the same plan as the reference; they were chosen for a
TPU and are yet to be measured again on the H100.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.dispatch.policy import (PATH_CSR, PATH_DENSE, PATH_ELL,
                                         PATH_SELL)
from repro_torch.dispatch.stats import MatrixStats


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-element relative cost constants (unitless, dense == 1.0)."""

    c_dense: float = 1.0
    # stored-element cost of the blocked path (includes its padding)
    c_ell: float = 1.05
    # per-nonzero cost of the scalar path
    c_csr: float = 12.0
    # per-slot cost of the SELL-C-σ path (packed slot volume)
    c_sell: float = 9.0

    def spmm_costs(self, stats: MatrixStats, d: int) -> Dict[str, float]:
        """Relative cost of Y[M,D] = A[M,N] @ H[N,D] per path."""
        d = max(int(d), 1)
        return {
            PATH_DENSE: self.c_dense * stats.dense_elements * d,
            PATH_ELL: self.c_ell * stats.ell_stream_estimate * d,
            PATH_SELL: self._sell_cost(stats, d),
            PATH_CSR: self.c_csr * stats.nnz * d,
        }

    def sddmm_costs(self, stats: MatrixStats, k: int) -> Dict[str, float]:
        """Relative cost of Y = A (.) (B[M,K] @ C[K,N]) per path."""
        k = max(int(k), 1)
        return {
            PATH_DENSE: self.c_dense * stats.dense_elements * k,
            PATH_ELL: self.c_ell * stats.stored_elements * k,
            PATH_SELL: self._sell_cost(stats, k),
            PATH_CSR: self.c_csr * stats.nnz * k,
        }

    def fused_attn_costs(self, stats: MatrixStats, k: int, d: int
                         ) -> Dict[str, float]:
        """Relative cost of the one-pass fused attention pipeline: one
        stream of each layout's stored volume at the combined inner width
        ``k + d`` (the unfused composition streams the topology three
        times)."""
        inner = max(int(k), 1) + max(int(d), 1)
        return {
            PATH_DENSE: self.c_dense * stats.dense_elements * inner,
            PATH_ELL: self.c_ell * stats.ell_stream_estimate * inner,
            PATH_SELL: self._sell_cost(stats, inner),
            PATH_CSR: self.c_csr * stats.nnz * inner,
        }

    def _sell_cost(self, stats: MatrixStats, inner: int) -> float:
        # an unmeasured slot volume with nonzeros present is unpriceable
        if stats.sell_stored_elements <= 0 and stats.nnz > 0:
            return float("inf")
        return self.c_sell * stats.sell_stored_elements * inner

    @staticmethod
    def pick(costs: Dict[str, float]) -> str:
        """Cheapest path; ties broken dense < ell < sell < csr."""
        order = {PATH_DENSE: 0, PATH_ELL: 1, PATH_SELL: 2, PATH_CSR: 3}
        return min(costs, key=lambda p: (costs[p], order[p]))


DEFAULT_COST_MODEL = CostModel()

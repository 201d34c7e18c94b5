"""Dispatch policy vocabulary (the port of ``repro.dispatch.policy``).

Execution paths:

  * ``ell``   — Block-ELL / Block-COO; the CUDA kernels K1/K5 (SpMM), K3
                (SDDMM) and K7 (fused attention) for CUDA operands.
  * ``sell``  — SELL-C-σ over live tiles only; K2/K6, K4 and K8.
  * ``csr``   — element-granular gather + a fixed-order segmented sum
                (``torch.segment_reduce``: no atomics).
  * ``dense`` — densified fallback.

Policies: ``auto`` (the analytic cost model), ``autotune`` (time the
candidate paths once on the operand's device, cache the winner per (op,
shape, width, dtype, sparsity-bucket) key: ``repro_torch.dispatch
.autotune``), or one of the path names, which forces that path.
"""
from __future__ import annotations

import dataclasses

PATH_ELL = "ell"
PATH_SELL = "sell"
PATH_CSR = "csr"
PATH_DENSE = "dense"
PATHS = (PATH_ELL, PATH_SELL, PATH_CSR, PATH_DENSE)

# Op tag of the one-pass fused SDDMM -> softmax -> SpMM pipeline.  Not a
# storage path: a fused plan still names one of the layout paths above,
# priced as ONE stream of the topology, and carries this tag in
# ``Plan.op`` so the dispatch log shows fused decisions distinctly.
PATH_FUSED_ATTN = "fused_attn"

POLICY_AUTO = "auto"
POLICY_AUTOTUNE = "autotune"
POLICIES = (POLICY_AUTO, POLICY_AUTOTUNE) + PATHS

# historical aliases (SDDMM literature calls the paths by format name)
_ALIASES = {
    "block": PATH_ELL,
    "blockell": PATH_ELL,
    "blockcoo": PATH_ELL,
    "coo": PATH_CSR,
    "element": PATH_CSR,
    "scalar": PATH_CSR,
    "sellcs": PATH_SELL,
    "sell-c-sigma": PATH_SELL,
}


def normalize_policy(policy: str) -> str:
    """Canonicalize a policy/path name; raise on unknown names."""
    p = str(policy).lower()
    p = _ALIASES.get(p, p)
    if p not in POLICIES:
        raise ValueError(
            f"unknown dispatch policy {policy!r}; expected one of "
            f"{POLICIES + tuple(_ALIASES)}")
    return p


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Tunables of the dispatch layer (the cost-model constants are in
    ``dispatch/cost_model.py``).  The reference's ``use_kernel`` is not
    here: the operand's device chooses between a kernel and its plain
    version."""

    # autotune measurement
    autotune_warmup: int = 1
    autotune_iters: int = 3
    # sparsity buckets per density decade for the autotune cache key
    buckets_per_decade: int = 2


DEFAULT_CONFIG = DispatchConfig()

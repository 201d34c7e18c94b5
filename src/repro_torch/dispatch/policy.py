"""Dispatch policy vocabulary (the port of ``repro.dispatch.policy``).

Execution paths:

  * ``ell``   — Block-ELL; the CUDA kernels K1/K5 for CUDA operands.
  * ``sell``  — SELL-C-σ over live tiles only; K2/K6 for CUDA operands.
  * ``csr``   — element-granular gather + ``index_add_``.
  * ``dense`` — densified fallback.

Policies: ``auto`` (the analytic cost model), ``autotune`` (planned by
the cost model in this port until the autotune slice lands), or one of
the path names, which forces that path.
"""
from __future__ import annotations

PATH_ELL = "ell"
PATH_SELL = "sell"
PATH_CSR = "csr"
PATH_DENSE = "dense"
PATHS = (PATH_ELL, PATH_SELL, PATH_CSR, PATH_DENSE)

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

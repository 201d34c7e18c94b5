"""Legacy SDDMM surface — thin deprecation shim over ``repro_torch.sparse``
(the port of ``repro.core.sddmm``).

``sddmm()`` keeps working (forwarding through the dispatch machinery) but
emits a ``DeprecationWarning``; new code should use::

    from repro_torch.sparse import SparseMatrix, sample
    s = sample(SparseMatrix.from_dense(mask), b, c)   # or A.sddmm(b, c)

See ``repro_torch.sparse.legacy`` for what the legacy keywords mean.
"""
from __future__ import annotations

from repro_torch.core.formats import BlockCOO  # noqa: F401  (legacy re-export)
from repro_torch.sparse.legacy import warn_deprecated
from repro_torch.sparse.paths import sddmm_element_dots


def sddmm(a, b, c, *, policy: str = "auto", **kw) -> BlockCOO:
    """SDDMM for sparse-mask A (BlockCOO or dense); returns BlockCOO.

    .. deprecated:: use ``repro_torch.sparse.sample`` / ``A.sddmm(b, c)``.
    """
    warn_deprecated(
        "repro.core.sddmm.sddmm",
        "use repro.sparse: sample(SparseMatrix.from_dense(mask), b, c) "
        "(policy/use_kernel/interpret move to repro.sparse.ops.sddmm)")
    from repro_torch.dispatch.dispatcher import dispatch_sddmm

    return dispatch_sddmm(a, b, c, policy=policy, **kw)


def sddmm_coo(row_ids, col_ids, b, c):
    """Element-granular SDDMM dots (forwards to repro_torch.sparse)."""
    return sddmm_element_dots(row_ids, col_ids, b, c)

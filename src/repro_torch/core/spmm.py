"""Legacy SpMM surface — thin deprecation shim over ``repro_torch.sparse``
(the port of ``repro.core.spmm``).

``spmm()`` (and the per-path helper below) predate the unified
``SparseMatrix`` API.  They keep working — forwarding to the dispatch
machinery / the shared path implementations in
``repro_torch.sparse.paths`` — but ``spmm`` emits a ``DeprecationWarning``
with the migration hint.  New code should use::

    from repro_torch.sparse import SparseMatrix
    y = SparseMatrix.from_dense(a) @ h

See ``repro_torch.sparse.legacy`` for what the legacy keywords mean.
"""
from __future__ import annotations

from repro_torch.core.formats import CSR, BlockELL  # noqa: F401  (legacy re-export)
from repro_torch.sparse.legacy import warn_deprecated
from repro_torch.sparse.paths import (csr_to_device_arrays,  # noqa: F401
                                      spmm_dense, spmm_elements)


def spmm(a, h, *, policy: str = "auto", **kw):
    """Y = A @ H for sparse A (BlockELL, SparseMatrix, operand, or dense).

    .. deprecated:: use ``repro_torch.sparse.SparseMatrix`` / ``A @ h``.
    """
    warn_deprecated(
        "repro.core.spmm.spmm",
        "use repro.sparse: SparseMatrix.from_dense(a) @ h "
        "(policy/use_kernel/interpret move to repro.sparse.ops.matmul)")
    from repro_torch.dispatch.dispatcher import dispatch_spmm

    return dispatch_spmm(a, h, policy=policy, **kw)


def spmm_csr(row_ids, col_ids, values, h, num_rows: int):
    """Y = A @ H via gather + segment-sum (forwards to repro_torch.sparse)."""
    return spmm_elements(row_ids, col_ids, values, h, num_rows)

"""Deprecated public operand wrapper — use ``repro_torch.sparse.SparseMatrix``
(the port of ``repro.dispatch.operand``).

``SparseOperand`` was the pre-``repro.sparse`` multi-format wrapper.
Constructing one still works (it forwards to the ``LazyForms`` the legacy
dispatcher keeps using) but emits a ``DeprecationWarning``; the
replacement carries its forms, operators, gradients and per-instance
plan caching::

    from repro_torch.sparse import SparseMatrix
    A = SparseMatrix.from_dense(dense)        # instead of SparseOperand
    y = A @ h                                 # instead of dispatch_spmm

Its forms live on ``device`` (keyword, the card by default), as a
``LazyForms``'s do.
"""
from __future__ import annotations

from repro_torch.dispatch._forms import LazyForms
from repro_torch.sparse.legacy import warn_deprecated


class SparseOperand(LazyForms):
    """Deprecated; see ``repro_torch.sparse.SparseMatrix``."""

    def __init__(self, *args, **kwargs):
        warn_deprecated(
            "dispatch.SparseOperand",
            "use repro.sparse.SparseMatrix (multi-form via "
            "SparseMatrix.from_dense(a, formats=(...)))")
        super().__init__(*args, **kwargs)

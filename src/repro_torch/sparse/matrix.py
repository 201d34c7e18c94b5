"""``SparseMatrix`` — one sparse matrix carried in one or more storage
forms (the port of the part of ``repro.sparse.matrix`` that serving
uses).

Forms:

  * ``"csr"``  — element-granular (row_ids, col_ids, values) tensors,
    int32 indices;
  * ``"ell"``  — :class:`repro_torch.core.formats.BlockELL`;
  * ``"coo"``  — :class:`repro_torch.core.formats.BlockCOO` (the
    SDDMM-side blocked form);
  * ``"sell"`` — :class:`repro_torch.core.formats.SellCS`.

A matrix may carry several forms at once, so the dispatcher can route
any of their paths.  The planner reads the host-measured
:class:`MatrixStats` and memoizes plans per matrix (``plan_cache``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import BlockCOO, BlockELL, SellCS
from repro_torch.device import resolve_device
from repro_torch.dispatch.stats import MatrixStats
from repro_torch.kernels.sddmm.ref import pack_occupancy
from repro_torch.sparse import paths
from repro_torch.sparse.plan import PlanCache

FORMATS = ("ell", "sell", "coo", "csr")


def values_of(name: str, form) -> torch.Tensor:
    """The values tensor of one form."""
    if name == "csr":
        return form[2]
    if name == "sell":
        return form.slot_vals
    return form.blocks


def with_values(name: str, form, vals: torch.Tensor):
    """Same topology, new values."""
    if name == "csr":
        return (form[0], form[1], vals)
    if name == "sell":
        return dataclasses.replace(form, slot_vals=vals)
    return dataclasses.replace(form, blocks=vals)


def single_form(a: "SparseMatrix", name: str,
                vals: torch.Tensor) -> "SparseMatrix":
    """A matrix carrying only A's ``name`` form, with new values (A's
    topology, stats and plan memo)."""
    return SparseMatrix({name: with_values(name, a.form(name), vals)},
                        a.shape, a.stats, cache=a.plan_cache)


class SparseMatrix:
    """One sparse matrix, any carried storage format, dispatch-ready.

    Construct with :meth:`from_dense`.
    """

    __slots__ = ("_forms", "shape", "stats", "_cache", "_transpose",
                 "_occupancy", "__weakref__")

    def __init__(self, forms: Dict[str, Any], shape: Tuple[int, int],
                 stats: Optional[MatrixStats],
                 cache: Optional[PlanCache] = None):
        if not forms:
            raise ValueError("SparseMatrix needs at least one form")
        for name in forms:
            if name not in FORMATS:
                raise ValueError(
                    f"unknown format {name!r}; expected one of {FORMATS}")
        self._forms = dict(forms)
        self.shape = (int(shape[0]), int(shape[1]))
        self.stats = stats
        self._cache = cache if cache is not None else PlanCache()
        # the memoized transpose: a reference, or a weak one on the
        # transpose back to its source (no cycle keeps device memory alive)
        self._transpose: Any = None
        self._occupancy: Optional[torch.Tensor] = None

    @classmethod
    def from_dense(cls, a, *, formats: Tuple[str, ...] = ("ell", "csr"),
                   block: Tuple[int, int] = (64, 64),
                   ell_width: Optional[int] = None,
                   device="cuda") -> "SparseMatrix":
        """Build the named forms from a dense host (numpy) matrix."""
        device = resolve_device(device)
        a = np.asarray(a)
        if a.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {a.shape}")
        bm, bn = block
        rows, cols = np.nonzero(a)
        stats = MatrixStats.from_coords(a.shape, rows, cols, block_m=bm,
                                        block_n=bn, nnz=len(rows))
        forms = {name: _build_form(name, a, block, ell_width, device,
                                   rows, cols) for name in formats}
        return cls(forms, a.shape, stats)

    # -- metadata -------------------------------------------------------------

    @property
    def format(self) -> str:
        """Primary format (the first carried form)."""
        return next(iter(self._forms))

    @property
    def formats(self) -> Tuple[str, ...]:
        return tuple(self._forms)

    def has_form(self, name: str) -> bool:
        return name in self._forms

    def form(self, name: str):
        """The raw container of one carried form."""
        if name not in self._forms:
            raise ValueError(
                f"matrix carries no {name!r} form (has {self.formats}); "
                "convert with .to()")
        return self._forms[name]

    @property
    def plan_cache(self) -> PlanCache:
        """This instance's plan memo (per-matrix hit/miss counters)."""
        return self._cache

    @property
    def data(self) -> torch.Tensor:
        """Values of the primary form."""
        return values_of(self.format, self._forms[self.format])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def block(self) -> Tuple[int, int]:
        if self.stats is not None:
            return (self.stats.block_m, self.stats.block_n)
        return (64, 64)

    def __repr__(self) -> str:
        nnz = self.stats.nnz if self.stats is not None else "?"
        return (f"SparseMatrix(shape={self.shape}, formats={self.formats}, "
                f"nnz={nnz}, device={self.device})")

    # -- data / topology edits ----------------------------------------------

    def with_data(self, values: torch.Tensor) -> "SparseMatrix":
        """Same topology, new values on the *primary* form.  Secondary
        forms are dropped (their values would go stale); the plan memo is
        shared, since plans depend on structure, not values."""
        return single_form(self, self.format, values)

    def pattern(self) -> "SparseMatrix":
        """0/1 mask of the primary form's nonzero entries (the sampling
        operand of SDDMM)."""
        v = self.data
        return self.with_data((v != 0).to(v.dtype))

    def sddmm(self, b, c, **kw) -> "SparseMatrix":
        """``self ⊙ (b @ c)`` at this matrix's stored entries."""
        from repro_torch.sparse import ops

        return ops.sddmm(self, b, c, **kw)

    # -- transpose ----------------------------------------------------------

    @property
    def T(self) -> "SparseMatrix":
        """The transpose, built once and memoized both ways (a fixed graph
        transposes once).  csr swaps its coordinates; sell becomes the csr
        slot triplet (padding slots repeat coordinates with zero values);
        ell and coo become transposed Block-COO (views of the blocks)."""
        t = self._transpose
        if isinstance(t, weakref.ref):
            t = t()
        if t is None:
            t = self._transposed()
            self._transpose = t
            t._transpose = weakref.ref(self)
        return t

    def _transposed(self) -> "SparseMatrix":
        forms: Dict[str, Any] = {}
        for name, form in self._forms.items():
            if name == "csr":
                r, c, v = form
                forms["csr"] = (c, r, v)
            elif name == "sell":
                # a packed tile covers permuted rows, so sell transposes
                # element by element: the slot triplet with coordinates
                # swapped is the transposed csr form
                forms.setdefault(
                    "csr", (form.slot_cols, form.slot_rows, form.slot_vals))
            else:
                coo = paths.ell_to_coo(form) if name == "ell" else form
                forms.setdefault("coo", paths.transpose_coo(coo))
        return SparseMatrix(forms, (self.shape[1], self.shape[0]),
                            _transpose_stats(self.stats))

    # -- pattern ------------------------------------------------------------

    def tile_occupancy(self) -> torch.Tensor:
        """The nonzero cells of each tile row of the blocked form the ell
        path reads (``ell``, else ``coo``) as bit words (int32 [T, bm,
        ceil(bn / 32)], tiles in Block-COO order; ``pack_occupancy``):
        the pattern the backward masks with, ``values != 0``.  Built on
        the matrix's device once and memoized (a fixed graph packs it
        once)."""
        if self._occupancy is None:
            name = "ell" if self.has_form("ell") else "coo"
            self._occupancy = pack_occupancy(values_of(name,
                                                       self.form(name)))
        return self._occupancy

    # -- conversions --------------------------------------------------------

    def densify(self) -> torch.Tensor:
        """Dense tensor on the matrix's device, from the primary form,
        trimmed to the logical shape."""
        name = self.format
        form = self._forms[name]
        m, n = self.shape
        if name == "csr":
            return paths.densify_elements(form[0], form[1], form[2], (m, n))
        if name == "sell":
            return paths.densify_sell(form)
        full = paths.densify_ell(form) if name == "ell" \
            else paths.densify_coo(form)
        return full[:m, :n]

    def to_dense(self) -> np.ndarray:
        """Host numpy densification."""
        return self.densify().cpu().numpy()

    def to(self, fmt: str):
        """Convert to another format: a single-form ``SparseMatrix``
        (reusing the tensors when the form is carried; host conversion
        otherwise), or a dense tensor for ``"dense"``.  The plan memo is
        shared."""
        if fmt == "dense":
            return self.densify()
        if fmt not in FORMATS:
            raise ValueError(
                f"unknown format {fmt!r}; expected 'dense' or {FORMATS}")
        form = self._forms.get(fmt)
        if form is None:
            form = _build_form(fmt, self.to_dense(), self.block, None,
                               self.device)
        return SparseMatrix({fmt: form}, self.shape, self.stats,
                            cache=self._cache)

    def with_form(self, fmt: str) -> "SparseMatrix":
        """This matrix plus one more carried form (a no-op when ``fmt`` is
        already carried; host conversion otherwise).  The plan memo is
        shared: plan keys include the candidate set."""
        if fmt in self._forms:
            return self
        forms = dict(self._forms)
        forms[fmt] = self.to(fmt)._forms[fmt]
        return SparseMatrix(forms, self.shape, self.stats, cache=self._cache)


def _transpose_stats(stats: Optional[MatrixStats]
                     ) -> Optional[MatrixStats]:
    """The stats of the transpose, as the reference derives them (block
    shape swapped, no ELL width: the transpose is Block-COO)."""
    if stats is None:
        return None
    bm, bn = stats.block_n, stats.block_m
    return MatrixStats(
        shape=(stats.shape[1], stats.shape[0]), nnz=stats.nnz,
        stored_elements=stats.stored_elements, block_m=bm, block_n=bn,
        n_block_rows=max(stats.shape[1] // max(bm, 1), 1), ell_width=0,
        occupancy=stats.occupancy)


def _build_form(name: str, a: np.ndarray, block: Tuple[int, int],
                ell_width: Optional[int], device: torch.device,
                rows: Optional[np.ndarray] = None,
                cols: Optional[np.ndarray] = None):
    bm, bn = block
    if name == "ell":
        return BlockELL.from_dense(a, bm, bn, ell_width=ell_width,
                                   device=device)
    if name == "sell":
        return SellCS.from_dense(a, block=block, device=device)
    if name == "coo":
        return BlockCOO.from_dense(a, bm, bn, device=device)
    if name == "csr":
        if rows is None:
            rows, cols = np.nonzero(a)
        return (torch.from_numpy(rows.astype(np.int32)).to(device),
                torch.from_numpy(cols.astype(np.int32)).to(device),
                torch.from_numpy(np.ascontiguousarray(a[rows, cols]))
                .to(device))
    raise ValueError(f"unknown format {name!r}; expected one of {FORMATS}")

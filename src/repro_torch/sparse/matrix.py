"""``SparseMatrix`` — one sparse matrix carried in one or more storage
forms (the port of ``repro.sparse.matrix``).

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

Operators: ``A @ H`` plans an SpMM (a 1-D ``H``: an SpMV), ``x @ A`` the
SpMM of the transpose, ``A.sddmm(b, c)`` an SDDMM, ``A.T`` transposes;
each is differentiable (``repro_torch.sparse.autodiff``).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import CSR, BlockCOO, BlockELL, SellCS
from repro_torch.device import resolve_device
from repro_torch.dispatch.cost_model import DEFAULT_COST_MODEL, CostModel
from repro_torch.dispatch.policy import PATH_CSR, PATH_SELL
from repro_torch.dispatch.stats import MatrixStats
from repro_torch.kernels.sddmm.ref import pack_occupancy
from repro_torch.memo import Table, memoized
from repro_torch.sparse import paths
from repro_torch.sparse.plan import PlanCache

FORMATS = ("ell", "sell", "coo", "csr")
# the arrays of a SELL form that the reference's SellCS carries
_SELL_ARRAYS = ("slot_cols", "slot_rows", "slot_vals", "out_gather", "perm",
                "tile_rows", "tile_cols", "tile_slot_map", "slot_tile_pos",
                "tile_out_gather")
# feature width assumed when from_dense(formats=None) prices the paths
_AUTO_FORMAT_D = 256  # the paper's SpMM setting (§4.1)

# Densified-form memo (the reference's), keyed weakly on the primary
# form's values tensor; a hit needs the same form name, the same topology
# tensors and the values' version counter unchanged (an in-place update
# of the values must miss)
_DENSE_MEMO: Table = {}


def _dense_key(name: str, form) -> Tuple:
    tensors = form if name == "csr" else [
        getattr(form, f.name) for f in dataclasses.fields(form)]
    return (name, values_of(name, form)._version,
            tuple(id(t) for t in tensors if isinstance(t, torch.Tensor)))


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

    Construct with :meth:`from_dense` / :meth:`from_csr` /
    :meth:`from_blockell` / :meth:`from_blockcoo` / :meth:`from_sellcs`.
    """

    __slots__ = ("_forms", "shape", "stats", "_cache", "_transpose",
                 "_occupancy", "_transposed_of", "__weakref__")

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
        # a transpose's source forms read in place (ell: N1, sell: K2 on
        # Aᵀ's row view); not carried forms, so plans do not change
        self._transposed_of: Dict[str, Any] = {}

    @classmethod
    def from_dense(cls, a, *,
                   formats: Optional[Tuple[str, ...]] = ("ell", "csr"),
                   format: str = "auto", block: Tuple[int, int] = (64, 64),
                   ell_width: Optional[int] = None,
                   device="cuda") -> "SparseMatrix":
        """Build the named forms from a dense host (numpy) matrix.

        ``formats=None`` carries the one form ``format`` names;
        ``format="auto"`` (the reference's) measures the blocked structure
        and picks the element form where the cost model predicts the
        scalar path wins (hyper-sparsity), sell where it prices SELL-C-σ
        cheapest, the blocked form otherwise.
        """
        device = resolve_device(device)
        a = np.asarray(a)
        if a.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {a.shape}")
        bm, bn = block
        rows, cols = np.nonzero(a)
        stats = MatrixStats.from_coords(a.shape, rows, cols, block_m=bm,
                                        block_n=bn, nnz=len(rows))
        if formats is None:
            if format == "auto":
                pick = CostModel.pick(
                    DEFAULT_COST_MODEL.spmm_costs(stats, _AUTO_FORMAT_D))
                format = {PATH_CSR: "csr", PATH_SELL: "sell"}.get(pick,
                                                                  "ell")
            formats = (format,)
        forms = {name: _build_form(name, a, block, ell_width, device,
                                   rows, cols) for name in formats}
        return cls(forms, a.shape, stats)

    @classmethod
    def from_csr(cls, csr: CSR, *, block: Tuple[int, int] = (64, 64),
                 device="cuda") -> "SparseMatrix":
        """Wrap a host CSR as the element form on ``device``."""
        row_ids, col_ids, vals = paths.csr_to_device_arrays(csr, device)
        rows = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
        stats = MatrixStats.from_coords(csr.shape, rows, csr.indices,
                                        block_m=block[0], block_n=block[1],
                                        nnz=csr.nnz)
        return cls({"csr": (row_ids, col_ids, vals)}, csr.shape, stats)

    @classmethod
    def from_blockell(cls, ell: BlockELL, *,
                      stats: Optional[MatrixStats] = None,
                      nnz: Optional[int] = None) -> "SparseMatrix":
        """Wrap a BlockELL (stats measured from its blocks unless given)."""
        if stats is None:
            stats = MatrixStats.from_blockell(ell, nnz=nnz)
        return cls({"ell": ell}, ell.shape, stats)

    @classmethod
    def from_blockcoo(cls, coo: BlockCOO, *,
                      stats: Optional[MatrixStats] = None,
                      nnz: Optional[int] = None) -> "SparseMatrix":
        """Wrap a BlockCOO (stats measured from its blocks unless given)."""
        if stats is None:
            stats = MatrixStats.from_blockcoo(coo, nnz=nnz)
        return cls({"coo": coo}, coo.shape, stats)

    @classmethod
    def from_sellcs(cls, sell: SellCS, *,
                    stats: Optional[MatrixStats] = None) -> "SparseMatrix":
        """Wrap a SELL-C-σ packing (stats from its nonzero slots unless
        given)."""
        if stats is None:
            mask = sell.slot_vals.cpu().numpy() != 0
            stats = MatrixStats.from_coords(
                sell.shape, sell.slot_rows.cpu().numpy()[mask],
                sell.slot_cols.cpu().numpy()[mask], block_m=sell.bm,
                block_n=sell.bn, nnz=int(mask.sum()))
        return cls({"sell": sell}, sell.shape, stats)

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

    def transposed_form(self, name: str):
        """The ``ell`` or ``sell`` form of the matrix this one is the
        transpose of (``A.T``), or None: the transposed SpMM reads it in
        place, transposed."""
        return self._transposed_of.get(name)

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
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def nnz(self) -> int:
        if self.stats is None:
            raise ValueError("matrix has no sparsity stats")
        return self.stats.nnz

    @property
    def density(self) -> float:
        if self.stats is None:
            raise ValueError("matrix has no sparsity stats")
        return self.stats.density

    @property
    def block(self) -> Tuple[int, int]:
        if self.stats is not None:
            return (self.stats.block_m, self.stats.block_n)
        return (64, 64)

    def nbytes(self) -> int:
        """Bytes of the carried forms' arrays, counted as the reference
        counts its forms (a SELL form's row view, derived data the
        reference does not carry, is left out)."""
        total = 0
        for name, form in self._forms.items():
            if name == "csr":
                tensors = form
            elif name == "sell":
                tensors = [getattr(form, f) for f in _SELL_ARRAYS]
            else:
                tensors = [getattr(form, f.name)
                           for f in dataclasses.fields(form)]
            total += sum(t.numel() * t.element_size() for t in tensors
                         if isinstance(t, torch.Tensor))
        return total

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

    def with_stats(self, stats: MatrixStats) -> "SparseMatrix":
        """Same forms and data, re-stated planner stats, and a fresh plan
        memo (memoized plans were priced off the old stats)."""
        if stats is not None and (stats.shape[0] < self.shape[0]
                                  or stats.shape[1] < self.shape[1]):
            raise ValueError(
                f"stats shape {stats.shape} does not cover matrix shape "
                f"{self.shape} (stats carry the padded extent)")
        out = SparseMatrix(self._forms, self.shape, stats)
        out._transposed_of = self._transposed_of
        return out

    def pattern(self) -> "SparseMatrix":
        """0/1 mask of the primary form's nonzero entries (the sampling
        operand of SDDMM)."""
        v = self.data
        return self.with_data((v != 0).to(v.dtype))

    # -- operators ----------------------------------------------------------

    def __matmul__(self, h):
        if isinstance(h, SparseMatrix):
            return NotImplemented
        from repro_torch.sparse import ops

        return ops.matmul(self, h)

    def matmul(self, h, *, epilogue=None, bias=None, residual=None, **kw):
        """``A @ H`` with an optional fused epilogue:
        ``A.matmul(h, epilogue="relu", bias=b)`` is ``relu(A @ h + b)``
        (see :func:`repro_torch.sparse.ops.matmul`)."""
        from repro_torch.sparse import ops

        return ops.matmul(self, h, epilogue=epilogue, bias=bias,
                          residual=residual, **kw)

    def __rmatmul__(self, x):
        """``x @ A``: ``Aᵀ x`` for a 1-D ``x``, ``(Aᵀ xᵀ)ᵀ`` for a 2-D
        one."""
        from repro_torch.sparse import ops

        if not isinstance(x, torch.Tensor) or x.ndim not in (1, 2):
            return NotImplemented
        if x.ndim == 1:
            return ops.matmul(self.T, x)
        return ops.matmul(self.T, x.T).T

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
        ell and coo become transposed Block-COO (views of the blocks).  An
        ell or sell source form is kept beside them for the transposed
        SpMM (``transposed_form``)."""
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
        t = SparseMatrix(forms, (self.shape[1], self.shape[0]),
                         _transpose_stats(self.stats))
        t._transposed_of = {name: form for name, form in self._forms.items()
                            if name in ("ell", "sell")}
        return t

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
        trimmed to the logical shape.

        Memoized while the values tensor lives and is not changed in place
        (``_DENSE_MEMO``), so repeated dense-path dispatch pays the
        scatter once; the result is shared and must not be written to.  A
        result that carries an autograd graph is not memoized.
        """
        name = self.format
        form = self._forms[name]
        return memoized(_DENSE_MEMO, values_of(name, form),
                        _dense_key(name, form), self.dense_copy,
                        keep=lambda out: not out.requires_grad)

    def dense_copy(self) -> torch.Tensor:
        """``densify``'s tensor built anew and not memoized: the caller
        owns it, and it is freed when the caller drops it."""
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
        """Host numpy densification (a copy; nothing is memoized)."""
        return np.array(self.dense_copy().cpu())

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

"""The multi-form operand of the legacy dispatcher (the port of
``repro.dispatch._forms``).

One logical matrix and its execution forms (dense, element triplets,
Block-ELL), each converted on the host with numpy at first use and
memoized on the operand's device: the machinery behind ``dispatch_spmm``.
New code uses ``repro_torch.sparse.SparseMatrix``, which carries its
forms and plans per instance.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.formats import CSR, BlockELL
from repro_torch.device import resolve_device
from repro_torch.dispatch.stats import MatrixStats


class LazyForms:
    """Lazily converted bundle of {dense, CSR arrays, Block-ELL} forms;
    the device forms live on ``device`` (an ``ell`` given lives where its
    tensors do)."""

    def __init__(
        self,
        dense: Optional[np.ndarray] = None,
        *,
        ell: Optional[BlockELL] = None,
        csr: Optional[CSR] = None,
        block_m: int = 64,
        block_n: int = 64,
        ell_width: Optional[int] = None,
        device="cuda",
    ):
        if dense is None and ell is None and csr is None:
            raise ValueError("LazyForms needs at least one form")
        self._dense = np.asarray(dense) if dense is not None else None
        self._ell = ell
        self._csr = csr
        self.device = ell.device if ell is not None \
            else resolve_device(device)
        self.block_m = ell.bm if ell is not None else block_m
        self.block_n = ell.bn if ell is not None else block_n
        self._ell_width = ell_width
        self._csr_arrays: Optional[Tuple[torch.Tensor, ...]] = None
        self._dense_tensor: Optional[torch.Tensor] = None
        self._stats: Optional[MatrixStats] = None

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_dense(cls, dense: np.ndarray, *, block_m: int = 64,
                   block_n: int = 64, ell_width: Optional[int] = None,
                   device="cuda") -> "LazyForms":
        return cls(dense, block_m=block_m, block_n=block_n,
                   ell_width=ell_width, device=device)

    @classmethod
    def from_blockell(cls, ell: BlockELL) -> "LazyForms":
        return cls(ell=ell)

    # -- logical shape ------------------------------------------------------

    @property
    def shape(self) -> Tuple[int, int]:
        """Logical dense shape (unpadded if built from a dense matrix)."""
        if self._dense is not None:
            return self._dense.shape
        if self._csr is not None:
            return self._csr.shape
        return self._ell.shape

    # -- forms (memoized) ---------------------------------------------------

    def dense(self) -> np.ndarray:
        if self._dense is None:
            if self._ell is not None:
                self._dense = self._ell.to_dense()
            else:
                self._dense = self._csr.to_dense()
        return self._dense

    def dense_tensor(self) -> torch.Tensor:
        """The dense matrix on the operand's device, in its values' dtype
        (a Block-ELL given is densified on the device: numpy has no bf16)."""
        if self._dense_tensor is None:
            if self._dense is None and self._ell is not None:
                from repro_torch.sparse.paths import densify_ell

                self._dense_tensor = densify_ell(self._ell)
            else:
                self._dense_tensor = torch.from_numpy(
                    np.ascontiguousarray(self.dense())).to(self.device)
        return self._dense_tensor

    def ell(self) -> BlockELL:
        if self._ell is None:
            self._ell = BlockELL.from_dense(
                self.dense(), self.block_m, self.block_n,
                ell_width=self._ell_width, device=self.device)
        return self._ell

    def csr(self) -> CSR:
        if self._csr is None:
            self._csr = CSR.from_dense(self.dense())
        return self._csr

    def csr_arrays(self) -> Tuple[torch.Tensor, ...]:
        """(row_ids, col_ids, values) on the device, for the element
        path."""
        if self._csr_arrays is None:
            if self._csr is None and self._dense is None:
                # from the Block-ELL on the device, in its dtype, row-major
                # as CSR.from_dense orders them
                dt = self.dense_tensor()
                r, c = torch.nonzero(dt, as_tuple=True)
                self._csr_arrays = (r.to(torch.int32), c.to(torch.int32),
                                    dt[r, c])
            else:
                from repro_torch.sparse.paths import csr_to_device_arrays

                self._csr_arrays = csr_to_device_arrays(self.csr(),
                                                        self.device)
        return self._csr_arrays

    # -- stats --------------------------------------------------------------

    def stats(self) -> MatrixStats:
        if self._stats is None:
            if self._csr is not None:
                nnz = self._csr.nnz
            elif self._dense is not None:
                nnz = int(np.count_nonzero(self._dense))
            else:
                nnz = None  # count from the ELL blocks
            self._stats = MatrixStats.from_blockell(self.ell(), nnz=nnz)
        return self._stats

"""Operations and bytes of one sparse or dense product, counted from the
operation and not from any format or kernel: the nonzeros' int32 column
indices, their float32 values only where the operation reads them, each
dense operand read once and the output written once.  A change of format
or kernel cannot raise these counts, so a share of the roofline built on
them cannot pass 100 %.
"""
from __future__ import annotations

import dataclasses

from bench.work.peaks import PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S

F32 = 4  # bytes of a float32
IDX = 4  # bytes of an int32 column index


@dataclasses.dataclass(frozen=True)
class Work:
    """One operation's FLOPs and bytes."""

    what: str
    flops: int
    nbytes: int

    def least_s(self) -> float:
        """The least time the card needs: the larger of the bytes at the
        peak bandwidth and the FLOPs at the peak float32 rate."""
        return max(self.nbytes / PEAK_BYTES_PER_S,
                   self.flops / PEAK_F32_FLOP_PER_S)


def spmm(nnz: int, n_out: int, n_in: int, d: int, *,
         values: bool = True, what: str = "spmm") -> Work:
    """``Y[n_out, d] = A @ H[n_in, d]`` over ``nnz`` nonzeros of A."""
    nbytes = nnz * IDX + (nnz * F32 if values else 0) \
        + n_in * d * F32 + n_out * d * F32
    return Work(what, 2 * nnz * d, nbytes)


def spmm_t(nnz: int, n_rows: int, n_cols: int, d: int, *,
           values: bool = True, what: str = "spmm_t") -> Work:
    """``Y[n_cols, d] = Aᵀ @ G[n_rows, d]`` for A of shape
    ``[n_rows, n_cols]``: the same counts as the SpMM it transposes."""
    return spmm(nnz, n_cols, n_rows, d, values=values, what=what)


def sddmm(nnz: int, n_rows: int, n_cols: int, k: int, *,
          values: bool = False, what: str = "sddmm") -> Work:
    """``out[e] = (B[n_rows, k] Cᵀ[k, n_cols])`` at A's ``nnz`` nonzeros
    (times A's values where ``values``); one float32 out per nonzero."""
    nbytes = nnz * IDX + (nnz * F32 if values else 0) \
        + (n_rows + n_cols) * k * F32 + nnz * F32
    return Work(what, 2 * nnz * k, nbytes)


def fused_attention(nnz: int, n_rows: int, n_cols: int, dk: int, d: int, *,
                    what: str = "fused_attention") -> Work:
    """``Y = softmax_row(act(q kᵀ) at A's pattern) @ V``: the scores'
    SDDMM at ``dk`` and the SpMM at ``d`` in one pass; A's values are not
    read, and no per-edge array is written."""
    nbytes = nnz * IDX + (n_rows + n_cols) * dk * F32 \
        + n_cols * d * F32 + n_rows * d * F32
    return Work(what, 2 * nnz * dk + 2 * nnz * d, nbytes)


def dense_mm(m: int, k: int, n: int, *, what: str = "mm") -> Work:
    """``[m, k] @ [k, n]``."""
    return Work(what, 2 * m * k * n, (m * k + k * n + m * n) * F32)


def least_s(works) -> float:
    """The least time of operations run one after another."""
    return sum(w.least_s() for w in works)


def flops(works) -> int:
    return sum(w.flops for w in works)

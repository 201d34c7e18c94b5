"""The sparse-matrix API (the port of ``repro.sparse``): one
``SparseMatrix`` over every format, its planned SpMM / SpMV / SDDMM /
fused-attention front-ends and their autograd rules.

    from repro_torch.sparse import SparseMatrix, sample

    A = SparseMatrix.from_dense(a, device="cuda")
    y = A @ h                          # SpMM (a 1-D h: SpMV), planned once
    s = sample(A.pattern(), b, c)      # SDDMM at A's nonzeros
"""
from repro_torch.kernels.fused.epilogue import Epilogue
from repro_torch.sparse.matrix import FORMATS, SparseMatrix
from repro_torch.sparse.ops import (available_paths, fused_graph_attention,
                                   matmul, sample, sddmm, spmv)
from repro_torch.sparse.plan import (PlanCache, plan_cache_stats,
                                     reset_plan_cache_stats)

spmm = matmul  # functional alias, as the reference's

__all__ = [
    "Epilogue", "FORMATS", "SparseMatrix",
    "available_paths", "fused_graph_attention", "matmul", "sample",
    "sddmm", "spmm", "spmv",
    "PlanCache", "plan_cache_stats", "reset_plan_cache_stats",
]

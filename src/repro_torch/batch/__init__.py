"""Batched multi-graph execution: block-diagonal composition, shape
bucketing and the bucketed executor cache (the port of ``repro.batch``).

    from repro_torch.batch import BatchedSparseMatrix, BucketedExecutor

    B = BatchedSparseMatrix.from_matrices([A1, A2, A3])
    ys = B.unbatch(B @ B.batch_features([h1, h2, h3]))   # one SpMM

    ex = BucketedExecutor(max_batch=32)                  # O(#buckets)
    outs = ex.run(graphs, features)

The serving surface (bounded queue, micro-batch window, latency
reporting) is ``repro_torch.serve.engine.BatchServingEngine``.
"""
from repro_torch.batch.block_diag import (BatchedSparseMatrix, Segment,
                                          batch_matmul, batch_sddmm)
from repro_torch.batch.bucketing import (Bucket, BucketingConfig,
                                         DEFAULT_BUCKETING, PaddingWaste,
                                         bucket_for, canonical_stats,
                                         empty_in_bucket, pad_to_bucket,
                                         quantize_up)
from repro_torch.batch.executor import BucketedExecutor, ExecutorKey

__all__ = [
    "BatchedSparseMatrix", "Segment", "batch_matmul", "batch_sddmm",
    "Bucket", "BucketingConfig", "DEFAULT_BUCKETING", "PaddingWaste",
    "bucket_for", "canonical_stats", "empty_in_bucket", "pad_to_bucket",
    "quantize_up",
    "BucketedExecutor", "ExecutorKey",
]

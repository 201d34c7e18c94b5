"""Public entry point: banded (sliding-window) and custom block-sparse
masks (the port of ``repro.kernels.bsattn.ops``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.bsattn.kernel import bsattn_kernel


def banded_ell(s: int, block_q: int, block_kv: int, window: int):
    """ELL kv-block lists for causal sliding-window attention.

    Constant width: block-row i lists kv blocks [i - w_blocks + 1 .. i],
    clipped, with validity flags.  Reproduced exactly, with the
    reference's gap at ``block_q > block_kv``: block-row i's list ends at
    kv block ``i * (block_q // block_kv)``, so the later kv blocks inside
    the diagonal are not listed.
    """
    nq = s // block_q
    w_blocks = window // block_kv + 1 if window > 0 else s // block_kv
    rows = np.arange(nq)[:, None] * (block_q // block_kv)
    ell = rows - np.arange(w_blocks - 1, -1, -1)[None, :]
    valid = ell >= 0
    return (np.where(valid, ell, 0).astype(np.int32),
            valid.astype(np.int32))


def block_sparse_flash_attention(q, k, v, *, window: int = 0,
                                 causal: bool = True, block_q: int = 512,
                                 block_kv: int = 512, ell_idx=None,
                                 valid=None):
    """Fused SDDMM->softmax->SpMM attention over a block-sparse mask.

    q: [BH, S, D]; k/v: [BHkv, S, D] (GQA: BH % BHkv == 0; the kernel
    finds each q head's kv head by index arithmetic, never materialising
    repeated KV).  f32 or bf16; the output has q's dtype.  Default mask:
    causal sliding window of ``window`` (banded Block-ELL, constant
    width; ``window=0``: every block at or left of the diagonal).  Custom
    patterns: pass ``ell_idx``/``valid`` [n_q_blocks, W] (arrays or
    tensors).  Runs kernel K9 for CUDA tensors, its plain version for CPU
    tensors.
    """
    s = q.shape[1]
    if ell_idx is None:
        ell_idx, valid = banded_ell(s, block_q, block_kv, window)
    ell_idx = torch.as_tensor(ell_idx, dtype=torch.int32, device=q.device)
    valid = torch.as_tensor(valid, dtype=torch.int32, device=q.device)
    return bsattn_kernel(ell_idx, valid, q, k, v, block_q=block_q,
                         block_kv=block_kv, causal=causal, window=window)

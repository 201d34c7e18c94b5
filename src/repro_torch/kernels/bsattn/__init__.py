from repro_torch.kernels.bsattn.ops import block_sparse_flash_attention
from repro_torch.kernels.bsattn.ref import block_sparse_attention_ref

__all__ = ["block_sparse_flash_attention", "block_sparse_attention_ref"]

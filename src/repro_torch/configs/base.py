"""The LM model configuration type (the port of ``repro.configs.base``).

``ModelConfig`` names an LM architecture and carries the fields the
port reads: the attention widths, the sliding window and the attention
block.  Layer heterogeneity (gemma3's 5 local : 1 global) is a
``layer_pattern``: a period of layer kinds that repeats down the stack.
The reference's other fields (MoE, SSM, RG-LRU, enc-dec, VLM, MLP and
norm settings), its shape table and its parameter-count helpers come
with the code that reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # layer pattern (kinds: "attn" full, "local" windowed, "ssm", "rglru")
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0  # sliding-window size for "local" layers

    # paper technique knobs
    attn_block: int = 512  # block size for block-sparse / flash chunking

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        assert self.n_layers >= len(self.layer_pattern)

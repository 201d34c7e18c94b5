"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — Griffin: RG-LRU + local attention, 1 attn : 2 recurrent.
[arXiv:2402.19427; hf]

Hybrid: local-attention layers use the paper's banded block-sparse path;
RG-LRU layers are linear recurrences (associative scan).  long_500k RUNS.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=2560,
    act="gelu",
    tie_embeddings=True,
    long_context_ok=True,
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    n_layers=5,  # one period + (rglru, rglru) remainder
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    layer_pattern=("rglru", "rglru", "local"),
    window=64,
    attn_block=32,
    lru_width=64,
    act="gelu",
    tie_embeddings=True,
    long_context_ok=True,
)

"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1 (+1 shared).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

128 experts stress EP: the dispatch matrix is 8x sparser than Scout's —
the paper's hyper-sparsity cliff regime (EXPERIMENTS.md §Roofline).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    # Maverick interleaves dense and MoE layers (1:1) — that is how 128
    # experts yield ~400B total yet 17B active.
    layer_pattern=("attn", "moe"),
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    act="silu",
    rope_theta=500000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="llama4-maverick-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    layer_pattern=("attn", "moe"),
    n_experts=8,
    top_k=1,
    n_shared_experts=1,
    act="silu",
)

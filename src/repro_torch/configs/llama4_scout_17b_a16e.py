"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 (+1 shared), early fusion (text backbone
only; multimodal frontend out of scope per assignment).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Technique note (DESIGN.md §4): top-1 routing *is* the paper's hyper-sparse
SpMM (one nonzero per row of the dispatch matrix); implemented as
sort-based capacity dispatch, the comm-optimal form of that SpMM.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    layer_pattern=("moe",),
    n_experts=16,
    top_k=1,
    n_shared_experts=1,
    act="silu",
    rope_theta=500000.0,
)

SMOKE_CONFIG = ModelConfig(
    name="llama4-scout-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    layer_pattern=("moe",),
    n_experts=4,
    top_k=1,
    n_shared_experts=1,
    act="silu",
)

"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT frontend (STUB per assignment: input_specs()
provides precomputed patch embeddings) + InternLM2 backbone.
[arXiv:2404.16821; hf]

long_500k skipped (full-attention backbone).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    vision_tokens=256,
    act="silu",
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    vision_tokens=8,
    act="silu",
)

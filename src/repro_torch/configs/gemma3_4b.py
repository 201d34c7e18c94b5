"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global layer pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

The local layers are the paper's technique in production: banded
block-sparse attention (``core.attention.local_block_attention``, and
the same band through ``kernels.bsattn``).  Sub-quadratic in
depth-averaged cost => long_500k cell RUNS.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    act="gelu",
    tie_embeddings=True,
    rope_theta=1000000.0,
    long_context_ok=True,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-smoke",
    family="dense",
    n_layers=7,  # one full period + remainder (local) — exercises both paths
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    window=64,
    attn_block=32,
    act="gelu",
    tie_embeddings=True,
    long_context_ok=True,
)

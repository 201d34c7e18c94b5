"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 — QKV bias.  [hf:Qwen/Qwen1.5-0.5B; hf]

Largest dense cell; long_500k skipped (pure full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    act="silu",
)

SMOKE_CONFIG = ModelConfig(
    name="qwen-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    qkv_bias=True,
    act="silu",
)

"""granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch code model.  [arXiv:2405.04324; hf]

long_500k skipped (pure full attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    act="silu",
)

SMOKE_CONFIG = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    act="silu",
)

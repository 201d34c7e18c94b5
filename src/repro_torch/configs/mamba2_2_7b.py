"""mamba2-2.7b [ssm] — 64L d_model=2560 attn-free vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

Attention-free: attention-sparsity technique inapplicable (DESIGN.md
§Arch-applicability); SSD chunked scan implemented natively.  O(1)/token
decode state => long_500k RUNS.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    layer_pattern=("ssm",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
    long_context_ok=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=512,
    layer_pattern=("ssm",),
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=32,
    conv_width=4,
    tie_embeddings=True,
    long_context_ok=True,
)

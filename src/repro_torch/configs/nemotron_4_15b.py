"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — squared-ReLU MLP (non-gated).  [arXiv:2402.16819; unverified]

Pure full-attention arch: paper technique inapplicable to its structure
(DESIGN.md §Arch-applicability); long_500k cell skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    act="relu2",
    gated_mlp=False,
)

SMOKE_CONFIG = ModelConfig(
    name="nemotron-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    act="relu2",
    gated_mlp=False,
)

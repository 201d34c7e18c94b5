"""whisper-small [audio] — 12L d_model=768 12H (MHA kv=12) d_ff=3072
vocab=51865 — encoder-decoder; conv frontend STUB per assignment
(input_specs() provides precomputed frame embeddings [B, 1500, 768]).
[arXiv:2212.04356; unverified]

Shape interpretation (DESIGN.md §Arch-applicability): the assigned seq_len
applies to the decoder token stream; the encoder consumes whisper's native
1500 frame embeddings.  long_500k skipped (full attention; 500k is out of
the enc-dec family's operating range).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    encoder_layers=12,
    # whisper's native 1500 frames padded to 1536 (divisible by the 512
    # attention chunk) so the encoder takes the memory-bounded flash path
    encoder_seq=1536,
    act="gelu",
    gated_mlp=False,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    encoder_layers=2,
    encoder_seq=32,
    act="gelu",
    gated_mlp=False,
    tie_embeddings=True,
)

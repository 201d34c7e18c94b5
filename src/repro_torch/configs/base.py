"""Config system (the port of ``repro.configs.base``).

``ModelConfig`` is the single config type covering every LM architecture
family (dense / MoE / SSM / hybrid / enc-dec / VLM).  Layer
heterogeneity (gemma3's 5 local : 1 global, recurrentgemma's 2 recurrent :
1 local) is expressed as a ``layer_pattern`` — a period of layer *kinds*
that repeats down the stack; the params stack whole periods on a leading
axis, as the reference's do, and the port loops over them.

Every architecture file in this package defines ``CONFIG`` (the full
published card) and ``SMOKE_CONFIG`` (same family, tiny dims) and is
selectable by name (see ``repro_torch.configs.registry``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # layer pattern (kinds: "attn" full, "local" windowed, "ssm", "rglru")
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 0  # sliding-window size for "local" layers

    # MoE
    n_experts: int = 0
    top_k: int = 1
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_bf16_intra: bool = False  # bf16 intra-chunk quadratic (§Perf P8)
    conv_width: int = 4

    # RG-LRU (recurrentgemma)
    lru_width: Optional[int] = None

    # enc-dec (whisper): decoder cross-attends to encoder states
    encoder_layers: int = 0
    encoder_seq: int = 0  # frame-embedding count from the (stubbed) frontend

    # VLM: number of precomputed patch-embedding prefix tokens (stub)
    vision_tokens: int = 0

    # misc
    qkv_bias: bool = False
    act: str = "silu"  # silu | relu2 | gelu
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # paper technique knobs
    attn_block: int = 512  # block size for block-sparse / flash chunking
    long_context_ok: bool = False  # sub-quadratic => long_500k cell runs

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        assert self.n_layers >= len(self.layer_pattern)

    # -- derived -------------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def remainder_kinds(self) -> Tuple[str, ...]:
        r = self.n_layers % self.period
        return self.layer_pattern[:r]

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameter count (analytic; used for MODEL_FLOPS=6·N·D)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        mlp = d * f * (3 if self.gated_mlp else 2)
        moe = self.n_experts * mlp + d * self.n_experts \
            + self.n_shared_experts * mlp
        ssm = 0
        if "ssm" in self.layer_pattern:
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            conv_dim = di + 2 * ds
            ssm = (d * (2 * di + 2 * ds + nh)  # in_proj
                   + conv_dim * (self.conv_width + 1)  # conv w + bias
                   + 3 * nh  # A_log, D, dt_bias
                   + di * d  # out_proj
                   + di)  # gate norm
        rglru = 0
        if "rglru" in self.layer_pattern:
            w = self.lru_width or d
            rglru = (2 * d * w + w * d  # in (x & gate) + out proj
                     + w * (self.conv_width + 1)  # conv w + bias
                     + 2 * w * w + 2 * w  # gates (w + b)
                     + w)  # Lambda
        per_kind = {
            "attn": attn + mlp + 2 * d,
            "local": attn + mlp + 2 * d,
            "moe": attn + moe + 2 * d,
            "ssm": ssm + d,
            "rglru": rglru + mlp + 2 * d,
        }
        layers = 0
        for i in range(self.n_layers):
            layers += per_kind[self.layer_pattern[i % self.period]]
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = layers + emb + d  # final norm
        if self.vision_tokens:
            total += d * d  # vision projector
        if self.encoder_layers:
            total += self.encoder_layers * (attn + mlp + 2 * d) + d
            total += self.n_layers * (attn + d)  # cross-attention per dec layer
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top_k + shared only)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        mlp = d * f * (3 if self.gated_mlp else 2)
        inactive = (self.n_experts - self.top_k) * mlp
        n_moe_layers = sum(
            1 for i in range(self.n_layers)
            if self.layer_pattern[i % self.period] == "moe")
        return self.param_count() - n_moe_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

"""Architecture config dataclass covering all assigned model families."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | cnn
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # --- attention flavour ---
    attention: str = "full"          # full | swa (sliding) | local
    window: int = 0                  # swa/local window size
    qkv_bias: bool = False
    rope_fraction: float = 1.0       # chatglm applies RoPE to half the head dim
    rope_theta: float = 10_000.0

    # --- ssm / hybrid ---
    ssm_state: int = 0               # mamba N
    ssm_expand: int = 2              # d_inner = expand * d_model
    conv_width: int = 4
    lru_width: int = 0               # RG-LRU recurrent width
    pattern_recurrent: int = 0       # hybrid: recurrent blocks per super-block
    pattern_attention: int = 0       # hybrid: attention blocks per super-block

    # --- enc-dec ---
    is_encdec: bool = False
    enc_layers: int = 0

    # --- modality frontend (STUB: precomputed embeddings per spec) ---
    frontend: str = "none"           # none | vision_stub | audio_stub
    frontend_len: int = 0            # patches / frames occupying seq prefix

    # --- KV-cache spec (models/cache.py owns the convention) ---
    # "auto" (== "head/bf16", the historical convention) or
    # "layout[:shards]/dtype", e.g. "ring/bf16", "ring:4/int8", "head/int8".
    # The serve policy overrides this per cell via dataclasses.replace.
    cache_spec: str = "auto"

    # --- misc ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu (gated) | gelu (gated) | gelu_plain
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    grad_accum: int = 1              # microbatch accumulation steps in train_step
    remat: bool = True

    # cnn (paper Tier-A models)
    img_hw: int = 0
    img_c: int = 0
    cnn_channels: tuple = ()
    n_classes: int = 0

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family in ("hybrid",) and not self.lru_width:
            object.__setattr__(self, "lru_width", self.d_model)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k+ contexts? (bounded state / windowed attn)"""
        return self.family in ("ssm", "hybrid") or self.attention in ("swa", "local")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_serve(self) -> bool:
        return self.kind in ("prefill", "decode")


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

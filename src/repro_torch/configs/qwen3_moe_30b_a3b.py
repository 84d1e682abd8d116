"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 128 experts, top-8, no shared."""
from ..models.moe import MoEConfig

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,               # per-expert width
    vocab_size=151936,
    mlp_kind="swiglu",
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768, n_shared=0,
                  capacity_factor=1.25, group_size=512),
    rope_mode="rope",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    source="hf:Qwen/Qwen3-30B-A3B",
))

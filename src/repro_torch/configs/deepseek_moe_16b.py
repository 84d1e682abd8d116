"""DeepSeekMoE 16B [arXiv:2401.06066]: fine-grained experts, 2 shared +
64 routed top-6; layer 0 is a dense MLP (the published model)."""
from ..models.moe import MoEConfig

from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,               # per-expert width (fine-grained)
    vocab_size=102400,
    mlp_kind="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  capacity_factor=1.25, group_size=512),
    moe_layer_start=1,
    d_ff_dense=10944,        # dense layer-0 FFN width
    rope_mode="rope",
    rope_theta=10_000.0,
    norm="rmsnorm",
    source="arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base",
))

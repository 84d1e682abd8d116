"""Phi-3-medium 14B [arXiv:2404.14219]: RoPE + SwiGLU + GQA (kv=10)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    mlp_kind="swiglu",
    rope_mode="rope",
    rope_theta=10_000.0,
    norm="rmsnorm",
    source="arXiv:2404.14219",
))

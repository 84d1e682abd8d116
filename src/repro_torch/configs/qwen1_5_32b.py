"""Qwen1.5-32B [hf:Qwen/Qwen1.5-32B]: QKV bias, near-MHA GQA (kv=40)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    mlp_kind="swiglu",
    qkv_bias=True,
    rope_mode="rope",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    source="hf:Qwen/Qwen1.5-32B (family ref hf:Qwen/Qwen1.5-0.5B)",
))

"""Qwen2-VL-72B language backbone [arXiv:2409.12191; hf].

VLM: M-RoPE (multimodal rotary: temporal/height/width sections), dynamic
resolution.  The vision encoder is a STUB per the assignment - dry-run
``input_specs`` provide token ids / patch-embedding stand-ins; M-RoPE is
implemented faithfully with text positions (t = h = w).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    mlp_kind="swiglu",
    qkv_bias=True,          # Qwen2 attention uses QKV bias
    rope_mode="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    norm="rmsnorm",
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B-Instruct",
))

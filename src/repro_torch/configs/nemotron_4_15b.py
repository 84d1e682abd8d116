"""Nemotron-4 15B [arXiv:2402.16819]: GQA + squared-ReLU MLP."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_kind="squared_relu",
    rope_mode="rope",
    rope_theta=10_000.0,
    norm="layernorm",
    source="arXiv:2402.16819",
))

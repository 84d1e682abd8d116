"""RWKV-6 "Finch" 7B [arXiv:2404.05892]: attention-free, data-dependent
decay; head size 64.  Runs ``long_500k`` (O(1) state)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # d_model / 64 heads of size 64
    n_kv_heads=64,
    d_head=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    mlp_kind="relu",         # channel-mix uses relu^2 internally
    rope_mode="none",
    norm="layernorm",
    source="arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b",
))

"""IBM Granite 3.0 2B base [hf:ibm-granite/granite-3.0-2b-base]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    mlp_kind="swiglu",
    rope_mode="rope",
    rope_theta=10_000.0,
    norm="rmsnorm",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
))

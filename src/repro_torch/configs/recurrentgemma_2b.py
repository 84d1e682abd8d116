"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427]: RG-LRU + local attention
in a 2:1 pattern (recurrent, recurrent, local-attn), window 2048.

Runs ``long_500k``: recurrent state + windowed cache are O(1) in context.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,            # MQA in the local-attention layers
    d_head=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local_attn"),
    attn_window=2048,
    d_rnn=2560,              # lru_width
    conv_width=4,
    mlp_kind="geglu",        # Gemma-family gated GELU
    rope_mode="rope",
    rope_theta=10_000.0,
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2402.19427; hf:google/recurrentgemma-2b",
))

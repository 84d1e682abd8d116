"""Whisper-tiny [arXiv:2212.04356]: encoder-decoder; conv frontend is a
STUB (input_specs supply precomputed 50Hz frame embeddings)."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,              # decoder layers
    n_encoder_layers=4,
    is_encoder_decoder=True,
    encoder_seq_len=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    block_pattern=("xattn",),
    mlp_kind="gelu",
    rope_mode="none",        # Whisper uses learned absolute positions
    norm="layernorm",
    tie_embeddings=True,
    source="arXiv:2212.04356; hf:openai/whisper-tiny",
))

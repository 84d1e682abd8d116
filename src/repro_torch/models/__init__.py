"""PyTorch model zoo of the port: the decoder models of ``model.py``."""
from .model import (
    Transformer,
    build_segments,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)

__all__ = ["Transformer", "build_segments", "decode_step", "forward",
           "init_cache", "init_params", "loss_fn", "prefill"]

"""PyTorch model zoo of the port: the dense decoder for now."""
from .model import (
    Transformer,
    build_segments,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)

__all__ = ["Transformer", "build_segments", "decode_step", "forward",
           "init_cache", "init_params", "prefill"]

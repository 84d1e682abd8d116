"""PyTorch model zoo of the port: the models of ``model.py``."""
from .model import (
    Transformer,
    build_segments,
    cache_specs,
    decode_step,
    encode,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)

__all__ = ["Transformer", "build_segments", "cache_specs", "decode_step",
           "encode", "forward", "init_cache", "init_params", "loss_fn",
           "prefill"]

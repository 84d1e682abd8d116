"""Architecture configs (one module per assigned arch) + shape sets."""
from .base import ModelConfig, all_configs, get_config, register
from .shapes import SHAPES, ShapeSpec, all_cells, applicable_shapes, skip_reason

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        deepseek_moe_16b,
        granite_3_2b,
        nemotron_4_15b,
        phi3_medium_14b,
        qwen1_5_32b,
        qwen2_vl_72b,
        qwen3_moe_30b_a3b,
        recurrentgemma_2b,
        rwkv6_7b,
        whisper_tiny,
    )


__all__ = [
    "SHAPES", "ModelConfig", "ShapeSpec", "all_cells", "all_configs",
    "applicable_shapes", "get_config", "register", "skip_reason",
]

"""Assigned input-shape sets for the LM-family architectures.

Each (arch x shape) pair is one dry-run/roofline cell.  ``decode_*`` /
``long_*`` lower ``serve_step`` (one new token against a KV cache of
``seq_len``); ``train_4k`` lowers ``train_step``; ``prefill_32k`` lowers
``prefill_step``.

``long_500k`` requires sub-quadratic context state: it runs only for the
hybrid/ssm architectures (recurrentgemma-2b, rwkv6-7b); pure full-attention
archs skip it (recorded in DESIGN.md section 5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# families whose context state is O(1)/O(window) in seq_len
SUBQUADRATIC_FAMILIES = ("hybrid", "ssm")


def applicable_shapes(cfg: ModelConfig) -> List[ShapeSpec]:
    out = []
    for spec in SHAPES.values():
        if spec.name == "long_500k" and cfg.family not in SUBQUADRATIC_FAMILIES:
            continue  # full-attention archs skip long-context decode
        out.append(spec)
    return out


def skip_reason(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    if (shape_name == "long_500k"
            and cfg.family not in SUBQUADRATIC_FAMILIES):
        return ("full-attention KV cache at 524k context is quadratic-cost; "
                "assignment: run long_500k only for SSM/hybrid archs")
    return None


def all_cells() -> List[Tuple[str, str]]:
    """Every (arch, shape) cell in the assignment - including skipped ones."""
    from .base import all_configs
    cells = []
    for name in sorted(all_configs()):
        for shape in SHAPES:
            cells.append((name, shape))
    return cells

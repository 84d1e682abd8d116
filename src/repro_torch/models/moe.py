"""Mixture-of-experts configuration.

Only the plain dataclass the configs need (a copy of the JAX package's
``models/moe.py:MoEConfig``); the MoE layers themselves are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int          # per-expert FFN width (fine-grained: small)
    n_shared: int = 0      # DeepSeekMoE shared experts (always active)
    capacity_factor: float = 1.25
    group_size: int = 512  # dispatch group size (bounds one-hot tensors)
    renormalize: bool = True  # renormalize top-k gate weights

"""Model configuration schema + registry for the assigned architectures.

Every architecture in the assignment pool is a ``ModelConfig``; reduced
smoke variants (same family, tiny dims) come from ``.smoke()`` and are what
the CPU tests instantiate.  The same data as the JAX package's
``configs/base.py``; only the dtype accessors differ: they return
``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from ..models.moe import MoEConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; have {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    # block structure: cycled over layers.  types: attn | local_attn |
    # rglru | rwkv6 | xattn (decoder self+cross)
    block_pattern: Tuple[str, ...] = ("attn",)
    attn_window: Optional[int] = None   # for local_attn
    # channel mixer
    mlp_kind: str = "swiglu"
    moe: Optional[MoEConfig] = None
    moe_layer_start: int = 0         # layers < start use a dense MLP
    d_ff_dense: int = 0              # dense-MLP width for pre-MoE layers
    # attention details
    qkv_bias: bool = False
    rope_mode: str = "rope"          # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    # recurrent details
    d_rnn: int = 0                   # 0 -> d_model
    conv_width: int = 4
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500      # whisper 30s @ 50Hz after conv stem
    # execution policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    q_block: int = 512               # chunked-attention query block
    moe_impl: str = "gshard"
    remat: bool = True
    # "full": recompute everything (min memory); "dots": save matmul
    # outputs (skips refwd matmuls AND their all-reduces at ~activation
    # memory cost - Megatron-style selective recompute)
    remat_policy: str = "full"
    # kept only for parity with the reference's configs, where it unrolls
    # the layer scans for XLA's cost analysis: the port runs its layers as
    # a Python loop, and its dry run counts every layer eagerly
    unroll: bool = False
    # KV-cache storage dtype ("" -> param_dtype).  "int8" is the
    # bandwidth-study variant (production int8-KV adds per-head scale
    # tensors, +1.6% bytes - see EXPERIMENTS.md section Perf)
    cache_dtype: str = ""

    def kv_dtype(self) -> torch.dtype:
        return _torch_dtype(self.cache_dtype or self.param_dtype)
    # citation / provenance
    source: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    def dtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return _torch_dtype(self.compute_dtype)

    def layer_types(self) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def channel_kind(self, layer_idx: int) -> str:
        """"mlp" | "moe" | "rwkv_cm" for layer ``layer_idx``."""
        if self.layer_types()[layer_idx] == "rwkv6":
            return "rwkv_cm"
        if self.moe is not None and layer_idx >= self.moe_layer_start:
            return "moe"
        return "mlp"

    def n_params(self) -> int:
        """Approximate parameter count (for 6ND roofline accounting)."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        for i, t in enumerate(self.layer_types()):
            if t in ("attn", "local_attn", "xattn"):
                hd = self.head_dim
                attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
                if t == "xattn":
                    attn *= 2
                total += attn
            elif t == "rglru":
                r = self.rnn_width
                total += 2 * d * r + self.conv_width * r + 2 * r * r + r * d
            elif t == "rwkv6":
                total += 4 * d * d + d * d  # r,k,v,g + out
            ck = self.channel_kind(i)
            n_mats = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
            if ck == "mlp":
                ff = self.d_ff_dense or self.d_ff
                total += n_mats * d * ff
            elif ck == "moe":
                m = self.moe
                total += d * m.n_experts
                total += m.n_experts * n_mats * d * m.d_expert
                if m.n_shared:
                    total += n_mats * d * m.d_expert * m.n_shared
            elif ck == "rwkv_cm":
                total += 2 * d * self.d_ff + d * d
        if self.is_encoder_decoder:
            hd = self.head_dim
            per_enc = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                       + self.n_heads * hd * d + 2 * d * self.d_ff)
            total += self.n_encoder_layers * per_enc
        return int(total)

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        n_mats = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        m = self.moe
        inactive_per_layer = (m.n_experts - m.top_k) * n_mats * d * m.d_expert
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.channel_kind(i) == "moe")
        return int(self.n_params() - n_moe_layers * inactive_per_layer)

    # -- reduced variants ----------------------------------------------------
    def smoke(self) -> "ModelConfig":
        """Tiny same-family config for CPU tests."""
        pattern_len = len(self.block_pattern)
        n_layers = max(pattern_len, 2)
        if self.moe_layer_start > 0:
            n_layers = max(n_layers, self.moe_layer_start + 1)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, n_experts=8,
                                      top_k=min(self.moe.top_k, 2),
                                      d_expert=32, group_size=16,
                                      n_shared=min(self.moe.n_shared, 1))
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=16,
            d_ff=96,
            d_ff_dense=96 if self.d_ff_dense else 0,
            vocab_size=128,
            d_rnn=64 if self.d_rnn or "rglru" in self.block_pattern else 0,
            attn_window=(8 if self.attn_window else None),
            moe=moe,
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq_len=16 if self.is_encoder_decoder else self.encoder_seq_len,
            mrope_sections=(4, 2, 2) if self.rope_mode == "mrope" else self.mrope_sections,
            param_dtype="float32",
            compute_dtype="float32",
            q_block=16,
            # exact (drop-free) MoE for numerical decode==forward checks;
            # the capacity-dispatch path is tested separately in
            # tests/test_torch_moe.py
            moe_impl="dense" if self.moe is not None else self.moe_impl,
            remat=False,
        )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import _load_all  # noqa - populate registry
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    from . import _load_all
    _load_all()
    return dict(_REGISTRY)

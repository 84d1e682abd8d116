"""Step functions (train / prefill / serve) and dry-run input specs (port
of ``runtime/steps.py``).

The reference's steps close over the static ModelConfig and are jitted;
here they run eagerly.  The train step differentiates ``loss_fn`` with
autograd - on the card through the hand-written attention backward - and
applies AdamW in place.  The prefill and serve steps run under
``torch.inference_mode()``.  The spec functions give tensors on
``torch.device("meta")``: shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from ..models import model as model_lib
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state

_META = torch.device("meta")


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: one forward and backward of ``loss_fn`` over ``params`` (a
    :class:`~repro_torch.models.Transformer` whose parameters require
    grad), then AdamW, which writes the parameters and moments in place.
    ``metrics``: "loss", "ce", "aux", "grad_norm", "lr" as 0-d tensors."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state, batch):
        for p in params.parameters():
            p.grad = None
        loss, metrics = model_lib.loss_fn(cfg, params, batch)
        loss.backward()
        named = dict(params.named_parameters())
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        _, new_opt, opt_metrics = adamw_update(opt_cfg, grads, opt_state,
                                               named)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return params, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.inference_mode()
    def prefill_step(params, batch):
        return model_lib.prefill(cfg, params, batch["tokens"],
                                 frames=batch.get("frames"),
                                 cache_len=batch["tokens"].shape[1])
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy next token against a filled KV cache."""

    @torch.inference_mode()
    def serve_step(params, caches, token):
        logits, new_caches = model_lib.decode_step(cfg, params, caches, token)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, new_caches

    return serve_step


# ---------------------------------------------------------------------------
# dry-run input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    specs = {
        "tokens": torch.empty((B, S), dtype=torch.int32, device=_META),
        "labels": torch.empty((B, S), dtype=torch.int32, device=_META),
    }
    if cfg.is_encoder_decoder:
        # modality frontend stub: precomputed frame embeddings
        specs["frames"] = torch.empty(
            (B, cfg.encoder_seq_len, cfg.d_model), dtype=cfg.cdtype(),
            device=_META)
    return specs


def params_specs(cfg: ModelConfig) -> model_lib.Transformer:
    return model_lib.Transformer(cfg, None, _META)


def opt_state_specs(params) -> Dict[str, Any]:
    return init_opt_state(params)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    return model_lib.cache_specs(cfg, batch, cache_len)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Every model input for the given cell, as meta tensors."""
    if shape.kind == "train":
        p = params_specs(cfg)
        return {
            "params": p,
            "opt_state": opt_state_specs(p),
            "batch": batch_specs(cfg, shape),
        }
    if shape.kind == "prefill":
        return {
            "params": params_specs(cfg),
            "batch": batch_specs(cfg, shape),
        }
    if shape.kind == "decode":
        return {
            "params": params_specs(cfg),
            "caches": cache_specs(cfg, shape.global_batch, shape.seq_len),
            "token": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                 device=_META),
        }
    raise ValueError(shape.kind)

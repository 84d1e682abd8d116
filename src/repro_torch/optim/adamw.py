"""AdamW over named tensors (port of ``optim/adamw.py``).

Mixed precision as in the reference: parameters stay in their stored
dtype (bf16 in production configs); first and second moments are
float32; global-norm gradient clipping; a linear warmup then a cosine
schedule; no weight decay on tensors of fewer than 2 dims in the
reference's tree (the top-level norms: a layer's tensors are stacked
there over its segment's repeats, so its norms and biases are 2-D and
decayed; the caller passes that as ``decay``).  Parameters, gradients
and moments are flat mappings from a name to a tensor (a model's
``named_parameters()``); the step's scalars are 0-d tensors on the
parameters' device, so nothing waits on the card.

One difference of form: :func:`adamw_update` writes the new parameters
and moments into the tensors it is given (the reference returns new
arrays), and widens and clips one gradient at a time, so a model of
billions of parameters is not held twice; it returns the same mappings.
Each value is computed in the reference's order, op by op, in float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

Named = Mapping[str, torch.Tensor]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def named_tensors(params: Union[Named, nn.Module]) -> Dict[str, torch.Tensor]:
    """A model's parameters by name, or the mapping itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params: Union[Named, nn.Module]) -> Dict[str, object]:
    """{"m": zeros, "v": zeros (float32, one per parameter), "step": 0-d
    int32}, on the parameters' device."""
    named = named_tensors(params)
    device = next(iter(named.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"m": {n: zeros(p) for n, p in named.items()},
            "v": {n: zeros(p) for n, p in named.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine down to
    ``lr * min_lr_ratio`` at ``total_steps``; a float32 0-d tensor."""
    step_f = torch.as_tensor(step).float()
    warm = step_f / max(cfg.warmup_steps, 1)
    progress = torch.clamp((step_f - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
    cosine = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1.0 + torch.cos(math.pi * progress))
    return cfg.lr * torch.where(step_f < cfg.warmup_steps, warm, cosine)


def global_norm(tree: Named) -> torch.Tensor:
    """sqrt of the sum over tensors of their float32 sums of squares."""
    total = 0
    for leaf in tree.values():
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads: Named, max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), the norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Named, opt_state: Dict[str, object],
                 params: Union[Named, nn.Module],
                 decay: Optional[Mapping[str, bool]] = None,
                 grad_norm: Optional[torch.Tensor] = None
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, object],
                            Dict[str, torch.Tensor]]:
    """One AdamW step.  ``grads`` holds a gradient for every parameter;
    ``decay`` says which parameters take weight decay (default: those of 2
    or more dims, the reference's rule on its own tree; a model's is
    :func:`repro_torch.models.convert.decay_mask`).  Writes the new
    parameters and moments in place; returns (params, opt_state with the
    new step, {"grad_norm": the norm before clipping, "lr"}).  Where
    ``params`` and ``grads`` are one rank's blocks of sharded tensors,
    ``grad_norm`` is the whole gradient's global norm."""
    named = named_tensors(params)
    # clip_by_global_norm's values, one tensor at a time: no float32 copy
    # of every gradient at once
    if grad_norm is None:
        grad_norm = global_norm({n: grads[n] for n in named})
    scale = torch.clamp(cfg.clip_norm / torch.clamp(grad_norm, min=1e-12),
                        max=1.0)
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    m_all, v_all = opt_state["m"], opt_state["v"]
    for name, p in named.items():
        g, m, v = grads[name].float() * scale, m_all[name], v_all[name]
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        m_hat = m_new / bc1
        v_hat = v_new / bc2
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps)
        decays = p.dim() >= 2 if decay is None else decay[name]
        if cfg.weight_decay > 0 and decays:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
    opt_state["step"] = step
    return named, opt_state, {"grad_norm": grad_norm, "lr": lr}

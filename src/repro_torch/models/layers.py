"""Shared layer primitives for the model zoo (port of ``models/layers.py``).

Functions of plain tensors: parameters are passed as dicts or modules whose
entries carry the JAX package's names and layouts (a weight is
``(in, out)`` and applied as ``x @ w``).  Dtype policy as in the
reference: parameters in ``param_dtype``, activations in
``compute_dtype``, normalization statistics, rotary angles and softmax in
float32.
"""
from __future__ import annotations

import functools
import math
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class ParamModule(nn.Module):
    """A module whose own parameters and submodules carry the reference's
    names and index like its dicts: ``m["w_q"]``, ``"b_q" in m``,
    ``moe["experts"]["w_up"]``.  Parameters are made with
    ``requires_grad=False``, so serving records no graph; training turns
    them on (``init_params(..., trainable=True)``, or
    ``requires_grad_(True)`` on the model)."""

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules

    def add(self, name: str, value: torch.Tensor) -> None:
        self.register_parameter(name, nn.Parameter(value, requires_grad=False))


# ---------------------------------------------------------------------------
# init helpers (the reference's distributions; the draws come from a
# torch.Generator and so differ from jax.random's)
# ---------------------------------------------------------------------------


def dense_init(gen: Optional[torch.Generator], in_dim: int, out_dim: int,
               dtype: torch.dtype, lead: Tuple[int, ...] = (),
               device=None) -> torch.Tensor:
    """N(0, 1/in_dim) weights of shape ``lead + (in_dim, out_dim)`` (a
    leading ``(n,)`` stacks n of them: the experts), drawn in float32 on
    the generator's device; ``gen=None`` leaves them unset (to be filled,
    e.g. from the reference's) on ``device``."""
    shape = lead + (in_dim, out_dim)
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """N(0, 0.02^2) embeddings of shape (vocab, dim)."""
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def rmsnorm(params: Mapping[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def layernorm(params: Mapping[str, torch.Tensor], x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64) / d_head))


# Small constants are copied to each device once: a copy from host memory
# on every call would make the host wait on the device at every layer.
@functools.lru_cache(maxsize=None)
def _rope_freqs(d_head: int, theta: float, device: str) -> torch.Tensor:
    return torch.as_tensor(rope_frequencies(d_head, theta),
                           dtype=torch.float32).to(device)


@functools.lru_cache(maxsize=None)
def _mrope_section_ids(sections: Tuple[int, ...], device: str
                       ) -> torch.Tensor:
    return torch.as_tensor(np.concatenate(
        [np.full(s, i) for i, s in enumerate(sections)])).to(device)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, d_head); positions: broadcastable to (..., S)."""
    freqs = _rope_freqs(x.shape[-1], theta, str(x.device))
    angles = positions[..., :, None].float() * freqs  # (..., S, d/2)
    return _rotate(x, torch.cos(angles)[..., :, None, :],
                   torch.sin(angles)[..., :, None, :])


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                sections: Tuple[int, int, int] = (16, 24, 24),
                theta: float = 1_000_000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE [arXiv:2409.12191].

    The d_head/2 frequency dims are split into (temporal, height, width)
    sections; each section rotates by its own position stream.
    x: (B, S, H, d_head); positions_3d: (3, B, S)."""
    d_head = x.shape[-1]
    if sum(sections) != d_head // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to "
                         f"{d_head // 2}")
    freqs = _rope_freqs(d_head, theta, str(x.device))
    sec_id = _mrope_section_ids(tuple(sections), str(x.device))
    pos_per_dim = positions_3d.float()[sec_id]  # (d/2, B, S)
    angles = torch.einsum("dbs,d->bsd", pos_per_dim, freqs)  # (B, S, d/2)
    return _rotate(x, torch.cos(angles)[:, :, None, :],
                   torch.sin(angles)[:, :, None, :])


def text_mrope_positions(batch: int, seq: int, offset=0,
                         device=None) -> torch.Tensor:
    """(3, B, S) positions for text-only inputs (t = h = w = index)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(batch, seq)[None].expand(3, batch, seq)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

MLP_KINDS = ("swiglu", "geglu", "gelu", "squared_relu", "relu")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def apply_mlp(params: Mapping[str, torch.Tensor], x: torch.Tensor,
              kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif kind == "geglu":
        h = _gelu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif kind == "gelu":
        h = _gelu(x @ params["w_up"])
    elif kind == "squared_relu":  # Nemotron-4 [arXiv:2402.16819]
        h = torch.square(F.relu(x @ params["w_up"]))
    elif kind == "relu":
        h = F.relu(x @ params["w_up"])
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return h @ params["w_down"]


class FeedForward(ParamModule):
    """An MLP's weights under the reference's names: ``w_gate`` (the gated
    kinds), ``w_up`` (d_model, d_ff) and ``w_down`` (d_ff, d_model).  With
    ``lead=(n,)`` each is n of them stacked on a leading axis, one per
    expert; ``apply_mlp`` then runs every expert as one batched product on
    an (n, tokens, d_model) input.  ``gen=None`` leaves the weights unset
    (to be filled, e.g. from the reference's) on ``device``."""

    def __init__(self, d_model: int, d_ff: int, kind: str,
                 gen: Optional[torch.Generator], dtype: torch.dtype, device,
                 lead: Tuple[int, ...] = ()) -> None:
        super().__init__()
        self.kind = kind
        shapes = [("w_up", d_model, d_ff), ("w_down", d_ff, d_model)]
        if kind in ("swiglu", "geglu"):
            shapes.insert(0, ("w_gate", d_model, d_ff))
        for name, in_dim, out_dim in shapes:
            self.add(name, dense_init(gen, in_dim, out_dim, dtype, lead,
                                      device))


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def embed_tokens(params: Mapping[str, torch.Tensor],
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["tokens"][tokens.long()]


def unembed(params: Mapping[str, torch.Tensor], x: torch.Tensor
            ) -> torch.Tensor:
    if "unembed" in params:
        return x @ params["unembed"]
    return x @ params["tokens"].t().to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE.  logits (B, S, V), computed in float32; labels
    (B, S); with ``mask`` (B, S) the masked mean, over at least 1.  Inside
    the sharded train step the mean is the whole batch's: the sum and the
    count are summed over the batch's ranks before the division."""
    from ..runtime.mesh_context import batch_axes, whole_batch_sum
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - label_logit
    if batch_axes():
        w = torch.ones_like(nll) if mask is None else mask.float()
        total, count = whole_batch_sum((nll * w).sum(), w.sum())
        return total / torch.clamp(count, min=1.0)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()

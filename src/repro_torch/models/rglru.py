"""RG-LRU recurrent block (Griffin / RecurrentGemma [arXiv:2402.19427])
(port of ``models/rglru.py``).

Block structure (the paper's "recurrent block"):
    x -> linear (2 branches) -> [branch1: gelu] ; [branch2: conv1d -> RG-LRU]
      -> elementwise product -> linear out

RG-LRU recurrence (real-gated linear recurrent unit), per channel:
    r_t = sigmoid(W_a x_t + b_a)                     (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                     (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)           (decay in (0, 1))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference evaluates the sequence form with an associative scan; here
:func:`rglru_scan` hands it to ``ops.rglru_scan`` (the CUDA kernel on the
card, the serial plain version on the host), so every prefill and every
decode step of a recurrent layer launches the kernel once.  Parameters
keep the reference's names (``w_in_rnn``, ..., ``lambda``), ``lambda``
stays float32 whatever the config's dtype, and the gate math runs in
float32 as the reference's does.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import ParamModule, _gelu, dense_init

C_FACTOR = 8.0  # Griffin's fixed scaling constant


def init_rglru_block(gen: Optional[torch.Generator], d_model: int, d_rnn: int,
                     conv_width: int, dtype: torch.dtype,
                     device=None) -> dict:
    """The reference's parameters and distributions, drawn from ``gen`` on
    its device (``gen=None`` leaves the weights unset, to be filled, e.g.
    from the reference's, on ``device``)."""
    if gen is None:
        shapes = {"w_in_rnn": (d_model, d_rnn), "w_in_gate": (d_model, d_rnn),
                  "conv_w": (conv_width, d_rnn), "conv_b": (d_rnn,),
                  "w_a": (d_rnn, d_rnn), "b_a": (d_rnn,),
                  "w_x": (d_rnn, d_rnn), "b_x": (d_rnn,), "lambda": (d_rnn,),
                  "w_out": (d_rnn, d_model)}
        return {name: torch.empty(shape, device=device,
                                  dtype=torch.float32 if name == "lambda"
                                  else dtype)
                for name, shape in shapes.items()}
    dev = gen.device
    # Lambda so that a ~ Uniform(0.9, 0.999)^c (Griffin appendix)
    u = torch.empty((d_rnn,), dtype=torch.float32, device=dev).uniform_(
        0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / C_FACTOR))  # softplus^-1
    conv_w = torch.randn((conv_width, d_rnn), generator=gen,
                         dtype=torch.float32, device=dev)
    return {
        "w_in_rnn": dense_init(gen, d_model, d_rnn, dtype),
        "w_in_gate": dense_init(gen, d_model, d_rnn, dtype),
        "conv_w": (conv_w * (1.0 / math.sqrt(conv_width))).to(dtype),
        "conv_b": torch.zeros((d_rnn,), dtype=dtype, device=dev),
        "w_a": dense_init(gen, d_rnn, d_rnn, dtype),
        "b_a": torch.zeros((d_rnn,), dtype=dtype, device=dev),
        "w_x": dense_init(gen, d_rnn, d_rnn, dtype),
        "b_x": torch.zeros((d_rnn,), dtype=dtype, device=dev),
        "lambda": lam,  # float32
        "w_out": dense_init(gen, d_rnn, d_model, dtype),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (B, S, D); w: (W, D).

    state: (B, W-1, D) left context (decode); returns (y, new_state)."""
    W, S = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+W-1, D)
    y = sum(xp[:, i:i + S] * w[i] for i in range(W)) + b
    new_state = xp[:, S:] if W > 1 else state
    return y.to(x.dtype), new_state


def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + x_t from ``h_{-1} = h0``, through
    ``ops.rglru_scan``.

    x, a: (B, S, D) float32; h0: (B, D) float32 or None (zero).  The
    reference folds h0 into the first step (``x_0 + a_0 h0``); here the
    kernel starts its carry from h0, the same sum.  Returns
    (h (B, S, D), h_last (B, D))."""
    h = ops.rglru_scan(x, a, h0)
    return h, h[:, -1]


def rglru(params: Mapping[str, torch.Tensor], x: torch.Tensor,
          h0: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU over a sequence.  x: (B, S, D_rnn).  float32 state math."""
    xf = x.float()
    r = torch.sigmoid(xf @ params["w_a"].float() + params["b_a"].float())
    i = torch.sigmoid(xf @ params["w_x"].float() + params["b_x"].float())
    log_a = -C_FACTOR * F.softplus(params["lambda"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)
                       ) * (i * xf)
    h, h_last = rglru_scan(gated, a, h0)
    return h.to(x.dtype), h_last


def apply_rglru_block(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                      state: Optional[dict] = None
                      ) -> Tuple[torch.Tensor, dict]:
    """Full Griffin recurrent block.  x: (B, S, d_model).

    state (decode): {"h": (B, D_rnn) float32, "conv": (B, W-1, D_rnn)}.
    Returns (output (B, S, d_model), the new state); the state given is
    not written."""
    gate = _gelu(x @ params["w_in_gate"])
    u = x @ params["w_in_rnn"]
    conv_state = state["conv"] if state is not None else None
    u, new_conv = causal_conv1d(u, params["conv_w"], params["conv_b"],
                                conv_state)
    h0 = state["h"] if state is not None else None
    h, h_last = rglru(params, u, h0)
    out = (h * gate) @ params["w_out"]
    return out, {"h": h_last, "conv": new_conv}


class RecurrentBlock(ParamModule):
    """The recurrent block's parameters under the reference's names
    (``block["w_a"]``, ``block["lambda"]``).  As a mixer of
    ``models/model.py`` it runs a whole sequence (``forward``) or one
    decode step (``step``) through :func:`apply_rglru_block`; its cache is
    its state."""

    def __init__(self, cfg, gen: Optional[torch.Generator], dtype, device
                 ) -> None:
        super().__init__()
        for name, value in init_rglru_block(gen, cfg.d_model, cfg.rnn_width,
                                            cfg.conv_width, dtype,
                                            device).items():
            self.add(name, value)

    def forward(self, x: torch.Tensor, positions=None,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Whole sequence from a zero state (positions are not used).
        With ``cache_len`` it also returns the state after it."""
        out, state = apply_rglru_block(self, x)
        return out, state if cache_len is not None else None

    def step(self, x: torch.Tensor, state: dict) -> Tuple[torch.Tensor, dict]:
        """One decode step from ``state``; returns a new state."""
        return apply_rglru_block(self, x, state)

    @staticmethod
    def empty_cache(cfg, batch: int, cache_len: int, device) -> dict:
        return init_rglru_state(batch, cfg.rnn_width, cfg.conv_width,
                                cfg.kv_dtype(), device)


def init_rglru_state(batch: int, d_rnn: int, conv_width: int,
                     dtype: torch.dtype, device=None) -> dict:
    return {
        "h": torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, d_rnn), dtype=dtype,
                            device=device),
    }

"""RWKV-6 "Finch" [arXiv:2404.05892]: attention-free, data-dependent decay
(port of ``models/rwkv6.py``).

Time-mix recurrence (per head, state S in R^{dk x dv}):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with per-channel decay w_t = exp(-exp(w0 + lora_w(x))) data-dependent (the
v6 novelty) and token-shift ddlerp mixing on every projection input.

The reference evaluates a sequence in the chunked (GLA) form and a decode
step serially; here both go through ``ops.wkv6`` (the CUDA kernel on the
card, the serial plain version on the host), so every prefill and every
decode step of an ``rwkv6`` layer launches the kernel once, from the
layer's state.  Parameters keep the reference's names; ``w0`` and ``u``
stay float32 whatever the config's dtype, and the decay, the recurrence
and the per-head norm run in float32 as the reference's do.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import ParamModule, dense_init

DDLERP_DIM = 32   # TIME_MIX_EXTRA_DIM
DECAY_DIM = 64    # TIME_DECAY_EXTRA_DIM
_FLOAT32 = ("w0", "u")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _time_mix_shapes(d_model: int, n_heads: int) -> dict:
    d = d_model
    shapes = {f"mu_{n}": (d,) for n in "xwkvrg"}
    shapes.update({"tm_w1": (d, 5 * DDLERP_DIM),
                   "tm_w2": (5, DDLERP_DIM, d), "td_w1": (d, DECAY_DIM),
                   "td_w2": (DECAY_DIM, d), "w0": (d,), "w_r": (d, d),
                   "w_k": (d, d), "w_v": (d, d), "w_g": (d, d),
                   "u": (n_heads, d // n_heads), "ln_x_scale": (d,),
                   "ln_x_bias": (d,), "w_o": (d, d)})
    return shapes


def _empty(shapes: dict, dtype, device) -> dict:
    return {name: torch.empty(shape, device=device,
                              dtype=torch.float32 if name in _FLOAT32
                              else dtype)
            for name, shape in shapes.items()}


def _mu(gen: torch.Generator, d: int, dtype) -> torch.Tensor:
    return torch.rand((d,), generator=gen, dtype=torch.float32,
                      device=gen.device).to(dtype)


def _small(gen: torch.Generator, shape, dtype, scale: float) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def init_rwkv6_time_mix(gen: Optional[torch.Generator], d_model: int,
                        n_heads: int, dtype, device=None) -> dict:
    """The reference's parameters and distributions, drawn from ``gen`` on
    its device (``gen=None`` leaves them unset, to be filled, e.g. from the
    reference's, on ``device``)."""
    shapes = _time_mix_shapes(d_model, n_heads)
    if gen is None:
        return _empty(shapes, dtype, device)
    d, dev = d_model, gen.device
    p = {f"mu_{n}": _mu(gen, d, dtype) for n in "xwkvrg"}
    p.update({
        "tm_w1": dense_init(gen, d, 5 * DDLERP_DIM, dtype),
        "tm_w2": _small(gen, shapes["tm_w2"], dtype, 0.01),
        "td_w1": dense_init(gen, d, DECAY_DIM, dtype),
        "td_w2": _small(gen, shapes["td_w2"], dtype, 0.01),
        # decays spread over (-6, -1) pre-exp (slow..fast)
        "w0": torch.linspace(-6.0, -1.0, d, dtype=torch.float32, device=dev),
        "w_r": dense_init(gen, d, d, dtype),
        "w_k": dense_init(gen, d, d, dtype),
        "w_v": dense_init(gen, d, d, dtype),
        "w_g": dense_init(gen, d, d, dtype),
        "u": _small(gen, shapes["u"], torch.float32, 0.1),
        "ln_x_scale": torch.ones((d,), dtype=dtype, device=dev),
        "ln_x_bias": torch.zeros((d,), dtype=dtype, device=dev),
        "w_o": dense_init(gen, d, d, dtype),
    })
    return p


def init_rwkv6_channel_mix(gen: Optional[torch.Generator], d_model: int,
                           d_ff: int, dtype, device=None) -> dict:
    shapes = {"mu_k": (d_model,), "mu_r": (d_model,),
              "w_k": (d_model, d_ff), "w_v": (d_ff, d_model),
              "w_r": (d_model, d_model)}
    if gen is None:
        return _empty(shapes, dtype, device)
    return {"mu_k": _mu(gen, d_model, dtype), "mu_r": _mu(gen, d_model, dtype),
            "w_k": dense_init(gen, d_model, d_ff, dtype),
            "w_v": dense_init(gen, d_ff, d_model, dtype),
            "w_r": dense_init(gen, d_model, d_model, dtype)}


# ---------------------------------------------------------------------------
# token shift + ddlerp
# ---------------------------------------------------------------------------


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} along the sequence.  prev: (B, D) last token of the previous
    segment (decode), else zeros."""
    if prev is None:
        prev = x.new_zeros((x.shape[0], 1, x.shape[2]))
    else:
        prev = prev[:, None, :].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _last(x: torch.Tensor) -> torch.Tensor:
    """x[:, -1] as the next segment's shift state: a copy when it would be
    a view of a longer sequence, so a cache does not hold the prefill's
    activations."""
    return x[:, -1] if x.shape[1] == 1 else x[:, -1].clone()


def ddlerp_inputs(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                  x_prev: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Data-dependent lerp producing the 5 projection inputs (w, k, v, r, g)."""
    xx = x_prev - x
    xxx = x + xx * params["mu_x"]
    # (B, S, 5*DD) -> (5, B, S, DD) -> (5, B, S, D)
    mix = torch.tanh(xxx @ params["tm_w1"])
    B, S, _ = x.shape
    mix = mix.reshape(B, S, 5, DDLERP_DIM).permute(2, 0, 1, 3)
    dyn = torch.einsum("nbsd,ndm->nbsm", mix,
                       params["tm_w2"].to(mix.dtype))
    mus = torch.stack([params["mu_w"], params["mu_k"], params["mu_v"],
                       params["mu_r"], params["mu_g"]]).to(x.dtype)
    outs = x[None] + xx[None] * (mus[:, None, None, :] + dyn.to(x.dtype))
    return tuple(outs.unbind(0))


def decay_log(params: Mapping[str, torch.Tensor], xw: torch.Tensor
              ) -> torch.Tensor:
    """log w_t = -exp(w0 + lora(xw)), clamped at -5 as in the reference.
    float32."""
    lora = torch.tanh(xw @ params["td_w1"]) @ params["td_w2"]
    return torch.clamp(-torch.exp(params["w0"] + lora.float()), min=-5.0)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                n_heads: int, eps: float = 64e-5) -> torch.Tensor:
    """Per-head LayerNorm over the head channel dim (RWKV's ln_x).
    float32."""
    B, S, D = x.shape
    xh = x.reshape(B, S, n_heads, D // n_heads).float()
    mean = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return xh.reshape(B, S, D) * scale.float() + bias.float()


# ---------------------------------------------------------------------------
# full blocks
# ---------------------------------------------------------------------------


def apply_time_mix(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                   n_heads: int, state: Optional[dict] = None
                   ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D).  state: {"shift": (B, D), "wkv": (B, H, K, V) float32}
    or None (zero).  Returns (output, the new state); the state given is
    not written."""
    B, S, D = x.shape
    d_head = D // n_heads
    prev = state["shift"] if state is not None else None
    xw, xk, xv, xr, xg = ddlerp_inputs(params, x, _shift(x, prev))
    r = (xr @ params["w_r"]).reshape(B, S, n_heads, d_head)
    k = (xk @ params["w_k"]).reshape(B, S, n_heads, d_head)
    v = (xv @ params["w_v"]).reshape(B, S, n_heads, d_head)
    g = F.silu(xg @ params["w_g"])
    logw = decay_log(params, xw).reshape(B, S, n_heads, d_head)
    s0 = state["wkv"] if state is not None else None
    y, s_last = ops.wkv6(r, k, v, logw, params["u"], s0)
    y = _group_norm(y.reshape(B, S, D), params["ln_x_scale"],
                    params["ln_x_bias"], n_heads).to(x.dtype)
    out = (y * g) @ params["w_o"]
    return out, {"shift": _last(x), "wkv": s_last}


def apply_channel_mix(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                      state: Optional[dict] = None
                      ) -> Tuple[torch.Tensor, dict]:
    prev = state["shift"] if state is not None else None
    xx = _shift(x, prev) - x
    xk = x + xx * params["mu_k"]
    xr = x + xx * params["mu_r"]
    k = torch.square(F.relu(xk @ params["w_k"]))
    out = torch.sigmoid(xr @ params["w_r"]) * (k @ params["w_v"])
    return out, {"shift": _last(x)}


def _shift_state(batch: int, d_model: int, dtype, device) -> dict:
    return {"shift": torch.zeros((batch, d_model), dtype=dtype,
                                 device=device)}


def _time_mix_state(batch: int, d_model: int, n_heads: int, dtype,
                    device) -> dict:
    d_head = d_model // n_heads
    return {**_shift_state(batch, d_model, dtype, device),
            "wkv": torch.zeros((batch, n_heads, d_head, d_head),
                               dtype=torch.float32, device=device)}


def init_rwkv6_state(batch: int, d_model: int, n_heads: int,
                     dtype: torch.dtype, device=None) -> dict:
    return {"tm": _time_mix_state(batch, d_model, n_heads, dtype, device),
            "cm": _shift_state(batch, d_model, dtype, device)}


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class TimeMix(ParamModule):
    """The time mix's parameters under the reference's names
    (``block.tm["w_r"]``, ``block.tm["u"]``).  As a mixer of
    ``models/model.py`` it runs a whole sequence (``forward``) or one
    decode step (``step``) through :func:`apply_time_mix`; its cache is
    its state {"shift", "wkv"}."""

    def __init__(self, cfg, gen: Optional[torch.Generator], dtype, device
                 ) -> None:
        super().__init__()
        self.n_heads = cfg.n_heads
        for name, value in init_rwkv6_time_mix(gen, cfg.d_model, cfg.n_heads,
                                               dtype, device).items():
            self.add(name, value)

    def forward(self, x: torch.Tensor, positions=None,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Whole sequence from a zero state (positions are not used).
        With ``cache_len`` it also returns the state after it."""
        out, state = apply_time_mix(self, x, self.n_heads)
        return out, state if cache_len is not None else None

    def step(self, x: torch.Tensor, state: dict) -> Tuple[torch.Tensor, dict]:
        """One decode step from ``state``; returns a new state."""
        return apply_time_mix(self, x, self.n_heads, state)

    @staticmethod
    def empty_cache(cfg, batch: int, cache_len: int, device) -> dict:
        return _time_mix_state(batch, cfg.d_model, cfg.n_heads,
                               cfg.kv_dtype(), device)


class ChannelMix(ParamModule):
    """The channel mix under the reference's names (``block.cm["w_k"]``):
    a channel of ``models/model.py`` with a state, the last token
    ({"shift"})."""

    has_state = True

    def __init__(self, cfg, gen: Optional[torch.Generator], dtype, device
                 ) -> None:
        super().__init__()
        for name, value in init_rwkv6_channel_mix(gen, cfg.d_model, cfg.d_ff,
                                                  dtype, device).items():
            self.add(name, value)

    def forward(self, x: torch.Tensor, state: Optional[dict] = None,
                need_aux: bool = False) -> Tuple[torch.Tensor, dict, None]:
        return (*apply_channel_mix(self, x, state), None)

    @staticmethod
    def empty_cache(cfg, batch: int, device) -> dict:
        return _shift_state(batch, cfg.d_model, cfg.kv_dtype(), device)

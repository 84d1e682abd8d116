"""Model assembly (port of ``models/model.py``).

``init_params`` builds a :class:`Transformer`: an embedding, an
``nn.ModuleList`` of :class:`DecoderBlock` (norm, a mixer - :class:`Attention`,
:class:`~repro_torch.models.rglru.RecurrentBlock` or
:class:`~repro_torch.models.rwkv6.TimeMix` - norm, a channel -
:class:`MLP`, :class:`~repro_torch.models.moe.MoE` or
:class:`~repro_torch.models.rwkv6.ChannelMix`) and a final norm.  Every
module keeps the JAX package's parameter names and ``(in, out)`` layouts,
so its parameters index like the reference's dicts
(``block.attn["w_q"]``) and :mod:`repro_torch.models.convert` can carry
the reference's weights over one to one.  ``forward``, ``loss_fn``,
``prefill``, ``decode_step``, ``init_cache``, ``encode`` and
``cache_specs`` keep the reference's names and signatures as thin
functions over the modules, so the serving and training code reads the
same in both packages.

Layers run as a Python loop; the reference's segments (stacked
``lax.scan`` bodies) are a JAX compile-time device and are kept only to map
its stacked weights and caches onto layers (:func:`build_segments`).

The port covers mixers ``"attn"``, ``"local_attn"`` (windowed, with a
ring-buffer cache), ``"rglru"`` (the RG-LRU recurrent block, whose cache
is its state), ``"rwkv6"`` (RWKV-6's time mix, likewise), ``"enc_attn"``
(the encoder's full self-attention) and ``"xattn"`` (causal
self-attention, then ``ln_x`` and cross-attention to the encoder's output,
whose keys and values join the layer's cache as ``cross_k`` /
``cross_v``), channels
``"mlp"`` (all five kinds), ``"moe"`` (routed experts, dense or
capacity-dispatched, with an auxiliary load-balance loss that ``forward``
sums over the layers) and ``"rwkv_cm"`` (RWKV-6's channel mix, whose
state joins the mixer's in the layer's cache), rmsnorm or layernorm,
rope, M-RoPE or none, optional QKV bias, tied or untied embeddings -
granite-3-2b, phi3-medium-14b, qwen1.5-32b, nemotron-4-15b, the
qwen2-vl-72b text backbone, recurrentgemma-2b, rwkv6-7b,
deepseek-moe-16b, qwen3-moe-30b-a3b and the encoder-decoder whisper-tiny
(its encoder over precomputed frame embeddings, as the reference's conv
stub, with sinusoidal positions in both stacks).  ``decode_step`` writes
the attention layers' K/V caches in place and returns new recurrent
states.

Training: with ``cfg.remat`` and grad mode on, each layer runs under
``torch.utils.checkpoint`` (its activations recomputed in the backward),
as the reference wraps each layer in ``jax.checkpoint``; the
``remat_policy`` ``"dots"`` of the reference (keep the products) has no
counterpart and recomputes the whole layer too.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from . import attention as attn_lib
from .layers import (
    MLP_KINDS,
    FeedForward,
    ParamModule,
    apply_mlp,
    dense_init,
    embed_init,
    embed_tokens,
    layernorm,
    rmsnorm,
    softmax_cross_entropy,
    text_mrope_positions,
    unembed,
)
from .moe import MoE
from .rglru import RecurrentBlock
from .rwkv6 import ChannelMix, TimeMix

if TYPE_CHECKING:  # configs.base imports models.moe
    from ..configs.base import ModelConfig

LayerSig = Tuple[str, str]  # (mixer, channel): ("attn", "mlp"), ...


@dataclass(frozen=True)
class Segment:
    pattern: Tuple[LayerSig, ...]
    repeats: int


def layer_signatures(cfg: ModelConfig) -> List[LayerSig]:
    return [(t, cfg.channel_kind(i)) for i, t in enumerate(cfg.layer_types())]


def split_segments(sigs: List[LayerSig]) -> List[Segment]:
    """The reference's segment splitter (maximal runs of a repeating layer
    signature), carried as is: the order of its stacked weights."""
    segments: List[Segment] = []
    i = 0
    while i < len(sigs):
        rest = sigs[i:]
        q_best, reps_best = len(rest), 1
        for q in range(1, len(rest) + 1):
            reps = len(rest) // q
            if reps >= 2 and all(rest[j] == rest[j % q] for j in range(reps * q)):
                q_best, reps_best = q, reps
                break
        if reps_best == 1 and len(rest) > 1:
            r = 1
            while r < len(rest) and rest[r] == rest[0]:
                r += 1
            q_best, reps_best = 1, r
        segments.append(Segment(pattern=tuple(rest[:q_best]), repeats=reps_best))
        i += q_best * reps_best
    return segments


def build_segments(cfg: ModelConfig) -> List[Segment]:
    return split_segments(layer_signatures(cfg))


def encoder_signatures(cfg: ModelConfig) -> List[LayerSig]:
    """The encoder's layers (an encoder-decoder's; none otherwise)."""
    return [("enc_attn", "mlp")] * (cfg.n_encoder_layers
                                    if cfg.is_encoder_decoder else 0)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a layer or MLP kind the port does not
    know."""
    for mixer, channel in layer_signatures(cfg) + encoder_signatures(cfg):
        if mixer not in MIXERS or channel not in CHANNELS:
            raise ValueError(f"{cfg.name}: unknown layer {mixer}/{channel}")
    if cfg.mlp_kind not in MLP_KINDS:
        raise ValueError(f"{cfg.name}: unknown mlp kind {cfg.mlp_kind!r}")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class Norm(ParamModule):
    def __init__(self, kind: str, dim: int, dtype, device) -> None:
        super().__init__()
        self.kind = kind
        self.add("scale", torch.ones((dim,), dtype=dtype, device=device))
        if kind == "layernorm":
            self.add("bias", torch.zeros((dim,), dtype=dtype, device=device))
        elif kind != "rmsnorm":
            raise ValueError(f"unknown norm {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self, x) if self.kind == "rmsnorm" else layernorm(self, x)


class Attention(ParamModule):
    """Self-attention under the reference's parameter names; with a
    ``window`` (``local_attn``) query i sees key j only where
    ``i - j < window``, and the cache is a ring buffer of ``window`` rows.

    Like every mixer it runs a whole sequence (``forward``), one decode
    step (``step``) and makes its empty cache (``empty_cache``)."""

    def __init__(self, cfg: ModelConfig, gen, dtype, device,
                 window: Optional[int] = None, causal: bool = True) -> None:
        super().__init__()
        self.cfg = cfg
        self.window = window
        self.causal = causal
        d, H, H_kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.add("w_q", dense_init(gen, d, H * dh, dtype, device=device))
        self.add("w_k", dense_init(gen, d, H_kv * dh, dtype, device=device))
        self.add("w_v", dense_init(gen, d, H_kv * dh, dtype, device=device))
        self.add("w_o", dense_init(gen, H * dh, d, dtype, device=device))
        if cfg.qkv_bias:  # Qwen1.5 [hf:Qwen/Qwen1.5-*]
            for name, width in (("b_q", H * dh), ("b_k", H_kv * dh),
                                ("b_v", H_kv * dh)):
                self.add(name, torch.zeros((width,), dtype=dtype,
                                           device=device))

    def _akw(self) -> dict:
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    d_head=cfg.head_dim)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Whole sequence.  With ``cache_len`` it also returns the KV cache
        with ``pos`` = S: padded to ``max(cache_len, S)`` rows, or with a
        window the reference's ring buffer of ``window`` rows (position p
        at row p % window)."""
        cfg = self.cfg
        B, S, _ = x.shape
        q, k, v = attn_lib.qkv_project(self, x, **self._akw())
        q, k = attn_lib._rope_qk(q, k, positions, cfg.rope_mode,
                                 cfg.rope_theta, cfg.mrope_sections)
        out = attn_lib.chunked_attention(q, k, v, causal=self.causal,
                                         window=self.window)
        out = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ self["w_o"]
        if cache_len is None:
            return out, None
        entry = {"pos": torch.full((), S, dtype=torch.int32,
                                   device=x.device)}
        w = self.window
        for name, t in (("k", k), ("v", v)):
            if w is not None and S >= w:
                entry[name] = torch.roll(t[:, -w:], S % w, dims=1)
                continue
            rows = w if w is not None else max(cache_len, S)
            buf = t.new_zeros((B, rows) + t.shape[2:])
            buf[:, :S] = t
            entry[name] = buf
        return out, entry

    def _query(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        q = x @ self["w_q"]
        if "b_q" in self:
            q = q + self["b_q"]
        return q.reshape(x.shape[0], x.shape[1], cfg.n_heads, cfg.head_dim)

    def cross(self, x: torch.Tensor, ctx: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Cross-attention of a whole sequence: queries from x (B, S,
        d_model), keys and values from the encoder's output ctx (B, S_enc,
        d_model), no mask.  Returns (output (B, S, d_model), the keys and
        values (B, S_enc, H_kv, d): the layer's ``cross_k`` / ``cross_v``
        cache)."""
        cfg = self.cfg
        B, S, _ = x.shape
        _, kc, vc = attn_lib.qkv_project(self, ctx, **self._akw())
        out = attn_lib.chunked_attention(self._query(x), kc, vc,
                                         causal=False)
        return (out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ self["w_o"],
                kc, vc)

    def cross_step(self, x: torch.Tensor, cross_k: torch.Tensor,
                   cross_v: torch.Tensor) -> torch.Tensor:
        """One decode step's cross-attention against the cached encoder
        keys and values (B, S_enc, H_kv, d), all S_enc rows of them."""
        cfg = self.cfg
        B = x.shape[0]
        cache_len = torch.full((B,), cross_k.shape[1], dtype=torch.int32,
                               device=x.device)
        out = attn_lib.decode_attention(self._query(x), cross_k, cross_v,
                                        cache_len)
        return out.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ self["w_o"]

    def step(self, x: torch.Tensor, cache: dict) -> Tuple[torch.Tensor, dict]:
        """One decode step.  x: (B, 1, d_model); the cache's K/V are
        written in place."""
        cfg = self.cfg
        return attn_lib.decode_attention_block(
            self, x, cache, rope_mode=cfg.rope_mode,
            rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
            window=self.window, **self._akw())

    @staticmethod
    def empty_cache(cfg: ModelConfig, batch: int, cache_len: int, device,
                    window: Optional[int] = None) -> dict:
        """``cache_len`` rows of zeros, or ``min(window, cache_len)``."""
        rows = min(window, cache_len) if window is not None else cache_len
        return attn_lib.init_kv_cache(batch, rows, cfg.n_kv_heads,
                                      cfg.head_dim, cfg.kv_dtype(), device)


#: The mixers the port runs: mixer -> (the reference's name for its
#: parameters, its module, the module's keyword arguments from the config).
MIXERS = {
    "attn": ("attn", Attention, lambda cfg: {}),
    "local_attn": ("attn", Attention, lambda cfg: {"window": cfg.attn_window}),
    "rglru": ("rec", RecurrentBlock, lambda cfg: {}),
    "rwkv6": ("tm", TimeMix, lambda cfg: {}),
    "enc_attn": ("attn", Attention, lambda cfg: {"causal": False}),
    # causal self-attention; the layer adds ``ln_x`` and ``xattn``
    "xattn": ("attn", Attention, lambda cfg: {}),
}


class MLP(FeedForward):
    """The dense feed-forward channel (width ``d_ff_dense`` or ``d_ff``);
    it has no state, so its ``forward`` returns None for one and its
    ``empty_cache`` is None, and no auxiliary loss."""

    has_state = False

    def __init__(self, cfg: ModelConfig, gen, dtype, device) -> None:
        super().__init__(cfg.d_model, cfg.d_ff_dense or cfg.d_ff,
                         cfg.mlp_kind, gen, dtype, device)

    def forward(self, x: torch.Tensor, state=None, need_aux: bool = False
                ) -> Tuple[torch.Tensor, None, None]:
        return apply_mlp(self, x, self.kind), None, None

    @staticmethod
    def empty_cache(cfg: ModelConfig, batch: int, device) -> None:
        return None


#: The channels the port runs: channel -> (the reference's name for its
#: parameters, its module).  A channel runs ``forward(x, state, need_aux)``
#: and returns (out, its new state or None if it has none
#: (``empty_cache``), its auxiliary loss or None): only the MoE has one,
#: and computes it only when ``need_aux``.
CHANNELS = {
    "mlp": ("mlp", MLP),
    "moe": ("moe", MoE),
    "rwkv_cm": ("cm", ChannelMix),
}


def _layer_cache(names: Tuple[str, str], mixer_entry, channel_entry):
    """A layer's cache: the mixer's, or, for a channel with a state, both
    under the two modules' names (the reference's {"tm": ..., "cm": ...})."""
    if channel_entry is None:
        return mixer_entry
    return {names[0]: mixer_entry, names[1]: channel_entry}


class DecoderBlock(nn.Module):
    """Pre-norm decoder layer: x + mixer(ln1(x)), then + channel(ln2(x)).
    The mixer (:data:`MIXERS`) and the channel (:data:`CHANNELS`) sit under
    the reference's names for them: ``attn`` (an :class:`Attention`,
    windowed for ``local_attn``, full for ``enc_attn``), ``rec`` (a
    :class:`RecurrentBlock`) or ``tm`` (a :class:`TimeMix`); ``mlp`` (an
    :class:`MLP`), ``moe`` (a :class:`MoE`) or ``cm`` (a
    :class:`ChannelMix`).  An ``xattn`` layer also has ``ln_x`` and
    ``xattn`` (a second :class:`Attention`): x + xattn(ln_x(x), ctx) after
    the self-attention, ctx being the encoder's output."""

    def __init__(self, cfg: ModelConfig, mixer: str, channel: str, gen,
                 device) -> None:
        super().__init__()
        dtype = cfg.dtype()
        name, module, kwargs = MIXERS[mixer]
        cname, cmodule = CHANNELS[channel]
        self.names = (name, cname)
        self.ln1 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.add_module(name, module(cfg, gen, dtype, device, **kwargs(cfg)))
        self.cross = mixer == "xattn"
        if self.cross:
            self.ln_x = Norm(cfg.norm, cfg.d_model, dtype, device)
            self.xattn = Attention(cfg, gen, dtype, device, causal=False)
        self.ln2 = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.add_module(cname, cmodule(cfg, gen, dtype, device))

    @property
    def mix(self) -> nn.Module:
        return getattr(self, self.names[0])

    @property
    def channel(self) -> nn.Module:
        return getattr(self, self.names[1])

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache_len: Optional[int] = None,
                ctx: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[dict],
                           Optional[torch.Tensor]]:
        """Whole-sequence step (forward, prefill): (x, the layer's cache
        with ``cache_len`` else None, the channel's auxiliary loss or
        None).  A prefill, as the reference's, makes no use of the
        auxiliary loss, so only ``forward`` (no ``cache_len``) asks for
        it.  ``ctx``: the encoder's output, for an ``xattn`` layer."""
        out, entry = self.mix(self.ln1(x), positions, cache_len)
        x = x + out
        if self.cross:
            out, kc, vc = self.xattn.cross(self.ln_x(x), ctx)
            x = x + out
            if cache_len is not None:
                entry = {"self": entry, "cross_k": kc, "cross_v": vc}
        out, c_entry, aux = self.channel(self.ln2(x), None, cache_len is None)
        if cache_len is None:
            return x + out, None, aux
        return x + out, _layer_cache(self.names, entry, c_entry), aux

    def decode(self, x: torch.Tensor, cache: dict
               ) -> Tuple[torch.Tensor, dict]:
        """One-token step.  x: (B, 1, d_model)."""
        if self.channel.has_state:
            cache, c_state = cache[self.names[0]], cache[self.names[1]]
        else:
            c_state = None
        if self.cross:
            out, new_self = self.mix.step(self.ln1(x), cache["self"])
            x = x + out
            x = x + self.xattn.cross_step(self.ln_x(x), cache["cross_k"],
                                          cache["cross_v"])
            new_cache = {"self": new_self, "cross_k": cache["cross_k"],
                         "cross_v": cache["cross_v"]}
        else:
            out, new_cache = self.mix.step(self.ln1(x), cache)
            x = x + out
        out, c_new, _ = self.channel(self.ln2(x), c_state)
        return x + out, _layer_cache(self.names, new_cache, c_new)


class Transformer(nn.Module):
    """Embedding, decoder layers, final norm; tied or untied unembedding;
    for an encoder-decoder also the encoder's layers (``encoder``, the
    reference's ``enc_segments``) and ``enc_final_norm``."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator],
                 device) -> None:
        super().__init__()
        check_supported(cfg)
        dtype = cfg.dtype()
        self.cfg = cfg
        self.embed = ParamModule()
        self.embed.add("tokens", embed_init(gen, cfg.vocab_size, cfg.d_model,
                                            dtype) if gen is not None else
                       torch.empty((cfg.vocab_size, cfg.d_model),
                                   dtype=dtype, device=device))
        if not cfg.tie_embeddings:
            self.embed.add("unembed", dense_init(
                gen, cfg.d_model, cfg.vocab_size, dtype, device=device))
        self.final_norm = Norm(cfg.norm, cfg.d_model, dtype, device)
        self.layers = nn.ModuleList(
            DecoderBlock(cfg, mixer, channel, gen, device)
            for mixer, channel in layer_signatures(cfg))
        if cfg.is_encoder_decoder:
            self.encoder = nn.ModuleList(
                DecoderBlock(cfg, mixer, channel, gen, device)
                for mixer, channel in encoder_signatures(cfg))
            self.enc_final_norm = Norm(cfg.norm, cfg.d_model, dtype, device)

    @property
    def device(self) -> torch.device:
        return self.embed["tokens"].device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_tokens(self.embed, tokens.to(self.device)
                            ).to(self.cfg.cdtype())

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return unembed(self.embed, self.final_norm(x)).float()

    def _layer(self, layer: DecoderBlock, x, positions, cache_len, ctx):
        """One layer, under ``torch.utils.checkpoint`` where the config
        asks for remat and a gradient is being recorded (a forward that
        collects caches is never trained)."""
        if self.cfg.remat and cache_len is None and torch.is_grad_enabled():
            return checkpoint(layer, x, positions, None, ctx,
                              use_reentrant=False)
        return layer(x, positions, cache_len, ctx)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over precomputed frame embeddings (B, S_enc,
        d_model): sinusoidal positions, the ``enc_attn`` layers, the
        encoder's final norm."""
        cfg = self.cfg
        x = frames.to(device=self.device, dtype=cfg.cdtype())
        B, S, _ = x.shape
        x = x + sinusoid_positions(S, cfg.d_model, device=x.device
                                   ).to(x.dtype)
        positions = _positions_for(cfg, B, S, x.device)
        for layer in self.encoder:
            x, _, _ = self._layer(layer, x, positions, None, None)
        return self.enc_final_norm(x)

    def forward(self, tokens: torch.Tensor,
                cache_len: Optional[int] = None,
                frames: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Union[torch.Tensor, List[dict]]]:
        """tokens (B, S); ``frames`` (B, S_enc, d_model) for an
        encoder-decoder.  Without ``cache_len``: (logits (B, S, V)
        float32, the layers' auxiliary losses summed, a float32 scalar - 0
        without MoE layers).  With it: (last position's logits (B, V),
        per-layer caches)."""
        B, S = tokens.shape
        x = self._embed(tokens)
        ctx = None
        if self.cfg.is_encoder_decoder:
            x = x + sinusoid_positions(S, self.cfg.d_model, device=x.device
                                       ).to(x.dtype)
            ctx = self.encode(frames)
        positions = _positions_for(self.cfg, B, S, x.device)
        caches = [] if cache_len is not None else None
        auxes = []
        for layer in self.layers:
            x, entry, aux = self._layer(layer, x, positions, cache_len, ctx)
            if caches is not None:
                caches.append(entry)
            if aux is not None:
                auxes.append(aux)
        if caches is None:
            aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
            for aux in auxes:  # in layer order, as the reference's scan
                aux_total = aux_total + aux
            return self._logits(x), aux_total
        return self._logits(x[:, -1:])[:, 0], caches

    def decode(self, caches: List[dict], token: torch.Tensor
               ) -> Tuple[torch.Tensor, List[dict]]:
        x = self._embed(token)
        if self.cfg.is_encoder_decoder:
            # the absolute position: the first attention layer's cache pos
            x = x + _sinusoid_at(_first_attn_pos(caches, x.device),
                                 self.cfg.d_model).to(x.dtype)
        new_caches = []
        for layer, cache in zip(self.layers, caches):
            x, nc = layer.decode(x, cache)
            new_caches.append(nc)
        return self._logits(x)[:, 0], new_caches


def _positions_for(cfg: ModelConfig, batch: int, seq: int, device,
                   offset=0):
    if cfg.rope_mode == "mrope":
        return text_mrope_positions(batch, seq, offset, device=device)
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(batch, seq)


def _inv_frequencies(dim: int, device) -> torch.Tensor:
    return torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=device)
                     * (math.log(10_000.0) / dim))


def sinusoid_positions(seq: int, dim: int, offset=0,
                       device=None) -> torch.Tensor:
    """(1, seq, dim) float32 whisper-style absolute positions: sin of
    position x frequency, then cos (the reference's)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device) + offset
    ang = pos[:, None] * _inv_frequencies(dim, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[None]


def _sinusoid_at(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """(1, 1, dim) sinusoid of one position, a 0-d tensor on the device
    (read there: the host never waits for it)."""
    ang = pos.float() * _inv_frequencies(dim, pos.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]


def _first_attn_pos(caches: List, device) -> torch.Tensor:
    """The ``pos`` of the first attention layer's cache (of the
    self-attention in an ``xattn`` layer's), or 0."""
    for entry in caches:
        if isinstance(entry, dict):
            if "pos" in entry:
                return entry["pos"]
            if "self" in entry:
                return entry["self"]["pos"]
    return torch.zeros((), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# the reference's entry points, over the modules
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig,
                gen: Union[torch.Generator, int, None] = 0,
                device=None, trainable: bool = False) -> Transformer:
    """Random weights with the reference's distributions, drawn from ``gen``
    (a ``torch.Generator`` on the target device, or an int seed) on
    ``device`` (``None`` means cuda: without a card this raises unless
    ``device="cpu"``).  ``trainable`` makes every parameter require
    grad (for serving they do not)."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen or 0))
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, weights on {dev}")
    return Transformer(cfg, gen, dev).requires_grad_(trainable)


def encode(cfg: ModelConfig, params: Transformer,
           frames: torch.Tensor) -> torch.Tensor:
    """Whisper's encoder over precomputed frame embeddings (B, S_enc,
    d_model): (B, S_enc, d_model) in the compute dtype."""
    return params.encode(frames)


def forward(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
            frames: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, S, V) float32, aux loss:
    the MoE layers' load-balance losses summed in layer order, 0 for a
    model without them).  ``frames``: the encoder's input, for an
    encoder-decoder."""
    return params(tokens, frames=frames)


def loss_fn(cfg: ModelConfig, params: Transformer,
            batch: Dict[str, torch.Tensor], aux_coef: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy plus ``aux_coef`` times the aux loss.
    ``batch``: "tokens" and "labels" (B, S), optionally "loss_mask" (B, S)
    and, for an encoder-decoder, "frames" (B, S_enc, d_model).  Returns
    (loss, {"loss", "ce", "aux"})."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          frames=batch.get("frames"))
    labels = batch["labels"].to(logits.device)
    mask = batch.get("loss_mask")
    ce = softmax_cross_entropy(logits, labels,
                               mask=None if mask is None
                               else mask.to(logits.device))
    loss = ce + aux_coef * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def prefill(cfg: ModelConfig, params: Transformer, tokens: torch.Tensor,
            frames: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, List[dict]]:
    """Forward + cache collection.  Returns (last logits (B, V), caches);
    ``cache_len`` reserves room in the full-attention KV caches for later
    decode steps (default S + 128).  ``frames``: the encoder's input, for
    an encoder-decoder (its keys and values per ``xattn`` layer join the
    caches)."""
    return params(tokens, cache_len=cache_len or (tokens.shape[1] + 128),
                  frames=frames)


def decode_step(cfg: ModelConfig, params: Transformer, caches: List[dict],
                token: torch.Tensor) -> Tuple[torch.Tensor, List[dict]]:
    """One decode step.  token: (B, 1) integer.  Returns (logits (B, V)
    float32, caches); the caches' K/V buffers are written in place, the
    recurrent states are new tensors."""
    return params.decode(caches, token)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device=None, fill_pos: int = 0) -> List[dict]:
    """Zeroed per-layer caches with ``pos`` = ``fill_pos``: ``cache_len``
    rows of K/V for ``attn``, ``min(window, cache_len)`` for
    ``local_attn``, for ``xattn`` {"self": those, "cross_k", "cross_v":
    (batch, encoder_seq_len, H_kv, d) zeros}, and a zero state for
    ``rglru`` and ``rwkv6`` (with the ``rwkv_cm`` channel's).  On
    ``device="meta"`` nothing is allocated (:func:`cache_specs`)."""
    check_supported(cfg)
    dev = resolve_device(device)
    caches = []
    for mixer, channel in layer_signatures(cfg):
        name, module, kwargs = MIXERS[mixer]
        cname, cmodule = CHANNELS[channel]
        entry = module.empty_cache(cfg, batch, cache_len, dev, **kwargs(cfg))
        if "pos" in entry:
            entry["pos"] = torch.full((), fill_pos, dtype=torch.int32,
                                      device=dev)
        if mixer == "xattn":
            shape = (batch, cfg.encoder_seq_len, cfg.n_kv_heads, cfg.head_dim)
            entry = {"self": entry,
                     "cross_k": torch.zeros(shape, dtype=cfg.kv_dtype(),
                                            device=dev),
                     "cross_v": torch.zeros(shape, dtype=cfg.kv_dtype(),
                                            device=dev)}
        caches.append(_layer_cache(
            (name, cname), entry, cmodule.empty_cache(cfg, batch, dev)))
    return caches


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int) -> List[dict]:
    """:func:`init_cache`'s tree as tensors on ``torch.device("meta")``:
    shapes and dtypes, nothing allocated (the dry run's inputs)."""
    return init_cache(cfg, batch, cache_len, device="meta")

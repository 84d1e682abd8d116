"""Carry the JAX package's weights and caches into the port, and back.

The reference keeps each segment's layers stacked on a leading
``(repeats, ...)`` axis (``models/model.py:init_segment``,
``init_cache``); the port keeps one module and one cache dict per layer.
These functions unstack (and restack) in the reference's layer order, so
both packages compute on the same weights in the tests; a MoE layer's
{"router", "experts", "shared"} tree lands in its module as it is, the
experts' leaves stacked (E, ...) in both; an encoder-decoder's
``enc_segments`` land in its ``encoder`` layers, ``enc_final_norm`` as
it is, and an ``xattn`` layer's ``ln_x`` and ``xattn`` leaves beside its
``attn``.  They take and
give numpy arrays (``jax.tree.map(np.asarray, tree)`` on the reference's
side), never JAX arrays: the port imports no JAX.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .model import Transformer, build_segments, encoder_signatures, \
    split_segments

if TYPE_CHECKING:
    from ..configs.base import ModelConfig


def _layer_slots(cfg: ModelConfig, encoder: bool = False
                 ) -> List[Tuple[int, int, int]]:
    """(segment, repeat, pattern position) of every layer, in order: the
    decoder's, or with ``encoder`` the encoder's."""
    segs = (split_segments(encoder_signatures(cfg)) if encoder
            else build_segments(cfg))
    return [(si, r, p)
            for si, seg in enumerate(segs)
            for r in range(seg.repeats)
            for p in range(len(seg.pattern))]


def decay_mask(model: Transformer) -> Dict[str, bool]:
    """Which of ``model``'s parameters AdamW decays: those of 2 or more
    dims in the reference's tree, where every layer's tensors (the ones
    :func:`_layer_slots` unstacks) carry one more, leading, dim - so only
    the top-level 1-D norms (``final_norm``, ``enc_final_norm``) escape."""
    return {name: p.dim() + name.startswith(("layers.", "encoder.")) >= 2
            for name, p in model.named_parameters()}


def _to_tensor(a, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    """A copy of ``a`` as a tensor in ``dtype`` (``None``: its own)."""
    arr = np.array(a)  # a writable copy: the port writes caches in place
    if arr.dtype.name == "bfloat16":
        # through float32: numpy has no bfloat16 of its own, and every
        # bfloat16 value is exact in float32
        dtype = dtype or torch.bfloat16
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr).to(dtype=dtype, device=device)


def _assign(module: torch.nn.Module, tree: Dict[str, Any], where: str) -> None:
    for name, value in tree.items():
        if isinstance(value, dict):
            _assign(getattr(module, name), value, f"{where}.{name}")
            continue
        param = module._parameters.get(name)
        if param is None:
            raise KeyError(f"the port has no parameter {where}.{name}")
        if tuple(np.shape(value)) != tuple(param.shape):
            raise ValueError(f"{where}.{name}: shape {np.shape(value)} against "
                             f"{tuple(param.shape)}")
        param.data.copy_(_to_tensor(value, param.dtype, param.device))


def params_from_jax(cfg: ModelConfig, tree: Dict[str, Any],
                    device=None) -> Transformer:
    """A :class:`Transformer` holding the reference's ``init_params`` tree
    (as numpy arrays), on ``device`` (``None`` means cuda)."""
    model = Transformer(cfg, None, resolve_device(device))
    _assign(model.embed, tree["embed"], "embed")
    _assign(model.final_norm, tree["final_norm"], "final_norm")
    for layer, (si, r, p) in zip(model.layers, _layer_slots(cfg)):
        stacked = tree["segments"][si][p]
        _assign(layer, _take(stacked, r), "layer")
    if cfg.is_encoder_decoder:
        _assign(model.enc_final_norm, tree["enc_final_norm"],
                "enc_final_norm")
        for layer, (si, r, p) in zip(model.encoder,
                                     _layer_slots(cfg, encoder=True)):
            _assign(layer, _take(tree["enc_segments"][si][p], r),
                    "encoder layer")
    return model


def _take(tree, r: int):
    if isinstance(tree, dict):
        return {k: _take(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def caches_from_jax(cfg: ModelConfig, caches, device=None) -> List[dict]:
    """The port's per-layer caches from the reference's stacked ones (as
    numpy arrays), on ``device`` (``None`` means cuda): {"k", "v", "pos"}
    for attention layers (a ring buffer for ``local_attn``), {"h",
    "conv"} for recurrent ones, {"tm": {"shift", "wkv"}, "cm": {"shift"}}
    for rwkv6 ones, each entry in the reference's dtype."""
    dev = resolve_device(device)

    def carry(tree):
        if isinstance(tree, dict):
            return {name: carry(value) for name, value in tree.items()}
        return _to_tensor(tree, None, dev)

    return [carry(_take(caches[si][p], r)) for si, r, p in _layer_slots(cfg)]


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _stack(entries: List[Any]):
    """Layers' cache trees stacked leaf by leaf on a leading axis."""
    if isinstance(entries[0], dict):
        return {name: _stack([e[name] for e in entries])
                for name in entries[0]}
    return np.stack([_to_numpy(t) for t in entries])


def caches_to_numpy(cfg: ModelConfig, caches: List[dict]) -> List[tuple]:
    """The port's caches in the reference's layout: a list over segments of
    tuples over pattern positions of each layer's cache tree ({"k", "v",
    "pos"}, {"h", "conv"} or {"tm": {...}, "cm": {...}}), stacked leaf by
    leaf on a leading (repeats,) axis; floating entries as float32 numpy
    arrays."""
    segs = build_segments(cfg)
    out = [[[] for _ in seg.pattern] for seg in segs]
    for entry, (si, r, p) in zip(caches, _layer_slots(cfg)):
        out[si][p].append(entry)
    return [tuple(_stack(layers) for layers in seg) for seg in out]

"""Attention: GQA/MHA prefill and cached decode (port of
``models/attention.py``).

Prefill runs :func:`chunked_attention`, which the JAX package wrote as a
scan over query blocks and names the reference oracle of the Pallas flash
kernel; here it is one call of ``ops.flash_attention`` (the CUDA kernel on
the card, its plain version on the host).  Decode runs
``ops.flash_decode`` against the KV cache.  Both hand the kernels strided
views of the (B, S, H, d) activations and (B, S_max, H_kv, d) caches: no
copy per layer per token.

Caches are updated in place (the reference returns new arrays): a decode
step writes its key and value into row ``pos`` of the cache it is given,
or, for a windowed (local-attention) cache, into row ``pos % S_max`` of
its ring buffer.  ``pos`` is a 0-d int32 tensor on the cache's device, so
a step never waits on the device for it.

A cache the sharded serve step split along its sequence over a mesh axis
comes as a ``DTensor`` (``Shard(1)`` over a one-dim mesh) whose local
tensor is this rank's block of rows (:func:`_sequence_block`): a step
writes its key and value only on the rank that owns the row (a masked
write, no host read), and the attention over it is the distributed
split-KV decode (``runtime.collectives.make_distributed_flash_decode``):
each rank's partial over its rows, merged across the axis.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from ..kernels import ops
from .layers import apply_mrope, apply_rope


def qkv_project(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                n_heads: int, n_kv_heads: int, d_head: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = x @ params["w_q"]
    k = x @ params["w_k"]
    v = x @ params["w_v"]
    if "b_q" in params:
        q = q + params["b_q"]
        k = k + params["b_k"]
        v = v + params["b_v"]
    return (q.reshape(B, S, n_heads, d_head),
            k.reshape(B, S, n_kv_heads, d_head),
            v.reshape(B, S, n_kv_heads, d_head))


def _rope_qk(q, k, positions, rope_mode: str, theta: float, mrope_sections):
    if rope_mode == "none":
        return q, k
    if rope_mode == "mrope":
        return (apply_mrope(q, positions, mrope_sections, theta),
                apply_mrope(k, positions, mrope_sections, theta))
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, d); k/v: (B, S, H_kv, d) with H % H_kv == 0.  Returns
    (B, S, H, d); with a ``window``, query i sees key j only where
    ``i - j < window``.  The flash kernel walks the whole sequence itself,
    so the reference's query-block scan has no counterpart."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window)
    return out.transpose(1, 2)


def _sequence_block(cache: torch.Tensor):
    """(this rank's block of rows, its index along the split, the one-dim
    mesh the sequence is split over) of a cache (B, S, H_kv, d) handed
    over as a ``DTensor`` with ``Shard(1)``; (the cache, 0, None) for a
    whole one."""
    from torch.distributed.tensor import DTensor
    if not isinstance(cache, DTensor):
        return cache, 0, None
    mesh = cache.device_mesh
    return cache.to_local(), mesh.get_local_rank(), mesh


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor
                     ) -> torch.Tensor:
    """q: (B, 1, H, d); caches: (B, S_max, H_kv, d); cache_len: (B,) int32
    on the caches' device.  Returns (B, 1, H, d).  A sequence-split cache
    runs the distributed split-KV decode (``cache_len`` counts rows of the
    whole cache)."""
    B, _, H, D = q.shape
    k_block, _, mesh = _sequence_block(k_cache)
    if mesh is not None:
        from ..runtime.collectives import make_distributed_flash_decode
        fn = make_distributed_flash_decode(
            mesh, seq_axis=mesh.mesh_dim_names[0], batch_axes=())
        out = fn(q.reshape(B, H, D), k_block,
                 _sequence_block(v_cache)[0], cache_len)
        return out.to(q.dtype).reshape(B, 1, H, D)
    out = ops.flash_decode(q.reshape(B, H, D), k_cache.transpose(1, 2),
                           v_cache.transpose(1, 2), cache_len)
    return out.reshape(B, 1, H, D)


def decode_attention_block(params: Mapping[str, torch.Tensor],
                           x: torch.Tensor, cache: dict, *, n_heads: int,
                           n_kv_heads: int, d_head: int,
                           rope_mode: str = "rope",
                           rope_theta: float = 10_000.0,
                           mrope_sections=(16, 24, 24),
                           window: Optional[int] = None,
                           ) -> Tuple[torch.Tensor, dict]:
    """One decode step.  cache: {"k": (B, S_max, H_kv, d), "v": ...,
    "pos": () int32}; "k" and "v" are written in place at row pos, or with
    a ``window`` at row pos % S_max (the cache is then a ring buffer of
    the last S_max positions).  Returns (output (B, 1, d_model), the cache
    with "pos" advanced)."""
    B = x.shape[0]
    pos = cache["pos"]
    q, k, v = qkv_project(params, x, n_heads, n_kv_heads, d_head)
    positions = (pos.expand(B, 1) if rope_mode != "mrope"
                 else pos.expand(3, B, 1))
    q, k = _rope_qk(q, k, positions, rope_mode, rope_theta, mrope_sections)

    k_cache, v_cache = cache["k"], cache["v"]
    S_max = k_cache.shape[1]
    if window is not None:
        slot = torch.remainder(pos, S_max).reshape(1).long()
    else:
        # past the end the reference's dynamic_update_slice clamps to the
        # last row; clamping here keeps that and never indexes out of bounds
        slot = torch.clamp(pos, max=S_max - 1).reshape(1).long()
    k, v = k.to(k_cache.dtype), v.to(v_cache.dtype)
    k_block, rank, mesh = _sequence_block(k_cache)
    v_block = _sequence_block(v_cache)[0]
    if mesh is not None:
        # the row is this rank's only inside its block; elsewhere the
        # write puts back what the clamped row held
        rows = k_block.shape[1]
        slot = slot - rank * rows
        own = (slot >= 0) & (slot < rows)
        slot = torch.clamp(slot, 0, rows - 1)
        k = torch.where(own, k, k_block.index_select(1, slot))
        v = torch.where(own, v, v_block.index_select(1, slot))
    k_block.index_copy_(1, slot, k)
    v_block.index_copy_(1, slot, v)
    cache_len = torch.clamp(pos + 1, max=S_max).to(torch.int32).expand(B)
    out = decode_attention(q, k_cache, v_cache, cache_len.contiguous())
    new_cache = {"k": k_cache, "v": v_cache, "pos": pos + 1}
    return out.reshape(B, 1, n_heads * d_head) @ params["w_o"], new_cache


def init_kv_cache(batch: int, s_max: int, n_kv_heads: int, d_head: int,
                  dtype: torch.dtype, device=None) -> dict:
    return {
        "k": torch.zeros((batch, s_max, n_kv_heads, d_head), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, s_max, n_kv_heads, d_head), dtype=dtype,
                         device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }

"""Distributed collectives: hierarchical gradient reduction, compressed
cross-pod exchange, and the distributed split-KV decode combine (port of
``runtime/collectives.py``).

The reference writes these as ``shard_map`` bodies over mesh axes; here
each rank runs them on its own tensors over the process groups of a
``DeviceMesh``'s axes (``mesh.get_group(axis)``):

* :func:`hierarchical_allreduce` - reduce-scatter inside the pod, exchange
  only 1/|data| of the gradient across pods, all-gather back.
  Cross-pod bytes: 2/|data| of a flat all-reduce.
* int8 cross-pod compression - the S-Paxos control/data split: tiny f32
  scales ride with int8 payloads.
* :func:`make_distributed_flash_decode` - merges per-shard (m, l, acc)
  partial attention over a sequence-sharded KV cache with one MAX and two
  SUMs (log-sum-exp algebra); the multi-device form of
  ``kernels/decode_attention``.  The partials are plain float32 torch, as
  the reference computes them in jnp outside any kernel.

Every collective goes through :func:`collective`, which counts its calls
and payload bytes in :data:`CALLS` and :data:`BYTES` (what the tests and
the card's smoke run read).  ``reduce_scatter_tensor`` and
``all_gather_into_tensor`` are the names both the card's torch and newer
ones have (the newer warn that they were renamed).
"""
from __future__ import annotations

import collections
import math
import warnings
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..optim.compression import quantize_int8, tree_map

#: calls and payload bytes (the input's) of each collective, by name
CALLS: collections.Counter = collections.Counter()
BYTES: collections.Counter = collections.Counter()


def reset_counts() -> None:
    CALLS.clear()
    BYTES.clear()


def collective(name: str, *args, group=None, **kwargs):
    """``torch.distributed.<name>(*args, group=group, **kwargs)``, counted;
    the payload is the last positional tensor (the input)."""
    CALLS[name] += 1
    BYTES[name] += args[-1].numel() * args[-1].element_size()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return getattr(dist, name)(*args, group=group, **kwargs)


def _sum(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    collective("all_reduce", t, group=group, op=op)
    return t


def mean_over(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``t`` averaged over the ranks of the mesh axes ``axes`` (in place)."""
    n = 1
    for a in axes:
        _sum(t, mesh.get_group(a))
        n *= mesh.size(list(mesh.mesh_dim_names).index(a))
    return t.div_(n) if n > 1 else t


def hierarchical_allreduce(x: torch.Tensor, mesh, *,
                           in_pod_axis: str = "data",
                           cross_pod_axis: Optional[str] = "pod",
                           compress_cross_pod: bool = False
                           ) -> torch.Tensor:
    """Mean of ``x`` over the ranks of (pod, data); dim 0 of ``x`` divides
    by |data|.

    reduce_scatter(in-pod) -> [quantize] -> all_reduce(cross-pod) ->
    [dequantize] -> all_gather(in-pod).  Equal to an all-reduce over both
    axes (up to int8 rounding when compression is on), with cross-pod
    traffic cut |data|-fold (and a further 4x with int8): the cross-pod
    step sums the int8 codes as int32 and takes the MAX of the scales."""
    in_group = mesh.get_group(in_pod_axis)
    n_in = dist.get_world_size(in_group)
    shard = x.new_empty((x.shape[0] // n_in,) + tuple(x.shape[1:]))
    collective("reduce_scatter_tensor", shard, x.contiguous(),
               group=in_group)
    n_cross = 1
    if cross_pod_axis is not None:
        cross = mesh.get_group(cross_pod_axis)
        n_cross = dist.get_world_size(cross)
        if compress_cross_pod:
            q, scale = quantize_int8(shard)
            q_sum = _sum(q.to(torch.int32), cross)
            scale = _sum(scale.reshape(1), cross, dist.ReduceOp.MAX)
            shard = (q_sum.float() * scale).to(shard.dtype)
        else:
            _sum(shard, cross)
    out = torch.empty_like(x)
    collective("all_gather_into_tensor", out, shard, group=in_group)
    return out / (n_in * n_cross)


def make_hierarchical_grad_mean(mesh, compress_cross_pod: bool = False
                                ) -> Callable:
    """Returns a function averaging a gradient tree (nested dicts / lists
    of tensors, each whole on every rank) over all data axes of ``mesh``,
    leaf by leaf: flattened, padded to a multiple of |data|, reduced,
    sliced back."""
    has_pod = "pod" in mesh.mesh_dim_names
    n_data = mesh.size(list(mesh.mesh_dim_names).index("data"))

    def one(g: torch.Tensor) -> torch.Tensor:
        flat = g.reshape(-1)
        pad = (-flat.shape[0]) % n_data
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        out = hierarchical_allreduce(
            flat, mesh, in_pod_axis="data",
            cross_pod_axis="pod" if has_pod else None,
            compress_cross_pod=compress_cross_pod)
        return out[:g.numel()].reshape(g.shape)

    def grad_mean(grads):
        return tree_map(one, grads)

    return grad_mean


# ---------------------------------------------------------------------------
# distributed split-KV flash decode
# ---------------------------------------------------------------------------


def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         valid: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-shard partial attention.  q: (B, H, d); k/v: (B, S_loc, H_kv, d);
    valid: (B, S_loc) bool.  Returns (m, l, acc) with shapes
    ((B, H, 1), (B, H, 1), (B, H, d)), float32."""
    B, H, D = q.shape
    H_kv = k.shape[2]
    group = H // H_kv
    qg = q.reshape(B, H_kv, group, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float())
    s = s / math.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    m = torch.amax(s, dim=-1, keepdim=True)            # (B, H_kv, g, 1)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return m.reshape(B, H, 1), l.reshape(B, H, 1), acc.reshape(B, H, D)


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     group) -> torch.Tensor:
    """Merge per-shard softmax partials over ``group``: a MAX, then two
    SUMs."""
    m_glob = _sum(m.clone(), group, dist.ReduceOp.MAX)
    corr = torch.exp(m - m_glob)
    l_glob = _sum(l * corr, group)
    acc_glob = _sum(acc * corr, group)
    return acc_glob / torch.clamp(l_glob, min=1e-30)


def make_distributed_flash_decode(mesh, seq_axis: str = "model",
                                  batch_axes=("data",)) -> Callable:
    """Decode attention over a sequence-sharded KV cache.

    Returns ``fn(q, k_cache, v_cache, cache_len)`` run by every rank on its
    own blocks: q (B_loc, H, d) and cache_len (B_loc,), the rank's rows of
    the batch (split over ``batch_axes``, whole over ``seq_axis``), and
    k/v (B_loc, S_loc, H_kv, d), its rows and its ``S_loc`` positions of
    the cache, those from ``rank * S_loc`` on (``rank`` along
    ``seq_axis``).  Each rank computes its partial and one (m, l, acc)
    reduction of size O(B*H*d) merges them - instead of all-gathering an
    O(B*S*H_kv*d) cache.  Returns the rank's rows of the output (B_loc,
    H, d), float32."""
    names = list(mesh.mesh_dim_names)
    for a in batch_axes:
        if a not in names:
            raise ValueError(f"no mesh axis {a!r} in {names}")
    group = mesh.get_group(seq_axis)

    def fn(q, k_cache, v_cache, cache_len):
        idx = mesh.get_local_rank(seq_axis)
        s_loc = k_cache.shape[1]
        pos = idx * s_loc + torch.arange(s_loc, device=q.device)[None, :]
        valid = pos < cache_len.to(q.device)[:, None]
        m, l, acc = flash_decode_partial(q, k_cache, v_cache, valid)
        return combine_partials(m, l, acc, group)

    return fn

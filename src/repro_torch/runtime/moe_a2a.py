"""Explicit all-to-all MoE dispatch over the model axis (port of
``runtime/moe_a2a.py``).

Under automatic SPMD the GShard one-hot dispatch with tokens sharded over
(data x model) and experts over model lowers to token *all-gathers*.  The
right pattern is an **all-to-all**: each rank packs per-expert capacity
buckets and ships each bucket only to the rank that owns that expert.

Per rank:
  1. take its tokens: the rank's rows of the batch along the model axis
     (the reference's ``P((data, model))`` token split; the input is the
     rank's data shard, whole along the model axis);
  2. route them: top-k experts + weights (the router is replicated);
  3. scatter them into an (E, C, d) capacity buffer (E = global expert
     count, C = local capacity per expert); drops land in a pad row;
  4. ``all_to_all_single`` over the model axis: (E, C, d) -> (E_loc,
     M * C, d) - every rank now holds exactly the tokens bound for ITS
     experts;
  5. run the local experts' FFN (``models.layers.apply_mlp``, one batched
     product per weight);
  6. reverse ``all_to_all_single``; combine with the routing weights and
     the shared experts; all-gather the model axis's rows back, so the
     output is whole along the model axis again, as the input was.

Bytes per rank per layer: 2 x (E * C * d) - independent of the expert
count's share, vs the gather formulation's E-fold token replication.
Every exchange is differentiable.  Under the gather-at-use train step
(``runtime/steps.py``) the router's, the shared experts' and the experts'
gradients come out partial over the model axis (each rank's from its own
tokens, or for its own experts; the other ranks hold zeros for those
experts): that step gives the layer's parameters ``Partial`` gradient
placements over "model", so its backward sums them there (a
reduce-scatter into the experts' shards, an all-reduce for the router and
the shared experts).

Numerics match ``models.moe.apply_moe_dense`` when capacity is sufficient
(drop-free), and ``kept`` / ``slot`` equal the reference's
``_local_dispatch`` exactly (``tests/test_torch_distributed_moe.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, Tuple

import torch

from ..models.layers import apply_mlp
from ..models.moe import (MoEConfig, _capacity, _hits, load_balance_loss,
                          router_probs)
from .collectives import collective, mean_over
from .mesh_context import batch_axes


def _local_dispatch(x: torch.Tensor, top_w: torch.Tensor,
                    top_i: torch.Tensor, n_experts: int, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter local tokens into per-expert capacity buckets.

    x: (T, d); top_w/top_i: (T, k).  Returns (buf (E, C, d), slot (T, k)
    int64 [-1 if dropped], kept (T, k) bool).  Pairs are counted in
    (token, choice) order."""
    T, k = top_i.shape
    flat_e = top_i.reshape(-1)                         # (T*k,)
    onehot = _hits(flat_e, n_experts).long()
    pos = torch.cumsum(onehot, dim=0) - onehot         # place within expert
    slot = torch.sum(pos * onehot, dim=1)              # (T*k,)
    kept = slot < capacity
    dest = torch.where(kept, flat_e * capacity + slot, n_experts * capacity)
    buf = x.new_zeros((n_experts * capacity + 1, x.shape[-1]))
    src = torch.repeat_interleave(x, k, dim=0)         # (T*k, d)
    buf = buf.index_put((dest,), src)                  # drops: the pad row
    return (buf[:-1].reshape(n_experts, capacity, x.shape[-1]),
            torch.where(kept, slot, -1).reshape(T, k), kept.reshape(T, k))


class _AllToAll(torch.autograd.Function):
    """Equal splits of dim 0 exchanged over a group; its own transpose, so
    the backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        collective("all_to_all_single", out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.apply(g, ctx.group), None


class _GatherRows(torch.autograd.Function):
    """The ranks' row blocks stacked in rank order (an all-gather); the
    backward keeps this rank's rows of the gradient, which is whole on
    every rank (the code after the layer runs replicated)."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.rank, ctx.rows = rank, x.shape[0]
        whole = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        collective("all_gather_into_tensor", whole, x.contiguous(),
                   group=group)
        return whole

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.rank * ctx.rows, ctx.rows), None, None, None


class _SliceRows(torch.autograd.Function):
    """This rank's row block of a tensor whole on every rank; the backward
    gathers the ranks' gradients of their blocks into the whole one."""

    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.group, ctx.n = group, n
        rows = x.shape[0] // n
        return x.narrow(0, rank * rows, rows).clone()

    @staticmethod
    def backward(ctx, g):
        whole = g.new_empty((ctx.n * g.shape[0],) + tuple(g.shape[1:]))
        collective("all_gather_into_tensor", whole, g.contiguous(),
                   group=ctx.group)
        return whole, None, None, None


def _local_experts(experts: Mapping, rank: int, e_loc: int) -> dict:
    """This rank's experts: rows [rank * e_loc, (rank + 1) * e_loc) of each
    whole (E, ...) leaf.  A ``DTensor`` leaf split over the experts (dim
    0) is this rank's block already: its local tensor, with no gather,
    whose gradient is the block's, summed over the mesh's other dims."""
    if isinstance(experts, torch.nn.Module):
        experts = dict(experts.named_parameters(recurse=False))
    out = {}
    for name, w in experts.items():
        if hasattr(w, "to_local"):
            from torch.distributed.tensor import Partial
            local = w.to_local(grad_placements=[
                p if p.is_shard() else Partial() for p in w.placements])
            if local.shape[0] != e_loc:
                raise ValueError(f"experts {name}: a block of "
                                 f"{local.shape[0]} rows, not {e_loc}")
            out[name] = local
        else:
            out[name] = w.narrow(0, rank * e_loc, e_loc)
    return out


def make_moe_a2a(mesh, cfg: MoEConfig, mlp_kind: str, d_model: int,
                 axis: str = "model", dp_axis: str = "data") -> Callable:
    """Returns ``fn(params, x, need_aux=True) -> (out, aux)`` running
    expert-parallel MoE with explicit all-to-alls on ``mesh`` (a
    ``DeviceMesh``).  params: as ``models.moe.MoE``, whole on every rank
    (each rank runs its own experts' rows); x: (B, S, d), this rank's data
    shard of the batch, whole along ``axis``, with B divisible by |axis|.
    out: (B, S, d), whole along ``axis``; aux: the load-balance loss of
    the rank's tokens averaged over ``dp_axis`` and ``axis`` (None without
    ``need_aux``).  An expert weight may also be a ``DTensor`` split over
    the experts on ``axis``: each rank then runs its block as it holds it
    (:func:`_local_experts`)."""
    names = list(mesh.mesh_dim_names)
    M = mesh.size(names.index(axis))
    if cfg.n_experts % M:
        raise ValueError(f"{cfg.n_experts} experts on {M} ranks")
    e_loc = cfg.n_experts // M
    group = mesh.get_group(axis)

    def fn(params, x: torch.Tensor, need_aux: bool = True):
        rank = mesh.get_local_rank(axis)
        B_all, S, D = x.shape
        if B_all % M:
            raise ValueError(f"batch {B_all} on {M} ranks of {axis!r}")
        B = B_all // M
        xt = (x if M == 1 else _SliceRows.apply(x, group, rank, M)
              ).reshape(B * S, D)
        T = B * S
        gates, top_w, top_i = router_probs(params, xt, cfg)
        capacity = _capacity(cfg, T)   # one group: all the rank's tokens
        buf, slot, kept = _local_dispatch(xt, top_w, top_i, cfg.n_experts,
                                          capacity)
        # (E, C, d) = M blocks of (e_loc, C, d), block m to rank m; the M
        # blocks received stack on a leading axis: (M, e_loc, C, d) ->
        # (e_loc, M * C, d), every source's capacity buckets per expert
        recv = _AllToAll.apply(buf, group)
        recv = recv.reshape(M, e_loc, capacity, D).transpose(0, 1) \
            .reshape(e_loc, M * capacity, D)
        out_loc = apply_mlp(_local_experts(params["experts"], rank, e_loc),
                            recv, mlp_kind)
        # reverse: (e_loc, M * C, d) -> (M, e_loc, C, d), block m back to
        # rank m; received by source: (E, C, d) in global expert order
        back = out_loc.reshape(e_loc, M, capacity, D).transpose(0, 1) \
            .contiguous()
        sent = _AllToAll.apply(back, group).reshape(cfg.n_experts, capacity,
                                                   D)
        flat_e = top_i.reshape(-1)
        flat_s = torch.clamp(slot.reshape(-1), min=0)
        vals = sent[flat_e, flat_s].reshape(T, cfg.top_k, D)
        # the weights rounded to x's dtype, a dropped choice's to 0, as the
        # reference's; the weighted sum over the k choices accumulates in
        # float32 (one product), where the reference rounds each term
        w = (top_w * kept).to(vals.dtype)
        out = torch.bmm(w[:, None, :], vals)[:, 0]
        if "shared" in params:
            out = out + apply_mlp(params["shared"], xt, mlp_kind)
        out = out.reshape(B, S, D)
        if M > 1:  # the model axis's rows back together
            out = _GatherRows.apply(out, group, rank, M)
        aux = None
        if need_aux:
            aux = load_balance_loss(gates, top_i, cfg.n_experts)
            split = batch_axes()
            with torch.no_grad():
                mean = mean_over(aux.detach().clone(), mesh, list(
                    dict.fromkeys([a for a in (dp_axis, axis) if a in names]
                                  + list(split))))
            # the value is the mean over the ranks; the gradient is the
            # rank's own tokens' share of it (1 / |axis|, and 1 / the
            # batch's ranks inside the sharded step), partial over
            # ``axis`` and the batch's axes as the router's and the
            # experts' gradients are
            share = M * math.prod(mesh.size(names.index(a)) for a in split)
            aux = aux / share + (mean - aux.detach() / share)
        return out, aux

    return fn

"""Mixture-of-experts FFN (port of ``models/moe.py``).

The reference's two formulations, as functions of plain tensors:

* ``gshard``: capacity-factor dispatch [GShard arXiv:2006.16668, Switch
  arXiv:2101.03961].  Tokens are cut into groups; in each group every
  expert takes at most C (token, choice) pairs, counted slot-major (all
  first choices, then all second choices, ...), and the pairs past C are
  dropped (combine weight 0).  The reference writes dispatch and combine as
  one-hot einsums; here the same function is an index map: each kept pair
  gets a row of an (E, G * C, D) capacity buffer, the experts run as three
  batched products over it (``torch.bmm`` through ``apply_mlp``) and the
  combine gathers each pair's row back.  A layer is a fixed number of
  device ops: no loop over experts, no value read back to the host.
* ``dense``: every token through every expert, weighted by the sparse gate
  matrix; exact (no drops), the oracle the capacity path is held to.

``impl="a2a"`` is the distributed runtime's expert-parallel layer
(``runtime/moe_a2a.py``) on the mesh of ``runtime.mesh_context.use_mesh``,
as the reference's model runs it.

Fine-grained + shared experts (DeepSeekMoE [arXiv:2401.06066]) and
128-expert top-8 routing (Qwen3-MoE [hf:Qwen/Qwen3-30B-A3B]).

Routing is exact against the reference: the router's logits are a float32
product of float32 copies (the caller keeps TF32 off, as PyTorch's default
is), and the top k are the first k of a stable descending sort, so ties go
to the lower expert index as ``jax.lax.top_k``'s do (``torch.topk`` breaks
them otherwise).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import torch

from .layers import FeedForward, ParamModule, apply_mlp, dense_init


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int          # per-expert FFN width (fine-grained: small)
    n_shared: int = 0      # DeepSeekMoE shared experts (always active)
    capacity_factor: float = 1.25
    group_size: int = 512  # dispatch group size (bounds one-hot tensors)
    renormalize: bool = True  # renormalize top-k gate weights


class MoE(ParamModule):
    """The MoE channel under the reference's names: ``router`` (D, E),
    ``experts`` (a :class:`FeedForward` whose weights are stacked (E, ...))
    and, with shared experts, ``shared`` (an MLP of width ``d_expert *
    n_shared``).  A channel of ``models/model.py`` without a state, and the
    one with an auxiliary loss."""

    has_state = False

    def __init__(self, cfg, gen: Optional[torch.Generator], dtype, device
                 ) -> None:
        super().__init__()
        m = cfg.moe
        self.moe_cfg, self.kind, self.impl = m, cfg.mlp_kind, cfg.moe_impl
        self.add("router", dense_init(gen, cfg.d_model, m.n_experts, dtype,
                                      device=device))
        self.experts = FeedForward(cfg.d_model, m.d_expert, cfg.mlp_kind,
                                   gen, dtype, device, lead=(m.n_experts,))
        if m.n_shared > 0:
            self.shared = FeedForward(cfg.d_model, m.d_expert * m.n_shared,
                                      cfg.mlp_kind, gen, dtype, device)

    def forward(self, x: torch.Tensor, state=None, need_aux: bool = False
                ) -> Tuple[torch.Tensor, None, Optional[torch.Tensor]]:
        """(out, None, the load-balance loss if ``need_aux`` else None)."""
        out, aux = apply_moe(self, x, self.moe_cfg, self.kind,
                             impl=self.impl, need_aux=need_aux)
        return out, None, aux

    @staticmethod
    def empty_cache(cfg, batch: int, device) -> None:
        return None


def router_probs(params: Mapping, x: torch.Tensor, cfg: MoEConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates (T, E) post-softmax float32, top-k weights (T, k),
    top-k indices (T, k) int64, ties to the lower index)."""
    logits = x.float() @ params["router"].float()
    gates = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[..., :cfg.top_k], top_i[..., :cfg.top_k]
    if cfg.renormalize:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return gates, top_w, top_i


def load_balance_loss(gates: torch.Tensor, top_i: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e over all T tokens."""
    f = _hits(top_i, n_experts).float().mean(dim=(0, 1))
    p = gates.mean(dim=0)
    return n_experts * (f * p).sum()


def batch_load_balance_loss(gates: torch.Tensor, top_i: torch.Tensor,
                            n_experts: int) -> torch.Tensor:
    """:func:`load_balance_loss` over the whole batch: inside the sharded
    train step, whose ranks each route their own rows, f_e and P_e are
    sums over the batch's ranks before the product (the reference's one
    SPMD program takes them over every token); elsewhere the same
    function of these tokens."""
    from ..runtime.mesh_context import batch_axes, whole_batch_sum
    if not batch_axes():
        return load_balance_loss(gates, top_i, n_experts)
    hits, p, n = whole_batch_sum(
        _hits(top_i, n_experts).float().sum(dim=(0, 1)), gates.sum(dim=0),
        gates.new_tensor(gates.shape[0]))
    return n_experts * ((hits / (n * top_i.shape[1])) * (p / n)).sum()


# ---------------------------------------------------------------------------
# dense (oracle) path
# ---------------------------------------------------------------------------


def apply_moe_dense(params: Mapping, x: torch.Tensor, cfg: MoEConfig,
                    mlp_kind: str, need_aux: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Every token through every expert; exact (no capacity drops)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    gates, top_w, top_i = router_probs(params, xt, cfg)
    combine = torch.zeros_like(gates).scatter(1, top_i, top_w)  # (T, E)
    all_out = apply_mlp(params["experts"],
                        xt.expand(cfg.n_experts, -1, -1), mlp_kind)
    out = torch.einsum("te,etd->td", combine.to(x.dtype), all_out)
    if "shared" in params:
        out = out + apply_mlp(params["shared"], xt, mlp_kind)
    aux = (batch_load_balance_loss(gates, top_i, cfg.n_experts)
           if need_aux else None)
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# GShard capacity-factor dispatch
# ---------------------------------------------------------------------------


def _capacity(cfg: MoEConfig, group_tokens: int) -> int:
    c = int(math.ceil(cfg.top_k * group_tokens * cfg.capacity_factor
                      / cfg.n_experts))
    return max(c, cfg.top_k)


def group_size(cfg: MoEConfig, n_tokens: int) -> int:
    """The reference's dispatch group: ``cfg.group_size`` capped at T; if T
    is no multiple of it, their gcd, and T itself when that is 1."""
    g = min(cfg.group_size, n_tokens)
    if n_tokens % g:
        g = math.gcd(n_tokens, g)
        if g == 1:
            g = n_tokens
    return g


def _hits(idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """``idx[..., None] == e`` for every expert e: a boolean one-hot that,
    unlike ``F.one_hot``, never reads the indices back to the host to check
    their range."""
    return idx[..., None] == torch.arange(n_experts, device=idx.device)


def dispatch_positions(top_i: torch.Tensor, n_groups: int, n_experts: int
                       ) -> torch.Tensor:
    """Each (token, choice) pair's place in its expert's queue within its
    group, counted slot-major: in a group all tokens' first choices come
    first, then their second choices, and so on (the reference's
    ``cumsum - self`` after its (0, 2, 1, 3) transpose: here the
    inclusive count at the pair's own expert, less one).  top_i (T, k)
    -> positions (T, k) int64."""
    T, k = top_i.shape
    g = T // n_groups
    slot_major = top_i.reshape(n_groups, g, k).transpose(1, 2)  # (G, k, g)
    flat = slot_major.reshape(n_groups, k * g, 1)
    counts = _hits(flat[..., 0], n_experts).cumsum(dim=1)  # (G, k g, E)
    pos = counts.gather(2, flat) - 1
    return pos.reshape(n_groups, k, g).transpose(1, 2).reshape(T, k)


def apply_moe_gshard(params: Mapping, x: torch.Tensor, cfg: MoEConfig,
                     mlp_kind: str, need_aux: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Capacity-factor dispatch (GShard).  x: (B, S, D).

    Each group dispatches into (E, C) expert slots; pairs past C are
    dropped (their combine weight is 0) and write nothing.  The combine
    weights are the top-k weights rounded to x's dtype, as the reference's
    cast of its combine tensor rounds them."""
    B, S, D = x.shape
    T, E = B * S, cfg.n_experts
    g = group_size(cfg, T)
    G, C = T // g, _capacity(cfg, g)
    xt = x.reshape(T, D)
    gates, top_w, top_i = router_probs(params, xt, cfg)
    pos = dispatch_positions(top_i, G, E)
    keep = pos < C
    # the pair's row of the (E, G, C) buffer; a dropped pair's is row
    # E G C, one past it: the map below drops it, the combine reads zeros
    group = torch.arange(T, device=x.device)[:, None] // g
    rows = torch.where(keep, (top_i * G + group) * C + pos, E * G * C)
    # each buffer row's token (T: none, a zero row), then the gather
    token = torch.full((E * G * C + 1,), T, dtype=torch.long,
                       device=x.device)
    token.scatter_(0, rows.reshape(-1),
                   torch.arange(T * cfg.top_k, device=x.device) // cfg.top_k)
    x_pad = torch.cat([xt, xt.new_zeros((1, D))])
    expert_in = x_pad[token[:-1]].reshape(E, G * C, D)
    expert_out = apply_mlp(params["experts"], expert_in, mlp_kind)
    picked = torch.cat([expert_out.reshape(E * G * C, D),
                        expert_out.new_zeros((1, D))])[rows]  # (T, k, D)
    weights = (top_w * keep).to(x.dtype)
    out = torch.bmm(weights[:, None, :], picked)[:, 0]
    if "shared" in params:
        out = out + apply_mlp(params["shared"], xt, mlp_kind)
    aux = batch_load_balance_loss(gates, top_i, E) if need_aux else None
    return out.reshape(B, S, D), aux


def apply_moe(params: Mapping, x: torch.Tensor, cfg: MoEConfig,
              mlp_kind: str, impl: str = "gshard", need_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, the load-balance loss, or None without ``need_aux``)."""
    if impl == "dense":
        return apply_moe_dense(params, x, cfg, mlp_kind, need_aux)
    if impl == "gshard":
        return apply_moe_gshard(params, x, cfg, mlp_kind, need_aux)
    if impl == "a2a":  # expert parallel over the current mesh's model axis
        from ..runtime.mesh_context import current_mesh
        from ..runtime.moe_a2a import make_moe_a2a
        fn = make_moe_a2a(current_mesh(), cfg, mlp_kind, x.shape[-1])
        return fn(params, x, need_aux=need_aux)
    raise ValueError(f"unknown moe impl {impl!r}")

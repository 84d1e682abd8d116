"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Small, obviously-correct implementations that follow the reference's own
definitions.  The CPU path runs them, the tests hold them against the JAX
package, and the card's kernels are held against them: the histogram bit
for bit, attention and the RG-LRU and WKV recurrences within the float
tolerance its test states; the execution and transient lanes' step loops
bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

#: The reference's mask value: masked scores are set to it, not to -inf.
NEG_INF = -1e30

#: Elements of the (L, chunk, B+1) comparison tensor built per pass; keeps
#: the plain histogram's working set to a few hundred MB at any N.
_HIST_CHUNK_ELEMS = 1 << 26


def ref_latency_hist(samples: torch.Tensor, valid: torch.Tensor,
                     edges: torch.Tensor) -> torch.Tensor:
    """Masked histogram per lane.  samples/valid: (L, N); edges: (L, B+1).
    Bin = #{j : edges_j < sample} - 1, clipped to [0, B) - the transient
    plane's searchsorted-left binning written as a comparison count, so a
    NaN sample lands in bin 0 exactly as in the reference (where
    ``torch.searchsorted`` would put it past the end).  A sample counts
    where ``valid > 0``.  Returns (L, B) int32, chunked over N."""
    n_lanes, n = samples.shape
    n_bins = edges.shape[-1] - 1
    out = torch.zeros((n_lanes, n_bins), dtype=torch.int64,
                      device=samples.device)
    step = max(1, _HIST_CHUNK_ELEMS // max(n_lanes * (n_bins + 1), 1))
    for lo in range(0, n, step):
        x = samples[:, lo:lo + step]
        idx = (edges[:, None, :] < x[..., None]).sum(dim=-1) - 1
        idx = idx.clamp(0, n_bins - 1)
        ok = (valid[:, lo:lo + step] > 0).to(torch.int64)
        out.scatter_add_(1, idx, ok)
    return out.to(torch.int32)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S_q, d); k/v: (B, H_kv, S_k, d), H % H_kv == 0 (query head
    h reads kv head h // (H / H_kv)).  Full-softmax attention with float32
    scores, a -1e30 mask and float32 softmax; the output has q's dtype.
    Query i sees key j where ``j <= i`` (causal) and, with a ``window``,
    where ``i - j < window`` too (the reference's local-attention mask,
    ``models/attention.py:chunked_attention``); both need S_q == S_k, and
    without them any S_k is taken (cross-attention).  Any strides are
    taken."""
    B, H, S, D = q.shape
    H_kv, S_k = k.shape[1], k.shape[2]
    group = H // H_kv
    qg = q.reshape(B, H_kv, group, S, D).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) / math.sqrt(D)
    if causal or window is not None:
        pos = torch.arange(S, device=q.device)
        diff = pos[:, None] - pos[None, :]  # query minus key position
        mask = torch.ones((S, S_k), dtype=torch.bool, device=q.device)
        if causal:
            mask &= diff >= 0
        if window is not None:
            mask &= diff < window
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(B, H, S, D).to(q.dtype)


def ref_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               cache_len: torch.Tensor) -> torch.Tensor:
    """q: (B, H, d), one token per sequence; caches: (B, H_kv, S_max, d);
    cache_len: (B,) integer.  Row b attends to its first cache_len[b]
    entries (float32 scores and softmax, -1e30 mask); the output has q's
    dtype.  Any strides are taken."""
    B, H, D = q.shape
    H_kv, S = k_cache.shape[1], k_cache.shape[2]
    group = H // H_kv
    qg = q.reshape(B, H_kv, group, D).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()) / math.sqrt(D)
    valid = (torch.arange(S, device=q.device)[None, :]
             < cache_len.to(q.device).reshape(-1, 1))
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def ref_rglru(x: torch.Tensor, a: torch.Tensor,
              h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Serial ``h_t = a_t h_{t-1} + x_t`` from ``h = h0`` (B, D), or 0.
    x/a: (B, S, D).  The carry is float32; the output has x's dtype.  Any
    strides are taken."""
    xf, af = x.float(), a.float()
    h = h0.float() if h0 is not None else torch.zeros_like(xf[:, 0])
    out = torch.empty(xf.shape, dtype=torch.float32, device=x.device)
    for t in range(x.shape[1]):
        h = af[:, t] * h + xf[:, t]
        out[:, t] = h
    return out.to(x.dtype)


def ref_wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor,
             s0: Optional[torch.Tensor] = None):
    """Serial RWKV-6 recurrence in the model's layout.  r/k/v/logw:
    (B, S, H, d); u: (H, d); s0: (B, H, d, d) or None (zero).  Per (b, h)
    ``y_t = r_t (S + diag(u) k_t^T v_t)`` and
    ``S <- diag(exp(logw_t)) S + k_t^T v_t``, the carry in float32.
    Returns (y (B, S, H, d) in r's dtype, s_last (B, H, d, d) float32);
    s0 is not written.  Any strides are taken."""
    rf, kf, vf, lw = r.float(), k.float(), v.float(), logw.float()
    B, S, H, K = k.shape
    s = (torch.zeros((B, H, K, v.shape[-1]), dtype=torch.float32,
                     device=r.device) if s0 is None else s0.float())
    uf = u.float()[None, :, :, None]
    y = torch.empty(vf.shape, dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B, H, K, V)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], s + uf * kv)
        s = torch.exp(lw[:, t])[..., None] * s + kv
    return y.to(r.dtype), s


def ref_exec_lanes(rate_w: torch.Tensor, rate_r: torch.Tensor,
                   finishes_at: torch.Tensor, arrive_at: torch.Tensor,
                   cls: torch.Tensor, budget: torch.Tensor,
                   t_ends: torch.Tensor, draws: Optional[torch.Tensor],
                   stage: torch.Tensor, rank: torch.Tensor,
                   enter_t: torch.Tensor, op_i: torch.Tensor,
                   q: torch.Tensor, work: torch.Tensor,
                   fin_all: torch.Tensor, lat_all: torch.Tensor,
                   i0: int, i1: int) -> None:
    """Steps ``[i0, i1)`` of the batched execution engine's closed-loop
    client step loop over every lane (the reference's ``_one_exec_lane``
    step, eager, in its float32 op order).

    Per lane: ``rate_w`` / ``rate_r`` [L, K+1] float32 work drained a step
    by a write / read at the head of each station (column K is where
    parked clients sit: rate 0); ``finishes_at`` [L, K+1] bool and
    ``arrive_at`` [L, K+1] int64 the tandem routing; ``cls`` [L, N,
    n_ops + 1] int64 op classes per client (a zero column past the
    longest stream); ``budget`` [L, N] int64; ``t_ends`` [n_steps, L]
    float32, step i's end time; ``draws`` [L, i1 - i0, K] float32 service
    draws, or None for the deterministic mode (every draw 1.0).

    The state - ``stage``, ``rank``, ``op_i`` [L, N] int64, ``enter_t``
    [L, N] float32, ``q`` [L, K+1] int64 and ``work`` [L, K+1] float32 -
    is updated in place, and step i's completion mask and latencies are
    written in place into ``fin_all[:, i]`` [L, n_steps, N] bool and
    ``lat_all[:, i]`` float32."""
    n_lanes, k1 = q.shape
    k = k1 - 1
    dev = q.device
    inf_col = torch.full((n_lanes, 1), float("inf"), device=dev)
    ones = torch.ones(stage.shape, dtype=torch.long, device=dev)
    state = (stage, rank, enter_t, q, work)
    for i in range(i0, i1):
        if draws is None:
            draw_i = 1.0
        else:
            draw_i = torch.cat([draws[:, i - i0], inf_col], dim=1)
        t_end = t_ends[i][:, None]                               # [L, 1]

        cls_cur = cls.gather(2, op_i[:, :, None])[:, :, 0]       # [L, N]
        # the head command's class picks each station's service demand
        head = rank == 0
        head_cls = torch.zeros_like(q).scatter_add_(
            1, stage, torch.where(head, cls_cur, 0))
        rate = torch.where(head_cls > 0, rate_w, rate_r)

        busy = q > 0
        work = torch.where(busy, work - rate, work)
        complete = busy & (work <= 0.0)                          # [L, K+1]

        dep_here = complete.gather(1, stage)                     # [L, N]
        moving = dep_here & head
        fin = fin_all[:, i]
        torch.logical_and(moving, finishes_at.gather(1, stage), out=fin)
        torch.sub(t_end, enter_t, out=lat_all[:, i])

        op_i += fin
        # next hop, or next op; a client whose budget drained parks
        enters = moving & (~fin | (op_i < budget))
        dest = arrive_at.gather(1, stage)
        q_dep = q - complete.long()
        # a mover's new rank is its destination's queue length; any other
        # client at a station that completed moves up one
        rank = torch.where(moving, q_dep.gather(1, dest),
                           rank - dep_here.long())
        goes_to = torch.where(enters, dest, k)
        stage = torch.where(moving, goes_to, stage)
        enter_t = torch.where(fin, t_end, enter_t)
        arrivals = torch.zeros_like(q).scatter_add_(1, goes_to, ones)
        q = q_dep + arrivals
        # new head enters service: carry the completion residual on a busy
        # server, fresh draw on an idle one
        fresh = torch.where(busy, complete & (q > 0), arrivals > 0)
        work = torch.where(
            fresh, draw_i + torch.where(complete, work, 0.0), work)
    for into, now in zip(state, (stage, rank, enter_t, q, work)):
        if now is not into:
            into.copy_(now)


def ref_transient_lanes(rates: torch.Tensor, window_of: torch.Tensor,
                        dt: torch.Tensor, finishes_at: torch.Tensor,
                        arrive_at: torch.Tensor,
                        draws: Optional[torch.Tensor], stage: torch.Tensor,
                        rank: torch.Tensor, enter_t: torch.Tensor,
                        q: torch.Tensor, work: torch.Tensor,
                        qsum: torch.Tensor, flows: torch.Tensor,
                        lat1: torch.Tensor, i0: int, i1: int) -> None:
    """Steps ``[i0, i1)`` of the transient engine's token ring over every
    lane (the reference's ``_one_lane`` step, eager, in its float32 op
    order).

    Per lane ``l`` (lane order ``m * S + s``): ``rates`` [W, L, K] float32
    work a station drains a step in each window; ``window_of`` [T] int32
    the window of each step; ``dt`` [L] float32 the step length (step i
    ends at ``(i + 1) * dt``); ``finishes_at`` [L, K] bool and
    ``arrive_at`` [L, K] int64 the tandem routing; ``draws`` [S, T + 1, K]
    float32 service draws, lane ``l`` reading seed ``l % S`` and step i
    row ``i + 1``, or None for the deterministic mode (every draw 1.0).

    The state - ``stage``, ``rank`` [L, N] int64, ``enter_t`` [L, N]
    float32, ``q`` [L, K] int64, ``work`` [L, K] float32 and the
    per-window queue integral ``qsum`` [L, W, K] float32 - is updated in
    place.  Step i writes ``flows[:, i]`` [L, T] int32, the lane's
    finished commands, and ``lat1[:, i]`` [L, T] float32, the finisher's
    ``t_end - enter_t`` (0.0 where none finished; a lane finishes at most
    one command a step, so this is that command's latency)."""
    n_lanes, k = q.shape
    dev = q.device
    windows = window_of.tolist()
    t_ends = (torch.arange(i0 + 1, i1 + 1, dtype=torch.float32, device=dev)
              [:, None] * dt[None, :])                          # [i1 - i0, L]
    state = (stage, rank, enter_t, q, work)
    for i in range(i0, i1):
        w = windows[i]
        t_end = t_ends[i - i0][:, None]                          # [L, 1]

        busy = q > 0
        work = torch.where(busy, work - rates[w], work)
        complete = busy & (work <= 0.0)                          # [L, K]

        dep_here = complete.gather(1, stage)                     # [L, N]
        moving = dep_here & (rank == 0)
        fin = moving & finishes_at.gather(1, stage)
        flows[:, i] = fin.sum(dim=1)
        lat1[:, i] = torch.where(fin, t_end - enter_t, 0.0).sum(dim=1)

        dest = arrive_at.gather(1, stage)
        done_here = complete.long()
        q_dep = q - done_here
        stage = torch.where(moving, dest, stage)
        enter_t = torch.where(fin, t_end, enter_t)
        # a mover's new rank is its destination's queue length; any other
        # client at a station that completed moves up one (its rank is > 0)
        rank = torch.where(moving, q_dep.gather(1, dest),
                           rank - dep_here.long())
        arrivals = torch.zeros_like(q).scatter_add_(1, arrive_at, done_here)
        q = q_dep + arrivals
        # per-window queue-depth integral, float32 as the reference's
        qsum[:, w] += q
        # new head enters service: carry the completion residual on a busy
        # server (unbiased long-run rate), fresh draw on an idle one
        fresh = torch.where(busy, complete & (q > 0), arrivals > 0)
        nxt_work = torch.where(complete, work, 0.0)
        if draws is None:
            nxt_work += 1.0
        else:
            nxt_work.view(-1, draws.shape[0], k).add_(draws[:, i + 1])
        work = torch.where(fresh, nxt_work, work)
    for into, now in zip(state, (stage, rank, enter_t, q, work)):
        if now is not into:
            into.copy_(now)

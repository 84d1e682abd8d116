"""Operations and bytes of the port's hand-written kernels.

The reference's cost analysis sees its jnp oracles; the port's kernels are
``ctypes`` launches that ``torch.utils.flop_counter.FlopCounterMode``
cannot see.  This module holds what each kernel's work is, in one place:

* ``chip_smoke.py``'s bounds read these counts (a bound is the larger of
  the bytes over the card's memory rate and the operations over the peak
  rate of their type, ``roofline/analysis.py``);
* under fake tensors (the dry run, ``launch/dryrun.py``) each kernel's
  wrapper adds its call's counts to :data:`COUNTS` instead of launching,
  and the dry run adds them to the FLOPs and bytes it counted itself.

Every function returns ``(operations, bytes, rate)``: ``rate`` names the
peak the operations run at, ``"bf16"`` (tensor cores), ``"tf32"`` (tensor
cores) or ``"f32"`` (the CUDA cores).  Bytes are each input read once and
each output written once.  Where the work depends on the data (the cached
rows a decode step reads, the valid samples a histogram bins), the caller
says how much this call's data needs; under fake tensors the data is
unknown and the wrappers count the most it could be (a full cache, every
sample valid).

Imports nothing of the package, so every kernel module can import it.
"""
from __future__ import annotations

import collections
import math
from typing import Optional, Tuple

Cost = Tuple[int, int, str]

#: flops per computed (query, key) pair and head-dim element: the forward's
#: two products (q k^T and p v), and the backward's five (s, dp, dv, dk,
#: dq)
ATTN_FWD_FLOPS = 4
ATTN_BWD_FLOPS = 10

#: what the wrappers counted under fake tensors: "flops", "bytes", and
#: "<kernel>.calls" / "<kernel>.flops" / "<kernel>.bytes"
COUNTS: collections.Counter = collections.Counter()


def reset() -> None:
    COUNTS.clear()


def record(name: str, cost: Cost) -> None:
    """Add one call of kernel ``name`` of ``cost`` to :data:`COUNTS`."""
    flops, nbytes, _ = cost
    COUNTS["flops"] += flops
    COUNTS["bytes"] += nbytes
    COUNTS[f"{name}.calls"] += 1
    COUNTS[f"{name}.flops"] += flops
    COUNTS[f"{name}.bytes"] += nbytes


def _rate(esize: int) -> str:
    return "bf16" if esize == 2 else "f32"


def attention_pairs(s_q: int, s_k: int, causal: bool,
                    window: Optional[int] = None) -> int:
    """(query, key) pairs one (batch, head) computes: S_q S_k without a
    mask, S (S + 1) / 2 causal, and with a window the keys within it of
    each query (sum over i of min(i + 1, window))."""
    if window is not None:
        w = min(window, s_q)
        return w * (w + 1) // 2 + (s_q - w) * window
    if causal:
        return s_q * (s_q + 1) // 2
    return s_q * s_k


def flash_attention_cost(B: int, H: int, H_kv: int, S_q: int, S_k: int,
                         D: int, esize: int, causal: bool,
                         window: Optional[int] = None) -> Cost:
    """The forward: 4 d flops per computed pair; q read and the output
    written, k and v read."""
    pairs = B * H * attention_pairs(S_q, S_k, causal, window)
    nbytes = (2 * B * H * S_q * D + 2 * B * H_kv * S_k * D) * esize
    return ATTN_FWD_FLOPS * D * pairs, nbytes, _rate(esize)


def flash_attention_bwd_cost(B: int, H: int, H_kv: int, S_q: int, S_k: int,
                             D: int, esize: int, causal: bool,
                             window: Optional[int] = None) -> Cost:
    """The backward: 10 d flops per computed pair; q, the output, its
    cotangent and dq, k, v, dk and dv moved once, and the float32
    log-sum-exp read."""
    pairs = B * H * attention_pairs(S_q, S_k, causal, window)
    nbytes = ((4 * B * H * S_q * D + 4 * B * H_kv * S_k * D) * esize
              + 4 * B * H * S_q)
    return ATTN_BWD_FLOPS * D * pairs, nbytes, _rate(esize)


def flash_decode_cost(B: int, H: int, H_kv: int, D: int, n_valid: int,
                      esize: int) -> Cost:
    """One query token per sequence against ``n_valid`` cached rows in all
    (the sum of the cache lengths): 4 d flops a (head, row) pair; q read
    and the output written, the valid K/V rows read, the int32 lengths
    read."""
    nbytes = (2 * B * H * D + 2 * H_kv * D * n_valid) * esize + 4 * B
    return ATTN_FWD_FLOPS * D * H * n_valid, nbytes, _rate(esize)


def rglru_scan_cost(numel: int, esize: int, h0_bytes: int = 0) -> Cost:
    """h_t = a_t h_{t-1} + x_t: two float32 flops an element; x and a read
    and h written in x's dtype, h0 read."""
    return 2 * numel, 3 * numel * esize + h0_bytes, "f32"


def rglru_scan_bwd_cost(numel: int, esize: int, h0_bytes: int = 0) -> Cost:
    """The backward, g_t = dh_t + a_{t+1} g_{t+1}, dx_t = g_t and
    da_t = g_t h_{t-1}: three float32 flops an element; dh and a read and
    dx and da written in their dtype, the float32 carry h read, and h0
    read and dh0 written."""
    return 3 * numel, numel * (4 * esize + 4) + 2 * h0_bytes, "f32"


def wkv6_cost(B: int, S: int, H: int, D: int, esize: int, has_s0: bool,
              chunk: Optional[int] = None) -> Cost:
    """The WKV recurrence: r, k, v read in their dtype and logw in float32,
    y written, u and s0 read, s_last written.  Operations: with ``chunk``
    and S > 1 the chunked form's on the tensor cores, per token and head
    4 C d + 4 d^2 (the scores and A v over the chunk of C steps, q_in S'
    and the state update), tripled by the split TF32 products; else the
    serial recurrence's 5 d^2 + 5 d float32 flops."""
    nbytes = (B * S * H * D * (3 * esize + 4 + esize) + 4 * H * D
              + 4 * B * H * D * D * (2 if has_s0 else 1))
    if chunk is not None and S > 1:
        return 3 * (4 * chunk * D + 4 * D * D) * B * S * H, nbytes, "tf32"
    return (5 * D * D + 5 * D) * B * S * H, nbytes, "f32"


def latency_hist_cost(lanes: int, n: int, bins: int, n_valid: int,
                      mask_esize: int) -> Cost:
    """Binning: a compare-and-add per mask entry plus a lower-bound search
    per valid sample; every mask entry and every valid sample read once,
    the edges read and the counts written once."""
    nbytes = (lanes * n * mask_esize + 4 * n_valid + lanes * (bins + 1) * 4
              + lanes * bins * 4)
    ops = lanes * n + n_valid * (math.ceil(math.log2(bins + 2)) + 1)
    return ops, nbytes, "f32"


def exec_lanes_cost(lanes: int, n_steps: int, n_clients: int,
                    n_stations: int, n_ops: int, drawn: bool) -> Cost:
    """``n_steps`` steps of the execution lanes' step loop, ``n_stations``
    = K + 1 columns with the parked one, ``n_ops`` + 1 op classes a
    client, in the least bytes the function needs: each step's completion
    mask (one byte) and latency (four) written per client; the 0/1 class
    table at one byte a class, the budgets, routing and state as int32 and
    float32 (the reference's types), the rates and each lane's step length
    ``dt`` (a step's end time is ``(i + 1) * dt``) read once, (when
    ``drawn``) the float32 service draws read once, the state read and
    written once.  Operations: the float32 arithmetic of a step, a
    latency subtraction per client and per station the work's
    subtraction, its comparison and the draw's addition."""
    nbytes = (lanes * n_steps * n_clients * 5
              + lanes * n_clients * (n_ops + 1)
              + lanes * n_clients * 4
              + lanes * n_stations * (4 + 4 + 1 + 4)
              + lanes * 4
              + (lanes * n_steps * (n_stations - 1) * 4 if drawn else 0)
              + 2 * lanes * (n_clients * 4 * 4 + n_stations * (4 + 4)))
    ops = lanes * n_steps * (n_clients + 3 * n_stations)
    return ops, nbytes, "f32"


def transient_lanes_cost(lanes: int, n_steps: int, n_clients: int,
                         n_stations: int, n_windows: int,
                         n_seeds: int) -> Cost:
    """``n_steps`` steps of the transient lanes' step loop over
    ``n_stations`` columns and ``n_windows`` demand windows, in the least
    bytes the function needs: each step's finish count (int32) and
    latency (float32) written per lane; the window table a step and each
    lane's step length ``dt`` (a step's end time is ``(i + 1) * dt``),
    the window rates and the routing (a byte and an int32 a column) read
    once; (with ``n_seeds`` seeds; 0 in the deterministic mode) each
    seed's float32 service draws for the steps read once, whatever the
    lanes sharing it; the state (int32 station and rank and float32 entry
    time a client, int32 queue and float32 work a station) and the
    per-window queue integrals read and written once.  Operations: the
    float32 arithmetic of a step, the end time and the finisher's latency
    a lane and per station the work's subtraction, its comparison, the
    draw's addition and the queue integral's."""
    nbytes = (lanes * n_steps * (4 + 4)
              + n_steps * 4
              + lanes * 4
              + n_windows * lanes * n_stations * 4
              + lanes * n_stations * (1 + 4)
              + n_seeds * n_steps * n_stations * 4
              + 2 * lanes * (n_clients * (4 + 4 + 4) + n_stations * (4 + 4))
              + 2 * lanes * n_windows * n_stations * 4)
    ops = lanes * n_steps * (2 + 4 * n_stations)
    return ops, nbytes, "f32"


def wkv6_bwd_cost(B: int, S: int, H: int, D: int, esize: int, has_s0: bool,
                  has_ds_last: bool, chunk: int) -> Cost:
    """The WKV backward: r, k, v and dy read and dr, dk and dv written in
    their dtype, logw read and dlogw written in float32, u read and du
    written, s0 read and ds0 written, ds_last read.  Operations: the
    chunked form's products on the tensor cores, per token and head
    10 C d + 10 d^2 with C = ``chunk`` (the walk forward's state update;
    the scores A and dA, dA k_in, dA^T q_in and A^T dy over the chunk; the
    inter-chunk dr, dk and dv and the dS update), tripled by the split TF32
    products, as ``wkv6_cost`` counts the forward's."""
    nbytes = (B * S * H * D * (7 * esize + 8) + 8 * H * D
              + 4 * B * H * D * D * (2 * int(has_s0) + int(has_ds_last)))
    return 3 * (10 * chunk * D + 10 * D * D) * B * S * H, nbytes, "tf32"

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (the run then exits non-zero and prints
no result line):

1. device - the card's name and count, and ``nvidia-smi``'s name and
   power limit; without a card the run fails at once;
2. build - compile every CUDA kernel of the port from ``src/`` (one
   ``nvcc`` per source, all started together) and print ``-Xptxas -v``
   (registers and spills) and the bf16 attention kernels' tiles;
3. kernels against their plain versions - small shapes and edge cases
   (the histogram exactly; flash attention and flash decode within
   ``ATTN_TOL``, recurrentgemma's windowed head-dim-256 attention, its
   group-10 decode and the RG-LRU scan from a zero and from a given
   starting state, within ``SCAN_TOL``, too, and the WKV recurrence
   within ``WKV_TOL``), then the histogram on the execution path's own
   full-size tensors, one device kernel a call (a profiler window), its
   plan (its route and chunks), timed alone (queued behind a sleep) beside
   the call's host wall and its bound (each execute there runs
   the step kernel: its launches and scan time, beside the plain loop's
   ms a step from 3b);
3b. the execution lanes' step kernels - ``exec_lanes`` against the plain
   step loop (``ref_exec_lanes``), both on the card, bitwise (completion
   masks, latencies, the state after the run, drain counts, makespans):
   phase 4's grid at both mixes with its commands cut to
   ``EXEC_LANES_CUT_COMMANDS`` (reduced: commands; every step of both,
   with the plain loop's ms a step) and phase 5's grid with injected and
   with generator draws, all through the warp kernel (each launch's
   kernel counted), phase 5's grid at ``WIDE_CLIENTS`` clients a lane
   through the block kernel, and the first block of steps of phase 4's
   own 90 %-read lanes, where the warp kernel, the block kernel (the
   design it replaced) and the plain loop are timed beside the block's
   bound;
4. the execution path - ``compile_sweep`` of the 32-config
   compartmentalized MultiPaxos grid (f = 1, 2x2 acceptor grid; the
   deployment family of the paper's ablation, arXiv 2012.15762 section 8,
   Fig. 29), its bottleneck law and MVA on the card, and ``.execute`` at
   2048 commands x 8 seeds x 64 clients for the paper's two headline
   mixes; every lane must drain, the step kernel must launch once a
   block of ``BLOCK_STEPS`` steps, each launch the warp kernel (its
   device time summed by CUDA events, beside the scan's bound) and the
   histogram kernel must launch;
5. the card against the CPU - the port on ``cuda`` and on ``cpu`` agree on
   a 4-config x 2-seed grid (the MVA surfaces bit for bit);
5b. the steady-state solves - phase 4's grid through ``CompiledSweep.mva``
   at ``SS_CLIENTS`` clients and sharded over ``SS_SHARDS`` shards (480
   columns), and ``.fluid`` at ``SS_FLUID``, each one launch of its
   kernel (``csrc/mva_scan.cu``, ``csrc/fluid_scan.cu``; counted from 0)
   and bit for bit the CPU's; each kernel bit for bit its plain loop on
   the card at those demands and in edge cases, 20 CUDA-graph replays
   bitwise equal, each kernel alone (queued behind a sleep; the MVA's
   row-sum plan and cycles a step) beside its bound and the plain
   loop's, and each call's host wall beside the eager parent's;
6. the transient path - the same 32-config grid through
   ``CompiledSweep.transient`` at 8 seeds x 64 clients x 4000 steps,
   exponential service (the seeded generator's draws), with the leader
   crash ``autotune`` scripts by default (``Event("leader", 0.4, 0.6,
   1e9)``), for both mixes, its steps through the ``transient_lanes``
   warp kernel (one launch a block of ``BLOCK_STEPS`` steps, counted by
   kernel, its device time summed by CUDA events): every lane's histogram
   mass equals its completions, the ``latency_hist`` kernel bins the run's
   latencies in one launch a mix (counted), each config's seed-mean
   throughput outside the crash is within 10 % of its bottleneck-law peak
   and every lane's crash window below it; the same lanes through the
   plain step
   loop (``ref_transient_lanes``) on the card, bitwise equal (flows,
   latencies, the final state, queue sums), with its ms a step; the
   histogram against its plain version on the samples the path handed
   it (one device kernel a call), and the step kernel's first block at
   the path's shape, both timed alone
   beside their bounds (and the block kernel on the same lanes beside the
   warp kernel); then ``bottleneck_trace(budget=19)`` (the Fig. 29
   staircase, exactly), ``autotune(objective="p99_under_failover")`` on
   the card, ``autotune_policy`` at ``benchmarks/autoscale.py``'s
   settings (the numbers of ``BENCH_autoscale.json``, exactly), both
   timed, both step kernels against the plain loop on a 4-config x
   2-seed crash grid (16 clients a lane: the warp kernel; ``WIDE_CLIENTS``:
   the block kernel) with injected and with deterministic draws, bitwise,
   and
   the card against the CPU on that grid, deterministic and exponential
   (flows, completions, histograms, queue sums, throughput and mean
   latency equal);
7. the serving path - granite-3-2b at full width (40 layers, d_model
   2048, bf16, random weights from a seeded generator on the card) behind
   a compartmentalized ``ServingDeployment`` (3 replicas, 3 proxy leaders,
   2x2 grid, 2 clients, linearizable): weights v1, then 8 requests of
   17-2048 prompt tokens x 16 new tokens with v2 pushed after the 4th,
   then ``ContinuousBatcher`` over 16 requests of 512 tokens in 8 slots;
   versions, leaderless reads, spread loads and a direct decode must hold,
   and each attention kernel must launch 40 times per prefill / decode
   step.  Then both kernels against their plain versions on the
   full-width tensors the path handed them, with their times, the
   library call's and their bounds, and the path's prefill and decode
   times;
8. the recurrent serving path - recurrentgemma-2b at full width (26
   layers: 18 RG-LRU of width 2560 and 8 local attention of 10/1 heads x
   256 with a 2048-token window; d_model 2560, bf16, random seeded
   weights on the card) behind the same fleet: 5 requests of 17-3000
   prompt tokens x 16 new (3000 runs the window mask and the ring-buffer
   roll, 2040 + 16 wraps the ring in decode) with v2 pushed after the
   2nd, then ``ContinuousBatcher`` (8 slots, max_len 2048) over 16
   requests of 512 tokens x 32 new; the same checks, with exactly 18
   ``rglru_scan`` + 8 ``flash_attention`` launches per prefill and 18
   ``rglru_scan`` + 8 ``flash_decode`` per decode step, and every
   kernel's launches printed by shape (prefill length, decode batch).
   Then the three kernels against their plain versions on the full-width
   tensors the path handed them (the recurrence at decode, batch 8 and 1,
   at the batcher's 512-token prefill and at the longest prefill), with
   their times, bounds and the library call's;
9. the attention-free serving path - rwkv6-7b at full width (32 layers of
   RWKV-6 time mix, 64 heads x 64, and channel mix 14336; d_model 4096,
   vocab 65,536, bf16, random seeded weights on the card) behind the same
   fleet: 5 requests of 17-4096 prompt tokens x 16 new with v2 pushed
   before the 3rd, then ``ContinuousBatcher`` (8 slots, max_len 1024)
   over 16 requests of 512 tokens x 32 new; the same checks, with exactly
   32 ``wkv6`` launches per prefill and per decode step, printed by
   shape.  Then the kernel against its plain version on the full-width
   tensors the path handed it (decode at batch 8 and 1, the 512-token and
   the longest prefill), with its times and bound;
9a. the mixture-of-experts serving path - deepseek-moe-16b at full width
    and depth (28 layers of 16/16 heads x 128: a dense SwiGLU 10944 layer,
    then 27 of 64 routed experts of 1408, top-6, plus 2 shared; d_model
    2048, vocab 102,400, bf16, 16.4 B random seeded parameters x 2
    versions on the card) with GShard capacity dispatch, behind the same
    fleet: 6 requests of 17-2048 prompt tokens x 16 new (1000 dispatches
    in gcd groups of 8, 2048 in four groups of 512) with v2 pushed before
    the 4th, then the batcher (8 slots, max_len 1024) over 16 x 512 x 32
    new; exactly 28 ``flash_attention`` launches per prefill and 28
    ``flash_decode`` per decode step.  Then one MoE layer on the
    full-width input the path handed it at the 2048-token prefill and at
    decode batch 8: its kept mask and queue positions equal a loop's on
    the host from the card's own top-k indices, and its output equals the
    drop-free dense layer's on every token with no dropped choice (within
    ``ATTN_TOL``); its drop fraction, time and bound, and a decode step's
    device time (one step as a CUDA graph) beside the bytes it must read;
9b. the same for qwen3-moe-30b-a3b (48 layers of 32/4 heads x 64, 128
    experts of 768, top-8, no shared; 30.1 B parameters, so one version:
    two would not fit the card): 3 requests of 17-2048 tokens x 16 new,
    the batcher over 8 x 512 x 32 new;
10. the card against the CPU on the models - the five models' smoke
    configs in float32 on the same weights (the MoE configs with capacity
    dispatch): logits agree, greedy and served tokens are equal;
T1. (right after phase 3) the attention backward - the hand-written
    ``flash_attention_bwd`` through the autograd Function (on the
    forward kernel's output and log-sum-exp) against autograd through the
    plain forward on edge cases (lengths 1-2048, S_q x S_k 1/17/448 x
    1500, groups 1/4/8, head dims 64/128/256, causal, windowed, full;
    float32 and bf16) within ``BWD_TOL``; the backward library's
    registers and spills for each kernel (``-Xptxas -v``; a spill in the
    bf16 ``wgmma`` path at d 64 / 128 fails) and its launch plan at
    granite's and whisper's shapes; at granite-3-2b's training shape
    against the same, 20 replays bitwise equal, its time beside its
    operations bound, autograd's backward through the plain forward and
    SDPA's backward (all three by graph replay after an L2 flush); the
    forward there with and without its log-sum-exp;
T2. the training path - granite-3-2b at full width and depth (bf16, remat
    on) trained by the port's ``Trainer`` for 4 steps on ``SyntheticLM``
    at batch 4 x 1024 tokens (no checkpoint inside the run), the memory
    reckoned first; per step the loss (finite), ms, tokens/s, peak memory
    and exactly 40 ``flash_attention_bwd`` and 80 ``flash_attention``
    (forward and recompute) launches; then the same 4 steps with the
    plain attention under autograd, for its loss curve beside the
    kernels';
T2b. granite-3-2b at full width and depth: one batch's gradients
    through the kernels against the same with the plain attention, in
    float32 every parameter within ``GRAD_TOL_F32`` of its largest entry,
    in bf16 every parameter no further from the float32 gradient than
    ``GRAD_NOISE_RATIO_BF16`` x the plain bf16 attention's;
A6 / A7. (right after phase 3) the recurrences' backward kernels -
    ``wkv6_bwd`` and ``rglru_scan_bwd`` through their autograd Functions
    against autograd through the plain forwards on edge cases
    (``WKV_BWD_CASES``, ``RG_BWD_CASES``; float32 and bf16, strided and
    dense; the WKV backward at the -5 clamp over 1024 steps and at -20,
    whose chunks are walked back step by step) within ``WKV_TOL`` /
    ``SCAN_TOL`` relative to each gradient's largest entry; (in phase 2)
    ``wkv6_bwd.cu``'s registers and spills, a spill in any of its kernels
    failing;
T4. recurrentgemma-2b at full width and depth (26 layers: 18 RG-LRU, 8
    local attention of 10/1 heads x 256, window 2048; bf16, remat on)
    trained as T2 at ``RECURRENT_TRAIN_SHAPE``, the memory reckoned first:
    per step exactly 18 ``rglru_scan_bwd`` + 36 ``rglru_scan`` and 8
    ``flash_attention_bwd`` + 16 ``flash_attention`` launches; the steady
    step, tokens/s, peak and a traced step's device time by kind;
T5. the same for rwkv6-7b at full width (64 heads of 64, d_ff 14336,
    vocab 65,536), its depth cut to the deepest whose reckoned peak stays
    under ``TRAIN_PEAK_GIB`` (reduced: depth; 32 layers reckon about 92
    GiB): exactly one ``wkv6_bwd`` and two ``wkv6`` a layer a step;
T4b / T5b. one batch of ``RECURRENT_GRAD_SHAPE`` (reduced: batch and
    length) through the kernels against the plain forwards, as T2b:
    recurrentgemma-2b at T4's depth, rwkv6-7b at ``T5B_LAYERS`` (reduced:
    depth); then both backward kernels at T4's and T5's shapes against
    autograd through the plain forwards, 20 CUDA-graph replays bitwise
    equal, their times beside their bounds and the plain backward's (the
    WKV backward's plan and workspace bytes printed), and
    the forwards (T4's local attention and its backward too, with SDPA's)
    at the same shapes;
T3. the trainer's fault path - granite-3-2b cut to 4 layers (reduced:
    depth): a checkpoint, ``crash_and_recover`` with the params and
    moments bitwise equal to the saved ones, a straggler step and
    ``scale_workers`` committing through the coordinator;
W.  whisper-tiny at full width and depth (bf16, random seeded weights):
    a prefill over random frames (2, 1500, 384) with exactly 4 encoder, 4
    causal and 4 cross ``flash_attention`` launches, 32 greedy decode
    steps of 8 ``flash_decode`` each; the encoder's, the causal and the
    cross ``flash_attention`` and the cross ``flash_decode`` on the
    tensors the path gave them; the float32 smoke config on the card
    against the CPU; one ``make_train_step`` step with frames (the
    backward at S_q 16 x S_k 1500), and the backward of each kind on the
    q, k, v and cotangent direction of that step against autograd
    through the plain forward (the cross kind, whose dq sums key splits,
    also 20 replays bitwise equal);
D.  the distributed runtime on a one-rank NCCL group in this process
    (one card cannot hold two NCCL ranks; the CPU tests run many over
    gloo) with a (data=1, model=1) ``DeviceMesh``: D1 ``ShardingPolicy``
    on both production layouts for all 10 configs, each device's bytes
    of bf16 parameters and float32 moments with and without ZeRO-1 beside
    the card's memory; D2 granite-3-2b at full width cut to 4 layers
    (reduced: depth), one sharded ZeRO-1 train step against the unsharded
    step from the same weights and batch (loss and every parameter, each
    step's peak memory), exactly 4 ``flash_attention_bwd`` and 8
    ``flash_attention`` launches, and the gradient tree's hierarchical
    mean through NCCL (exact; within int8's step compressed), its time
    and bytes; D3 deepseek-moe-16b cut to its first MoE layer, prefilled
    on 2048 tokens with ``moe_impl="a2a"`` under ``use_mesh``, and that
    layer on the input the prefill handed it: exactly two
    ``all_to_all_single`` a layer call, slots and kept mask == a loop on
    the host, the output == the dense layer's on every token with no
    dropped choice and == the kept choices' sum on every token
    (``ATTN_TOL``), its time and drop fraction; D4
    ``make_distributed_flash_decode`` at granite's decode shapes, batch 1
    and 8 against 2048 rows, within ``ATTN_TOL`` of ``flash_decode``'s
    kernel (the reference: its launches are not the path's, and the
    ``kernels`` line has no row for them).  The checks are functions
    (``_dist_*``) that ``scripts/distributed_nccl.py`` runs on four
    cards (with one more there, ``_dist_a2a_train``: the sharded step
    with ``moe_impl="a2a"`` over a model axis of four ranks);
R.  the roofline on the card's constants (``roofline/analysis.py``), on
    the CPU in child processes (fake process groups; the card is idle):
    R1 ``python -m repro_torch.launch.dryrun --all --mesh R1_MESH`` (every
    architecture x shape x production mesh: ok, every ``train_4k`` cell
    included, but the attention configs' ``long_500k`` skipped; no
    error), its wall time and the three hillclimb picks; R2 the dry run's
    cell function at three sizes this run measured, on a (1, 1) mesh - granite-3-2b trained at T2's 4 x 1024
    (against T2's steady step and its traced device time), its 2048-token
    prefill (against phase 7's), deepseek-moe-16b's batch-1 decode step
    (against phase 9a's one-graph device time) - predicted beside
    measured; R3 ``python -m repro_torch.launch.moe_a2a_probe``.

The line before the last is the card's name and power limit; the line
before it, a JSON object describing every kernel; the last line,
``{"ok": true, "device": {...}}``.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
# the card's rates and the kernels' operation and byte counts: one copy,
# the roofline's (NVIDIA's data sheet, H100 SXM at its full 700 W limit)
from repro_torch.roofline import kernel_costs  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    HBM_BW as PEAK_BYTES_PER_S,
    PEAK_BY_RATE,
    PEAK_F32_FLOPS as PEAK_F32_OPS_PER_S,
    PEAK_FLOPS as PEAK_BF16_OPS_PER_S,
)

#: what the phases measured that phase R holds the roofline against:
#: (arch, "prefill_ms") -> {prompt length: ms}, (arch, "decode_graph_ms",
#: batch) -> ms, "train_step_ms" and "train_device_ms"
MEASURED: dict = {}

GRID = dict(variants=("compartmentalized",),
            n_proxy_leaders=(2, 3, 4, 5, 6, 7, 8, 10), grids=((2, 2),),
            n_replicas=(2, 3, 4, 6))
EXECUTE = dict(n_commands=2048, seeds=8, n_clients=64, probe_n=96)
#: phase 3b: the grid's lanes with the commands cut to this (reduced:
#: commands), so that the plain step loop runs every step on the card too
EXEC_LANES_CUT_COMMANDS = 256
#: the state the execution lanes' step loop updates in place
EXEC_STATE = ("stage", "rank", "enter_t", "op_i", "q", "work")
#: clients a lane past the step kernels' warp kernel (128): phases 3b and 6
#: run such lanes through the block kernel (3b for WIDE_STEPS steps)
WIDE_CLIENTS = 200
WIDE_STEPS = 1024
#: The transient phase: the grid's lanes, and the leader crash ``autotune``
#: ranks deployments under by default (demand x 1e9 over 40-60 % of the run)
TRANSIENT = dict(n_clients=64, seeds=8, n_steps=4000)
TRANSIENT_CRASH = ("leader", 0.4, 0.6, 1e9)
#: the state the transient lanes' step loop updates in place, and its outputs
TRANSIENT_STATE = ("stage", "rank", "enter_t", "q", "work", "qsum", "flows",
                   "lat1")
#: phase 5b, the steady-state solves on the Fig. 29 grid (write-only): MVA
#: at these n_clients_max, once more sharded over SS_SHARDS shards ([M, S,
#: K] flattened to [M, 480]), fluid at 64 clients x 2000 steps
SS_CLIENTS = (64, 512)
SS_SHARDS = 32
SS_FLUID = dict(n_clients=64, n_steps=2000)
#: the eager loops before these kernels: each call's host wall ms (two
#: runs of scripts/steady_state_ab.py on an H100 80GB HBM3 at 700 W,
#: PERF.md section 6) and its launches (kernels + copies)
SS_PARENT = {"mva 64": ((6.481, 5.137), "515 + 4"),
             "mva 512": ((51.104, 63.563), "4,099 + 4"),
             "mva 512 sharded": ((53.311, 50.736), "4,099 + 4"),
             "fluid": ((129.997, 179.313), "12,010 + 5")}
#: bottleneck_trace(budget=19) with the calibrated alpha, the paper's
#: Fig. 29 staircase: (machines, cmd/s rounded, bottleneck) per rung
FIG29 = [(3, 25_000, "leader"), (8, 46_296, "proxy"), (9, 69_444, "proxy"),
         (10, 92_593, "proxy"), (11, 104_167, "leader")]
#: benchmarks/autoscale.py's deployment, floors and policy grid, whose
#: autotune_policy run BENCH_autoscale.json records
AUTOSCALE_CFG = {"variant": "compartmentalized", "f": 1,
                 "n_proxy_leaders": 8, "grid_rows": 2, "grid_cols": 2,
                 "n_replicas": 6, "n_batchers": 3, "n_unbatchers": 3}
AUTOSCALE_FLOORS = (("proxy", 3), ("replica", 2), ("batcher", 2),
                    ("unbatcher", 2))
AUTOSCALE_BANDS = ((0.4, 0.65, None), (0.35, 0.6, None), (0.4, 0.65, 1.0))
#: (atol, rtol) of each attention kernel against its plain version, by
#: dtype.  float32 as in tests/test_kernels.py:21-23.  bfloat16: both sides
#: round their output to bf16 (one ulp is at most 2^-7 of a value) and the
#: kernel rounds the softmax weights to bf16 for the tensor cores, so the
#: check holds it to about one output ulp plus that; the CPU tests' 2e-2 is
#: for the JAX kernel, whose rounding differs.
ATTN_TOL = {"torch.float32": (2e-5, 2e-5), "torch.bfloat16": (4e-3, 1e-2)}
#: The planted fault drops one whole key tile of the kernel that runs the
#: path: ``flash_attention.key_tile(d)`` keys at a prefill (64, or 32 at
#: head dim 256), ``decode_attention.TILE`` (64) at decode.
#: The serving phases, in order: arch -> the fleet's prompt lengths, new
#: tokens per request, the request before which weights v2 are pushed, and
#: the batcher's run.  recurrentgemma-2b: 3000 runs the prefill's window
#: mask and ring-buffer roll at full width, 2040 + 16 new tokens wraps the
#: ring during decode, and max_len must reach the window (the prefill's
#: ring buffer has `window` rows and init_cache min(window, max_len), and
#: the two must splice).  rwkv6-7b: 100 is no multiple of the reference's
#: 32-step chunk, and 4096 shows that the state does not grow with the
#: prompt.  deepseek-moe-16b: 1000 tokens dispatch in gcd groups of 8, 2048
#: in four groups of 512.  ``push_at=None``: one weight version, never
#: replaced.
SERVE = {
    "granite-3-2b": dict(
        prompts=(17, 128, 256, 512, 1000, 1024, 2048, 2048), new=16,
        push_at=4, batch=dict(n_slots=8, max_len=1024, n_requests=16,
                              prompt=512, max_new=32)),
    "recurrentgemma-2b": dict(
        prompts=(17, 512, 2040, 2048, 3000), new=16, push_at=2,
        batch=dict(n_slots=8, max_len=2048, n_requests=16, prompt=512,
                   max_new=32)),
    "rwkv6-7b": dict(
        prompts=(17, 100, 512, 2048, 4096), new=16, push_at=2,
        batch=dict(n_slots=8, max_len=1024, n_requests=16, prompt=512,
                   max_new=32)),
    "deepseek-moe-16b": dict(
        prompts=(17, 128, 512, 1000, 2048, 2048), new=16, push_at=3,
        batch=dict(n_slots=8, max_len=1024, n_requests=16, prompt=512,
                   max_new=32)),
    # one weight version: two would be 120 GB
    "qwen3-moe-30b-a3b": dict(
        prompts=(17, 512, 2048), new=16, push_at=None,
        batch=dict(n_slots=8, max_len=1024, n_requests=8, prompt=512,
                   max_new=32)),
}
#: (atol, rtol) of rglru_scan against its plain version.  float32: the
#: kernel's chunks multiply the same decays in another order than the
#: serial loop, which moves the result by float32 rounding only
#: (tests/test_torch_rglru_scan.py states the same 1e-5); bfloat16: one
#: rounding of the output, as ATTN_TOL.
SCAN_TOL = {"torch.float32": (1e-5, 1e-5), "torch.bfloat16": (4e-3, 1e-2)}
#: recurrentgemma's edge cases: rglru_scan (B, S, D) (3000 and 515 end in
#: a ragged chunk of the one-launch kernel's plan: 56 of 128 steps, 3);
#: windowed flash
#: attention (B, H, H_kv, S, d, window) past, at and short of the 2048
#: window, with 64-row query blocks at exactly i = window (64, 128) and
#: straddling it (1, 100); flash decode (B, H, H_kv, S_max, d)
RG_SCAN_CASES = ([(b, s, 2560) for b in (1, 8) for s in (1, 17, 77, 4096)]
                 + [(3, 129, 77), (1, 300, 1), (1, 3000, 2560),
                    (1, 515, 2560)])
RG_WINDOW_CASES = ([(1, 10, 1, s, 256, 2048)
                    for s in (1, 17, 2047, 2048, 2049, 3000)]
                   + [(2, 4, 1, 300, 256, 64), (1, 8, 2, 257, 64, 128),
                      (1, 6, 1, 77, 128, 1), (2, 10, 1, 500, 256, 100),
                      (1, 10, 1, 1000, 256, None)])
RG_DECODE_CASES = [(1, 10, 1, 2048, 256), (8, 10, 1, 2048, 256),
                   (3, 10, 1, 17, 256), (2, 10, 1, 1000, 256)]
#: (atol, rtol) of wkv6 against its plain version, the atol relative to
#: max(1, max |want|) (``_wkv_ratio``): both sum in float32 in different
#: orders, and a sum's rounding error grows with its terms - with logw
#: = 0 the state, and y with it, grows with S (|y| ~ 2,800 at S = 4096,
#: where the serial float32 recurrence is 3.2e-3 off in float64).
#: float32 rtol as atol; bfloat16 one rounding of the output (at most 2^-7
#: of it).  As tests/test_torch_wkv6.py.
WKV_TOL = {"torch.float32": (1e-5, 1e-5), "torch.bfloat16": (1e-5, 1e-2)}
#: rwkv6-7b's WKV edge cases: (B, S) at its 64 heads of 64 - decode, S
#: short of, at and past the kernel's 32-step chunk and two chunks,
#: ragged, the longest prompt; each from a zero and a given state, with
#: logw from the model's range, at its -5 clamp everywhere (chunk totals
#: of -160, the recentring's edge), at 0 (no decay: the state grows with
#: S) and at -20 (totals past the recentring's range: chunks evaluated
#: step by step)
WKV_CASES = [(b, s) for b in (1, 8) for s in (1, 31, 32, 33, 64, 100, 4096)]
WKV_LOGW = (None, -5.0, 0.0, -20.0)
#: ... and at large k and v: (B, S, logw, scale of k and v), at the clamp
#: and at chunk totals of -164 (recentred factors near exp(80) and
#: exp(82) times |k|: the state update's products must stay as small as
#: the serial form's), and with factors past FACTOR_MAX there (those
#: chunks go step by step)
WKV_LARGE = [(1, 100, -5.0, 100.0), (1, 100, -5.125, 30.0),
             (1, 100, -5.125, 1000.0)]
#: The MoE models' attention at head dim 128: flash attention (B, H, H_kv,
#: S, d) at deepseek-moe-16b's 16/16 heads (group 1), and at 32/4 (group
#: 8), Qwen3-30B-A3B's published heads of 128 (the config here, as the
#: reference's, takes d_model / n_heads = 64, which phase 9b runs); flash
#: decode (B, H, H_kv, S_max, d) at both, batch 1 and 8, with cache
#: lengths of 1, 17 and S_max (and different per row)
MOE_ATTN_CASES = [(1, H, H_kv, S, 128) for H, H_kv in ((16, 16), (32, 4))
                  for S in (17, 1000, 2048)]
MOE_DECODE_CASES = [(B, H, H_kv, S, 128) for H, H_kv in ((16, 16), (32, 4))
                    for B in (1, 8) for S in (1024, 2064)]


def _mixes(P):
    return [("write-only", P.Workload(f_write=1.0)),
            ("90% reads", P.Workload.read_mix(0.9))]


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _sm_clock_hz() -> float:
    """The card's SM clock now, as ``nvidia-smi`` reads it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(out.stdout.split()[0]) * 1e6


def _time_ms(fn, warmup: int, reps: int) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _hist_cases(rng):
    """(samples, valid, edges) float32 numpy triples: the CPU tests' shapes,
    an N that is no multiple of the block, B of 64 and 96, edge cases."""
    cases = []
    for lanes, n, bins in [(1, 64, 8), (4, 128, 16), (3, 96, 24),
                           (5, 4099, 64), (3, 20_001, 96), (257, 3000, 64)]:
        lo = (0.5 + np.arange(lanes, dtype=np.float32))[:, None]
        edges = (lo * np.logspace(0.0, 2.0, bins + 1)[None, :]
                 ).astype(np.float32)
        samples = rng.uniform(0.1, 200.0, (lanes, n)).astype(np.float32)
        valid = (rng.uniform(size=(lanes, n)) < 0.7).astype(np.float32)
        # an exact-edge sample, 1e9, 0.0, NaN, +inf (all valid), and the
        # last lane fully masked
        samples[:, 0] = edges[:, 3]
        samples[:, 1] = 1e9
        samples[:, 2] = 0.0
        samples[:, 3] = np.nan
        samples[:, 4] = np.inf
        valid[:, :5] = 1.0
        valid[-1] = 0.0
        cases.append((samples, valid, edges))
    return cases


def _main_path_tensors(PB, sweep, w, dev):
    """The (L, n_steps * N) samples, mask and edges that ``.execute`` hands
    the histogram kernel, caught on their way into it."""
    caught = {}
    kernel = PB.latency_hist

    def catch(samples, valid, edges):
        caught.update(samples=samples, mask=valid, edges=edges)
        return kernel(samples, valid, edges)

    PB.latency_hist = catch
    try:
        res = sweep.execute(workload=w, device=dev, **EXECUTE)
    finally:
        PB.latency_hist = kernel
    return (caught["samples"], caught["mask"], caught["edges"], res.n_steps,
            res.timings["scan"])


def _bound_ms(cost):
    """Least time for a kernel's work on this card: the larger of its bytes
    at the memory rate and its operations at the peak rate of their type,
    from ``roofline/kernel_costs``' (operations, bytes, rate)."""
    ops, nbytes, rate = cost
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_BY_RATE[rate] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _hist_bound_ms(samples, mask, edges, n_valid: int):
    """Least time for the histogram on this card: every mask byte and every
    valid sample read once, edges read and counts written once; against a
    compare-and-add per mask byte plus a lower-bound search per valid
    sample."""
    lanes, n = samples.shape
    return _bound_ms(kernel_costs.latency_hist_cost(
        lanes, n, edges.shape[1] - 1, n_valid, mask.element_size()))


#: cycles of the sleep a step-kernel call is queued behind when timed alone
#: (about 1 ms: longer than the wrapper's Python before its launch)
STEP_LEAD_CYCLES = 2_000_000
#: how the step kernels' ``ms`` and ``block_kernel_ms`` are timed (their
#: ``kernels`` rows say so: the wrapper's host time is outside the window)
STEP_TIMED = ("CUDA events around each launch, queued behind a sleep on "
              "the card, median of 5")


def _alone_ms(fn, reps: int = 5) -> float:
    """``fn``'s device time alone (``STEP_TIMED``): CUDA events around one
    call queued behind a sleep on the card, so that the wrapper's host
    work before its launches is outside the window; the median of
    ``reps`` after a warm call."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(STEP_LEAD_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _host_wall_ms(fn, reps: int = 5) -> float:
    """The host wall of one whole call of ``fn`` to a synchronize, median
    of ``reps``."""
    import torch
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _device_kernels(fn) -> list:
    """The device kernels (no copies) a ``torch.profiler`` window over one
    call of ``fn`` holds, by name."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
            and "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower()]


def _hist_record(LH, ref, samples, mask, edges, what: str) -> dict:
    """The histogram on one call's tensors: bit for bit its plain version,
    exactly one device kernel a call (a profiler window: no fill before
    it), timed alone beside the call's host wall, its bound and the plain
    version's time.  Returns its ``kernels`` row's figures."""
    import torch
    want = ref.ref_latency_hist(samples, mask, edges)
    got = LH.latency_hist(samples, mask, edges)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"{what}: latency_hist differs from its plain "
                             f"version (max {err})")
    del got, want

    def call():
        return LH.latency_hist(samples, mask, edges)

    before = LH.latency_hist.launches
    kernels = _device_kernels(call)
    # the profiler may see no device event at all (then the counter and
    # the gpu test on garbage memory stand for it), never more than one
    if LH.latency_hist.launches - before != 1 or len(kernels) > 1:
        raise AssertionError(f"{what}: one latency_hist call launched "
                             f"{LH.latency_hist.launches - before} times "
                             f"and ran the device kernels {kernels}")
    n_valid = int(mask.sum())
    plan = LH.launch_plan(samples)
    bound_ms, bound_by = _hist_bound_ms(samples, mask, edges, n_valid)
    return dict(max_abs_err=err, ms=_alone_ms(call), wall_ms=_host_wall_ms(
                    call), plain_ms=_time_ms(lambda: ref.ref_latency_hist(
                        samples, mask, edges), 1, 2),
                bound_ms=bound_ms, bound_by=bound_by, n_valid=n_valid,
                plan=plan._asdict(), kernel=(kernels[0].split("(")[0]
                                             if kernels else "not seen"),
                timed=STEP_TIMED)


def _step_run(mod, steps, fn, *args, kernel="exec_lanes", keys=EXEC_STATE,
              lead=False, **kw):
    """``fn(*args, **kw)`` with an engine's step function (``mod.<kernel>``:
    ``batched_execution.exec_lanes`` by default, or
    ``transient.transient_lanes``) replaced by ``steps``, each call timed
    by CUDA events.  With ``lead`` each call's events and launch are queued
    behind a sleep on the card, so the host's work before the launch is
    outside the window (the run's own wall clock then includes the
    sleeps).  Returns (fn's result, the calls' device ms summed, the last
    call's tensors named in ``keys``, which then hold the run's final
    state; nothing else of the calls is kept, so no table or output lives
    longer than the run would keep it)."""
    import torch
    events, last = [], {}

    def timed(*p, **a):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if lead:
            torch.cuda._sleep(STEP_LEAD_CYCLES)
        start.record()
        steps(*p, **a)
        end.record()
        events.append((start, end))
        last.update((key, a[key]) for key in keys)

    real = getattr(mod, kernel)
    setattr(mod, kernel, timed)
    try:
        out = fn(*args, **kw)
    finally:
        setattr(mod, kernel, real)
    torch.cuda.synchronize()
    return out, sum(a.elapsed_time(b) for a, b in events), last


def _block_plan(EL):
    """A launch plan with the step kernels' ``plan`` signature that takes
    the block kernel (one block a lane) for every lane: the design the warp
    kernel replaced at the main path's lanes, run beside it."""
    def plan(n_lanes, n_clients, n_columns, n_sms=132):
        threads, cpt = EL.launch_plan(max(n_clients, 1), n_columns)
        return EL.LaunchPlan("block", n_lanes, threads, cpt, 1)
    return plan


def _with_plan(mod, plan, fn, *args, **kw):
    """``fn(*args, **kw)`` with ``mod.plan`` (a step kernel's launch plan)
    replaced by ``plan``."""
    real = mod.plan
    mod.plan = plan
    try:
        return fn(*args, **kw)
    finally:
        mod.plan = real


def _lanes_equal(got, want, what: str) -> float:
    """got / want: ``_step_run``'s results of ``_execute_batch`` through
    the kernel and through the plain loop: raise unless the completion
    masks, latencies, drain counts, makespans and final state are bitwise
    equal.  Returns the largest |a - b| over the float outputs and state
    (latencies, makespans, entry times, work; equal infinities count 0)."""
    import torch
    (out_a, _, last_a), (out_b, _, last_b) = got, want
    pairs = list(zip(("fin", "lat", "done_w", "done_r", "t_last"), out_a,
                     out_b))
    pairs += [(key, last_a[key], last_b[key]) for key in EXEC_STATE]
    err = 0.0
    for name, a, b in pairs:
        if a.is_floating_point():
            diff = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: exec_lanes differs from its plain "
                                 f"version in {name} (max |diff| {err})")
    return err


def _exec_lanes_phase(P, PB, EL, ref, sweep, dev) -> dict:
    """Phase 3b: the execution lanes' step kernels against the plain step
    loop, both on the card, bitwise: the Fig. 29 grid (32 configs x 8
    seeds x 64 clients) at both mixes with its commands cut to
    ``EXEC_LANES_CUT_COMMANDS`` (every step of both), phase 5's small grid
    with injected and with generator draws (these take the warp kernel),
    the small grid at ``WIDE_CLIENTS`` clients a lane (the block kernel),
    and the first block of steps of the main path's own 90 %-read lanes
    (2048 commands), where the warp kernel, the block kernel and the plain
    loop are timed beside the block's bound.  Returns the ``kernels`` row's
    numbers and the plain loop's ms a step at the cut size by mix."""
    import torch
    t_phase = time.perf_counter()
    n_clients = EXECUTE["n_clients"]
    seeds = np.arange(EXECUTE["seeds"], dtype=np.int32)
    errs = []   # max |kernel - plain| of each comparison

    def both(inp, n_clients, n_steps, exponential, what, kernel="warp"):
        before = EL.exec_lanes.launches
        by_kernel = EL.exec_lanes.by_kernel[kernel]
        t0 = time.perf_counter()
        got = _step_run(PB, EL.exec_lanes, PB._execute_batch, inp,
                        n_clients, n_steps, exponential)
        kernel_s = time.perf_counter() - t0
        launches = EL.exec_lanes.launches - before
        if launches != -(-n_steps // PB.BLOCK_STEPS):
            raise AssertionError(f"{what}: {launches} exec_lanes launches "
                                 f"for {n_steps} steps")
        if EL.exec_lanes.by_kernel[kernel] - by_kernel != launches:
            raise AssertionError(f"{what}: the launches did not all take "
                                 f"the {kernel} kernel")
        t0 = time.perf_counter()
        want = _step_run(PB, ref.ref_exec_lanes, PB._execute_batch, inp,
                         n_clients, n_steps, exponential)
        plain_s = time.perf_counter() - t0
        if EL.exec_lanes.launches != before + launches:
            raise AssertionError(f"{what}: the plain loop launched the "
                                 f"kernel")
        errs.append(_lanes_equal(got, want, what))
        return got, kernel_s, plain_s, launches

    plain_ms_step = {}
    for label, w in _mixes(P):
        low = PB._lower_configs(sweep.configs, w,
                                n_commands=EXEC_LANES_CUT_COMMANDS,
                                seeds_arr=seeds, n_clients=n_clients,
                                probe_n=EXECUTE["probe_n"])
        (out, dev_ms, _), kernel_s, plain_s, launches = both(
            PB._lane_inputs(low, dev), n_clients, low.n_steps, False,
            f"{label}, {EXEC_LANES_CUT_COMMANDS} commands")
        done = (out[2] + out[3]).cpu().numpy().reshape(len(low.lane_n), -1)
        if not np.all(done == low.lane_n[:, None]):
            raise AssertionError(f"{label}: a cut lane did not drain")
        n = low.n_steps
        plain_ms_step[label] = plain_s / n * 1e3
        print(f"kernel check: exec_lanes (warp kernel) == plain step loop "
              f"bitwise (fin, lat, state, done, t_last), {label}, the Fig. "
              f"29 grid "
              f"({len(low.lane_n)} configs x {seeds.size} seeds x "
              f"{n_clients} clients) with {EXEC_LANES_CUT_COMMANDS} commands "
              f"(reduced: commands, from {EXECUTE['n_commands']}), {n} steps: "
              f"kernel {launches} launches, {dev_ms:.2f} ms on the card "
              f"({dev_ms / n * 1e3:.3f} us a step), scan {kernel_s:.3f} s; "
              f"the plain loop {plain_s:.1f} s ({plain_ms_step[label]:.3f} "
              f"ms a step)", flush=True)
        del out, low
    small = P.compile_sweep(P.SweepSpec(n_proxy_leaders=(2, 4),
                                        grids=((2, 2),), n_replicas=(2, 3)))
    small_seeds = np.arange(2, dtype=np.int32)
    for mode in ("injected", "generator"):
        low = PB._lower_configs(small.configs, P.MIXED_50_50,
                                n_commands=64,
                                seeds_arr=small_seeds, n_clients=8,
                                exponential_service=True)
        draws = None
        if mode == "injected":
            draws = np.random.default_rng(29).exponential(
                size=(len(low.dt), small_seeds.size, low.n_steps + 1,
                      low.d_w.shape[1])).astype(np.float32)
        inp = P.lane_inputs_from_numpy(low.d_w, low.d_r, low.entry, low.nxt,
                                       low.cls, low.budget, low.dt,
                                       low.seeds, draws, device=dev)
        (out, _, _), _, _, launches = both(inp, 8, low.n_steps, True,
                                           f"small grid, {mode} draws")
        done = (out[2] + out[3]).cpu().numpy().reshape(len(low.lane_n), -1)
        if not np.all(done == low.lane_n[:, None]):
            raise AssertionError(f"small grid, {mode} draws: a lane did not "
                                 f"drain")
        print(f"kernel check: exec_lanes (warp kernel) == plain step loop "
              f"bitwise, phase 5's grid ({len(low.lane_n)} configs x 2 seeds "
              f"x 8 clients, 64 commands), "
              f"exponential service, {mode} "
              f"draws, {low.n_steps} steps in {launches} launches; every "
              f"lane drained", flush=True)
    # lanes too wide for a warp: the block kernel, over WIDE_STEPS steps
    for mode in ("deterministic", "injected"):
        low = PB._lower_configs(small.configs, P.MIXED_50_50,
                                n_commands=WIDE_CLIENTS + 56,
                                seeds_arr=small_seeds,
                                n_clients=WIDE_CLIENTS,
                                exponential_service=mode == "injected")
        n_steps = min(low.n_steps, WIDE_STEPS)
        draws = None
        if mode == "injected":
            draws = np.random.default_rng(32).exponential(
                size=(len(low.dt), small_seeds.size, n_steps + 1,
                      low.d_w.shape[1])).astype(np.float32)
        inp = P.lane_inputs_from_numpy(low.d_w, low.d_r, low.entry, low.nxt,
                                       low.cls, low.budget, low.dt,
                                       low.seeds, draws, device=dev)
        _, _, _, launches = both(inp, WIDE_CLIENTS, n_steps,
                                 mode == "injected", f"wide lanes, {mode}",
                                 kernel="block")
        print(f"kernel check: exec_lanes (block kernel) == plain step loop "
              f"bitwise, phase 5's grid at {WIDE_CLIENTS} clients a lane "
              f"({WIDE_CLIENTS + 56} commands), {mode}, the first {n_steps} "
              f"of {low.n_steps} steps in {launches} launches", flush=True)

    # the first block of the main path's own 90 %-read lanes, timed
    low = PB._lower_configs(sweep.configs, P.Workload.read_mix(0.9),
                            n_commands=EXECUTE["n_commands"],
                            seeds_arr=seeds, n_clients=n_clients,
                            probe_n=EXECUTE["probe_n"])
    inp = PB._lane_inputs(low, dev)
    block = min(PB.BLOCK_STEPS, low.n_steps)
    warp = EL.exec_lanes.by_kernel["warp"]
    runs = [_step_run(PB, EL.exec_lanes, PB._execute_batch, inp, n_clients,
                      block, False, lead=True) for _ in range(6)]
    if EL.exec_lanes.by_kernel["warp"] - warp != 6:
        raise AssertionError("the main path's lanes did not take the warp "
                             "kernel")
    blocks = [_with_plan(EL, _block_plan(EL), _step_run, PB, EL.exec_lanes,
                         PB._execute_batch, inp, n_clients, block, False,
                         lead=True) for _ in range(6)]
    plain = [_step_run(PB, ref.ref_exec_lanes, PB._execute_batch, inp,
                       n_clients, block, False) for _ in range(2)]
    errs.append(_lanes_equal(runs[-1], plain[-1],
                             "the main path's first block"))
    errs.append(_lanes_equal(blocks[-1], plain[-1], "the main path's first "
                                                    "block, block kernel"))
    lanes, k1 = inp.d_w.shape[0], inp.d_w.shape[1] + 1
    n_ops = inp.cls.shape[2]
    ms = float(np.median([r[1] for r in runs[1:]]))
    block_ms = float(np.median([r[1] for r in blocks[1:]]))
    plain_ms = min(r[1] for r in plain)
    bound_ms, bound_by = _bound_ms(kernel_costs.exec_lanes_cost(
        lanes, block, n_clients, k1, n_ops, False))
    scan_bound_ms, _ = _bound_ms(kernel_costs.exec_lanes_cost(
        lanes, low.n_steps, n_clients, k1, n_ops, False))
    print(f"kernel exec_lanes: the 90 % reads execute's first {block} steps "
          f"(L={lanes} lanes x N={n_clients} clients x {k1} station "
          f"columns, of {low.n_steps} steps): bitwise equal; warp kernel "
          f"{ms:.4f} ms ({ms / block * 1e3:.3f} us a step), the block "
          f"kernel on the same lanes {block_ms:.4f} ms "
          f"({block_ms / block * 1e3:.3f} us a step; warp / block "
          f"{ms / block_ms:.3f}), plain {plain_ms:.2f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); the whole scan's bound "
          f"{scan_bound_ms:.3f} ms; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del runs, blocks, plain, inp, low
    torch.cuda.empty_cache()
    return dict(record=dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            kernel="warp", block_kernel_ms=block_ms,
                            timed=STEP_TIMED,
                            shape=dict(lanes=lanes, clients=n_clients,
                                       columns=k1, steps=block),
                            plain_ms_per_step_cut=plain_ms_step),
                plain_ms_step=plain_ms_step)


def _time_graph_ms(fn, flush, reps: int, stream=None) -> float:
    """Device time of ``fn``: its launches captured once in a CUDA graph and
    replayed ``reps`` times, each after an L2 flush, between CUDA events.
    The host's Python is outside the window: every replay is queued behind
    a sleep on the card before the first runs, so a kernel of a few
    microseconds is timed as itself, not as the host's pace of queueing
    replays.  ``stream``: the side stream to warm up and capture on (by
    default a new one)."""
    import torch
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as CUDA graphs ask
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        fn()
    # hold the card for 20 ms so the host queues every replay before the
    # first one starts: the card then never waits on the host inside a
    # timed window
    torch.cuda._sleep(40_000_000)
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in events) / reps
    del graph
    return ms


def _time_grad_graph_ms(fwd, leaves, dout, flush, reps: int) -> float:
    """Device time of the backward of ``fwd(*leaves)`` alone, timed as
    :func:`_time_graph_ms` times a kernel: the forward runs once on a side
    stream, then ``torch.autograd.grad`` of its output is captured on that
    stream (where autograd runs the backward) and replayed after an L2
    flush, so the autograd engine's host work is outside the window."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = fwd(*leaves)
    return _time_graph_ms(lambda: torch.autograd.grad(
        out, leaves, dout, retain_graph=True), flush, reps, stream=stream)


def _tol_ratio(got, want, tol=ATTN_TOL) -> float:
    """Largest |got - want| / (atol + rtol |want|) at want's dtype in
    ``tol`` (``ATTN_TOL`` or ``SCAN_TOL``): above 1 fails the check."""
    atol, rtol = tol[str(want.dtype)]
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


def _close(name: str, got, want, what: str, tol=ATTN_TOL) -> float:
    """Max abs error of a kernel against its plain version; raises past
    the dtype's tolerance in ``tol``."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    if not bool(torch.isfinite(got).all()) or _tol_ratio(got, want,
                                                         tol) > 1.0:
        raise AssertionError(f"{name} differs from its plain version at "
                             f"{what}: max abs err {err:.3e}, (atol, rtol) "
                             f"{tol[str(want.dtype)]}")
    return err


def _randn(rng, shape, dtype, dev):
    import torch
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(device=dev, dtype=dtype)


def _strided(t):
    """The same values laid out as the model holds them: (B, S, H, d)
    transposed to (B, H, S, d)."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _attention_edge_cases(FA, FD, ref, dev):
    """Both attention kernels against their plain versions on the card:
    S of 1, 17, 128, 1000 and 2048; head dims 64 and 128; groups 1, 4, 6
    and 8; causal and not; float32 and bfloat16; contiguous and strided
    inputs; cache lengths of 1, of S_max and different per row (and 17 at
    the MoE models' head-dim-128 shapes, ``MOE_ATTN_CASES`` and
    ``MOE_DECODE_CASES``).  Every
    case runs; then the worst case of a dtype past its tolerance raises.
    Returns the number of cases and, by dtype, the largest share of the
    tolerance a case used."""
    import torch
    rng = np.random.default_rng(1)
    n, worst = 0, {}

    def close(name, got, want, what):
        ratio = (_tol_ratio(got, want) if bool(torch.isfinite(got).all())
                 else float("inf"))
        key = str(want.dtype)
        if ratio >= worst.get(key, (0.0,))[0]:
            err = float((got.float() - want.float()).abs().max())
            worst[key] = (ratio, f"{name} at {what}, max abs err {err:.3e}")

    for B, H, H_kv, S, D in [(1, 4, 4, 1, 64), (2, 8, 2, 17, 64),
                             (1, 8, 1, 128, 128), (2, 12, 2, 1000, 64),
                             (1, 32, 8, 2048, 64), (1, 16, 2, 2048, 128),
                             (1, 6, 1, 77, 128)] + MOE_ATTN_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(rng, (B, H, S, D), dt, dev)
            k, v = (_randn(rng, (B, H_kv, S, D), dt, dev) for _ in "kv")
            for causal in (True, False):
                want = ref.ref_attention(q, k, v, causal=causal)
                for args in ((q, k, v), tuple(map(_strided, (q, k, v)))):
                    got = FA.flash_attention(*args, causal=causal)
                    close("flash_attention", got, want,
                          f"{(B, H, H_kv, S, D)} {dt} causal={causal}")
                    n += 1
    for B, H, H_kv, S, D in [(1, 32, 8, 2064, 64), (8, 32, 8, 1024, 64),
                             (3, 8, 8, 17, 128), (2, 48, 8, 1000, 128),
                             (4, 6, 1, 300, 64), (2, 64, 8, 4096, 128)
                             ] + MOE_DECODE_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(rng, (B, H, D), dt, dev)
            k, v = (_randn(rng, (B, H_kv, S, D), dt, dev) for _ in "kv")
            mixed = rng.integers(1, S + 1, size=B)
            mixed[0] = S
            lengths = [np.ones(B), np.full(B, S), mixed]
            if (B, H, H_kv, S, D) in MOE_DECODE_CASES:
                lengths.append(np.full(B, 17))
            for lens in lengths:
                cl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
                want = ref.ref_decode(q, k, v, cl)
                for kv in ((k, v), (_strided(k), _strided(v))):
                    got = FD.flash_decode(q, *kv, cl)
                    close("flash_decode", got, want,
                          f"{(B, H, H_kv, S, D)} {dt} cache_len "
                          f"{lens.tolist()}")
                    n += 1
    torch.cuda.synchronize()
    for key, (ratio, what) in worst.items():
        print(f"  worst {key} case: {ratio:.3f} of the tolerance, {what}")
        if ratio > 1.0:
            raise AssertionError(f"{what}: past (atol, rtol) "
                                 f"{ATTN_TOL[key]} of its plain version")
    return n, {key: round(r, 3) for key, (r, _) in worst.items()}


def _recurrent_edge_cases(FA, FD, RS, ref, dev):
    """recurrentgemma-2b's three kernels against their plain versions at
    the shapes its path can hand them, and around them (``RG_SCAN_CASES``,
    ``RG_WINDOW_CASES``, ``RG_DECODE_CASES``), decode with cache lengths of
    1, of S_max and different per row; float32 and bfloat16, contiguous
    and strided.
    Every case runs; then the worst case of a kernel and dtype past its
    tolerance raises.  Returns the number of cases and, by kernel and
    dtype, the largest share of the tolerance a case used."""
    import torch
    rng = np.random.default_rng(3)
    n, worst = 0, {}

    def close(name, got, want, what, tol):
        ratio = (_tol_ratio(got, want, tol) if bool(torch.isfinite(got).all())
                 else float("inf"))
        key = f"{name} {want.dtype}"
        if ratio >= worst.get(key, (0.0,))[0]:
            err = float((got.float() - want.float()).abs().max())
            worst[key] = (ratio, f"{name} at {what}, max abs err {err:.3e}",
                          tol[str(want.dtype)])

    def batch_strided(t):
        return t.transpose(0, 1).contiguous().transpose(0, 1)

    for B, S, D in RG_SCAN_CASES:
        x32 = _randn(rng, (B, S, D), torch.float32, dev)
        a32 = torch.from_numpy(rng.uniform(0.3, 0.9999, (B, S, D)).astype(
            np.float32)).to(dev)
        # a float32 starting state, as a view with a batch stride of 2 D
        h0 = _randn(rng, (B, 2 * D), torch.float32, dev)[:, D:]
        for dt in (torch.float32, torch.bfloat16):
            x, a = x32.to(dt), a32.to(dt)
            for start in (None, h0):
                want = ref.ref_rglru(x, a, start)
                for args in ((x, a), (batch_strided(x), batch_strided(a))):
                    close("rglru_scan", RS.rglru_scan(*args, start), want,
                          f"{(B, S, D)} {dt} h0="
                          f"{'none' if start is None else 'given'}",
                          SCAN_TOL)
                    n += 1
    for B, H, H_kv, S, D, window in RG_WINDOW_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(rng, (B, H, S, D), dt, dev)
            k, v = (_randn(rng, (B, H_kv, S, D), dt, dev) for _ in "kv")
            for causal in (True, False):
                want = ref.ref_attention(q, k, v, causal=causal,
                                         window=window)
                for args in ((q, k, v), tuple(map(_strided, (q, k, v)))):
                    got = FA.flash_attention(*args, causal=causal,
                                             window=window)
                    close("flash_attention", got, want,
                          f"{(B, H, H_kv, S, D)} {dt} causal={causal} "
                          f"window={window}", ATTN_TOL)
                    n += 1
    for B, H, H_kv, S, D in RG_DECODE_CASES:
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(rng, (B, H, D), dt, dev)
            k, v = (_randn(rng, (B, H_kv, S, D), dt, dev) for _ in "kv")
            mixed = rng.integers(1, S + 1, size=B)
            mixed[0] = S
            for lens in (np.ones(B), np.full(B, S), mixed):
                cl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
                want = ref.ref_decode(q, k, v, cl)
                for kv in ((k, v), (_strided(k), _strided(v))):
                    close("flash_decode", FD.flash_decode(q, *kv, cl), want,
                          f"{(B, H, H_kv, S, D)} {dt} cache_len "
                          f"{lens.tolist()}", ATTN_TOL)
                    n += 1
    torch.cuda.synchronize()
    for key, (ratio, what, tol) in sorted(worst.items()):
        print(f"  worst {key} case: {ratio:.3f} of the tolerance {tol}, "
              f"{what}")
    for key, (ratio, what, tol) in worst.items():
        if ratio > 1.0:
            raise AssertionError(f"{what}: past (atol, rtol) {tol} of its "
                                 f"plain version")
    return n, {key: round(r, 3) for key, (r, _, _) in worst.items()}


def _attention_bound_ms(q, k, causal: bool, window=None):
    """Least time for the attention forward on this card at q (B, H, S_q,
    d) and k / v (B, H_kv, S_k, d): 4 d flops per computed (query, key)
    pair at the dtype's peak rate (bf16 tensor cores, or float32 outside
    them), against every input read and output written once at the memory
    rate (``kernel_costs.flash_attention_cost``)."""
    B, H, S, D = q.shape
    return _bound_ms(kernel_costs.flash_attention_cost(
        B, H, k.shape[1], S, k.shape[2], D, q.element_size(), causal,
        window))


def _scan_bound_ms(x, h0=None):
    """Least time for the RG-LRU scan on this card: x and a read and h
    written once, in x's dtype, and h0 read once, against two float32
    flops per element."""
    return _bound_ms(kernel_costs.rglru_scan_cost(
        x.numel(), x.element_size(),
        h0.numel() * h0.element_size() if h0 is not None else 0))


def _count_ops(fn) -> int:
    """PyTorch operators ``fn`` dispatches (the eager model's launches, give
    or take views), counted by a dispatch mode around one call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _serve_times(cfg, params, prompts, new: int, cb) -> str:
    """The path's own times, off the counted run: prefill ms by prompt
    length (the median of 3 after a warm-up), decode-step ms at batch 1
    after the last prompt and at the batcher's slots from its caches, and
    the operators one batch-1 step dispatches.  Returns the report."""
    import torch
    from repro_torch.models import decode_step, prefill
    dev = params.device
    pre_ms = {}
    for p in prompts:
        toks = torch.tensor([p], dtype=torch.int32, device=dev)
        prefill(cfg, params, toks, cache_len=len(p) + new)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill(cfg, params, toks, cache_len=len(p) + new)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        pre_ms[len(p)] = sorted(times)[1]
    toks = torch.tensor([prompts[-1]], dtype=torch.int32, device=dev)
    _, caches = prefill(cfg, params, toks, cache_len=toks.shape[1] + 32)
    tok = toks[:, -1:]
    step_ms = {}
    for c, t_in in ((caches, tok), (cb.caches, cb.tokens)):
        c = [dict(e) for e in c]
        decode_step(cfg, params, c, t_in)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(16):
            _, c = decode_step(cfg, params, c, t_in)
        torch.cuda.synchronize()
        step_ms[t_in.shape[0]] = (time.perf_counter() - t) * 1e3 / 16
    n_ops = _count_ops(lambda: decode_step(
        cfg, params, [dict(e) for e in caches], tok))
    nb = cb.n_slots
    MEASURED[(cfg.name, "prefill_ms")] = dict(pre_ms)
    return (f"serve times (host clock, synchronized): prefill ms by prompt "
            f"length {{{', '.join(f'{n}: {m:.2f}' for n, m in pre_ms.items())}"
            f"}}; decode step {step_ms[1]:.2f} ms at batch 1 (after the "
            f"{len(prompts[-1])}-token prompt), {step_ms[nb]:.2f} ms at batch "
            f"{nb} (the batcher's caches) = {nb * 1e3 / step_ms[nb]:.1f} "
            f"tokens/s; one batch-1 decode step dispatches {n_ops} PyTorch "
            f"operators = {step_ms[1] * 1e3 / n_ops:.1f} us of host time each")


def _decode_record(FD, ref, q, kc, vc, cl, flush) -> dict:
    """``flash_decode`` on full-width tensors the path handed it: against
    its plain version (and what a planted fault reads: each row's last,
    partial KV tile skipped), with its times, the library call's and its
    bound.  Returns the kernel's record."""
    import torch
    import torch.nn.functional as F
    want = ref.ref_decode(q, kc, vc, cl)
    got = FD.flash_decode(q, kc, vc, cl)
    err = _close("flash_decode", got, want,
                 f"full width {tuple(q.shape)} x {tuple(kc.shape)}")
    n_valid = int(cl.sum())
    B, H, D = q.shape
    bound, by = _bound_ms(kernel_costs.flash_decode_cost(
        B, H, kc.shape[1], D, n_valid, q.element_size()))
    mask = (torch.arange(kc.shape[2], device=q.device)[None, None, None, :]
            < cl[:, None, None, None])
    short = torch.clamp((cl - 1) // FD.TILE * FD.TILE, min=1)
    used, fault = (_tol_ratio(got, want),
                   _tol_ratio(ref.ref_decode(q, kc, vc, short), want))
    ms = _time_graph_ms(lambda: FD.flash_decode(q, kc, vc, cl), flush, 50)
    # the replays left the arrival counters at zero: an eager call after
    # them gives the same bits
    if not torch.equal(FD.flash_decode(q, kc, vc, cl), got):
        raise AssertionError("flash_decode after its graph replays differs "
                             "from its first call")
    rec = dict(
        max_abs_err=err, ms=ms,
        plain_ms=_time_graph_ms(lambda: ref.ref_decode(q, kc, vc, cl), flush,
                                20),
        library_ms=_time_graph_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
            flush, 50),
        bound_ms=bound, bound_by=by)
    print(f"kernel flash_decode at batch {q.shape[0]}: q {tuple(q.shape)}, "
          f"caches {tuple(kc.shape)} {q.dtype}, cache_len {cl.tolist()}: "
          f"max abs err {err:.3e} = {used:.3f} of the tolerance (the last "
          f"{FD.TILE}-key tile skipped reads {fault:.3f}); bitwise the same "
          f"after 50 graph replays; device times (graph replay, cold L2) " +
          ", ".join(f"{k_} {v_:.4f}" for k_, v_ in rec.items()
                    if k_.endswith("ms")) + f" ({by}); "
          f"{rec['ms'] / rec['library_ms']:.2f}x SDPA's time", flush=True)
    return rec


def _prefill_record(FA, ref, q, k, v, causal, window, flush) -> dict:
    """``flash_attention`` on the full-width tensors a prefill handed it:
    against its plain version (and, without a window, what a planted
    fault reads: the last KV tile skipped), with its times, the library
    call's (SDPA, with a boolean band mask for a window) and its bound.
    Returns the kernel's record."""
    import torch
    import torch.nn.functional as F
    S, D = q.shape[2:]
    want = ref.ref_attention(q, k, v, causal=causal, window=window)
    got = FA.flash_attention(q, k, v, causal=causal, window=window)
    err = _close("flash_attention", got, want,
                 f"full width {tuple(q.shape)} window {window}")
    if window is None:
        sdpa = dict(is_causal=causal)
        # the planted fault: the last key tile skipped, which under causal
        # masking changes only the rows of the last tile's queries
        tile = FA.key_tile(D)
        last, early = slice(S - tile, S), slice(0, S - tile)
        faulty = ref.ref_attention(q[:, :, last], k[:, :, early],
                                   v[:, :, early], causal=False)
        fault = (f" (the last {tile}-key tile skipped reads "
                 f"{_tol_ratio(faulty, want[:, :, last]):.3f})")
    else:
        pos = torch.arange(S, device=q.device)
        gap = pos[:, None] - pos[None, :]
        sdpa = dict(attn_mask=(gap >= 0) & (gap < window))
        fault = ""
    bound, by = _attention_bound_ms(q, k, causal, window)
    rec = dict(
        max_abs_err=err,
        ms=_time_graph_ms(lambda: FA.flash_attention(
            q, k, v, causal=causal, window=window), flush, 20),
        plain_ms=_time_graph_ms(lambda: ref.ref_attention(
            q, k, v, causal=causal, window=window), flush, 3),
        library_ms=_time_graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **sdpa), flush, 20),
        bound_ms=bound, bound_by=by)
    print(f"kernel flash_attention at the prefill's {tuple(q.shape)} q, "
          f"{tuple(k.shape)} k/v {q.dtype} causal={causal} window {window}: "
          f"max abs err {err:.3e} = {_tol_ratio(got, want):.3f} of the "
          f"tolerance{fault}; device times (graph replay, cold L2) " +
          ", ".join(f"{key} {val:.4f}" for key, val in rec.items()
                    if key.endswith("ms")) + f" ({by}); "
          f"{rec['ms'] / rec['library_ms']:.2f}x SDPA's time", flush=True)
    return rec


def _scan_record(RS, ref, x, a, h0, flush) -> dict:
    """``rglru_scan`` on full-width tensors the path handed it: against its
    plain version, with its times and bound (no PyTorch call computes the
    recurrence).  Returns the kernel's record."""
    import torch
    want = ref.ref_rglru(x, a, h0)
    got = RS.rglru_scan(x, a, h0)
    err = _close("rglru_scan", got, want, f"full width {tuple(x.shape)}",
                 SCAN_TOL)
    bound, by = _scan_bound_ms(x, h0)
    rec = dict(
        max_abs_err=err,
        ms=_time_graph_ms(lambda: RS.rglru_scan(x, a, h0), flush, 20),
        plain_ms=_time_graph_ms(lambda: ref.ref_rglru(x, a, h0), flush, 3),
        library_ms=None, bound_ms=bound, bound_by=by)
    # the replays left the ticket, counter and flags at zero
    if not torch.equal(RS.rglru_scan(x, a, h0), got):
        raise AssertionError("rglru_scan after its graph replays differs "
                             "from its first call")
    print(f"kernel rglru_scan at {tuple(x.shape)} {x.dtype}, h0 "
          f"{'none' if h0 is None else tuple(h0.shape)}, plan (chunks, "
          f"steps) {RS.chunk_plan(x.shape[0], x.shape[1], x.shape[2], _n_sms())}"
          f": max abs err {err:.3e} = {_tol_ratio(got, want, SCAN_TOL):.3f} "
          f"of the tolerance; bitwise the same after the graph replays; "
          f"device times (graph replay, cold L2) " +
          ", ".join(f"{k_} {v_:.4f}" for k_, v_ in rec.items()
                    if k_.endswith("ms") and v_ is not None) +
          f" ({by}); no PyTorch call computes the recurrence", flush=True)
    return rec


def _wkv_ratio(got, want) -> float:
    """Largest |got - want| / (atol max(1, max|want|) + rtol |want|) at
    want's dtype in ``WKV_TOL``: above 1 fails the check."""
    atol, rtol = WKV_TOL[str(want.dtype)]
    g, w = got.float(), want.float()
    scale = max(1.0, float(w.abs().max()))
    return float(((g - w).abs() / (atol * scale + rtol * w.abs())).max())


def _wkv_inputs(gen, B, S, dtype, dev, logw=None, scale=1.0):
    """rwkv6-7b's WKV inputs at its 64 heads of 64: r, k, v (B, S, H, d)
    in ``dtype`` (k and v times ``scale``) and logw float32 as strided
    views of (B, H, S, d) storage, u (H, d), and a given state s0
    (B, H, d, d) as a view with a batch stride of 2 H d^2, drawn on the
    card from ``gen``; logw from the model's range (-exp(N(0, 1) - 1)
    clamped at -5), or the constant given."""
    import torch
    H = D = 64

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    r, k, v = ((draw(B, H, S, D) * (1.0 if x == "r" else scale)).to(dtype)
               .transpose(1, 2) for x in "rkv")
    if logw is None:
        lw = torch.clamp(-torch.exp(draw(B, H, S, D) - 1.0), min=-5.0)
    else:
        lw = torch.full((B, H, S, D), logw, device=dev)
    u = draw(H, D) * 0.1
    s0 = draw(B, 2 * H, D, D)[:, H:]
    return r, k, v, lw.transpose(1, 2), u, s0


def _wkv_edge_cases(WK, ref, dev):
    """``wkv6`` against its plain version at ``WKV_CASES`` x (logw from
    the model's range, -5, 0 and -20 everywhere) and at ``WKV_LARGE``, x
    (zero and a given s0) x (float32, bfloat16) x (strided views,
    contiguous tensors), y and s_last.  Every case runs; then the worst case of a dtype past its
    tolerance raises.  Returns the number of cases and, by dtype, the
    largest share of the tolerance a case used."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(5)
    n, worst = 0, {}

    def close(got, want, what):
        ratio = (_wkv_ratio(got, want) if bool(torch.isfinite(got).all())
                 else float("inf"))
        key = str(want.dtype)
        if ratio >= worst.get(key, (0.0,))[0]:
            err = float((got.float() - want.float()).abs().max())
            worst[key] = (ratio, f"{what}, max abs err {err:.3e}")

    cases = ([(B, S, logw, 1.0) for B, S in WKV_CASES for logw in WKV_LOGW]
             + WKV_LARGE)
    for B, S, logw, scale in cases:
        for dt in (torch.float32, torch.bfloat16):
            r, k, v, lw, u, s0 = _wkv_inputs(gen, B, S, dt, dev, logw, scale)
            for start in (None, s0):
                want_y, want_s = ref.ref_wkv6(r, k, v, lw, u, start)
                for args in ((r, k, v, lw),
                             tuple(t.contiguous() for t in (r, k, v, lw))):
                    y, s_last = WK.wkv6(*args, u, start)
                    what = (f"wkv6 at {(B, S)} {dt} logw="
                            f"{'model' if logw is None else logw} k, v x"
                            f"{scale:g} s0="
                            f"{'none' if start is None else 'given'} "
                            f"{'strided' if args[0] is r else 'dense'}")
                    close(y, want_y, what)
                    close(s_last, want_s, what + " (s_last)")
                    n += 1
    torch.cuda.synchronize()
    for key, (ratio, what) in sorted(worst.items()):
        print(f"  worst {key} case: {ratio:.3f} of the tolerance "
              f"{WKV_TOL[key]}, {what}")
    for key, (ratio, what) in worst.items():
        if ratio > 1.0:
            raise AssertionError(f"{what}: past (atol, rtol) {WKV_TOL[key]} "
                                 f"of its plain version")
    return n, {key: round(r, 3) for key, (r, _) in worst.items()}


def _wkv_bound_ms(r, s0, chunk: int = 32):
    """Least time for the WKV recurrence on this card: r, k, v and logw
    read, u and s0 read, y and s_last written once, against the
    operations.  A prefill's are the chunked form's on the tensor cores:
    per token and head 4 C d + 4 d^2 flops (the scores and A v over the
    chunk of C steps, q_in S' and the state update), tripled by the split
    TF32 products, at the TF32 rate; a decode step's the serial step's
    5 d^2 + 5 d float32 flops at the float32 rate."""
    B, S, H, D = r.shape
    return _bound_ms(kernel_costs.wkv6_cost(B, S, H, D, r.element_size(),
                                            s0 is not None, chunk))


def _wkv_serial_ops_ms(r) -> float:
    """The serial form's 5 d^2 + 5 d float32 flops per token and head at
    the float32 rate: the bound the WKV row carried before the chunked
    form, kept beside the new one."""
    B, S, H, D = r.shape
    ops, _, rate = kernel_costs.wkv6_cost(B, S, H, D, r.element_size(), False)
    return ops / PEAK_BY_RATE[rate] * 1e3


def _wkv_record(WK, ref, r, k, v, logw, u, s0, flush) -> dict:
    """``wkv6`` on full-width tensors the path handed it: against its plain
    version, with its times and bound (no PyTorch call computes the
    recurrence).  Returns the kernel's record."""
    import torch
    want_y, want_s = ref.ref_wkv6(r, k, v, logw, u, s0)
    y, s_last = WK.wkv6(r, k, v, logw, u, s0)
    used = max(_wkv_ratio(y, want_y), _wkv_ratio(s_last, want_s))
    err = float((y.float() - want_y.float()).abs().max())
    if used > 1.0 or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"wkv6 differs from its plain version at full "
                             f"width {tuple(r.shape)}: max abs err "
                             f"{err:.3e}, {used:.3f} of (atol, rtol) "
                             f"{WKV_TOL[str(y.dtype)]}")
    bound, by = _wkv_bound_ms(r, s0, WK.CHUNK[r.shape[-1]])
    rec = dict(
        max_abs_err=err,
        ms=_time_graph_ms(lambda: WK.wkv6(r, k, v, logw, u, s0), flush, 20),
        plain_ms=_time_graph_ms(lambda: ref.ref_wkv6(r, k, v, logw, u, s0),
                                flush, 3),
        library_ms=None, bound_ms=bound, bound_by=by)
    again = WK.wkv6(r, k, v, logw, u, s0)
    if not (torch.equal(again[0], y) and torch.equal(again[1], s_last)):
        raise AssertionError("wkv6 after its graph replays differs from its "
                             "first call")
    print(f"kernel wkv6 at {tuple(r.shape)} {r.dtype}, s0 "
          f"{'none' if s0 is None else tuple(s0.shape)}, plan (chunk, "
          f"columns) {WK.plan(r.shape[1], r.shape[3])}: max abs "
          f"err {err:.3e} = {used:.3f} of the tolerance; bitwise the same "
          f"after the graph replays; device times (graph replay, cold L2) " +
          ", ".join(f"{k_} {v_:.4f}" for k_, v_ in rec.items()
                    if k_.endswith("ms") and v_ is not None) +
          f" ({by}; the serial form's float32 flops would bound it at "
          f"{_wkv_serial_ops_ms(r):.4f}); no PyTorch call computes the "
          f"recurrence", flush=True)
    return rec


def _n_sms() -> int:
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def _greedy(cfg, params, prompt, max_new: int, device):
    """The serving state machine's decode, written out: prefill, then feed
    the last prompt token and each argmax back.  Returns the tokens."""
    import torch
    from repro_torch.models import decode_step, prefill
    tokens = torch.tensor([list(prompt)], dtype=torch.int32, device=device)
    _, caches = prefill(cfg, params, tokens,
                        cache_len=tokens.shape[1] + max_new)
    tok, out = tokens[:, -1:], []
    for _ in range(max_new):
        logits, caches = decode_step(cfg, params, caches, tok)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        out.append(tok[0, 0])
    return torch.stack(out).tolist()


def _host_positions(top_i: np.ndarray, g: int) -> np.ndarray:
    """Each (token, choice) pair's place in its expert's queue, by a loop on
    the host: per group of ``g`` tokens, all first choices in token order,
    then all second choices, and so on (the reference's slot-major
    rank)."""
    T, k = top_i.shape
    pos = np.zeros((T, k), np.int64)
    for start in range(0, T, g):
        seen = collections.Counter()
        for j in range(k):
            for t in range(start, start + g):
                pos[t, j] = seen[top_i[t, j]]
                seen[top_i[t, j]] += 1
    return pos


def _moe_layer_check(cfg, layer, x, what: str, flush) -> str:
    """One MoE layer of the path on the full-width input it was handed:
    the kept mask and queue positions from the card's own top-k indices
    equal a loop's on the host (exactly), and the capacity dispatch's
    output equals the drop-free dense layer's on every token with no
    dropped choice, within ``ATTN_TOL``.  Raises otherwise; returns the
    report: the drop fraction, the layer's device time and its bound."""
    import torch
    from repro_torch.models import moe
    m, kind = cfg.moe, cfg.mlp_kind
    xt = x.reshape(-1, x.shape[-1])
    T, D = xt.shape
    g = moe.group_size(m, T)
    C = moe._capacity(m, g)
    _, _, top_i = moe.router_probs(layer, xt, m)
    pos = moe.dispatch_positions(top_i, T // g, m.n_experts)
    want = _host_positions(top_i.cpu().numpy(), g)
    if not np.array_equal(pos.cpu().numpy(), want):
        raise AssertionError(f"MoE queue positions at {what} differ from "
                             f"the host's loop")
    keep = pos < C
    if not np.array_equal(keep.cpu().numpy(), want < C):
        raise AssertionError(f"MoE kept mask at {what} differs")
    got, _ = moe.apply_moe_gshard(layer, x, m, kind, need_aux=False)
    dense, _ = moe.apply_moe_dense(layer, x, m, kind, need_aux=False)
    whole = keep.all(-1)
    n_whole = int(whole.sum())
    g_rows, d_rows = got.reshape(T, D)[whole], dense.reshape(T, D)[whole]
    used = _tol_ratio(g_rows, d_rows) if n_whole else 0.0
    if n_whole == 0 or used > 1.0 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"MoE capacity dispatch at {what}: {n_whole} "
                             f"tokens with no drop, {used:.3f} of ATTN_TOL "
                             f"against the dense layer")
    ms = _time_graph_ms(lambda: moe.apply_moe_gshard(
        layer, x, m, kind, need_aux=False), flush, 20)
    n_mats = 3 if kind in ("swiglu", "geglu") else 2
    w_bytes = sum(t.numel() * t.element_size() for t in layer.parameters())
    t_bytes = (w_bytes + 2 * x.numel() * x.element_size()) \
        / PEAK_BYTES_PER_S * 1e3
    shared = m.d_expert * m.n_shared
    flops = 2 * n_mats * D * (m.d_expert * m.n_experts * (T // g) * C
                              + shared * T)
    t_ops = flops / PEAK_BF16_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return (f"MoE layer at {what}: T {T} in {T // g} group(s) of {g}, "
            f"capacity {C}; positions and kept mask == the host's loop; "
            f"dropped {1.0 - float(keep.float().mean()):.4f} of "
            f"{T * m.top_k} choices; the {n_whole} tokens with no drop == "
            f"the dense layer within {used:.3f} of ATTN_TOL; device time "
            f"(graph replay, cold L2) {ms:.4f} ms against a bound of "
            f"{max(t_bytes, t_ops):.4f} ms ({by}: "
            f"{w_bytes / 1e9:.3f} GB of weights, of which the experts' "
            f"{m.n_experts * n_mats * D * m.d_expert * 2 / 1e9:.3f}, read "
            f"in {t_bytes:.4f} ms; {flops / 1e9:.1f} GFLOP on the capacity "
            f"layout in {t_ops:.4f} ms)")


def _decode_step_device(cfg, params, caches, tok, flush) -> str:
    """A decode step's device time: one step captured as a CUDA graph and
    replayed (after an L2 flush), beside the least time for the bytes it
    must read - every weight but the embedding table, the K/V rows up to
    each cache's length - at the card's memory rate."""
    import torch
    from repro_torch.models import decode_step
    c = [dict(e) for e in caches]
    ms = _time_graph_ms(lambda: decode_step(cfg, params, c, tok), flush, 5)
    w_bytes = sum(t.numel() * t.element_size() for t in params.parameters())
    if "unembed" in params.embed:
        table = params.embed["tokens"]
        w_bytes -= table.numel() * table.element_size()
    kv_bytes = 0
    for e in caches:
        B, S_max, H_kv, D = e["k"].shape
        rows = min(int(e["pos"]) + 1, S_max)
        kv_bytes += 2 * B * rows * H_kv * D * e["k"].element_size()
    bound = (w_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3
    MEASURED[(cfg.name, "decode_graph_ms", tok.shape[0])] = ms
    return (f"decode step at batch {tok.shape[0]}: {ms:.3f} ms on the card "
            f"(one step as a CUDA graph, cold L2) against {bound:.3f} ms for "
            f"its {(w_bytes + kv_bytes) / 1e9:.2f} GB ({w_bytes / 1e9:.2f} of "
            f"weights, {kv_bytes / 1e6:.1f} MB of K/V) at "
            f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s = {bound / ms:.3f} of it")


def _serve_phase(arch, prompts, new, push_at, batch, kernels, ref, dev):
    """Phases 7-9b: ``arch`` at full width behind the compartmentalized
    fleet (weights v1, then one request per prompt length with v2 pushed
    before request ``push_at``; ``None``: v1 only), then the continuous
    batcher.  Every kernel's launches are counted over exactly this run
    and must be one per layer that calls it per prefill and per decode
    step (from ``cfg.layer_types()``).  ``kernels`` maps each op's name to
    its kernel module.  A MoE model runs its capacity dispatch
    (``moe_impl="gshard"``, the config's own), and one of its MoE layers is
    checked on the inputs the path handed it (``_moe_layer_check``).
    Returns the records of the kernels the path ran."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, moe, prefill
    from repro_torch.serving.scheduler import ContinuousBatcher, Request
    from repro_torch.serving.server import ServingDeployment

    cfg = get_config(arch)
    kinds = cfg.layer_types()
    n_rec = kinds.count("rglru")
    n_wkv = kinds.count("rwkv6")
    n_att = sum(k in ("attn", "local_attn") for k in kinds)

    def expect(n_prefills, n_steps):
        return {"rglru_scan": n_rec * (n_prefills + n_steps),
                "wkv6": n_wkv * (n_prefills + n_steps),
                "flash_attention": n_att * n_prefills,
                "flash_decode": n_att * n_steps}

    gen = torch.Generator(device=dev)
    t0 = time.perf_counter()
    v1 = init_params(cfg, gen.manual_seed(0), device=dev)
    v2 = (None if push_at is None
          else init_params(cfg, gen.manual_seed(1), device=dev))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in v1.parameters())
    n_bytes = sum(t.numel() * t.element_size() for t in v1.parameters())
    layers = ", ".join(f"{kinds.count(k)} {k}" for k in dict.fromkeys(kinds))
    channels = collections.Counter(cfg.channel_kind(i)
                                   for i in range(cfg.n_layers))
    experts = (f"; {channels['moe']} MoE layers of {cfg.moe.n_experts} "
               f"experts x {cfg.moe.d_expert}, top-{cfg.moe.top_k}, "
               f"{cfg.moe.n_shared} shared, {cfg.moe_impl}; "
               f"{channels['mlp']} dense of {cfg.d_ff_dense or cfg.d_ff}"
               if cfg.moe else "")
    print(f"serve: {cfg.name} full width ({cfg.n_layers} layers: {layers}; "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, window {cfg.attn_window}, rnn width "
          f"{cfg.rnn_width if n_rec else None}, {cfg.mlp_kind} {cfg.d_ff}"
          f"{experts}, vocab {cfg.vocab_size}, {cfg.dtype()}), {n_params:,} "
          f"parameters ({cfg.n_params():,} by the config's count, which "
          f"leaves out the norms; {n_bytes / 1e9:.2f} GB) x "
          f"{1 if v2 is None else 2} version(s) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    texts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in prompts]
    batch_prompts = [rng.integers(0, cfg.vocab_size, batch["prompt"]
                                  ).tolist()
                     for _ in range(batch["n_requests"])]
    dep = ServingDeployment(cfg, n_replicas=3, n_proxy_leaders=3,
                            grid=(2, 2), n_clients=2,
                            consistency="linearizable", device=dev)

    # catch the full-width tensors the path hands each kernel: the first
    # prefill call at the longest prompt, and the last decode call at
    # batch 1 (the longest cache: full, or a wrapped ring buffer) and at
    # the batcher's slots
    caught = {}
    real = {name: getattr(ops, name) for name in kernels}

    # calls (one launch each) by shape: prefill length or decode batch
    by_shape = {name: collections.Counter() for name in kernels}

    def label(seq, batch_):
        return f"decode b{batch_}" if seq == 1 else f"prefill {seq}"

    def catch_rs(x, a, h0=None):
        by_shape["rglru_scan"][label(x.shape[1], x.shape[0])] += 1
        if x.shape[1] == 1:
            caught[f"rglru_scan{x.shape[0]}"] = (x, a, h0)
        elif x.shape[1] == max(prompts):
            caught.setdefault("rglru_scan", (x, a, h0))
        elif x.shape[1] == 512:
            caught.setdefault("rglru_scan_p512", (x, a, h0))
        return real["rglru_scan"](x, a, h0)

    def catch_wkv(r, k, v, logw, u, s0=None):
        by_shape["wkv6"][label(r.shape[1], r.shape[0])] += 1
        if r.shape[1] == 1:
            caught[f"wkv6{r.shape[0]}"] = (r, k, v, logw, u, s0)
        elif r.shape[1] == max(prompts):
            caught.setdefault("wkv6", (r, k, v, logw, u, s0))
        elif r.shape[1] == 512:
            caught.setdefault("wkv6_p512", (r, k, v, logw, u, s0))
        return real["wkv6"](r, k, v, logw, u, s0)

    def catch_fa(q, k, v, *, causal=True, window=None):
        by_shape["flash_attention"][label(q.shape[2], q.shape[0])] += 1
        if q.shape[2] == max(prompts):
            caught.setdefault("flash_attention", (q, k, v, causal, window))
        return real["flash_attention"](q, k, v, causal=causal, window=window)

    def catch_fd(q, k_cache, v_cache, cache_len):
        by_shape["flash_decode"][label(1, q.shape[0])] += 1
        caught[f"flash_decode{q.shape[0]}"] = (q, k_cache, v_cache,
                                               cache_len)
        return real["flash_decode"](q, k_cache, v_cache, cache_len)

    # the first MoE layer's input and module at the longest prefill and at
    # the batcher's decode batch
    real_moe = moe.apply_moe

    def catch_moe(params, x, *args, **kwargs):
        if x.shape[:2] in ((1, max(prompts)), (batch["n_slots"], 1)):
            caught.setdefault(f"moe{tuple(x.shape[:2])}", (params, x))
        return real_moe(params, x, *args, **kwargs)

    def launches():
        return {name: getattr(mod, name).launches
                for name, mod in kernels.items()}

    torch.cuda.reset_peak_memory_stats()
    for name, mod in kernels.items():
        getattr(mod, name).launches = 0
    catchers = dict(rglru_scan=catch_rs, wkv6=catch_wkv,
                    flash_attention=catch_fa, flash_decode=catch_fd)
    for name in kernels:
        setattr(ops, name, catchers[name])
    moe.apply_moe = catch_moe
    try:
        dep.push_weights(v1)
        served, req_s = [], []
        for i, p in enumerate(texts):
            if i == push_at:
                dep.push_weights(v2)
            slot = dep.rsm.leader.next_slot
            torch.cuda.synchronize()
            t = time.perf_counter()
            served.append(dep.infer(p, max_new=new, client=i % 2))
            torch.cuda.synchronize()
            req_s.append(time.perf_counter() - t)
            if dep.rsm.leader.next_slot != slot:
                raise AssertionError("an inference moved the leader's log: "
                                     "reads must be leaderless")
        on_fleet = launches()
        cb = ContinuousBatcher(cfg, v1, n_slots=batch["n_slots"],
                               max_len=batch["max_len"], device=dev)
        reqs = [Request(rid=i, prompt=p, max_new=batch["max_new"])
                for i, p in enumerate(batch_prompts)]
        for r in reqs:
            cb.submit(r)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cb.run_until_drained()
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
        moe.apply_moe = real_moe
    total = launches()
    peak_mem = torch.cuda.max_memory_allocated()

    versions = [v for v, _ in served]
    if push_at is None:
        push_at = len(texts)
    if versions != ["v1"] * push_at + ["v2"] * (len(texts) - push_at):
        raise AssertionError(f"served versions {versions}")
    for _, toks in served:
        if len(toks) != new or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            raise AssertionError(f"bad served tokens {toks}")
    loads = dep.replica_loads()
    if sum(loads) != len(texts) or max(loads) >= sum(loads):
        raise AssertionError(f"read loads {loads} not spread over replicas")
    if not all(r.done and len(r.out) == batch["max_new"] for r in reqs):
        raise AssertionError("the continuous batcher did not drain")
    on_batcher = {k: total[k] - on_fleet[k] for k in total}
    want_fleet = expect(len(texts), len(texts) * new)
    want_batcher = expect(len(reqs), cb.steps_executed)
    per_layer = " and ".join(
        f"{ {k: n for k, n in expect(*one).items() if n} } per {what}"
        for one, what in (((1, 0), "prefill"), ((0, 1), "decode step")))
    if on_fleet != want_fleet or on_batcher != want_batcher:
        raise AssertionError(
            f"launches: fleet {on_fleet}, batcher {on_batcher}; "
            f"{per_layer} give {want_fleet} and {want_batcher}")
    ran = [name for name in kernels if total[name] > 0]
    direct = _greedy(cfg, v1, texts[0], new, dev)
    if list(served[0][1]) != direct:
        raise AssertionError(f"request 0 served {served[0][1]}, a direct "
                             f"decode gives {direct}")
    n_tok = batch["n_requests"] * batch["max_new"]
    print(f"serve: {len(texts)} requests, versions {versions}, read loads "
          f"{loads}, the leader's log unmoved by reads, request 0 == direct "
          f"decode; request wall s {[round(x, 3) for x in req_s]} (prompt "
          f"{list(prompts)} + {new} tokens each); batcher "
          f"{batch['n_requests']} x {batch['prompt']}-token prompts x "
          f"{batch['max_new']} new in {batch['n_slots']} slots of max_len "
          f"{batch['max_len']}: {cb.steps_executed} steps, occupancy "
          f"{cb.mean_occupancy:.2f}, {batch_s:.2f} s = "
          f"{n_tok / batch_s:.1f} tokens/s with prefills; launches on the "
          f"fleet {on_fleet}, in all {total} = exactly {per_layer}; peak "
          f"device memory {peak_mem / 2**30:.2f} GiB", flush=True)

    # the path's own times, off the counted run; the prompts' lengths
    # rise, so the last is the longest
    print(_serve_times(cfg, v1, list({len(p): p for p in texts}.values()),
                       new, cb), flush=True)

    # each kernel on the full-width tensors the path handed it; of the
    # decode calls the batch-1 one, the fleet's, is recorded, and of the
    # recurrences the prefill's, the longest
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    records = {}
    nb = batch["n_slots"]
    if cfg.moe is not None:
        for shape, what in (((1, max(prompts)), f"prefill {max(prompts)}"),
                            ((nb, 1), f"decode b{nb}")):
            print(_moe_layer_check(cfg, *caught.pop(f"moe{shape}"), what,
                                   flush), flush=True)
        toks = torch.tensor([texts[-1]], dtype=torch.int32, device=dev)
        _, caches = prefill(cfg, v1, toks, cache_len=toks.shape[1] + new)
        for c, t_in in ((caches, toks[:, -1:]), (cb.caches, cb.tokens)):
            print(_decode_step_device(cfg, v1, c, t_in, flush), flush=True)
        del caches
    for name, record in (("rglru_scan", _scan_record),
                         ("wkv6", _wkv_record)):
        if name in ran:
            # decode at the batcher's slots and at batch 1, the batcher's
            # 512-token prefill, then the longest prefill (the row's own)
            shapes = {}
            for key, what in ((f"{name}{nb}", f"decode b{nb}"),
                              (f"{name}1", "decode b1"),
                              (f"{name}_p512", "prefill 512"),
                              (name, f"prefill {max(prompts)}")):
                rec = record(kernels[name], ref, *caught[key], flush)
                shapes[what] = {k_: rec[k_] for k_ in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
            records[name] = dict(rec, shapes=shapes)
    if "flash_attention" in ran:
        records["flash_attention"] = _prefill_record(
            kernels["flash_attention"], ref, *caught["flash_attention"],
            flush)
        for key in (f"flash_decode{batch['n_slots']}", "flash_decode1"):
            records["flash_decode"] = _decode_record(
                kernels["flash_decode"], ref, *caught[key], flush)
    for name in records:
        records[name]["launches"] = total[name]
        records[name]["launches_by_shape"] = dict(by_shape[name])
    print(f"serve: {cfg.name} launches by shape (prefill length, decode "
          f"batch): " + "; ".join(f"{name} {dict(by_shape[name])}"
                                  for name in ran), flush=True)
    return records


def _model_cuda_vs_cpu(dev, arch: str) -> None:
    """Phase 10: an arch's smoke config in float32 on the same weights, on
    the card and on the host: logits agree, greedy and served tokens
    equal.  recurrentgemma-2b's smoke window of 8 is shorter than the
    40-token prompt, so the window mask, the ring-buffer roll and its
    wrap in decode all run; rwkv6-7b's 40 tokens pass the kernel's 32-step
    chunk, at head dim 16.  The MoE configs run their capacity dispatch
    (the smoke configs' own is the dense one): the logits' 80 tokens
    dispatch in groups of 16, and on the same routing the two devices keep
    and drop the same choices."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.serving.server import ServingDeployment

    cfg = get_config(arch).smoke()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe_impl="gshard")
    on_cpu = init_params(cfg, 0, device="cpu")
    on_gpu = copy.deepcopy(on_cpu).to(dev)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32))
    lc, _ = forward(cfg, on_cpu, toks)
    lg, _ = forward(cfg, on_gpu, toks.to(dev))
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4,
                               atol=1e-4)
    prompt = toks[0].tolist()
    g_cpu = _greedy(cfg, on_cpu, prompt, 12, "cpu")
    g_gpu = _greedy(cfg, on_gpu, prompt, 12, dev)
    if g_cpu != g_gpu:
        raise AssertionError(f"greedy tokens differ: cpu {g_cpu}, cuda "
                             f"{g_gpu}")
    served = []
    for d, params in (("cpu", on_cpu), (dev, on_gpu)):
        fleet = ServingDeployment(cfg, n_replicas=3, n_clients=2, device=d)
        fleet.push_weights(params)
        served.append([fleet.infer(p, max_new=6, client=i % 2)
                       for i, p in enumerate(([1, 2, 3], prompt[:17],
                                              prompt))])
    if served[0] != served[1]:
        raise AssertionError(f"served tokens differ: {served}")
    print(f"cuda == cpu on {cfg.name} (float32, head dim {cfg.head_dim}"
          f"{', ' + cfg.moe_impl + ' MoE' if cfg.moe else ''}): "
          f"logits within rtol/atol 1e-4 (max abs diff "
          f"{float((lg.cpu() - lc).abs().max()):.2e}), greedy tokens and "
          f"three served requests equal", flush=True)


def _transient_grid(P, PT, LH, TL, sweep, alpha, dev):
    """The transient path's counted run: both mixes through
    ``CompiledSweep.transient`` with the ``latency_hist`` and
    ``transient_lanes`` launches counted from 0, each step-kernel launch
    timed by CUDA events.  Returns per mix (label, workload, result, peak
    device memory, the step kernel's device ms, the lanes' final state and
    outputs, the engine's arguments), the two launch counts, a copy of the
    first mix's histogram inputs and the histogram calls' shapes."""
    import torch
    kernel, batch = PT.latency_hist, PT._transient_batch
    caught, calls, engine = {}, [], []

    def catch(samples, valid, edges):
        if not calls:
            caught.update(samples=samples.clone(), mask=valid.clone(),
                          edges=edges.clone())
        calls.append(tuple(samples.shape))
        return kernel(samples, valid, edges)

    def catch_batch(*args, **kw):
        engine.append((args, kw))
        return batch(*args, **kw)

    # a first launch loads the kernel's module; keep it out of the timings
    P.simulate_transient(np.ones(3), n_clients=8, seeds=2, n_steps=16,
                         device=dev)
    out = []
    PT.latency_hist, PT._transient_batch = catch, catch_batch
    try:
        LH.latency_hist.launches = 0
        TL.transient_lanes.launches = 0
        warp = TL.transient_lanes.by_kernel["warp"]
        for label, w in _mixes(P):
            torch.cuda.reset_peak_memory_stats()
            res, dev_ms, last = _step_run(
                PT, TL.transient_lanes, sweep.transient, alpha, workload=w,
                events=[P.Event(*TRANSIENT_CRASH)], device=dev,
                kernel="transient_lanes", keys=TRANSIENT_STATE, **TRANSIENT)
            out.append((label, w, res, torch.cuda.max_memory_allocated(),
                        dev_ms, last, engine[-1]))
        launches = LH.latency_hist.launches
        tl_launches = TL.transient_lanes.launches
        if TL.transient_lanes.by_kernel["warp"] - warp != tl_launches:
            raise AssertionError("transient: the main path's lanes did not "
                                 "all take the warp kernel")
    finally:
        PT.latency_hist, PT._transient_batch = kernel, batch
    return out, launches, tl_launches, caught, calls


def _transient_lanes_equal(got, want, what: str) -> float:
    """got / want: ``_step_run``'s lanes (``TRANSIENT_STATE``) of a run
    through the kernel and through the plain loop: raise unless the flows,
    latencies, final state and queue sums are bitwise equal.  Returns the
    largest |a - b| over the float tensors (equal infinities count 0)."""
    import torch
    err = 0.0
    for key in TRANSIENT_STATE:
        a, b = got[key], want[key]
        if a.is_floating_point():
            diff = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: transient_lanes differs from its "
                                 f"plain version in {key} (max |diff| "
                                 f"{err})")
    return err


def _transient_results_equal(a, b, what: str) -> None:
    for field in ("flows", "completed", "hist", "queue_sums", "throughput",
                  "latency_mean", "latency_p99"):
        if not np.array_equal(getattr(a, field), getattr(b, field)):
            raise AssertionError(f"{what}: the results differ in {field}")


def _failover_ranking(P, alpha, dev):
    """``autotune(objective="p99_under_failover")`` at budget 19 on
    ``dev``: (the result, its wall-clock seconds)."""
    t0 = time.perf_counter()
    tune = P.autotune(19, alpha, objective="p99_under_failover",
                      transient_kwargs=dict(device=dev))
    return tune, time.perf_counter() - t0


def _autoscale_policy(P, alpha, dev):
    """``autotune_policy`` at ``benchmarks/autoscale.py``'s settings on
    ``dev``: (the result, ``BENCH_autoscale.json``'s numbers, the numbers
    this run gives under the same keys, its wall-clock seconds)."""
    want = json.loads((Path(__file__).resolve().parent
                       / "BENCH_autoscale.json").read_text())
    w1 = P.Workload(f_write=1.0)
    model = P.model_for(dict(AUTOSCALE_CFG), w1)
    d_w, _, servers = model.demand_slots()
    k = len(P.STATION_ORDER)
    base = np.asarray(d_w[:k], dtype=np.float64) / alpha
    srv = np.asarray(servers[:k], dtype=np.int64)
    rz = P.resizable_stations("compartmentalized", AUTOSCALE_CFG)
    policies = tuple(P.AutoscalePolicy(
        target_low=lo, target_high=hi, cooldown_windows=0,
        min_counts=AUTOSCALE_FLOORS,
        **({} if q is None else dict(queue_high=q)))
        for lo, hi, q in AUTOSCALE_BANDS)
    t0 = time.perf_counter()
    pol = P.autotune_policy(
        policies, base, srv,
        P.diurnal_load(want["windows"], low=0.15, sharpness=2.0),
        p99_slack=1.0, seeds=3, n_steps=4800,
        resizable=[rz] * (len(policies) + 1), device=dev)
    seconds = time.perf_counter() - t0
    saved = 1.0 - pol.winner.machine_time / pol.static.machine_time
    got = {"machine_time_autoscaled": round(pol.winner.machine_time, 4),
           "machine_time_static": round(pol.static.machine_time, 4),
           "machine_hours_saved_fraction": round(saved, 4),
           "peak_p99_autoscaled_s": float(pol.winner.peak_p99),
           "peak_p99_static_s": float(pol.static.peak_p99),
           "trough_floor_machines": int(pol.winner.trace.machines.min()),
           "resizes": len(pol.winner.trace.actions),
           "winner_policy": pol.winner.policy.describe()}
    return pol, want, got, seconds


def _transient_phase(P, PT, LH, TL, ref, sweep, alpha, dev):
    """Phase 6: the transient token engine, autotune and autoscale on the
    card.  Returns the ``latency_hist`` and ``transient_lanes`` rows of its
    path."""
    import torch
    t_phase = time.perf_counter()
    runs, launches, tl_launches, caught, calls = _transient_grid(
        P, PT, LH, TL, sweep, alpha, dev)
    n_steps = TRANSIENT["n_steps"]
    per_mix = -(-n_steps // PT.BLOCK_STEPS)
    if launches != len(runs) or calls != [calls[0]] * len(runs) \
            or calls[0][1] != n_steps:
        raise AssertionError(f"transient: {launches} latency_hist launches "
                             f"of shapes {calls}, expected one of "
                             f"(L, {n_steps}) per mix")
    if tl_launches != len(runs) * per_mix:
        raise AssertionError(f"transient: {tl_launches} transient_lanes "
                             f"launches, expected {len(runs) * per_mix}")
    errs = []   # max |kernel - plain| of each comparison
    plain_ms_step = {}
    for label, w, res, peak_mem, dev_ms, last, engine in runs:
        base = sweep.demands(w) / alpha
        _, bounds = P.build_schedule(base, [P.Event(*TRANSIENT_CRASH)],
                                     n_steps)
        if not np.array_equal(res.hist.sum(axis=2), res.completed):
            raise AssertionError(f"transient {label}: histogram mass != "
                                 f"completions")
        for arr in (res.flows, res.throughput, res.latency_mean,
                    res.latency_p50, res.latency_p99, res.queue_sums):
            if not np.all(np.isfinite(arr)):
                raise AssertionError(f"transient {label}: non-finite output")
        if not np.all(res.completed > 0):
            raise AssertionError(f"transient {label}: a lane completed "
                                 f"nothing")
        peak = sweep.peak_throughput(alpha, w)
        ratio = res.window_throughput(bounds) / peak[:, None, None]
        # one lane's window holds ~280 services of its bottleneck, so its
        # rate is Poisson-noisy (~6 % at one sigma); the seed mean is held
        # to the bottleneck law
        mean = ratio.mean(axis=1)
        outside = mean[:, [0, 2]]
        if not np.all(np.abs(outside - 1.0) <= 0.10):
            raise AssertionError(f"transient {label}: seed-mean window "
                                 f"throughput off the bottleneck law: "
                                 f"{outside.min():.3f}-{outside.max():.3f}")
        if not np.all(ratio[:, :, 1] < 1.0):
            raise AssertionError(f"transient {label}: a lane did not dip "
                                 f"in the crash window")
        # the same lanes through the plain loop on the card, bitwise
        plain, _, plain_last = _step_run(
            PT, ref.ref_transient_lanes, sweep.transient, alpha, workload=w,
            events=[P.Event(*TRANSIENT_CRASH)], device=dev,
            kernel="transient_lanes", keys=TRANSIENT_STATE, **TRANSIENT)
        errs.append(_transient_lanes_equal(last, plain_last, label))
        _transient_results_equal(res, plain, f"transient {label}, kernel "
                                             f"and plain loop")
        plain_ms_step[label] = plain.timings["scan"] / n_steps * 1e3
        scan = res.timings["scan"]
        print(f"transient {label}: {len(res.dt)} configs x "
              f"{TRANSIENT['seeds']} seeds x {TRANSIENT['n_clients']} "
              f"clients x {n_steps} steps, leader crash at 40-60 %; scan "
              f"{scan:.4f} s = {scan / n_steps * 1e3:.4f} ms/step "
              f"(transient_lanes {per_mix} launches of the warp kernel, "
              f"{dev_ms:.3f} ms on the card, "
              f"{dev_ms / n_steps * 1e3:.3f} us a step; the plain loop "
              f"{plain_ms_step[label]:.3f} ms/step, bitwise equal: flows, "
              f"lat1, state, qsum); 1 latency_hist launch of "
              f"{calls[0][0]} x {n_steps} samples; peak device memory "
              f"{peak_mem / 2**30:.3f} GiB; seed-mean window throughput / "
              f"bottleneck law: before "
              f"{mean[:, 0].min():.3f}-{mean[:, 0].max():.3f}, crash "
              f"{mean[:, 1].min():.3f}-{mean[:, 1].max():.3f}, after "
              f"{mean[:, 2].min():.3f}-{mean[:, 2].max():.3f}; lanes "
              f"{ratio[:, :, [0, 2]].min():.3f}-"
              f"{ratio[:, :, [0, 2]].max():.3f}; p99 "
              f"{res.latency_p99.min():.4e}-{res.latency_p99.max():.4e} s",
              flush=True)
        del plain, plain_last

    # the histogram on the samples the path handed it
    samples, mask, edges = caught["samples"], caught["mask"], caught["edges"]
    rec = _hist_record(LH, ref, samples, mask, edges, "transient")
    print(f"kernel transient: L={samples.shape[0]} N={samples.shape[1]} "
          f"(one latency a step), {rec.pop('n_valid')} valid samples; "
          f"exact, one device kernel a call ({rec['kernel']}, plan "
          f"{rec['plan']}); latency_hist {rec['ms']:.4f} ms alone, the "
          f"call's host wall {rec['wall_ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.2f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)
    hist_record = dict(launches=launches, **rec,
                       shape=dict(lanes=samples.shape[0],
                                  samples=samples.shape[1]))
    del samples, mask, edges, caught

    # the step kernel's first block at the main path's shape, timed
    (inp,), engine = runs[-1][6]
    n_clients = engine["n_clients"]
    block = min(PT.BLOCK_STEPS, n_steps)
    engine = dict(engine, n_steps=block)
    first = [_step_run(PT, TL.transient_lanes, PT._transient_batch, inp,
                       kernel="transient_lanes", keys=TRANSIENT_STATE,
                       lead=True, **engine) for _ in range(6)]
    blocks = [_with_plan(TL, _block_plan(TL), _step_run, PT,
                         TL.transient_lanes, PT._transient_batch, inp,
                         kernel="transient_lanes", keys=TRANSIENT_STATE,
                         lead=True, **engine) for _ in range(6)]
    plain = [_step_run(PT, ref.ref_transient_lanes, PT._transient_batch, inp,
                       kernel="transient_lanes", keys=TRANSIENT_STATE,
                       **engine) for _ in range(2)]
    errs.append(_transient_lanes_equal(first[-1][2], plain[-1][2],
                                       "the main path's first block"))
    errs.append(_transient_lanes_equal(blocks[-1][2], plain[-1][2],
                                       "the main path's first block, block "
                                       "kernel"))
    n_windows, lanes, k = inp.demands_w.shape
    seeds = inp.seeds.size
    ms = float(np.median([r[1] for r in first[1:]]))
    block_ms = float(np.median([r[1] for r in blocks[1:]]))
    plain_ms = min(r[1] for r in plain)
    # the same block in the deterministic mode, which loads no draws
    det_ms = float(np.median([_step_run(
        PT, TL.transient_lanes, PT._transient_batch, inp,
        kernel="transient_lanes", keys=TRANSIENT_STATE, lead=True,
        **dict(engine, exponential=False))[1] for _ in range(6)][1:]))
    bound_ms, bound_by = _bound_ms(kernel_costs.transient_lanes_cost(
        lanes, block, n_clients, k, n_windows, seeds))
    scan_bound_ms, _ = _bound_ms(kernel_costs.transient_lanes_cost(
        lanes, n_steps, n_clients, k, n_windows, seeds))
    scan_ms = [r[4] for r in runs]
    print(f"kernel transient_lanes: the 90 % reads grid's first {block} "
          f"steps (L={lanes} lanes x N={n_clients} clients x {k} stations x "
          f"{n_windows} windows, {seeds} seeds of draws): bitwise equal; "
          f"warp kernel {ms:.4f} ms ({ms / block * 1e3:.3f} us a step; "
          f"deterministic, no draws loaded, {det_ms:.4f} ms), the block "
          f"kernel on the same lanes {block_ms:.4f} ms "
          f"({block_ms / block * 1e3:.3f} us a step; warp / block "
          f"{ms / block_ms:.3f}), plain "
          f"{plain_ms:.2f} ms, bound {bound_ms:.5f} ms ({bound_by}); the "
          f"whole scan {' / '.join(f'{t:.3f}' for t in scan_ms)} ms on the "
          f"card by mix, its bound {scan_bound_ms:.5f} ms; "
          f"{tl_launches} launches on the path", flush=True)
    lanes_record = dict(launches=tl_launches, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by,
                        deterministic_ms=det_ms, kernel="warp",
                        block_kernel_ms=block_ms, timed=STEP_TIMED,
                        shape=dict(lanes=lanes, clients=n_clients,
                                   stations=k, windows=n_windows,
                                   steps=block),
                        scan_ms=dict(zip([r[0] for r in runs], scan_ms)),
                        scan_steps=n_steps, scan_bound_ms=scan_bound_ms,
                        scan_s={r[0]: r[2].timings["scan"] for r in runs},
                        plain_ms_per_step=plain_ms_step)
    del first, blocks, plain, inp, runs
    torch.cuda.empty_cache()

    # autotune: the staircase, and the failover ranking on the card
    trace = P.bottleneck_trace(budget=19, alpha=alpha, workload=P.Workload())
    stairs = [(t.machines, round(t.peak), t.bottleneck) for t in trace]
    if stairs != FIG29:
        raise AssertionError(f"Fig. 29 staircase differs: {stairs}")
    tune, tune_s = _failover_ranking(P, alpha, dev)
    if not (np.isfinite(tune.best_p99) and tune.best_p99 > 0):
        raise AssertionError(f"autotune p99 {tune.best_p99}")
    c = tune.best_config
    print(f"autotune: Fig. 29 staircase exact "
          f"({' -> '.join(f'{p:,} @ {m} ({b})' for m, p, b in stairs)}); "
          f"p99_under_failover on the card in {tune_s:.2f} s picks proxies="
          f"{c['n_proxy_leaders']} grid={c['grid_rows']}x{c['grid_cols']} "
          f"replicas={c['n_replicas']} on {tune.machines} machines, p99 "
          f"{tune.best_p99:.4e} s", flush=True)

    # autoscale: benchmarks/autoscale.py's policy search, to the bit
    pol, want, got, as_s = _autoscale_policy(P, alpha, dev)
    bad = {key: (v, want[key]) for key, v in got.items() if v != want[key]}
    if bad or pol.winner.machine_time != 17.78125:
        raise AssertionError(f"autoscale differs from BENCH_autoscale.json:"
                             f" {bad}, machine time "
                             f"{pol.winner.machine_time}")
    print(f"autoscale: autotune_policy at benchmarks/autoscale.py's settings"
          f" ({want['windows']} windows x 3 seeds x 4800 steps) on the card "
          f"in {as_s:.2f} s == BENCH_autoscale.json: machine time "
          f"{pol.winner.machine_time} / {pol.static.machine_time} "
          f"({got['machine_hours_saved_fraction']} saved), "
          f"{got['resizes']} resizes, trough floor "
          f"{got['trough_floor_machines']}, peak p99 "
          f"{got['peak_p99_autoscaled_s']!r} / {got['peak_p99_static_s']!r}"
          f" s", flush=True)
    lanes_record.update(autotune_failover_s=tune_s, autotune_policy_s=as_s)

    # a small crash grid: the kernel against the plain loop on the card
    # (injected and deterministic draws; 16 clients a lane take the warp
    # kernel, WIDE_CLIENTS the block kernel), then the card against the CPU
    small = P.compile_sweep(P.SweepSpec(n_proxy_leaders=(2, 4),
                                        grids=((2, 2),), n_replicas=(2, 3)))
    k_small = small.demands(P.MIXED_50_50).shape[1]
    injected = np.random.default_rng(30).exponential(
        size=(2, 1200 + 1, k_small)).astype(np.float32)
    for n_clients, kernel in ((16, "warp"), (WIDE_CLIENTS, "block")):
        kw = dict(workload=P.MIXED_50_50, n_clients=n_clients, seeds=2,
                  n_steps=1200, events=[P.Event(*TRANSIENT_CRASH)])
        for mode, extra in (("injected", dict(draws=injected)),
                            ("deterministic",
                             dict(exponential_service=False))):
            before = TL.transient_lanes.by_kernel[kernel]
            launches = TL.transient_lanes.launches
            on_card, _, lanes_k = _step_run(
                PT, TL.transient_lanes, small.transient, alpha, device=dev,
                kernel="transient_lanes", keys=TRANSIENT_STATE, **kw, **extra)
            if TL.transient_lanes.by_kernel[kernel] - before \
                    != TL.transient_lanes.launches - launches:
                raise AssertionError(f"small crash grid, {n_clients} "
                                     f"clients: not the {kernel} kernel")
            plain, _, lanes_p = _step_run(
                PT, ref.ref_transient_lanes, small.transient, alpha,
                device=dev, kernel="transient_lanes", keys=TRANSIENT_STATE,
                **kw, **extra)
            what = f"small crash grid, {n_clients} clients, {mode}"
            errs.append(_transient_lanes_equal(lanes_k, lanes_p, what))
            _transient_results_equal(on_card, plain,
                                     f"{what}, kernel and plain loop")
        print(f"kernel check: transient_lanes ({kernel} kernel) == plain "
              f"step loop bitwise (flows, lat1, state, qsum) on a 4-config x "
              f"2-seed x {n_clients}-client crash grid, 1200 steps, injected "
              f"and deterministic draws", flush=True)
    lanes_record["max_abs_err"] = max(errs)
    for expo in (False, True):
        kw = dict(workload=P.MIXED_50_50, n_clients=16, seeds=2,
                  n_steps=1200, events=[P.Event(*TRANSIENT_CRASH)],
                  exponential_service=expo)
        on_gpu = small.transient(alpha, device=dev, **kw)
        on_cpu = small.transient(alpha, device="cpu", **kw)
        for field in ("flows", "completed", "hist", "queue_sums",
                      "throughput", "latency_mean", "latency_p99"):
            if not np.array_equal(getattr(on_gpu, field),
                                  getattr(on_cpu, field)):
                raise AssertionError(f"transient cuda and cpu runs differ in"
                                     f" {field} (exponential={expo})")
    print(f"cuda == cpu on a 4-config x 2-seed transient crash grid, "
          f"deterministic and exponential (flows, completions, histograms, "
          f"queue sums, throughput, p99 and mean latency equal); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return hist_record, lanes_record


def _bits_equal(a, b) -> bool:
    """Equal bit for bit but for NaN's payload: the same shape, NaN where
    the other is NaN, and every other value equal."""
    import torch
    if a.shape != b.shape:
        return False
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan], b[~nan]))


def _ss_edge_cases(MV, FL, ref, dev) -> int:
    """Both steady-state kernels against their plain loops, both on the
    card, bit for bit (NaN to NaN): n_max 1, K = 1, a zero-demand column,
    a zero row at think 0 (x = N / 0 = inf, then NaN), think > 0, rows no
    multiple of a block's 4, K = 33 (two columns a lane), K = 600 (past
    the registers' 512: the global-memory walk), 1 and 2 fluid steps, a
    zero-step fluid call."""
    import torch
    rng = np.random.default_rng(31)

    def demands(m, k, zero_col=None, zero_row=None):
        d = rng.uniform(1e-6, 1e-4, size=(m, k)).astype(np.float32)
        if zero_col is not None:
            d[:, zero_col] = 0.0
        if zero_row is not None:
            d[zero_row] = 0.0
        return torch.from_numpy(d).to(dev)

    cases = [  # (name, demands, think, n_max, fluid steps)
        ("n_max 1", demands(32, 15), 0.0, 1, 1),
        ("K 1", demands(7, 1), 0.0, 64, 2),
        ("zero column", demands(32, 15, zero_col=3), 0.0, 64, 100),
        ("zero row, think 0", demands(8, 15, zero_row=2), 0.0, 16, 16),
        ("think 0.01", demands(32, 15), 0.01, 512, 64),
        ("5 rows", demands(5, 15), 0.0, 33, 33),
        ("K 33", demands(6, 33, zero_col=32), 0.0, 70, 70),
        ("K 600", demands(9, 600, zero_col=599), 0.002, 100, 100),
        ("zero steps", demands(3, 15), 0.0, 0, 0),
    ]
    for name, d, think, n_max, steps in cases:
        b_m, b_f = MV.mva_scan.launches, FL.fluid_scan.launches
        got = MV.mva_scan(d, think, n_max)
        want = ref.ref_mva_scan(d, think, n_max)
        fl_got = FL.fluid_scan(d, 64.0, 1.0 / 2000, steps)
        fl_want = ref.ref_fluid_scan(d, 64.0, 1.0 / 2000, steps)
        torch.cuda.synchronize()
        launched = (MV.mva_scan.launches - b_m, FL.fluid_scan.launches - b_f)
        if launched != (int(n_max > 0), int(steps > 0)):
            raise AssertionError(f"steady-state edge case {name}: launches "
                                 f"{launched}")
        for what, a, b in (("X", got[0], want[0]), ("R", got[1], want[1]),
                           ("done", fl_got[0], fl_want[0]),
                           ("flows", fl_got[1], fl_want[1])):
            if not _bits_equal(a, b):
                raise AssertionError(f"steady-state edge case {name}: the "
                                     f"kernel's {what} differs from its "
                                     f"plain loop")
    return len(cases)


def _steady_state_phase(P, MV, FL, ref, sweep, alpha, dev) -> dict:
    """Phase 5b: the steady-state solves on the Fig. 29 grid.  The main
    path first, its launch counts from 0: ``CompiledSweep.mva`` at
    ``SS_CLIENTS`` and sharded over ``SS_SHARDS`` shards, ``.fluid`` at
    ``SS_FLUID``, each exactly one launch of its kernel, each bitwise equal
    to the same call with ``device="cpu"``; then each kernel against its
    plain loop on the card at the path's demands (bit for bit), the edge
    cases, 20 CUDA-graph replays bitwise equal, and the times: each
    kernel alone (queued behind a sleep) beside its byte bound and the
    plain loop's ms, and each whole call's host wall beside the eager
    parent's (``SS_PARENT``).  Returns the ``kernels`` rows of both kernels."""
    import torch
    t_phase = time.perf_counter()
    w = P.Workload(f_write=1.0)
    shards = P.ShardingSpec(n_shards=SS_SHARDS)
    calls = {f"mva {n}": (lambda d, n=n: sweep.mva(
        alpha, n, workload=w, device=d)[1:]) for n in SS_CLIENTS}
    calls["mva 512 sharded"] = lambda d: sweep.mva(
        alpha, 512, workload=w, sharding=shards, device=d)[1:]
    calls["fluid"] = lambda d: (sweep.fluid(
        alpha, SS_FLUID["n_clients"], workload=w,
        n_steps=SS_FLUID["n_steps"], device=d),)
    # a first launch of each loads its module: keep it off the count
    MV.mva_scan(torch.ones((1, 1), device=dev), 0.0, 1)
    FL.fluid_scan(torch.ones((1, 1), device=dev), 1.0, 1.0, 1)
    MV.mva_scan.launches = 0
    FL.fluid_scan.launches = 0
    outs, per_call = {}, {}
    for name, call in calls.items():
        b_m, b_f = MV.mva_scan.launches, FL.fluid_scan.launches
        outs[name] = call(dev)
        per_call[name] = (MV.mva_scan.launches - b_m,
                          FL.fluid_scan.launches - b_f)
    launches = {"mva_scan": MV.mva_scan.launches,
                "fluid_scan": FL.fluid_scan.launches}
    for name, call in calls.items():
        want = (0, 1) if name == "fluid" else (1, 0)
        if per_call[name] != want:
            raise AssertionError(f"{name}: (mva_scan, fluid_scan) launches "
                                 f"{per_call[name]}, not {want}")
        for i, (a, b) in enumerate(zip(outs[name], call("cpu"))):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: output {i} on the card differs"
                                     f" from the CPU's")
            if not (np.all(np.isfinite(a)) and np.all(a > 0)):
                raise AssertionError(f"{name}: non-finite or non-positive "
                                     f"output {i}")
    if launches["mva_scan"] == 0 or launches["fluid_scan"] == 0:
        raise AssertionError(f"the steady-state path launched {launches}")
    print(f"phase 5b: mva at n_clients_max {SS_CLIENTS} and {SS_SHARDS} "
          f"shards x 15 = {SS_SHARDS * 15} columns, fluid at "
          f"{SS_FLUID['n_clients']} clients x {SS_FLUID['n_steps']} steps: "
          f"one launch a call ({launches}), the card == the CPU bit for bit",
          flush=True)

    # the kernels against their plain loops at the path's demands
    d15 = torch.from_numpy(
        (sweep.demands(w) / alpha).astype(np.float32)).to(dev)
    d480 = torch.from_numpy((P.flatten_shards(
        sweep.demands(w, sharding=shards)) / alpha).astype(np.float32)
        ).to(dev)
    dt = 1.0 / SS_FLUID["n_steps"]
    shapes = {"mva 64": (MV.mva_scan, ref.ref_mva_scan, (d15, 0.0, 64)),
              "mva 512": (MV.mva_scan, ref.ref_mva_scan, (d15, 0.0, 512)),
              "mva 512 sharded": (MV.mva_scan, ref.ref_mva_scan,
                                  (d480, 0.0, 512)),
              "fluid": (FL.fluid_scan, ref.ref_fluid_scan,
                        (d15, float(SS_FLUID["n_clients"]), dt,
                         SS_FLUID["n_steps"]))}
    errs = {}
    for name, (kernel, plain, args) in shapes.items():
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if not all(_bits_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: the kernel differs from its "
                                 f"plain loop on the card")
        errs[name] = max(float((a - b).abs().max()) if a.numel() else 0.0
                         for a, b in zip(got, want))
    n_edge = _ss_edge_cases(MV, FL, ref, dev)
    for name in ("mva 512", "mva 512 sharded", "fluid"):
        kernel, _, args = shapes[name]
        _graph_replays_equal(lambda: kernel(*args), f"{name} graph")
    print(f"kernel check: mva_scan and fluid_scan == their plain loops on "
          f"the card bit for bit at the path's demands (K 15 and "
          f"{d480.shape[1]}) and in {n_edge} edge cases (n_max 1, K 1 / 33 "
          f"/ 600, zero column, zero row at think 0, think 0.01, 5 rows, "
          f"1-2 and 0 fluid steps); 20 graph replays bitwise equal",
          flush=True)

    rows = {}
    sm_hz = _sm_clock_hz()
    for name, (kernel, plain, args) in shapes.items():
        m, k = args[0].shape
        if kernel is MV.mva_scan:
            cost = kernel_costs.mva_scan_cost(m, args[2], k)
        else:
            cost = kernel_costs.fluid_scan_cost(m, args[3], k)
        ms = _alone_ms(lambda: kernel(*args))
        plain_ms = _time_ms(lambda: plain(*args), 1, 2)
        bound_ms, bound_by = _bound_ms(cost)
        steps = args[2] if kernel is MV.mva_scan else args[3]
        plan = MV.plan(k)._asdict() if kernel is MV.mva_scan else None
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[name](dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = float(np.median(walls))
        parent, parent_launches = SS_PARENT[name]
        print(f"kernel {name}: ({m}, {k}) {kernel.__name__} {ms:.4f} ms "
              f"alone ({ms * 1e-3 * sm_hz / steps:.1f} cycles a step at "
              f"{sm_hz / 1e6:.0f} MHz; plan {plan}), "
              f"bound {bound_ms:.6f} ms ({bound_by}; the kernel "
              f"{ms / bound_ms:.0f}x: the serial chain), plain loop "
              f"{plain_ms:.2f} ms; the whole call's host wall {wall:.3f} ms "
              f"(median of 5; the eager parent {parent[0]:.3f} / "
              f"{parent[1]:.3f} ms, {parent_launches} launches a call; now "
              f"1 launch)", flush=True)
        rows[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, wall_ms=wall,
                          shape=[m, k], timed=STEP_TIMED,
                          cycles_a_step=ms * 1e-3 * sm_hz / steps)
        if plan is not None:
            rows[name]["plan"] = plan
    print(f"phase 5b: {time.perf_counter() - t_phase:.1f} s", flush=True)
    mva = dict(rows["mva 512"], launches=launches["mva_scan"],
               shapes={n: rows[n] for n in rows if n != "fluid"})
    fluid = dict(rows["fluid"], launches=launches["fluid_scan"])
    return {"mva_scan": mva, "fluid_scan": fluid}


#: The attention backward against autograd through the plain forward:
#: |err| <= rtol x the gradient's largest entry + atol.  float32: the
#: kernel sums in float32 in another order; bfloat16: inputs, the
#: cotangent and the gradients are bf16 (8 bits of mantissa)
BWD_TOL = {"torch.float32": (1e-5, 1e-5), "torch.bfloat16": (2e-2, 1e-3)}
#: (B, H, H_kv, S_q, S_k, d, causal, window): lengths 1, 17, 127, 300,
#: 700, 1024, 1500, 2048 and 2112; groups 1, 2, 4, 8 and 10; head dims 64,
#: 128 and 256; causal, windowed (the wgmma path's window-edge tiles),
#: and full with S_q != S_k (whisper's cross-attention, queries against
#: 1500 encoder keys).  At d 256 (bf16 on wgmma): windowed
#: 300 / 100, lengths that are no multiple of 64 (300, 1500), group 10
#: over 1 kv head, S_q = 1 (causal and against 300 keys), recurrentgemma-
#: 2b's training shape at B 1 (its 2048-key window; the group split into
#: 8 shares), and 132 dk/dv blocks, which take no group split
BWD_CASES = [
    (1, 8, 8, 1, 1, 64, True, None), (2, 8, 2, 17, 17, 64, True, None),
    (1, 8, 1, 127, 127, 128, True, None), (1, 4, 1, 300, 300, 256, True, 100),
    (1, 10, 1, 1500, 1500, 256, True, 512),
    (1, 4, 1, 300, 300, 64, True, 100), (1, 8, 2, 700, 700, 128, False, 130),
    (1, 6, 6, 1, 1500, 64, False, None), (2, 6, 6, 17, 1500, 64, False, None),
    (1, 6, 6, 448, 1500, 64, False, None),
    (1, 6, 6, 1500, 1500, 64, False, None),
    (1, 32, 8, 2048, 2048, 64, True, None),
    (1, 16, 2, 2048, 2048, 128, True, None),
    (1, 4, 1, 17, 1500, 256, False, None),
    (1, 4, 1, 1, 1, 256, True, None), (2, 10, 1, 1, 300, 256, False, None),
    (1, 10, 1, 1024, 1024, 256, True, 2048),
    (2, 4, 2, 2112, 2112, 256, True, None),
]
#: recurrentgemma-2b's training shape (phase T4's local attention): q (4,
#: 10, 1024, 256), k/v (4, 1, 1024, 256), bf16, causal (its 2048-key
#: window covers all 1024 keys)
RG_TRAIN_ATTN = (4, 10, 1, 1024, 256)
#: granite-3-2b's training shape: q (4, 32, 1024, 64), k/v (4, 8, 1024,
#: 64), causal, bf16
TRAIN_SHAPE = (4, 32, 8, 1024, 64)
#: phase T2: granite-3-2b trained at full width and depth
TRAIN = dict(arch="granite-3-2b", batch=4, seq_len=1024, steps=4)
#: phase T2b, float32: every parameter's gradient through the kernels
#: within this x its largest entry of the plain attention's (the CPU
#: trainer test's bound)
GRAD_TOL_F32 = 1e-4
#: phase T2b, bf16: two bf16 runs differ by bf16's own rounding (up to
#: 7e-2 of a leaf's largest entry on this batch, with the plain attention
#: as with SDPA), so each bf16 gradient is held against the float32 one
#: at the same weights: through the kernels its distance (2-norm) to it
#: may be at most this x the plain bf16 attention's
GRAD_NOISE_RATIO_BF16 = 1.25
#: phases T4b / T5b, float32: where the plain run itself lies further than
#: GRAD_TOL_F32 from a run with the recurrences' carries in float64 (T5b,
#: rwkv6-7b at 8 layers on an H100: 2.786e-4 of a leaf's largest entry, the
#: kernels 2.244e-4), each gradient through the kernels may lie from that
#: float64 run up to this x the plain run's largest such distance (the
#: float32 floor)
GRAD_NOISE_RATIO_F32 = 1.25
#: phase T3: the trainer's fault path, granite-3-2b cut to 4 layers
FAULT_LAYERS = 4
#: phase W: whisper-tiny at full width and depth
WHISPER = dict(batch=2, prompt=16, new=32)
#: phase D, the distributed runtime on a one-rank NCCL group: D2's
#: granite-3-2b step (full width, depth cut to 4 layers), D3's
#: deepseek-moe-16b layer (a 2048-token prefill), D4's decode batches
#: against a 2048-row cache
#: the meshes phase R1's dry run counts ("single", "multi" or "both")
R1_MESH = "single"
#: relative tolerance of the a2a sharded step's cross-entropy against the
#: dense unsharded step's: float32, sums in another order; bf16, the
#: experts' products over other row counts (a capacity buffer against all
#: tokens) rounding otherwise before the combine
A2A_CE_RTOL = {"torch.float32": 1e-5, "torch.bfloat16": 1e-3}
#: bound on the distance of each parameter's gradient in the a2a sharded
#: step to the dense unsharded step's, relative to its norm: float32, sums
#: in another order; bf16, two gradients that each lie up to 2.119e-02 of
#: their norm from the float32 gradient (the largest such distance of
#: granite-3-2b's full-width gradient check on the card, phase T) may lie
#: twice that from each other.  A gradient of a MoE parameter left
#: unsummed over a model axis of 4 ranks lies about 0.75 of its norm off.
A2A_GRAD_RTOL = {"torch.float32": 1e-4, "torch.bfloat16": 5e-2}
DIST = dict(arch="granite-3-2b", layers=4, batch=4, seq_len=1024,
            moe_arch="deepseek-moe-16b", moe_tokens=2048,
            decode=(1, 8), cache_rows=2048)
#: A6 / A7, the recurrences' backward kernels against autograd through
#: their plain forwards.  wkv6_bwd at rwkv6-7b's 64 heads of 64: (B, S,
#: logw, s0 given, ds_last given) - one step, S short of, at and past a
#: 32-step chunk, T5's 1024 and the longest prompt; logw from the model's
#: range, at its -5 clamp (32 chunks of totals -160, on the recentring's
#: edge, at 1024), at 0 (the state grows with S) and at -20 (the chunks
#: are walked back step by step)
WKV_BWD_CASES = [
    (1, 1, None, True, True), (4, 1, None, False, False),
    (1, 17, -5.0, True, False), (4, 17, None, False, True),
    (1, 32, 0.0, True, True), (4, 32, -20.0, False, False),
    (1, 33, -20.0, True, True), (4, 33, -5.0, True, False),
    (4, 1024, None, False, False), (1, 1024, 0.0, True, True),
    (1, 1024, -5.0, True, True), (4, 1024, -5.0, False, False),
    (1, 4096, None, True, True)]
#: rglru_scan_bwd: (B, S, D, h0 given) at recurrentgemma-2b's width 2560
#: and a ragged 77 channels
RG_BWD_CASES = [(1, 1, 2560, True), (4, 1, 2560, False),
                (1, 17, 2560, False), (4, 32, 2560, True),
                (1, 33, 77, True), (4, 1024, 2560, False),
                (1, 1024, 2560, True), (1, 4096, 2560, True),
                (4, 300, 77, False)]
#: phases T4 / T5: recurrentgemma-2b and rwkv6-7b trained at full width,
#: batch x tokens; a depth whose reckoned peak passes TRAIN_PEAK_GIB is cut
#: to the deepest that does not (at least TRAIN_MIN_LAYERS), reckoning
#: TRAIN_ALLOWANCE_GIB for one layer's recompute and its backward's scratch
RECURRENT_TRAIN_SHAPE = (4, 1024)
TRAIN_PEAK_GIB = 70.0
TRAIN_MIN_LAYERS = 8
TRAIN_ALLOWANCE_GIB = 4.0
#: phases T4b / T5b: one batch's gradients at full width, batch x tokens;
#: rwkv6-7b at this depth (float32 weights and gradients of 32 layers
#: would not fit beside the bf16 run's)
RECURRENT_GRAD_SHAPE = (1, 256)
T5B_LAYERS = 8


def _bwd_edge_cases(FA, ref, dev) -> int:
    """Phase T1: the backward kernel (through the autograd Function, on
    the kernel's own forward and log-sum-exp) against autograd through
    the plain forward, on every case of ``BWD_CASES`` in float32 and
    bfloat16."""
    import torch
    n = 0
    for i, case in enumerate(BWD_CASES):
        B, H, H_kv, Sq, Sk, D, causal, window = case
        g = torch.Generator().manual_seed(100 + i)
        host = [torch.randn(shape, generator=g) for shape in
                ((B, H, Sq, D), (B, H_kv, Sk, D), (B, H_kv, Sk, D),
                 (B, H, Sq, D))]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, do = (t.to(dev, dt) for t in host)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(
                ref.ref_attention(*leaves, causal=causal, window=window),
                leaves, do)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            got = torch.autograd.grad(
                FA.flash_attention(*leaves, causal=causal, window=window),
                leaves, do)
            torch.cuda.synchronize()
            rtol, atol = BWD_TOL[str(dt)]
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                err = float((a.float() - b.float()).abs().max())
                limit = rtol * float(b.float().abs().max()) + atol
                if not bool(torch.isfinite(a).all()) or err > limit:
                    raise AssertionError(
                        f"flash_attention_bwd {name} differs from autograd "
                        f"through the plain version at {case} {dt}: max abs "
                        f"err {err:.3e} > {limit:.3e}")
            n += 1
    return n


def _bwd_replays_equal(FA, q, k, v, do, causal: bool, what: str) -> None:
    """20 calls of the backward on the same inputs give the same bits."""
    import torch
    out, lse = FA._launch(q, k, v, causal, None, with_lse=True)
    got = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    for _ in range(20):
        again = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd replays differ at "
                                 f"{what}")


def _wkv_bwd_build_report(log: str) -> None:
    """Registers and spills of the WKV backward's kernels: a spill in any
    fails (the chunked kernel keeps dS and its accumulators in
    registers), and each head dim has its chunked kernel in both
    dtypes."""
    from repro_torch.kernels._build import ptxas_report
    rows = ptxas_report(log)
    for name, regs, st, ld in rows:
        print(f"  wkv6_bwd.cu {name}: {regs} registers, spill stores {st} B,"
              f" loads {ld} B")
        if st + ld > 0:
            raise AssertionError(f"{name} spills ({st} / {ld} bytes)")
    for dt in ("float", "bf16"):
        for d in (16, 32, 64, 128):
            if not any(r[0] == f"wkv6_bwd_kernel<{dt}, {d}>" for r in rows):
                raise AssertionError(f"no wkv6_bwd_kernel<{dt}, {d}> in the "
                                     f"backward's ptxas report")


def _bwd_build_report(FA, n_sms: int) -> None:
    """Phase T1: registers and spills of every kernel of the backward
    library (a spill in the bf16 ``wgmma`` path fails) and the launch
    plan at granite's training shape and whisper's cross-attention."""
    from repro_torch.kernels._build import ptxas_report
    rows = ptxas_report(FA.build_bwd())
    for name, regs, st, ld in rows:
        print(f"  flash_attention_bwd.cu {name}: {regs} registers, spill "
              f"stores {st} B, loads {ld} B")
        if (name.startswith(("bwd_wgmma", "bwd_delta_lse", "bwd_merge"))
                and st + ld > 0):
            raise AssertionError(f"{name} spills ({st} / {ld} bytes)")
    for d in (64, 128, 256):
        if not any(r[0].startswith(f"bwd_wgmma_kernel<{d},") for r in rows):
            raise AssertionError(f"no wgmma kernel at d {d} in the "
                                 f"backward's ptxas report")
    B, H, H_kv, S, D = TRAIN_SHAPE
    rB, rH, rH_kv, rS, rD = RG_TRAIN_ATTN
    for what, args in (("granite training", (B, H, H_kv, S, S, D, True)),
                       ("whisper cross", (2, 6, 6, 16, 1500, 64, False)),
                       ("recurrentgemma training",
                        (rB, rH, rH_kv, rS, rS, rD, True))):
        plan = FA.bwd_plan(*args, None, n_sms)
        print(f"  backward plan at {what} {args[:6]}: dk/dv query tile "
              f"{plan.kv_q_tile}, {plan.kv_keys} keys a dk/dv block, dk/dv "
              f"blocks {plan.kv_grid} ({plan.n_gsplit} group shares), dq "
              f"blocks {plan.dq_grid} ({plan.n_split} key splits of "
              f"{plan.dq_keys}-key tiles), one launch of {plan.n_blocks} "
              f"blocks on {n_sms} SMs", flush=True)


def _bwd_check(FA, ref, q, k, v, do, causal: bool, what: str):
    """The backward kernel (on the forward kernel's own output and
    log-sum-exp) against autograd through the plain forward on the same
    q, k, v and cotangent, within ``BWD_TOL``.  Returns (out, lse, the
    kernel's (dq, dk, dv), the max abs error)."""
    import torch
    out, lse = FA._launch(q, k, v, causal, None, with_lse=True)
    got = FA.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.ref_attention(*leaves, causal=causal),
                               leaves, do)
    rtol, atol = BWD_TOL[str(q.dtype)]
    err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        e = float((a.float() - b.float()).abs().max())
        limit = rtol * float(b.float().abs().max()) + atol
        if not bool(torch.isfinite(a).all()) or e > limit:
            raise AssertionError(f"flash_attention_bwd {name} differs from "
                                 f"autograd through the plain version at "
                                 f"{what}: max abs err {e:.3e} > {limit:.3e}")
        err = max(err, e)
    return out, lse, got, err


def _bwd_case_record(FA, ref, q, k, v, do, causal: bool, flush,
                     what: str) -> dict:
    """The backward kernel on one set of tensors: checked by
    :func:`_bwd_check`, then its time (graph replay, cold L2) beside its
    bound (five products, 10 d flops a computed pair, at the dtype's peak
    rate, against q, the output, its cotangent, dq, k, v, dk, dv and the
    log-sum-exp moved once), and, timed the same way, the backward of
    autograd through the plain forward and of SDPA (the yardstick)."""
    import torch
    import torch.nn.functional as F
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    out, lse, _, err = _bwd_check(FA, ref, q, k, v, do, causal, what)
    bound, by = _bound_ms(kernel_costs.flash_attention_bwd_cost(
        B, H, k.shape[1], Sq, Sk, D, q.element_size(), causal))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return dict(
        max_abs_err=err,
        ms=_time_graph_ms(lambda: FA.flash_attention_bwd(
            q, k, v, out, lse, do, causal=causal), flush, 10),
        plain_ms=_time_grad_graph_ms(
            lambda *t: ref.ref_attention(*t, causal=causal), leaves, do,
            flush, 3),
        library_ms=_time_grad_graph_ms(
            lambda *t: F.scaled_dot_product_attention(
                *t, is_causal=causal, enable_gqa=H != k.shape[1]),
            leaves, do, flush, 10),
        bound_ms=bound, bound_by=by)


def _bwd_record(FA, ref, dev, flush) -> dict:
    """The backward kernel at granite-3-2b's training shape: against
    autograd through the plain forward, 20 replays bitwise equal, and the
    times of :func:`_bwd_case_record`; the forward's time there with and
    without the log-sum-exp, and the kernel's backward through the
    autograd Function (captured as SDPA's is)."""
    import torch
    B, H, H_kv, S, D = TRAIN_SHAPE
    g = torch.Generator(device=dev).manual_seed(7)
    q, do = (torch.randn((B, H, S, D), generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, H_kv, S, D), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    rec = _bwd_case_record(FA, ref, q, k, v, do, True, flush,
                           f"granite's training shape {TRAIN_SHAPE}")
    _bwd_replays_equal(FA, q, k, v, do, True, "granite's training shape")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    autograd_ms = _time_grad_graph_ms(
        lambda *t: FA.flash_attention(*t, causal=True), leaves, do, flush,
        10)
    fwd_ms = _time_graph_ms(lambda: FA._launch(q, k, v, True, None),
                            flush, 20)
    fwd_lse_ms = _time_graph_ms(lambda: FA._launch(q, k, v, True, None,
                                                   with_lse=True), flush, 20)
    pairs = B * H * S * (S + 1) // 2
    print(f"kernel flash_attention_bwd at granite-3-2b's training shape q "
          f"{tuple(q.shape)}, k/v {tuple(k.shape)} bf16 causal: max abs err "
          f"{rec['max_abs_err']:.3e} against autograd through the plain "
          f"forward; 20 replays bitwise equal; device times (graph replay, "
          f"cold L2): kernel {rec['ms']:.4f} ms ({autograd_ms:.4f} through "
          f"the autograd Function), autograd through the plain forward "
          f"{rec['plain_ms']:.4f}, SDPA's backward {rec['library_ms']:.4f};"
          f" bound {rec['bound_ms']:.4f} ({rec['bound_by']}, "
          f"{10 * D * pairs / 1e9:.1f} GFLOP); {rec['ms'] / rec['library_ms']:.2f}x"
          f" SDPA's backward. The forward at the same shape: {fwd_ms:.4f} ms"
          f" serving (no log-sum-exp), {fwd_lse_ms:.4f} ms with it",
          flush=True)
    rec["forward_ms"], rec["forward_lse_ms"] = fwd_ms, fwd_lse_ms
    rec["autograd_function_ms"] = autograd_ms
    return rec


def _device_breakdown(prof, wall_s: float, store: bool = True) -> str:
    """A traced training step's device time by kind of kernel, from
    ``torch.profiler``'s per-kernel sums, beside the step's host-clock
    time: the card's busy share, and where its time goes.  ``store``:
    keep the busy time as T2's (``MEASURED["train_device_ms"]``)."""
    from torch.autograd import DeviceType
    kinds, other = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        name = e.key
        kind = ("recurrence backward" if ("wkv6_bwd" in name
                                          or "rglru_bwd" in name) else
                "recurrence forward" if ("wkv6" in name
                                         or "rglru" in name) else
                "attention backward" if "bwd_" in name else
                "attention forward" if "flash_attention" in name else
                "matrix products" if any(t in name.lower() for t in (
                    "gemm", "cutlass", "xmma", "nvjet", "cublas")) else
                "other")
        kinds[kind] += us / 1e3
        if kind == "other":
            other[name[:60]] += us / 1e3
    busy = sum(kinds.values())
    if store:
        MEASURED["train_device_ms"] = busy
    if busy == 0:
        return ("  traced step: the profiler recorded no device time "
                "(not measured)")
    return (f"  traced step ({wall_s * 1e3:.1f} ms on the host clock): "
            f"device busy {busy:.1f} ms ({busy / (wall_s * 1e3):.1%}); " +
            ", ".join(f"{k} {v:.1f} ms ({v / busy:.1%})"
                      for k, v in kinds.most_common()) +
            "; the largest others: " + ", ".join(
                f"{k} {v:.1f} ms" for k, v in other.most_common(6)))


def _ckpt_dir() -> Path:
    """A scratch directory for the trainer's checkpoints inside the
    checkout (``build/`` is gitignored), emptied first."""
    import shutil
    path = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(path, ignore_errors=True)
    return path


def _train_phase(FA, ref, dev, bwd_ms: float) -> dict:
    """Phase T2: granite-3-2b at full width and depth trained by the
    port's ``Trainer`` (remat on) for ``TRAIN["steps"]`` steps on
    ``SyntheticLM``: the memory reckoned first, then per step the loss,
    ms, tokens/s, peak memory and the attention kernels' launches (each
    layer's forward, its recompute under remat, its backward).  Then the
    same run with the plain attention under autograd in place of the
    kernels, for its loss curve beside the kernels'."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import Trainer

    cfg = get_config(TRAIN["arch"])
    B, S = TRAIN["batch"], TRAIN["seq_len"]
    n = cfg.n_params()
    gib = 2.0 ** 30
    print(f"train {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n:,} parameters, remat {cfg.remat}, batch {B} x {S} tokens; "
          f"reckoned: bf16 params {2 * n / gib:.2f} GiB + grads "
          f"{2 * n / gib:.2f} + float32 moments {8 * n / gib:.2f} = "
          f"{12 * n / gib:.2f} GiB, float32 logits {B * S * cfg.vocab_size * 4 / gib:.2f}"
          f" GiB (and their gradient), layer inputs under remat "
          f"{cfg.n_layers * B * S * cfg.d_model * 2 / gib:.2f} GiB", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ckpt = _ckpt_dir()

    def new_trainer():
        return Trainer(
            cfg, str(ckpt), opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=2,
                                                total_steps=100),
            data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                global_batch=B, seed=0),
            n_virtual_workers=4, ckpt_every=10 ** 6, device=dev)

    t0 = time.perf_counter()
    trainer = new_trainer()
    torch.cuda.synchronize()
    MEASURED["train_init_gib"] = torch.cuda.memory_allocated() / gib
    print(f"  init {time.perf_counter() - t0:.1f} s, "
          f"{MEASURED['train_init_gib']:.2f} GiB allocated", flush=True)
    # the main path's counts: set to 0 just before it runs
    FA.flash_attention.launches = 0
    FA.flash_attention_bwd.launches = 0
    per_step, losses, times = [], [], []
    for i in range(TRAIN["steps"]):
        f0, b0 = FA.flash_attention.launches, FA.flash_attention_bwd.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i + 1 < TRAIN["steps"]:
            m = trainer.run_step()  # ends reading the metrics: synchronized
        else:  # the last step traced: where its device time goes
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                m = trainer.run_step()
        dt = time.perf_counter() - t
        fwd = FA.flash_attention.launches - f0
        bwd = FA.flash_attention_bwd.launches - b0
        per_step.append((fwd, bwd))
        losses.append(m["loss"])
        times.append(dt)
        print(f"  step {m['step']}: loss {m['loss']:.4f} (ce {m['ce']:.4f}),"
              f" grad_norm {m['grad_norm']:.3f}, lr {m['lr']:.2e}; "
              f"{dt * 1e3:.1f} ms, {B * S / dt:.0f} tokens/s; peak "
              f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB; "
              f"flash_attention {fwd} (forward {cfg.n_layers} + recompute "
              f"{fwd - cfg.n_layers}), flash_attention_bwd {bwd}",
              flush=True)
    launches = dict(flash_attention=FA.flash_attention.launches,
                    flash_attention_bwd=FA.flash_attention_bwd.launches)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    want_fwd = cfg.n_layers * (2 if cfg.remat else 1)
    for fwd, bwd in per_step:
        if bwd != cfg.n_layers or fwd != want_fwd:
            raise AssertionError(f"a step launched {fwd} flash_attention and "
                                 f"{bwd} flash_attention_bwd, not {want_fwd} "
                                 f"and {cfg.n_layers}")
    print(_device_breakdown(prof, times[-1]), flush=True)
    # the traced step is left out: the profiler slows the host
    steady = float(np.median(times[1:-1]))
    MEASURED["train_step_ms"] = steady * 1e3
    MEASURED["train_peak_gib"] = torch.cuda.max_memory_allocated() / gib
    print(f"train {cfg.name}: losses {[round(x, 4) for x in losses]} all "
          f"finite; exactly {cfg.n_layers} backward and {want_fwd} forward "
          f"attention launches a step; steady step {steady * 1e3:.1f} ms "
          f"(median of steps 2-{len(times) - 1}), {B * S / steady:.0f} tokens/s, "
          f"peak {torch.cuda.max_memory_allocated() / gib:.2f} GiB; the "
          f"attention backward ({cfg.n_layers} x {bwd_ms:.4f} ms) is "
          f"{cfg.n_layers * bwd_ms / (steady * 1e3):.1%} of a step", flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    # the same run, same weights and batches, with the plain attention
    real_fa = ops.flash_attention
    ops.flash_attention = _plain_attention(ref)
    try:
        trainer = new_trainer()
        plain = [trainer.run_step()["loss"] for _ in range(TRAIN["steps"])]
    finally:
        ops.flash_attention = real_fa
    print(f"train {cfg.name}: losses with the plain attention under autograd"
          f" {[round(x, 4) for x in plain]}, with the kernels "
          f"{[round(x, 4) for x in losses]} (largest difference "
          f"{max(abs(a - b) for a, b in zip(plain, losses)):.4f})",
          flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(launches=launches, step_ms=steady * 1e3)


def _plain_attention(ref):
    """``ops.flash_attention``'s stand-in for a plain run: the plain
    forward, which autograd differentiates."""
    def attend(q, k, v, *, causal=True, window=None):
        return ref.ref_attention(q, k, v, causal=causal, window=window)
    return attend


def _layer_counts(cfg) -> dict:
    """Layers of ``cfg`` that call each sequence kernel: a kernel's
    launches per forward (and its backward's per backward)."""
    kinds = cfg.layer_types()
    counts = {"flash_attention": sum(k in ("attn", "local_attn")
                                     for k in kinds),
              "rglru_scan": kinds.count("rglru"),
              "wkv6": kinds.count("rwkv6")}
    return {op: n for op, n in counts.items() if n}


def _plain_ops(ref) -> dict:
    """The ops' stand-ins for a plain run: each plain forward, which
    autograd differentiates."""
    return {"flash_attention": _plain_attention(ref),
            "rglru_scan": lambda x, a, h0=None: ref.ref_rglru(x, a, h0),
            "wkv6": lambda r, k, v, logw, u, s0=None: ref.ref_wkv6(
                r, k, v, logw, u, s0)}


def _rglru_f64(x, a, h0=None):
    """The RG-LRU recurrence with its carry in float64 (the plain
    version's float32 carry is what T4b's float32 floor measures)."""
    import torch
    xd, ad = x.double(), a.double()
    h = h0.double() if h0 is not None else torch.zeros_like(xd[:, 0])
    out = []
    for t in range(x.shape[1]):
        h = ad[:, t] * h + xd[:, t]
        out.append(h)
    return torch.stack(out, 1).to(x.dtype)


def _wkv6_f64(r, k, v, logw, u, s0=None):
    """The WKV recurrence with its state in float64, in and out as the
    model's (y in r's dtype, s_last float32)."""
    import torch
    rd, kd, vd, lw = (t.double() for t in (r, k, v, logw))
    B, S, H, K = kd.shape
    st = (torch.zeros((B, H, K, vd.shape[-1]), dtype=torch.float64,
                      device=r.device) if s0 is None else s0.double())
    ud = u.double()[None, :, :, None]
    ys = []
    for t in range(S):
        kv = kd[:, t, :, :, None] * vd[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rd[:, t], st + ud * kv))
        st = torch.exp(lw[:, t])[..., None] * st + kv
    return torch.stack(ys, 1).to(r.dtype), st.float()


def _grad_check(base, B: int, S: int, kernels: dict, ref, dev,
                label: str, floor64: bool = False) -> None:
    """One batch's gradients of ``base`` at full width with the kernels
    and, from the same weights and batch, with every sequence op the
    model calls swapped for its plain forward under autograd: in bf16,
    then in float32 at those weights.  float32: every parameter's
    gradient through the kernels within ``GRAD_TOL_F32`` of its largest
    entry of the plain run's; with ``floor64``, a float32 run with the
    recurrences' carries in float64 (:func:`_wkv6_f64`,
    :func:`_rglru_f64`) measures the plain run's own float32 error, and a
    gradient past ``GRAD_TOL_F32`` passes if it lies from that run no
    further than ``GRAD_NOISE_RATIO_F32`` x the plain run's largest such
    distance.  bf16: every gradient through the kernels no further
    (2-norm) from the float32 gradient than ``GRAD_NOISE_RATIO_BF16`` x
    the plain bf16 run's.  Each kernel run launches one backward a layer
    of each op (``kernels`` maps an op to its backward's counted
    wrapper), each other run none."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.models.model import loss_fn

    counts = _layer_counts(base)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=base.vocab_size, seq_len=S, global_batch=B,
                   seed=0)).global_batch(0).items()}
    real = {op: getattr(ops, op) for op in counts}
    stand_ins = {"plain": _plain_ops(ref),
                 "float64": dict(_plain_ops(ref), rglru_scan=_rglru_f64,
                                 wkv6=_wkv6_f64)}

    def grads(cfg, params, runs=("kernels", "plain")):
        """{"kernels": (loss, {name: grad}), "plain": (...), ...}"""
        out = {}
        for name in runs:
            before = {op: kernels[op].launches for op in counts}
            if name != "kernels":
                for op in counts:
                    setattr(ops, op, stand_ins[name][op])
            try:
                loss, _ = loss_fn(cfg, params, batch)
                loss.backward()
            finally:
                for op, fn in real.items():
                    setattr(ops, op, fn)
            for op, n in counts.items():
                got = kernels[op].launches - before[op]
                if got != (n if name == "kernels" else 0):
                    raise AssertionError(
                        f"the {name} run of {label}'s gradient check "
                        f"launched {got} {op} backward kernels")
            out[name] = (float(loss.detach()),
                         {n: p.grad for n, p in params.named_parameters()})
            for p in params.parameters():
                p.grad = None
        return out

    t0 = time.perf_counter()
    cfg16 = base
    cfg32 = dataclasses.replace(base, param_dtype="float32",
                                compute_dtype="float32")
    params = init_params(cfg16, 0, device=dev, trainable=True)
    g16 = grads(cfg16, params)
    p32 = init_params(cfg32, 0, device=dev, trainable=True)
    with torch.no_grad():
        for a, b in zip(p32.parameters(), params.parameters()):
            a.copy_(b)
    del params
    g32 = grads(cfg32, p32, ("kernels", "plain", "float64") if floor64
                else ("kernels", "plain"))
    del p32
    f32_rel, ratio, faults = {}, {}, []
    to64 = {}  # leaf -> (kernels', plain's) distance to the float64 run
    if floor64:
        for n, exact in g32["float64"][1].items():
            scale = float(exact.abs().max()) or 1.0
            to64[n] = tuple(float((g32[k][1][n] - exact).abs().max()) / scale
                            for k in ("kernels", "plain"))
        floor = max(p for _, p in to64.values())
    for n, want in g32["plain"][1].items():
        got = g32["kernels"][1][n]
        scale = float(want.abs().max()) or 1.0
        f32_rel[n] = float((got - want).abs().max()) / scale
        within = f32_rel[n] <= GRAD_TOL_F32 or (
            floor64 and to64[n][0] <= GRAD_NOISE_RATIO_F32 * floor)
        if not bool(torch.isfinite(got).all()) or not within:
            faults.append(
                f"float32: the gradient of {n} through the kernels differs "
                f"from the plain run's by {f32_rel[n]:.3e} of its largest "
                f"entry (> {GRAD_TOL_F32})" + (
                    f" and lies {to64[n][0]:.3e} from the float64 run, past "
                    f"{GRAD_NOISE_RATIO_F32} x the plain run's floor "
                    f"{floor:.3e}" if floor64 else ""))
        kern, plain_d = (float((g16[k][1][n].float() - want).norm())
                         for k in ("kernels", "plain"))
        ratio[n] = (kern, plain_d)
        if (not bool(torch.isfinite(g16["kernels"][1][n]).all())
                or kern > GRAD_NOISE_RATIO_BF16 * plain_d):
            faults.append(
                f"bf16: the gradient of {n} through the kernels is "
                f"{kern:.3e} from the float32 gradient, the plain run's "
                f"{plain_d:.3e} (more than {GRAD_NOISE_RATIO_BF16}x)")
    if faults:  # every leaf checked first, the worst float32 ones named
        worst = sorted(f32_rel, key=f32_rel.get)[-5:]
        raise AssertionError(
            f"{label} {base.name}: {len(faults)} faults, first "
            f"{faults[:4]}; the largest float32 differences " +
            ", ".join(f"{n} {f32_rel[n]:.3e}" for n in worst))
    norms = {n: float(g.norm()) or 1.0 for n, g in g32["plain"][1].items()}
    share = {n: k / max(p, 1e-30) for n, (k, p) in ratio.items()}
    worst = max(share, key=share.get)
    print(f"{label} gradient check {base.name} at full width, "
          f"{base.n_layers} layers (batch {B} x {S}), {len(f32_rel)} "
          f"parameters, kernels {sorted(counts)} against their plain "
          f"forwards: float32 through the kernels within "
          f"{max(f32_rel.values()):.3e} of each gradient's largest entry of "
          f"the plain run's (median "
          f"{float(np.median(list(f32_rel.values()))):.3e}; bound "
          f"{GRAD_TOL_F32}); bf16 distance to the float32 gradient, "
          f"relative to its norm, through the kernels up to "
          f"{max(k / norms[n] for n, (k, _) in ratio.items()):.3e}, plain "
          f"up to {max(p / norms[n] for n, (_, p) in ratio.items()):.3e}; "
          f"the largest ratio {share[worst]:.3f} ({worst}; "
          f"bound {GRAD_NOISE_RATIO_BF16}); " + (
              f"float32 against the run with the recurrences in float64: "
              f"the plain run up to {floor:.3e} of a leaf's largest entry "
              f"(the floor), the kernels up to "
              f"{max(k for k, _ in to64.values()):.3e} (bound "
              f"{GRAD_NOISE_RATIO_F32} x the floor where past "
              f"{GRAD_TOL_F32}); " if floor64 else "") +
          f"losses bf16 "
          f"{g16['kernels'][0]:.6f} / {g16['plain'][0]:.6f}, float32 "
          f"{g32['kernels'][0]:.6f} / {g32['plain'][0]:.6f} (kernels / "
          f"plain); {time.perf_counter() - t0:.1f} s", flush=True)
    del g16, g32
    gc.collect()
    torch.cuda.empty_cache()


def _grad_check_phase(FA, RS, WK, ref, dev) -> None:
    """Phase T2b: granite-3-2b at full width and depth, one batch of
    ``TRAIN``'s size, the attention kernels against the plain attention
    (:func:`_grad_check`)."""
    from repro_torch.configs import get_config
    _grad_check(get_config(TRAIN["arch"]), TRAIN["batch"], TRAIN["seq_len"],
                _bwd_kernels(FA, RS, WK), ref, dev, "T2b")


def _bwd_kernels(FA, RS, WK) -> dict:
    """Each sequence op's backward, as counted wrappers."""
    return {"flash_attention": FA.flash_attention_bwd,
            "rglru_scan": RS.rglru_scan_bwd, "wkv6": WK.wkv6_bwd}


def _grad_ratio(got, want, tol) -> float:
    """Largest |got - want| / (atol max|want| + rtol |want|), (atol, rtol)
    = ``tol`` at want's dtype: a backward's tolerance is relative to each
    gradient's largest entry.  Above 1 fails the check."""
    atol, rtol = tol[str(want.dtype)]
    g, w = got.double(), want.double()
    scale = float(w.abs().max()) or 1.0
    return float(((g - w).abs() / (atol * scale + rtol * w.abs())).max())


def _recurrence_bwd_edge_cases(RS, WK, ref, dev):
    """A6 / A7: ``wkv6_bwd`` and ``rglru_scan_bwd``, each through its
    autograd Function on the forward kernel, against autograd through the
    plain forward on the card: ``WKV_BWD_CASES`` and ``RG_BWD_CASES`` x
    (float32, bfloat16) x (strided views, dense tensors), within
    ``WKV_TOL`` / ``SCAN_TOL`` relative to each gradient's largest entry.
    Every case runs; then the worst case of a dtype past its tolerance
    raises.  Returns the number of cases and, by kernel and dtype, the
    largest share of the tolerance a case used."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(9)
    n, worst = 0, {}

    def close(kernel, tol, names, got, want, what):
        for name, g, w in zip(names, got, want):
            if w is None:
                continue
            ratio = (_grad_ratio(g, w, tol) if bool(torch.isfinite(g).all())
                     else float("inf"))
            key = (kernel, str(w.dtype))
            if ratio >= worst.get(key, (0.0,))[0]:
                err = float((g.float() - w.float()).abs().max())
                worst[key] = (ratio, f"{what} {name}, max abs err {err:.3e}")

    for B, S, logw, with_s0, with_dsl in WKV_BWD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            r, k, v, lw, u, s0 = _wkv_inputs(gen, B, S, dt, dev, logw)
            s0 = s0 if with_s0 else None
            dy = torch.randn(r.shape, generator=gen, device=dev).to(dt)
            dsl = (torch.randn((B, 64, 64, 64), generator=gen, device=dev)
                   * 0.1 if with_dsl else None)

            def run(fn, args):
                leaves = [t.detach().requires_grad_() for t in args[:5]]
                leaves.append(None if s0 is None else
                              s0.detach().requires_grad_())
                y, s_last = fn(*leaves)
                outs, cots = [y], [dy]
                if dsl is not None:
                    outs.append(s_last)
                    cots.append(dsl)
                leaves = [t for t in leaves if t is not None]
                # (one step with no s0 and no ds_last leaves logw unused)
                got = [g if g is not None else torch.zeros_like(t)
                       for g, t in zip(torch.autograd.grad(
                           outs, leaves, cots, allow_unused=True), leaves)]
                return got + [None] * (6 - len(got))

            want = run(ref.ref_wkv6, (r, k, v, lw, u))
            for args in ((r, k, v, lw, u), tuple(
                    t.contiguous() for t in (r, k, v, lw)) + (u,)):
                before = WK.wkv6_bwd.launches
                got = run(WK.wkv6, args)
                if WK.wkv6_bwd.launches != before + 1:
                    raise AssertionError("wkv6's autograd Function did not "
                                         "launch its backward once")
                close("wkv6_bwd", WKV_TOL, ("dr", "dk", "dv", "dlogw",
                                            "du", "ds0"), got, want,
                      f"wkv6_bwd at {(B, S)} {dt} logw="
                      f"{'model' if logw is None else logw} s0="
                      f"{'given' if with_s0 else 'none'} ds_last="
                      f"{'given' if with_dsl else 'none'} "
                      f"{'strided' if args[0] is r else 'dense'}")
                n += 1
    for B, S, D, with_h0 in RG_BWD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            # x and a as the model's views: (B, S, D) of (B, S, 2 D) rows
            x, a = (torch.randn((B, S, 2 * D), generator=gen, device=dev)
                    [..., :D] for _ in range(2))
            a = torch.sigmoid(a * 4.0)
            x, a = x.to(dt), a.to(dt)
            h0 = (torch.randn((B, D), generator=gen, device=dev)
                  if with_h0 else None)
            dh = torch.randn((B, S, D), generator=gen, device=dev).to(dt)

            def run(fn, args):
                leaves = [t.detach().requires_grad_() for t in args]
                if h0 is not None:
                    leaves.append(h0.detach().requires_grad_())
                got = torch.autograd.grad(
                    fn(*leaves[:2], leaves[2] if h0 is not None else None),
                    leaves, dh)
                return list(got) + [None] * (3 - len(got))

            want = run(ref.ref_rglru, (x, a))
            for args in ((x, a), (x.contiguous(), a.contiguous())):
                before = RS.rglru_scan_bwd.launches
                got = run(RS.rglru_scan, args)
                if RS.rglru_scan_bwd.launches != before + 1:
                    raise AssertionError("rglru_scan's autograd Function did "
                                         "not launch its backward once")
                close("rglru_scan_bwd", SCAN_TOL, ("dx", "da", "dh0"), got,
                      want, f"rglru_scan_bwd at {(B, S, D)} {dt} h0="
                      f"{'given' if with_h0 else 'none'} "
                      f"{'strided' if args[0] is x else 'dense'}")
                n += 1
    torch.cuda.synchronize()
    for key, (ratio, what) in sorted(worst.items()):
        tol = WKV_TOL if key[0] == "wkv6_bwd" else SCAN_TOL
        print(f"  worst {key[0]} {key[1]} case: {ratio:.3f} of the "
              f"tolerance {tol[key[1]]}, {what}")
    for key, (ratio, what) in worst.items():
        if ratio > 1.0:
            raise AssertionError(f"{what}: past the tolerance of autograd "
                                 f"through its plain version")
    return n, {f"{k} {d}": round(r, 3) for (k, d), (r, _) in worst.items()}


def _graph_replays_equal(fn, what: str) -> None:
    """``fn`` captured once in a CUDA graph and replayed 20 times: every
    replay's outputs equal the eager call's, bit for bit."""
    import torch
    first = [t.clone() for t in fn() if t is not None]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as CUDA graphs ask
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [t for t in fn() if t is not None]
    for i in range(20):
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(outs, first)):
            raise AssertionError(f"{what}: graph replay {i} differs from the "
                                 f"eager call")
    del graph


def _recurrence_bwd_records(FA, RS, WK, ref, dev, flush) -> dict:
    """The backward kernels at the training paths' own shapes (T4's RG-LRU
    (4, 1024, 2560) float32, T5's WKV (4, 1024, 64, 64) bf16; no starting
    state, s_last unused): against autograd through the plain forward, 20
    CUDA-graph replays bitwise equal, their times (graph replay, cold L2)
    beside their bounds and the plain backward's; and the forwards on the
    same shapes (T4's local attention at q (4, 10, 1024, 256) over 1 kv
    head, whose 2048-key window covers all 1024 keys, forward and
    backward, with SDPA's).  Returns {path: {kernel: record}}."""
    import torch
    B, S = RECURRENT_TRAIN_SHAPE
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    # -- recurrentgemma-2b: the RG-LRU and the local attention -------------
    D = 2560
    x, dh = (torch.randn((B, S, D), generator=gen, device=dev)
             for _ in range(2))
    a = torch.sigmoid(torch.randn((B, S, D), generator=gen, device=dev) * 4)
    h = RS.rglru_scan(x, a)
    leaves = [t.detach().requires_grad_() for t in (x, a)]
    want = torch.autograd.grad(ref.ref_rglru(*leaves), leaves, dh)
    got = RS.rglru_scan_bwd(x, a, None, dh, h)
    used = max(_grad_ratio(g, w, SCAN_TOL) for g, w in zip(got, want))
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if used > 1.0:
        raise AssertionError(f"rglru_scan_bwd at {(B, S, D)}: {used:.3f} of "
                             f"its tolerance")
    _graph_replays_equal(lambda: RS.rglru_scan_bwd(x, a, None, dh, h),
                         f"rglru_scan_bwd at {(B, S, D)}")
    bound, by = _bound_ms(kernel_costs.rglru_scan_bwd_cost(x.numel(), 4))
    rg = dict(max_abs_err=err, bound_ms=bound, bound_by=by, library_ms=None,
              ms=_time_graph_ms(lambda: RS.rglru_scan_bwd(x, a, None, dh, h),
                                flush, 20),
              plain_ms=_time_grad_graph_ms(
                  lambda *t: ref.ref_rglru(*t), leaves, dh, flush, 3))
    print(f"kernel rglru_scan_bwd at T4's {(B, S, D)} float32, plan (chunks,"
          f" steps) {RS.chunk_plan(B, S, D, _n_sms())}: max abs err "
          f"{err:.3e} = {used:.3f} of the tolerance; 20 graph replays "
          f"bitwise equal; device times (graph replay, cold L2) kernel "
          f"{rg['ms']:.4f} ms, autograd through the plain forward "
          f"{rg['plain_ms']:.4f}, bound {bound:.4f} ({by}); no PyTorch call "
          f"computes it", flush=True)
    g_ = torch.Generator(device=dev).manual_seed(12)
    aB, aH, aH_kv, aS, aD = RG_TRAIN_ATTN
    q, do = (torch.randn((aB, aH, aS, aD), generator=g_, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((aB, aH_kv, aS, aD), generator=g_, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    bwd = _bwd_case_record(FA, ref, q, k, v, do, True, flush,
                           "recurrentgemma-2b's training shape")
    _bwd_replays_equal(FA, q, k, v, do, True,
                       "recurrentgemma-2b's training shape")
    plan = FA.bwd_plan(aB, aH, aH_kv, aS, aS, aD, True, None, _n_sms())
    print(f"kernel flash_attention_bwd at recurrentgemma-2b's training "
          f"shape q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16 causal "
          f"(wgmma, {plan.n_gsplit} group shares): max abs err "
          f"{bwd['max_abs_err']:.3e} against autograd through the plain "
          f"forward; 20 replays bitwise equal; device times (graph replay, "
          f"cold L2): kernel {bwd['ms']:.4f} ms, SDPA's backward "
          f"{bwd['library_ms']:.4f} (the kernel "
          f"{bwd['ms'] / bwd['library_ms']:.2f}x it), autograd through the "
          f"plain forward {bwd['plain_ms']:.4f}, bound {bwd['bound_ms']:.4f}"
          f" ({bwd['bound_by']})", flush=True)
    out["recurrentgemma-2b training"] = dict(
        rglru_scan=_scan_record(RS, ref, x, a, None, flush),
        rglru_scan_bwd=rg,
        flash_attention=_prefill_record(FA, ref, q, k, v, True, 2048, flush),
        flash_attention_bwd=bwd)
    del x, a, h, dh, leaves, want, got, q, k, v, do
    # -- rwkv6-7b: the WKV recurrence --------------------------------------
    r, k, v, lw, u, _ = _wkv_inputs(gen, B, S, torch.bfloat16, dev)
    r, k, v, lw = (t.contiguous() for t in (r, k, v, lw))
    dy = torch.randn(r.shape, generator=gen, device=dev).to(torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (r, k, v, lw, u)]
    want = torch.autograd.grad(ref.ref_wkv6(*leaves)[0], leaves, dy)
    got = WK.wkv6_bwd(r, k, v, lw, u, None, dy)
    used = max(_grad_ratio(g, w, WKV_TOL) for g, w in zip(got, want))
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    if used > 1.0:
        raise AssertionError(f"wkv6_bwd at {tuple(r.shape)}: {used:.3f} of "
                             f"its tolerance")
    _graph_replays_equal(lambda: WK.wkv6_bwd(r, k, v, lw, u, None, dy),
                         f"wkv6_bwd at {tuple(r.shape)}")
    H, Dh = r.shape[2:]
    cost = kernel_costs.wkv6_bwd_cost(B, S, H, Dh, 2, False, False,
                                      WK.BWD_CHUNK[Dh])
    bound, by = _bound_ms(cost)
    wk = dict(max_abs_err=err, bound_ms=bound, bound_by=by, library_ms=None,
              ms=_time_graph_ms(lambda: WK.wkv6_bwd(r, k, v, lw, u, None, dy),
                                flush, 10),
              plain_ms=_time_grad_graph_ms(
                  lambda *t: ref.ref_wkv6(*t)[0], leaves, dy, flush, 3))
    print(f"kernel wkv6_bwd at T5's {tuple(r.shape)} bf16, plan (chunk, "
          f"chunks) {WK.bwd_plan(S, Dh)}, {B * H} blocks of a whole head, "
          f"workspace {WK.bwd_workspace_bytes(B, S, H, Dh):,} bytes: max abs"
          f" err {err:.3e} = {used:.3f} of the tolerance; 20 graph replays "
          f"bitwise equal; device times (graph replay, cold L2) kernel "
          f"{wk['ms']:.4f} ms, autograd through the plain forward "
          f"{wk['plain_ms']:.4f}, bound {bound:.4f} ({by}; "
          f"{cost[0] / 1e9:.1f} GFLOP split TF32, {cost[1] / 1e6:.1f} MB), "
          f"the kernel {wk['ms'] / bound:.1f}x it; no PyTorch call computes "
          f"it", flush=True)
    out["rwkv6-7b training"] = dict(
        wkv6=_wkv_record(WK, ref, r, k, v, lw, u, None, flush), wkv6_bwd=wk)
    del r, k, v, lw, u, dy, leaves, want, got
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _reckon_train_gib(cfg, B: int, S: int):
    """(GiB, text): what a training step at ``B`` x ``S`` holds at its
    peak, reckoned: bf16 parameters and gradients and float32 AdamW
    moments (12 bytes a parameter), the float32 logits with their
    gradient and the softmax's (three of B S vocab), the layer inputs kept
    under remat, and ``TRAIN_ALLOWANCE_GIB`` for one layer's recompute and
    its backward's scratch."""
    gib = 2.0 ** 30
    n = cfg.n_params()
    parts = dict(params_grads_moments=12 * n,
                 logits=3 * B * S * cfg.vocab_size * 4,
                 layer_inputs=cfg.n_layers * B * S * cfg.d_model * 2)
    total = sum(parts.values()) / gib + TRAIN_ALLOWANCE_GIB
    return total, (f"{n:,} parameters: bf16 params, grads and float32 "
                   f"moments {parts['params_grads_moments'] / gib:.2f} GiB, "
                   f"float32 logits x 3 {parts['logits'] / gib:.2f}, layer "
                   f"inputs under remat {parts['layer_inputs'] / gib:.2f}, "
                   f"one layer and its scratch {TRAIN_ALLOWANCE_GIB:.2f}: "
                   f"{total:.2f} GiB")


def _recurrent_train_phase(arch: str, FA, RS, WK, dev) -> dict:
    """Phases T4 / T5: ``arch`` at full width trained by the port's
    ``Trainer`` (bf16, remat on) for ``TRAIN["steps"]`` steps on
    ``SyntheticLM`` at ``RECURRENT_TRAIN_SHAPE``; at full depth, or cut
    to the deepest depth whose reckoned peak (:func:`_reckon_train_gib`)
    stays under ``TRAIN_PEAK_GIB`` (at least ``TRAIN_MIN_LAYERS``).  Per
    step the loss (finite), ms, tokens/s, peak memory and every sequence
    kernel's launches, exactly one backward a layer of its kind and two
    forwards (the forward and its recompute); the last step traced, its
    device time by kind.  Returns the launches over the run, the depth,
    the steady step, tokens/s and the peak."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.train_loop import Trainer

    base = get_config(arch)
    B, S = RECURRENT_TRAIN_SHAPE
    gib = 2.0 ** 30
    cfg, cut = base, ""
    if _reckon_train_gib(base, B, S)[0] > TRAIN_PEAK_GIB:
        depth = max(L for L in range(TRAIN_MIN_LAYERS, base.n_layers + 1)
                    if _reckon_train_gib(dataclasses.replace(
                        base, n_layers=L), B, S)[0] <= TRAIN_PEAK_GIB)
        cfg = dataclasses.replace(base, n_layers=depth)
        cut = (f" (reduced: depth, {depth} of {base.n_layers} layers; full "
               f"depth reckons {_reckon_train_gib(base, B, S)[0]:.2f} GiB)")
    label = "T4" if arch == "recurrentgemma-2b" else "T5"
    counts = _layer_counts(cfg)
    fwd = {"flash_attention": FA.flash_attention,
           "rglru_scan": RS.rglru_scan, "wkv6": WK.wkv6}
    bwd = _bwd_kernels(FA, RS, WK)
    print(f"{label} train {cfg.name}: {cfg.n_layers} layers{cut}, d_model "
          f"{cfg.d_model}, remat {cfg.remat}, batch {B} x {S} tokens, kernels"
          f" a forward {counts}; reckoned: "
          f"{_reckon_train_gib(cfg, B, S)[1]}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ckpt = _ckpt_dir()
    t0 = time.perf_counter()
    trainer = Trainer(
        cfg, str(ckpt), opt_cfg=AdamWConfig(lr=3e-4, warmup_steps=2,
                                            total_steps=100),
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                            global_batch=B, seed=0),
        n_virtual_workers=4, ckpt_every=10 ** 6, device=dev)
    torch.cuda.synchronize()
    print(f"  init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / gib:.2f} GiB allocated",
          flush=True)
    # the main path's counts: set to 0 just before it runs
    for op in counts:
        fwd[op].launches = 0
        bwd[op].launches = 0
    losses, times = [], []
    for i in range(TRAIN["steps"]):
        before = {op: (fwd[op].launches, bwd[op].launches) for op in counts}
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i + 1 < TRAIN["steps"]:
            m = trainer.run_step()  # ends reading the metrics: synchronized
        else:  # the last step traced: where its device time goes
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                m = trainer.run_step()
        dt = time.perf_counter() - t
        step = {op: (fwd[op].launches - f0, bwd[op].launches - b0)
                for op, (f0, b0) in before.items()}
        losses.append(m["loss"])
        times.append(dt)
        print(f"  step {m['step']}: loss {m['loss']:.4f} (ce {m['ce']:.4f}),"
              f" grad_norm {m['grad_norm']:.3f}, lr {m['lr']:.2e}; "
              f"{dt * 1e3:.1f} ms, {B * S / dt:.0f} tokens/s; peak "
              f"{torch.cuda.max_memory_allocated() / gib:.2f} GiB; launches "
              f"(forward, backward) {step}", flush=True)
        for op, (nf, nb) in step.items():
            want_f = counts[op] * (2 if cfg.remat else 1)
            if nf != want_f or nb != counts[op]:
                raise AssertionError(
                    f"{label}: a step launched {nf} {op} and {nb} of its "
                    f"backward, not {want_f} and {counts[op]}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite training loss: {losses}")
    print(_device_breakdown(prof, times[-1], store=False), flush=True)
    steady = float(np.median(times[1:-1]))
    peak = torch.cuda.max_memory_allocated() / gib
    launches = {}
    for op in counts:
        launches[op] = fwd[op].launches
        launches[op + "_bwd"] = bwd[op].launches
    print(f"{label} train {cfg.name}: losses {[round(x, 4) for x in losses]}"
          f" all finite; exactly one backward a layer of each kind and two "
          f"forwards; steady step {steady * 1e3:.1f} ms (median of steps "
          f"2-{len(times) - 1}), {B * S / steady:.0f} tokens/s, peak "
          f"{peak:.2f} GiB (reckoned {_reckon_train_gib(cfg, B, S)[0]:.2f})",
          flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    import shutil
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(launches=launches, layers=cfg.n_layers, step_ms=steady * 1e3,
                tokens_per_s=B * S / steady, peak_gib=peak)


def _recurrent_grad_phase(arch: str, layers: int, FA, RS, WK, ref,
                          dev) -> None:
    """Phases T4b / T5b: ``arch`` at full width, ``layers`` deep, one batch
    of ``RECURRENT_GRAD_SHAPE`` (batch 1 x 256 tokens: autograd through the
    plain serial WKV keeps a float32 state a step and head) through the
    kernels against the plain forwards (:func:`_grad_check`)."""
    from repro_torch.configs import get_config
    base = get_config(arch)
    if layers != base.n_layers:
        base = dataclasses.replace(base, n_layers=layers)
    B, S = RECURRENT_GRAD_SHAPE
    label = "T4b" if arch == "recurrentgemma-2b" else "T5b"
    cut = ("" if layers == get_config(arch).n_layers else
           f", reduced: depth {layers}")
    print(f"{label}: {arch} at full width, batch {B} x {S} tokens (reduced: "
          f"batch and length{cut})", flush=True)
    _grad_check(base, B, S, _bwd_kernels(FA, RS, WK), ref, dev, label,
                floor64=True)


def _fault_phase(dev) -> None:
    """Phase T3: the trainer's fault path at full width, granite-3-2b cut
    to ``FAULT_LAYERS`` layers: a checkpoint through the grid store and
    the coordinator, a step past it, ``crash_and_recover`` (params and
    moments bitwise equal to the saved ones, training resumes at the
    committed step), a straggler step and ``scale_workers`` committing
    through the coordinator."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.train_loop import Trainer

    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              n_layers=FAULT_LAYERS)
    ckpt = _ckpt_dir()
    trainer = Trainer(cfg, str(ckpt), data_cfg=DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN["seq_len"],
        global_batch=TRAIN["batch"], seed=1), n_virtual_workers=3,
        ckpt_every=10 ** 6, device=dev)
    trainer.run(2)
    t0 = time.perf_counter()
    trainer.checkpoint()
    t_save = time.perf_counter() - t0
    saved = {n: p.detach().cpu().clone()
             for n, p in trainer.state.params.named_parameters()}
    moments = {part: {n: t.cpu().clone()
                      for n, t in trainer.state.opt_state[part].items()}
               for part in ("m", "v")}
    trainer.run_step()
    t0 = time.perf_counter()
    step = trainer.crash_and_recover()
    t_restore = time.perf_counter() - t0
    if step != 2 or trainer.coord.view.committed_ckpt != 2:
        raise AssertionError(f"restored step {step}, committed "
                             f"{trainer.coord.view.committed_ckpt}")
    for n, p in trainer.state.params.named_parameters():
        if not torch.equal(p.detach().cpu(), saved[n]):
            raise AssertionError(f"restored parameter {n} differs")
    for part in ("m", "v"):
        for n, t in trainer.state.opt_state[part].items():
            if not torch.equal(t.cpu(), moments[part][n]):
                raise AssertionError(f"restored moment {part}/{n} differs")
    m = trainer.run_step(straggler=1)
    if not np.isfinite(m["loss"]) or m["step"] != 2:
        raise AssertionError(f"the step after recovery: {m}")
    view = trainer.coord.view
    if view.committed_step < 1 or not any(view.step_noops.values()):
        raise AssertionError("the straggler's step did not commit by noops")
    g0 = view.generation
    trainer.scale_workers(5)
    trainer.run_step()
    view = trainer.coord.view
    if (len(view.workers) != 5 or view.generation <= g0
            or view.committed_step != 3):
        raise AssertionError(f"scale_workers: {view}")
    n_bytes = sum(t.numel() * t.element_size() for t in saved.values()) + \
        sum(t.numel() * 4 for part in moments.values() for t in part.values())
    print(f"fault path {cfg.name} cut to {FAULT_LAYERS} layers (reduced: "
          f"depth 40 -> {FAULT_LAYERS}): checkpoint of {n_bytes / 2**30:.2f}"
          f" GiB (params and moments, written to 2 rows x 2 columns) in "
          f"{t_save:.1f} s, crash_and_recover in {t_restore:.1f} s: "
          f"{len(saved)} parameters and their moments bitwise equal to the "
          f"saved ones; the straggler's step committed by noop fills, "
          f"scale_workers(5) committed step {view.committed_step} "
          f"(generation {view.generation})", flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt, ignore_errors=True)


def _whisper_phase(FA, FD, ref, dev, flush) -> dict:
    """Phase W: whisper-tiny at full width and depth (4 encoder and 4
    decoder layers, d_model 384, 6 heads of 64, vocab 51,865, bf16,
    random seeded weights): a prefill over random frames (B, 1500, 384)
    and 32 greedy decode steps, with the attention launches per prefill
    (4 non-causal encoder, 4 causal decoder, 4 cross) and per decode step
    (8 ``flash_decode``: self and cross) checked; the encoder's, the
    decoder's causal and the cross-attention's ``flash_attention`` and the
    cross ``flash_decode`` against their plain versions on the tensors
    the path handed them; the smoke config in float32 on the card against
    the CPU; one ``make_train_step`` step with frames, so the backward
    runs at S_q != S_k, and the backward of each kind of attention
    against autograd through the plain forward on the q, k, v and the
    direction of the cotangent that step gave it (scaled to a largest
    entry of 1, so ``BWD_TOL``'s atol does not swallow the error)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, forward, init_params, prefill
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime.steps import make_train_step

    cfg = get_config("whisper-tiny")
    B, P, new = WHISPER["batch"], WHISPER["prompt"], WHISPER["new"]
    params = init_params(cfg, 0, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    frames = torch.randn((B, cfg.encoder_seq_len, cfg.d_model), generator=g,
                         device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                           device=dev, dtype=torch.int32)
    kinds = collections.Counter()
    caught = {}
    real_fa, real_fd = ops.flash_attention, ops.flash_decode

    def catch_fa(q, k, v, *, causal=True, window=None):
        kind = ("cross" if q.shape[2] != k.shape[2] else
                "causal" if causal else "encoder")
        kinds[kind] += 1
        caught.setdefault(kind, (q, k, v))
        return real_fa(q, k, v, causal=causal, window=window)

    def catch_fd(q, k_cache, v_cache, cache_len):
        kinds["decode"] += 1
        if k_cache.shape[2] == cfg.encoder_seq_len:
            caught["cross_decode"] = (q, k_cache, v_cache, cache_len)
        return real_fd(q, k_cache, v_cache, cache_len)

    ops.flash_attention, ops.flash_decode = catch_fa, catch_fd
    try:
        FA.flash_attention.launches = FD.flash_decode.launches = 0
        with torch.inference_mode():
            logits, caches = prefill(cfg, params, tokens, frames=frames,
                                     cache_len=P + new)
            fa_prefill = FA.flash_attention.launches
            want = {"encoder": cfg.n_encoder_layers, "causal": cfg.n_layers,
                    "cross": cfg.n_layers}
            if dict(kinds) != want or fa_prefill != sum(want.values()):
                raise AssertionError(f"whisper prefill launched {dict(kinds)}"
                                     f" ({fa_prefill} kernels), not {want}")
            tok, out = tokens[:, -1:], []
            for _ in range(new):
                before = FD.flash_decode.launches
                logits, caches = decode_step(cfg, params, caches, tok)
                if FD.flash_decode.launches - before != 2 * cfg.n_layers:
                    raise AssertionError(f"a whisper decode step did not "
                                         f"launch {2 * cfg.n_layers} "
                                         f"flash_decode")
                tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                out.append(tok)
            out = torch.cat(out, dim=1)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("non-finite whisper logits")
        launches = dict(flash_attention=FA.flash_attention.launches,
                        flash_decode=FD.flash_decode.launches)
    finally:
        ops.flash_attention, ops.flash_decode = real_fa, real_fd
    print(f"whisper-tiny at full width and depth ({cfg.n_encoder_layers} "
          f"encoder + {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}, bf16, "
          f"{cfg.n_params():,} parameters): prefill of {P} tokens over frames "
          f"{tuple(frames.shape)} launched {want} flash_attention; {new} "
          f"greedy decode steps, {2 * cfg.n_layers} flash_decode each "
          f"({cfg.n_layers} self, {cfg.n_layers} cross against "
          f"{cfg.encoder_seq_len} rows); tokens {out[0, :8].tolist()}...",
          flush=True)

    # each kind of attention's kernel on the tensors the path handed it
    shapes = {}
    for kind in ("encoder", "causal", "cross"):
        q, k, v = caught[kind]
        causal = kind == "causal"
        err = _close("flash_attention",
                     FA.flash_attention(q, k, v, causal=causal),
                     ref.ref_attention(q, k, v, causal=causal),
                     f"whisper {kind} {tuple(q.shape)} x {tuple(k.shape)}")
        bound, by = _attention_bound_ms(q, k, causal)
        shapes[kind] = dict(
            max_abs_err=err,
            ms=_time_graph_ms(lambda: FA.flash_attention(
                q, k, v, causal=causal), flush, 20),
            plain_ms=_time_graph_ms(lambda: ref.ref_attention(
                q, k, v, causal=causal), flush, 5),
            library_ms=_time_graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal), flush, 20),
            bound_ms=bound, bound_by=by)
        print(f"kernel flash_attention at whisper's {kind} attention q "
              f"{tuple(q.shape)}, k/v {tuple(k.shape)} {q.dtype}: max abs "
              f"err {err:.3e}; device times " + ", ".join(
                  f"{key} {val:.4f}" for key, val in shapes[kind].items()
                  if key.endswith("ms")) + f" ({by})", flush=True)
    fa_rec = dict(shapes["cross"], launches=launches["flash_attention"],
                  shapes=shapes)
    fd_rec = _decode_record(FD, ref, *caught["cross_decode"], flush)
    fd_rec["launches"] = launches["flash_decode"]

    # the smoke config in float32: the card against the CPU
    small = get_config("whisper-tiny").smoke()
    on_cpu = init_params(small, 0, device="cpu")
    on_gpu = copy.deepcopy(on_cpu).to(dev)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, small.vocab_size, (2, 24))
                            .astype(np.int32))
    fr = torch.from_numpy(rng.standard_normal(
        (2, small.encoder_seq_len, small.d_model)).astype(np.float32))
    lc, _ = forward(small, on_cpu, toks, frames=fr)
    lg, _ = forward(small, on_gpu, toks.to(dev), frames=fr.to(dev))
    np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), rtol=1e-4,
                               atol=1e-4)
    greedy = []
    for d, p in (("cpu", on_cpu), (dev, on_gpu)):
        _, c = prefill(small, p, toks[:1].to(d), frames=fr[:1].to(d),
                       cache_len=24 + 8)
        t, seq = toks[:1, -1:].to(d), []
        for _ in range(8):
            lo, c = decode_step(small, p, c, t)
            t = torch.argmax(lo, dim=-1).to(torch.int32)[:, None]
            seq.append(int(t[0, 0]))
        greedy.append(seq)
    if greedy[0] != greedy[1]:
        raise AssertionError(f"whisper greedy tokens differ: {greedy}")

    # one train step with frames: the cross-attention backward at S_q !=
    # S_k; each kind's first call caught with its output's cotangent
    params.requires_grad_(True)
    labels = torch.roll(tokens, -1, dims=1)
    in_step = {}

    def catch_train(q, k, v, *, causal=True, window=None):
        out = real_fa(q, k, v, causal=causal, window=window)
        kind = ("cross" if q.shape[2] != k.shape[2] else
                "causal" if causal else "encoder")
        if kind not in in_step:  # the recompute under remat is skipped
            in_step[kind] = [q.detach(), k.detach(), v.detach(), None]
            out.register_hook(
                lambda g, kind=kind: in_step[kind].__setitem__(3, g))
        return out

    b0 = FA.flash_attention_bwd.launches
    ops.flash_attention = catch_train
    try:
        _, _, m = make_train_step(cfg)(params, init_opt_state(params), {
            "tokens": tokens, "labels": labels, "frames": frames})
        n_bwd = FA.flash_attention_bwd.launches - b0
    finally:
        ops.flash_attention = real_fa
    if (not np.isfinite(float(m["loss"]))
            or n_bwd != cfg.n_encoder_layers + 2 * cfg.n_layers):
        raise AssertionError(f"whisper train step: loss {float(m['loss'])}, "
                             f"{n_bwd} flash_attention_bwd launches")
    bwd_shapes = {}
    for kind in ("encoder", "causal", "cross"):
        q, k, v, g_out = in_step[kind]
        if g_out is None:
            raise AssertionError(f"whisper's {kind} attention got no "
                                 f"cotangent in the train step")
        do = g_out / g_out.abs().max()
        bwd_shapes[kind] = _bwd_case_record(
            FA, ref, q, k, v, do, kind == "causal", flush,
            f"whisper's {kind} train-step attention {tuple(q.shape)} x "
            f"{tuple(k.shape)}")
        if kind == "cross":  # dq summed over key splits
            _bwd_replays_equal(FA, q, k, v, do, False,
                               "whisper's cross attention")
        print(f"kernel flash_attention_bwd at whisper's {kind} attention q "
              f"{tuple(q.shape)}, k/v {tuple(k.shape)} {q.dtype} (the train "
              f"step's tensors and cotangent direction): max abs err "
              f"{bwd_shapes[kind]['max_abs_err']:.3e} against autograd "
              f"through the plain forward; device times (graph replay, cold "
              f"L2) " + ", ".join(
                  f"{key} {val:.4f}" for key, val in bwd_shapes[kind].items()
                  if key.endswith("ms")) +
              f" ({bwd_shapes[kind]['bound_by']})" +
              ("; 20 replays bitwise equal" if kind == "cross" else ""),
              flush=True)
    bwd_rec = dict(bwd_shapes["cross"], launches=n_bwd, shapes=bwd_shapes)
    print(f"whisper-tiny: cuda == cpu on the float32 smoke config (logits "
          f"within 1e-4, max abs diff {float((lg.cpu() - lc).abs().max()):.2e};"
          f" 8 greedy tokens equal); one train step with frames: loss "
          f"{float(m['loss']):.4f}, grad_norm {float(m['grad_norm']):.3f}, "
          f"{n_bwd} flash_attention_bwd ({cfg.n_encoder_layers} encoder, "
          f"{cfg.n_layers} causal, {cfg.n_layers} cross at S_q {P} x S_k "
          f"{cfg.encoder_seq_len})", flush=True)
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return dict(flash_attention=fa_rec, flash_decode=fd_rec,
                flash_attention_bwd=bwd_rec)


def _policy_table() -> None:
    """Phase D1: ``ShardingPolicy`` on both production mesh shapes for all
    10 configs: each device's bytes of bf16 parameters and float32 moments
    (m and v), with and without ZeRO-1, beside the card's memory.  Host
    arithmetic on meta tensors."""
    import torch
    from repro_torch.configs import all_configs, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.sharding import ShardingPolicy, _axes
    from repro_torch.runtime.steps import params_specs

    gib = 2.0 ** 30
    card = torch.cuda.get_device_properties(0).total_memory / gib
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rows = []
        for arch in sorted(all_configs()):
            cfg = get_config(arch)
            model = params_specs(cfg)
            numel = {n: p.numel() for n, p in model.named_parameters()}

            def per_device(specs, width):
                total = 0
                for n, spec in specs.items():
                    parts = 1
                    for entry in spec:
                        for a in _axes(entry):
                            parts *= mesh.shape[a]
                    total += numel[n] * width / parts
                return total / gib

            pol = ShardingPolicy(cfg, mesh)
            z1 = ShardingPolicy(cfg, mesh, zero1=True)
            params = per_device(pol.params_shardings(model), 2)
            moments = per_device(pol.opt_state_shardings(model)["m"], 8)
            moments_z1 = per_device(z1.opt_state_shardings(model)["m"], 8)
            rows.append(f"{arch} {params:.3f} + {moments:.3f} "
                        f"({moments_z1:.3f} ZeRO-1)")
            del model
        print(f"D1 ShardingPolicy on {mesh.shape}: per device, bf16 params "
              f"+ float32 moments GiB (card {card:.1f} GiB): "
              + "; ".join(rows), flush=True)


def _host_slots(top_i: np.ndarray, capacity: int):
    """Each (token, choice) pair's place in its expert's bucket by a loop
    on the host, in (token, choice) order (the a2a dispatch's), and
    whether it is kept."""
    T, k = top_i.shape
    slot = np.zeros((T, k), np.int64)
    seen = collections.Counter()
    for t in range(T):
        for j in range(k):
            slot[t, j] = seen[top_i[t, j]]
            seen[top_i[t, j]] += 1
    kept = slot < capacity
    return np.where(kept, slot, -1), kept


# -- the distributed checks: run by every rank of an initialised group, at
# one rank in phase D and at four in scripts/distributed_nccl.py ----------


def _say(text: str) -> None:
    """Print on rank 0 of the group."""
    import torch.distributed as dist
    if dist.get_rank() == 0:
        print(text, flush=True)


def _mesh_str(mesh) -> str:
    return str(dict(zip(mesh.mesh_dim_names, mesh.shape)))


def _dist_sync(dev) -> None:
    import torch
    import torch.distributed as dist
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()


def _dist_ms(fn, dev, reps: int) -> float:
    """ms a call of ``fn``: CUDA events on the card (after two warm-up
    calls), else the host clock's median, every rank in step."""
    if dev.type == "cuda":
        return _time_ms(fn, 2, reps)
    times = []
    for _ in range(3):
        _dist_sync(dev)
        t0 = time.perf_counter()
        fn()
        _dist_sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _dist_train(FA, dev, mesh, cfg, B: int, S: int, tag: str = ""
                ) -> tuple:
    """One ZeRO-1 sharded train step of ``cfg`` on ``mesh`` (data, model)
    against the unsharded step on the whole batch on each rank, from the
    same weights: the loss and grad norm within 1e-5 of themselves, every
    parameter within Adam's step of two learning rates plus a bf16
    rounding of itself, every rank holding the same parameters, and on
    the card exactly ``2 n_layers`` ``flash_attention`` and ``n_layers``
    ``flash_attention_bwd`` launches (counted over the sharded step
    only).  Prints the times and, on the card, each step's peak device
    memory above what it started from, beside what each keeps (parameters
    and moments).  Returns (the numbers, the launches, the unsharded
    step's gradients)."""
    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime.sharding import (ShardingPolicy,
                                              distribute_model,
                                              sharded_opt_state)
    from repro_torch.runtime.steps import make_train_step

    cuda = dev.type == "cuda"
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=100)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                   seed=2)).global_batch(0).items()}
    plain = init_params(cfg, 5, device=dev, trainable=True)
    sharded = copy.deepcopy(plain).requires_grad_(False)
    step = make_train_step(cfg, opt_cfg)
    warm = copy.deepcopy(plain)  # the first step's one-off set-up, untimed
    step(warm, init_opt_state(warm), batch)
    del warm
    opt_plain = init_opt_state(plain)
    policy = ShardingPolicy(cfg, mesh, zero1=True)
    distribute_model(sharded, policy)
    opt = sharded_opt_state(policy, sharded)
    sharded_step = make_train_step(cfg, opt_cfg, policy=policy)

    def kept(params, state):  # bytes a rank keeps: parameters and moments
        def own(t):
            t = t.to_local() if hasattr(t, "to_local") else t
            return t.numel() * t.element_size()
        return (sum(own(p) for p in params.parameters())
                + sum(own(t) for part in ("m", "v")
                      for t in state[part].values()))

    def run(fn, params, state):  # (metrics, host ms, peak bytes above)
        _dist_sync(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        _, _, metrics = fn(params, state, batch)
        _dist_sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - base if cuda else 0
        return metrics, ms, peak

    m_plain, plain_ms, plain_peak = run(step, plain, opt_plain)
    grads = {n: p.grad for n, p in plain.named_parameters()}
    FA.flash_attention.launches = FA.flash_attention_bwd.launches = 0
    m_sharded, ms, peak = run(sharded_step, sharded, opt)
    launches = dict(flash_attention=FA.flash_attention.launches,
                    flash_attention_bwd=FA.flash_attention_bwd.launches)
    if cuda and launches != dict(flash_attention=2 * cfg.n_layers,
                                 flash_attention_bwd=cfg.n_layers):
        raise AssertionError(f"sharded step: launched {launches}, not "
                             f"{2 * cfg.n_layers} forward and "
                             f"{cfg.n_layers} backward")
    loss = {k: (float(m_plain[k]), float(m_sharded[k]))
            for k in ("loss", "grad_norm")}
    if any(abs(a - b) > 1e-5 * abs(a) for a, b in loss.values()):
        raise AssertionError(f"sharded step against unsharded: {loss}")
    named = dict(sharded.named_parameters())
    n_equal, n_all, worst, digest = 0, 0, 0.0, []
    for n, p in plain.named_parameters():
        got, want = named[n].full_tensor().float(), p.detach().float()
        d = (got - want).abs()
        bound = 2 * opt_cfg.lr + want.abs() * 2.0 ** -7
        worst = max(worst, float((d / bound).max()))
        n_equal += int((d == 0).sum())
        n_all += d.numel()
        digest.append(float(got.double().sum()))
    if worst > 1.0:
        raise AssertionError(f"sharded step: a parameter {worst:.3f} of "
                             f"its bound off the unsharded step's")
    sums = [None] * dist.get_world_size()
    dist.all_gather_object(sums, digest)
    if any(s != sums[0] for s in sums):
        raise AssertionError("sharded step: the ranks hold different "
                             "parameters")
    gib = 2.0 ** 30
    emb = named["embed.tokens"].placements
    n_z1 = sum(m.placements[0].is_shard() for m in opt["m"].values())
    memory = (f"; a rank keeps {kept(sharded, opt) / gib:.3f} GiB of "
              f"parameters and moments (unsharded "
              f"{kept(plain, opt_plain) / gib:.3f}) and the step peaks "
              f"{peak / gib:.3f} GiB above what it started from (unsharded "
              f"{plain_peak / gib:.3f})" if cuda else "")
    _say(f"{tag}sharded ZeRO-1 train step of {cfg.name} ({cfg.n_layers} "
         f"layers, {cfg.dtype()}, remat {cfg.remat}) on {_mesh_str(mesh)}"
         f", batch {B} x {S}: loss {loss['loss'][1]:.6f} (unsharded on the "
         f"whole batch {loss['loss'][0]:.6f}), grad_norm "
         f"{loss['grad_norm'][1]:.6f} ({loss['grad_norm'][0]:.6f}); "
         f"{n_equal / n_all:.4f} of the parameters' elements bitwise equal "
         f"to the unsharded step's, the rest within {worst:.3f} of 2 lr + "
         f"a bf16 step; every rank the same parameters; embedding {emb}, "
         f"{n_z1} of {len(opt['m'])} moments on 'data'; attention launches "
         f"{launches}; {ms:.1f} ms (host clock; unsharded {plain_ms:.1f})"
         + memory)
    rec = dict(ms=ms, plain_ms=plain_ms, loss=loss["loss"][1],
               loss_unsharded=loss["loss"][0], equal_share=n_equal / n_all,
               worst=worst, peak_gib=peak / gib,
               plain_peak_gib=plain_peak / gib,
               kept_gib=kept(sharded, opt) / gib,
               plain_kept_gib=kept(plain, opt_plain) / gib)
    del plain, sharded, opt, opt_plain
    return rec, launches, grads


def _dist_a2a_train(dev, mesh, cfg, B: int, S: int, tag: str = "") -> dict:
    """The sharded train step of the MoE model ``cfg`` with
    ``moe_impl="a2a"`` on ``mesh`` (data, model) - the layer's rows split
    over "model", its parameters' gradients summed there - against the
    unsharded step with the dense MoE layer on the whole batch on each
    rank, from the same weights.  The capacity factor is E / top_k, so
    every expert could take every token and no choice drops, and both
    steps run ``loss_fn`` with ``aux_coef`` 0: the a2a layer averages the
    load-balance loss over the ranks' rows (the reference's estimator)
    where the dense layer takes it over all tokens (both printed; on few
    tokens a rank they differ by tens of percent), so with it in the loss
    the router's gradients would differ by design.  The two steps then
    differ only in the order of their sums, and the check holds the
    gradient itself: AdamW's first moment after its first step is
    ``(1 - beta1)`` times the clipped gradient, so each parameter's moment
    on the a2a side, gathered whole, is within ``A2A_GRAD_RTOL`` of the
    dense side's (relative to its norm), and the global ``grad_norm``
    (before clipping) within ``A2A_GRAD_RTOL`` of the dense side's.  A gradient left unsummed
    over "model", summed twice, or zero moves the first, or the second
    where every parameter scales alike.  Also held: the cross-entropy
    within ``A2A_CE_RTOL``, every parameter within two learning rates
    (each side's first Adam step) plus each side's rounding to bf16,
    every rank the same parameters, and exactly two
    ``all_to_all_single`` a MoE layer call (forward, its remat recompute,
    backward).  Prints the times; returns the numbers."""
    import functools
    from unittest import mock

    import torch
    import torch.distributed as dist
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.models import model as model_lib
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.runtime import collectives as C
    from repro_torch.runtime.sharding import (ShardingPolicy,
                                              distribute_model,
                                              sharded_opt_state)
    from repro_torch.runtime.steps import make_train_step

    m = cfg.moe
    a2a = dataclasses.replace(cfg, moe_impl="a2a", moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    dense = dataclasses.replace(a2a, moe_impl="dense")
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=0, total_steps=100)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                   seed=3)).global_batch(0).items()}
    # the same weights: the two configs differ only in the MoE layer's
    # formulation, which the draws do not depend on
    plain = init_params(dense, 6, device=dev, trainable=True)
    sharded = init_params(a2a, 6, device=dev)
    policy = ShardingPolicy(a2a, mesh)
    distribute_model(sharded, policy)
    opt = sharded_opt_state(policy, sharded)
    opt_plain = init_opt_state(plain)
    no_aux = functools.partial(model_lib.loss_fn, aux_coef=0.0)

    def run(fn, params, state):
        _dist_sync(dev)
        t0 = time.perf_counter()
        with mock.patch.object(model_lib, "loss_fn", no_aux):
            _, _, metrics = fn(params, state, batch)
        _dist_sync(dev)
        return metrics, (time.perf_counter() - t0) * 1e3

    m_plain, plain_ms = run(make_train_step(dense, opt_cfg), plain,
                            opt_plain)
    C.reset_counts()
    m_a2a, ms = run(make_train_step(a2a, opt_cfg, policy=policy), sharded,
                    opt)
    n_moe = sum(cfg.channel_kind(i) == "moe" for i in range(cfg.n_layers))
    want = n_moe * (6 if cfg.remat else 4)
    if C.CALLS["all_to_all_single"] != want:
        raise AssertionError(f"a2a step: {C.CALLS['all_to_all_single']} "
                             f"all_to_all_single, not {want}")
    rtol = A2A_CE_RTOL[str(cfg.dtype())]
    ce = (float(m_plain["ce"]), float(m_a2a["ce"]))
    aux = (float(m_plain["aux"]), float(m_a2a["aux"]))
    norm = (float(m_plain["grad_norm"]), float(m_a2a["grad_norm"]))
    if abs(ce[0] - ce[1]) > rtol * abs(ce[0]):
        raise AssertionError(f"a2a step against the dense one: ce {ce}")
    named = dict(sharded.named_parameters())
    worst, digest, grad_err = 0.0, [], {}
    for n, p in plain.named_parameters():
        got, want_p = named[n].full_tensor().float(), p.detach().float()
        # each side's first Adam step is at most lr, and each side rounds
        # its new value to the parameter's dtype (half a bf16 step: 2^-8
        # of the value)
        bound = 2 * opt_cfg.lr + (got.abs() + want_p.abs()) * 2.0 ** -8
        worst = max(worst, float(((got - want_p).abs() / bound).max()))
        digest.append(float(got.double().sum()))
        g_a2a, g_dense = opt["m"][n].full_tensor(), opt_plain["m"][n]
        grad_err[n] = float(torch.linalg.vector_norm(g_a2a - g_dense)
                            / torch.linalg.vector_norm(g_dense).clamp(
                                min=1e-30))
    sums = [None] * dist.get_world_size()
    dist.all_gather_object(sums, digest)
    grad_tol = A2A_GRAD_RTOL[str(cfg.dtype())]
    g_name = max(grad_err, key=grad_err.get)
    moe_err = max(e for n, e in grad_err.items() if ".moe." in f".{n}")
    _say(f"{tag}sharded train step of {cfg.name} ({cfg.n_layers} layers, "
         f"{cfg.dtype()}, remat {cfg.remat}) with moe_impl='a2a' on "
         f"{_mesh_str(mesh)}, batch {B} x {S}, capacity factor "
         f"{m.n_experts / m.top_k:.2f} (drop-free), aux_coef 0: ce "
         f"{ce[1]:.6f} (the dense layer unsharded {ce[0]:.6f}), grad_norm "
         f"{norm[1]:.6f} ({norm[0]:.6f}), aux {aux[1]:.6f} ({aux[0]:.6f}, "
         f"not in the loss); each parameter's gradient (AdamW's first "
         f"moment) within {grad_err[g_name]:.3e} of the dense step's, "
         f"relative to its norm ({g_name}; the MoE layers' parameters "
         f"within {moe_err:.3e}; bound {grad_tol:g}); every parameter "
         f"within {worst:.3f} of 2 lr + both sides' bf16 rounding; every "
         f"rank the same parameters: {all(x == sums[0] for x in sums)}; "
         f"{C.CALLS['all_to_all_single']} "
         f"all_to_all_single ({n_moe} MoE layer(s)); {ms:.1f} ms (host "
         f"clock; unsharded dense {plain_ms:.1f})")
    if abs(norm[0] - norm[1]) > grad_tol * abs(norm[0]):
        raise AssertionError(f"a2a step against the dense one: grad_norm "
                             f"{norm}")
    if grad_err[g_name] > grad_tol:
        raise AssertionError(f"a2a step: the gradient of {g_name} "
                             f"{grad_err[g_name]:.3e} off the dense step's")
    if worst > 1.0:
        raise AssertionError(f"a2a step: a parameter {worst:.3f} of its "
                             f"bound off the dense step's")
    if any(x != sums[0] for x in sums):
        raise AssertionError("a2a step: the ranks hold different parameters")
    return dict(ms=ms, plain_ms=plain_ms, ce=ce[1], ce_dense=ce[0],
                grad_norm=norm[1], grad_norm_dense=norm[0], aux=aux[1],
                aux_dense=aux[0], grad_err=grad_err[g_name],
                grad_err_moe=moe_err, worst=worst)


def _dist_grad_mean(mesh, tree: dict, dev, tag: str = "") -> dict:
    """``make_hierarchical_grad_mean`` on ``mesh`` (pod, data) over this
    rank's ``tree``: uncompressed within one rounding of the tree's dtype
    (1e-6 for float32) of each leaf's largest entry off a plain
    ``all_reduce`` mean; int8 across pods, on rank 0's tree on every rank,
    within int8's half step plus that rounding and float32's.  On rank-dependent trees
    across pods the int8 exchange's error is printed, not bounded (its
    codes are summed under different per-pod scales, as the reference's:
    ``ROADMAP.md`` queue 3).  Prints the times and the bytes handed to the
    collectives; returns them."""
    import torch
    import torch.distributed as dist
    from repro_torch.runtime import collectives as C

    world = dist.get_world_size()
    eps = torch.finfo(next(iter(tree.values())).dtype).eps
    f32_eps = torch.finfo(torch.float32).eps

    def plain(t_in):
        out = {n: t.clone() for n, t in t_in.items()}
        for t in out.values():
            dist.all_reduce(t)
            t.div_(world)
        return out

    same = {n: t.clone() for n, t in tree.items()}
    for t in same.values():
        dist.broadcast(t, 0)
    want = plain(tree)
    rec = {}
    for name, compress, given in (("hierarchical", False, tree),
                                  ("int8", True, same),
                                  ("int8 rank-dependent", True, tree)):
        if name == "int8 rank-dependent" and world == 1:
            continue
        fn = C.make_hierarchical_grad_mean(mesh, compress_cross_pod=compress)
        fn(given)  # warm-up: the first collectives set the group up
        C.reset_counts()
        got = fn(given)
        calls, moved = dict(C.CALLS), sum(C.BYTES.values())
        target = want if given is tree else given
        worst, exact, rel = 0.0, True, 0.0
        for n, g in got.items():
            w = target[n].float()
            d = float((g.float() - w).abs().max())
            big = float(w.abs().max())
            scale = big / 127.0
            # int8's half step, a rounding to the tree's dtype, and the
            # float32 arithmetic of the exchange
            bound = (scale / 2 + big * eps / 2 + (big + scale) * f32_eps
                     if compress else big * max(1e-6, eps))
            exact = exact and d == 0.0
            worst = max(worst, d / (bound or 1.0))
            rel = max(rel, d / (big or 1.0))
        if worst > 1.0 and name != "int8 rank-dependent":
            raise AssertionError(f"hierarchical mean ({name}) {worst:.3f} "
                                 f"of its bound off")
        rec[name] = dict(ms=_dist_ms(lambda: fn(given), dev, 3),
                         of_bound=worst, rel_err=rel, exact=exact,
                         bytes=moved,
                         calls=calls)
    rec["all_reduce"] = dict(ms=_dist_ms(lambda: plain(tree), dev, 3))
    n_bytes = sum(t.numel() * t.element_size() for t in tree.values())
    _say(f"{tag}hierarchical grad mean on {_mesh_str(mesh)}: {len(tree)} "
         f"{next(iter(tree.values())).dtype} leaves, "
         f"{n_bytes / 2**30:.3f} GiB a rank; "
         + "; ".join(f"{k} {v['ms']:.2f} ms" + (
             f", calls {v['calls']}, {v['bytes'] / 2**30:.3f} GiB handed "
             f"to the collectives, " + ("bitwise equal" if v["exact"] else
                                       f"{v['rel_err']:.3e} of a leaf's "
                                       f"largest entry off, "
                                       f"{v['of_bound']:.3f} of its bound")
             if "calls" in v else "") for k, v in rec.items())
         + " (times: CUDA events on the card, else host clock)")
    return rec


def _dist_moe(mesh, dev, cfg, B: int, S: int, tag: str = "") -> dict:
    """``cfg`` (a MoE model) cut to its first MoE layer, ``moe_impl="a2a"``,
    prefilled under ``use_mesh`` on each data rank's rows of one (B, S)
    token batch: on the input the path handed that layer, the a2a layer
    (``make_moe_a2a`` and the model's channel alike) makes exactly two
    ``all_to_all_single`` calls; each rank's slots and kept mask equal a
    loop on the host; its output equals, within ``ATTN_TOL``, the dense
    layer's on every token with no dropped choice, and on every token a
    per-expert computation over the kept choices only (a dropped choice
    weighs 0).  Prints its time and drops; returns them."""
    import torch
    from repro_torch.models import init_params, moe, prefill
    from repro_torch.models.layers import apply_mlp
    from repro_torch.runtime import collectives as C
    from repro_torch.runtime.mesh_context import use_mesh
    from repro_torch.runtime.moe_a2a import _local_dispatch, make_moe_a2a
    from repro_torch.runtime.sharding import local_chunk

    cfg = dataclasses.replace(cfg, n_layers=cfg.moe_layer_start + 1,
                              moe_impl="a2a")
    m, kind, D = cfg.moe, cfg.mlp_kind, cfg.d_model
    params = init_params(cfg, 11, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)).to(dev)
    caught = {}
    real = moe.apply_moe

    def catch(layer, x, *args, **kwargs):
        caught.setdefault("moe", (layer, x))
        return real(layer, x, *args, **kwargs)

    moe.apply_moe = catch
    try:
        with torch.no_grad(), use_mesh(mesh):
            prefill(cfg, params, local_chunk(tokens, ("data", None), mesh),
                    cache_len=S)
    finally:
        moe.apply_moe = real
    layer, x = caught["moe"]
    fn = make_moe_a2a(mesh, m, kind, D)
    with torch.no_grad(), use_mesh(mesh):
        C.reset_counts()
        got, _ = fn(layer, x)
        direct, moved = dict(C.CALLS), C.BYTES["all_to_all_single"]
        C.reset_counts()
        via_model, _, _ = layer(x, None, True)
        channel = dict(C.CALLS)
        dense, _ = moe.apply_moe_dense(layer, x, m, kind, need_aux=False)
        ms = _dist_ms(lambda: fn(layer, x, need_aux=False), dev, 10)
    if direct.get("all_to_all_single") != 2 or \
            channel.get("all_to_all_single") != 2:
        raise AssertionError(f"a2a MoE: all_to_all_single calls {direct} / "
                             f"{channel}, not 2 a layer call")
    if not torch.equal(via_model, got):
        raise AssertionError("a2a MoE: the model's channel differs from "
                             "make_moe_a2a")
    # this rank's tokens: its block of rows along the model axis
    M = mesh.size(list(mesh.mesh_dim_names).index("model"))
    rows = x.shape[0] // M
    mine = slice(mesh.get_local_rank("model") * rows,
                 (mesh.get_local_rank("model") + 1) * rows)
    xt = x[mine].reshape(-1, D)
    T = xt.shape[0]
    capacity = moe._capacity(m, T)
    with torch.no_grad():
        _, top_w, top_i = moe.router_probs(layer, xt, m)
        _, slot, kept = _local_dispatch(xt, top_w, top_i, m.n_experts,
                                        capacity)
        want_slot, want_kept = _host_slots(top_i.cpu().numpy(), capacity)
        if not (np.array_equal(slot.cpu().numpy(), want_slot)
                and np.array_equal(kept.cpu().numpy(), want_kept)):
            raise AssertionError("a2a MoE: slots or kept mask differ from "
                                 "the host's loop")
        # the kept choices only, expert by expert, summed in float32
        w = (top_w * kept).to(xt.dtype).float()
        experts = dict(layer["experts"].named_parameters(recurse=False))
        acc = torch.zeros((T, D), dtype=torch.float32, device=dev)
        for e in range(m.n_experts):
            t, j = torch.nonzero((top_i == e) & kept, as_tuple=True)
            if t.numel():
                y = apply_mlp({k: v[e] for k, v in experts.items()}, xt[t],
                              kind)
                acc.index_add_(0, t, y.float() * w[t, j, None])
        want = acc.to(xt.dtype)
        if "shared" in layer:
            want = want + apply_mlp(layer["shared"], xt, kind)
    out = got[mine].reshape(T, D)
    whole = kept.all(-1)
    n_whole = int(whole.sum())
    used_dense = _tol_ratio(out[whole], dense[mine].reshape(T, D)[whole]) \
        if n_whole else 0.0
    used_kept = _tol_ratio(out, want)
    drops = 1.0 - float(kept.float().mean())
    if n_whole == 0 or used_dense > 1.0 or used_kept > 1.0 \
            or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"a2a MoE: {n_whole} tokens with no drop "
                             f"{used_dense:.3f} of ATTN_TOL off the dense "
                             f"layer; every token {used_kept:.3f} off the "
                             f"kept choices' sum")
    _say(f"{tag}{cfg.name} a2a MoE layer (layer {cfg.moe_layer_start}'s "
         f"input from a prefill of {B} x {S} tokens under use_mesh, cut to "
         f"{cfg.n_layers} layers) on {_mesh_str(mesh)}: {T} tokens a rank, "
         f"{m.n_experts} experts of {m.d_expert} "
         f"({m.n_experts // M} a rank), top-{m.top_k}, {m.n_shared} shared, "
         f"capacity {capacity}; exactly 2 all_to_all_single a layer call "
         f"through make_moe_a2a and the model's channel alike (calls "
         f"{direct}, {moved / 2**20:.1f} MiB a rank through the two); slots "
         f"and kept mask == the host's loop; dropped {drops:.4f} of "
         f"{T * m.top_k} choices; the {n_whole} tokens with no drop == the "
         f"dense layer within {used_dense:.3f} of ATTN_TOL, all {T} == the "
         f"kept choices' sum within {used_kept:.3f}; {ms:.3f} ms a layer "
         f"call (eager)")
    del params, layer, x, got, dense, via_model
    return dict(ms=ms, drops=drops, tol_used_dense=used_dense,
                tol_used_kept=used_kept, a2a_bytes=moved)


def _dist_decode(FD, mesh, dev, cfg, batches, S: int, tag: str = ""
                 ) -> dict:
    """``make_distributed_flash_decode`` on ``mesh`` (data, model), each
    rank holding its data rows and its model shard of a ``S``-row cache
    (at ``cfg``'s heads, the model's dtype on the card), within
    ``ATTN_TOL`` of ``flash_decode`` on the rank's rows of the whole cache
    (the kernel on the card: the reference, whose launches are not the
    path's).  Prints the times; returns them."""
    import torch
    from repro_torch.runtime.collectives import make_distributed_flash_decode
    from repro_torch.runtime.sharding import local_chunk

    H, H_kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dtype = cfg.dtype()
    fn = make_distributed_flash_decode(mesh, seq_axis="model",
                                       batch_axes=("data",))
    gen = torch.Generator(device=dev).manual_seed(13)
    rows, cache = ("data", None, None), ("data", "model", None, None)
    report, rec, n_ref = [], {}, 0
    FD.flash_decode.launches = 0
    for B in batches:
        q = torch.randn((B, H, d), generator=gen, device=dev).to(dtype)
        kc, vc = (torch.randn((B, S, H_kv, d), generator=gen, device=dev
                              ).to(dtype) for _ in range(2))
        cl = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
        cl[0] = S
        args = (local_chunk(q, rows, mesh), local_chunk(kc, cache, mesh),
                local_chunk(vc, cache, mesh), local_chunk(cl, ("data",), mesh))
        got = fn(*args)
        want = FD.flash_decode(args[0], local_chunk(kc, rows + (None,), mesh)
                               .transpose(1, 2),
                               local_chunk(vc, rows + (None,), mesh)
                               .transpose(1, 2), args[3])
        n_ref += 1
        used = _tol_ratio(got.to(want.dtype), want)
        if used > 1.0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"distributed decode at batch {B} is "
                                 f"{used:.3f} of ATTN_TOL off flash_decode")
        ms = _dist_ms(lambda: fn(*args), dev, 20)
        rec[f"b{B}"] = dict(ms=ms, tol_used=used)
        report.append(f"batch {B}: {used:.3f} of ATTN_TOL, {ms:.4f} ms")
    if dev.type == "cuda" and FD.flash_decode.launches != n_ref:
        raise AssertionError(f"{FD.flash_decode.launches} flash_decode "
                             f"launches for {n_ref} reference calls")
    M = mesh.size(list(mesh.mesh_dim_names).index("model"))
    _say(f"{tag}make_distributed_flash_decode on {_mesh_str(mesh)} (q (B, "
         f"{H}, {d}) {dtype}, an {S}-row cache of {H_kv} heads, {S // M} rows a model "
         f"rank, cache_len random, row 0 full; plain float32 torch, as the "
         f"reference's jnp) against flash_decode on the whole cache "
         f"(reference launches {FD.flash_decode.launches}, not the path's): "
         + "; ".join(report) + " (CUDA events on the card, else host clock)")
    return rec


def _distributed_phase(FA, FD, dev, train_records) -> dict:
    """Phase D: the distributed runtime on a one-rank NCCL group (one card
    cannot hold two NCCL ranks; ``scripts/distributed_nccl.py`` runs the
    same checks on four cards) with a (data=1, model=1) mesh: D1 the
    policy's table; D2 :func:`_dist_train` on granite-3-2b at full width
    cut to 4 layers (bf16, remat on) and :func:`_dist_grad_mean` on its
    gradients over (pod=1, data=1); D3 :func:`_dist_moe` on
    deepseek-moe-16b's 2048-token prefill; D4 :func:`_dist_decode` on
    granite's decode shapes.  Returns the attention kernels' rows with
    D2's launches (the kernels on the phase's path)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    _policy_table()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    store_dir = tempfile.mkdtemp(dir=build)
    dist.init_process_group(
        rank=0, world_size=1, backend="nccl",
        device_id=torch.device("cuda", torch.cuda.current_device()),
        store=dist.FileStore(str(Path(store_dir) / "store"), 1))
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        pod_mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("pod", "data"))
        granite = dataclasses.replace(get_config(DIST["arch"]),
                                      n_layers=DIST["layers"])
        _, launches, grads = _dist_train(
            FA, dev, mesh, granite, DIST["batch"], DIST["seq_len"],
            tag="D2 (reduced: depth 40 -> 4 layers) ")
        _dist_grad_mean(pod_mesh, grads, dev, tag="D2 ")
        del grads
        gc.collect()
        torch.cuda.empty_cache()
        _dist_moe(mesh, dev, get_config(DIST["moe_arch"]), 1,
                  DIST["moe_tokens"], tag="D3 ")
        torch.cuda.empty_cache()
        _dist_decode(FD, mesh, dev, granite, DIST["decode"],
                     DIST["cache_rows"], tag="D4 ")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    print(f"phase D: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {name: dict(train_records[name], launches=launches[name])
            for name in ("flash_attention", "flash_attention_bwd")}


#: phase R2: the dry run's cell function at sizes this run measured, on a
#: (data=1, model=1) mesh: (what, arch, its shape, what it is held against)
R2_CELLS = (
    ("a", "granite-3-2b", dict(name="train_4x1024", seq_len=TRAIN["seq_len"],
                               global_batch=TRAIN["batch"], kind="train"),
     "T2's steady step"),
    ("b", "granite-3-2b", dict(name="prefill_2048", seq_len=2048,
                               global_batch=1, kind="prefill"),
     "phase 7's 2048-token prefill"),
    ("c", "deepseek-moe-16b", dict(name="decode_b1_2064", seq_len=2064,
                                   global_batch=1, kind="decode"),
     "phase 9a's batch-1 decode step as one CUDA graph"),
)

R2_BODY = """
import json, sys
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
one = MeshShape(("data", "model"), (1, 1))
recs = [dryrun.run_cell(arch, shape["name"], "card", verbose=False,
                        shape=ShapeSpec(**shape), mesh_shape=one)
        for arch, shape in json.loads(sys.argv[1])]
print(json.dumps(recs))
"""


def _child(args, what: str, timeout: int):
    """``python args...`` from the checkout with ``src`` on the path; its
    standard output (it must exit 0)."""
    root = Path(__file__).resolve().parent
    env = dict(__import__("os").environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable] + list(args), cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{what} exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return proc.stdout


def _roofline_phase() -> dict:
    """Phase R: the roofline on the card's constants, on the CPU in child
    processes (a fake process group each; the card is not used).  R1 the
    dry run of every cell; R2 the roofline of the steps this run measured,
    beside what it measured; R3 the a2a probe.  Returns R2's numbers."""
    import os
    from repro_torch.configs import SHAPES, all_configs, get_config
    from repro_torch.configs.shapes import SUBQUADRATIC_FAMILIES
    from repro_torch.launch.dryrun import RESULTS_DIR
    from repro_torch.roofline.analysis import (analyze_record, load_cells,
                                               pick_hillclimb_cells)

    # -- R1 ----------------------------------------------------------------
    t0 = time.perf_counter()
    out = _child(["-m", "repro_torch.launch.dryrun", "--all", "--mesh",
                  R1_MESH], "R1 the dry run", 900)
    wall = time.perf_counter() - t0
    meshes = ["single", "multi"] if R1_MESH == "both" else [R1_MESH]
    counts = collections.Counter()
    for mesh in meshes:
        for arch in sorted(all_configs()):
            cfg = get_config(arch)
            for shape in SHAPES:
                rec = json.loads((RESULTS_DIR / f"{arch}__{shape}__{mesh}"
                                  f".json").read_text())
                counts[rec["status"]] += 1
                want = ("skipped" if shape == "long_500k" and cfg.family
                        not in SUBQUADRATIC_FAMILIES else "ok")
                if rec["status"] != want:
                    raise AssertionError(
                        f"R1 {arch} x {shape} x {mesh}: {rec['status']}, "
                        f"not {want}: {rec.get('error', '')[:300]}")
    cells = load_cells(str(RESULTS_DIR))
    picks = pick_hillclimb_cells(cells)
    print(f"R1 dry run (python -m repro_torch.launch.dryrun --all --mesh "
          f"{R1_MESH}, fake process groups on the CPU's {os.cpu_count()} "
          f"cores): "
          f"{sum(counts.values())} records, {counts['ok']} ok, "
          f"{counts['skipped']} skipped (long_500k of the attention "
          f"configs), {counts['error']} errors, every train_4k cell ok, in "
          f"{wall:.1f} s; "
          f"{out.strip().splitlines()[-1]}", flush=True)
    for key, c in picks.items():
        print(f"R1 pick {key}: {c.arch} x {c.shape} x {c.mesh} "
              f"({c.dominant}-bound, T {c.step_s:.3e} s, MFU_est "
              f"{c.mfu_est:.4f}, compute {c.compute_s:.3e} / memory "
              f"{c.memory_s:.3e} / collective {c.collective_s:.3e} s)",
              flush=True)

    # -- R2 ----------------------------------------------------------------
    t0 = time.perf_counter()
    recs = json.loads(_child(
        ["-c", R2_BODY, json.dumps([(arch, shape) for _, arch, shape, _
                                    in R2_CELLS])],
        "R2 the dry run's cells", 600).strip().splitlines()[-1])
    measured = {
        "a": (MEASURED["train_step_ms"], MEASURED.get("train_device_ms")),
        "b": (MEASURED[("granite-3-2b", "prefill_ms")][2048], None),
        "c": (MEASURED[("deepseek-moe-16b", "decode_graph_ms", 1)], None)}
    numbers, gib = {}, 2.0 ** 30
    for (key, arch, shape, against), rec in zip(R2_CELLS, recs):
        if rec["status"] != "ok":
            raise AssertionError(f"R2 ({key}) {arch} {shape['name']}: "
                                 f"{rec['status']} {rec.get('error', '')}")
        c = analyze_record(rec)
        ms, device_ms = measured[key]
        pred = c.step_s * 1e3
        line = (f"R2 ({key}) {arch} {shape['name']} (full depth, mesh 1 x 1)"
                f": predicted T {pred:.3f} ms ({c.dominant}-bound: compute "
                f"{c.compute_s * 1e3:.3f}, memory {c.memory_s * 1e3:.3f}, "
                f"collective {c.collective_s * 1e3:.3f}, weight stream "
                f"{c.weight_stream_s * 1e3:.3f} ms; "
                f"{rec['cost_analysis']['flops'] / 1e12:.2f} TFLOP, "
                f"usefulness {c.usefulness:.3f}); measured {against} "
                f"{ms:.3f} ms = {ms / pred:.2f}x T")
        if device_ms:
            line += (f", its traced device time {device_ms:.3f} ms = "
                     f"{device_ms / pred:.2f}x T")
        if key == "a":
            ma = rec["memory_analysis"]
            peak, temp = (ma["peak_memory_in_bytes"] / gib,
                          ma["temp_size_in_bytes"] / gib)
            got, init = MEASURED["train_peak_gib"], MEASURED["train_init_gib"]
            line += (f"; the dry run's peak {peak:.3f} GiB "
                     f"({ma['argument_size_in_bytes'] / gib:.3f} of "
                     f"arguments, {temp:.3f} above what the step began "
                     f"with) against T2's measured peak {got:.3f} GiB "
                     f"({init:.3f} allocated at init, {got - init:.3f} above "
                     f"it)")
            numbers[key + "_memory"] = dict(
                dryrun_peak_gib=peak, dryrun_temp_gib=temp,
                measured_peak_gib=got, measured_init_gib=init)
        if key == "c":
            line += (f"; the memory term is {c.memory_s * 1e3 / ms:.3f} of "
                     f"the measured step (the memory rate's share reached)")
        print(line, flush=True)
        numbers[key] = dict(predicted_ms=pred, measured_ms=ms,
                            device_ms=device_ms, dominant=c.dominant,
                            compute_ms=c.compute_s * 1e3,
                            memory_ms=c.memory_s * 1e3,
                            weight_stream_ms=c.weight_stream_s * 1e3)
    print(f"R2: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- R3 ----------------------------------------------------------------
    t0 = time.perf_counter()
    out = _child(["-m", "repro_torch.launch.moe_a2a_probe"],
                 "R3 the a2a probe", 600)
    for line in out.strip().splitlines():
        if line.strip():
            print(f"R3 {line.strip()}", flush=True)
    print(f"R3: {time.perf_counter() - t0:.1f} s", flush=True)
    return numbers


def main() -> int:
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.core as P
    from repro_torch.core import batched_execution as PB
    from repro_torch.core import transient as PT
    from repro_torch.kernels import decode_attention as FD
    from repro_torch.kernels import exec_lanes as EL
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fluid_scan as FL
    from repro_torch.kernels import latency_hist as LH
    from repro_torch.kernels import mva_scan as MV
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.kernels import transient_lanes as TL
    from repro_torch.kernels import wkv6 as WK
    dev = torch.device("cuda")
    # float32 products in full float32 on the card (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------
    smi = _nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {smi}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    kernels = (("latency_hist.cu", LH.build), ("exec_lanes.cu", EL.build),
               ("transient_lanes.cu", TL.build),
               ("flash_attention.cu", FA.build),
               ("flash_attention_bwd.cu", FA.build_bwd),
               ("decode_attention.cu", FD.build), ("rglru_scan.cu", RS.build),
               ("rglru_scan_bwd.cu", RS.build_bwd), ("wkv6.cu", WK.build),
               ("wkv6_bwd.cu", WK.build_bwd), ("mva_scan.cu", MV.build),
               ("fluid_scan.cu", FL.build))
    with ThreadPoolExecutor(len(kernels)) as pool:
        logs = list(pool.map(lambda kv: kv[1](), kernels))
    print(f"build: {', '.join(k for k, _ in kernels)} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, together)")
    for (src, _), log in zip(kernels, logs):
        for line in log.splitlines():
            print(f"  ptxas {src}: {line.strip()}")
    _wkv_bwd_build_report(logs[[k for k, _ in kernels].index("wkv6_bwd.cu")])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"  bf16 flash_attention tiles, head dim -> (query rows, keys): "
          f"{FA.MMA_TILES}, two-stage cp.async ring; bf16 flash_decode: "
          f"{FD.TILE}-key tiles, 16 per warp, one launch, splits "
          f"{FD.split_plan(1, 8, 2064, n_sms)} at granite batch 1 and "
          f"{FD.split_plan(1, 1, 2048, n_sms)} at recurrentgemma batch 1 "
          f"(n_splits, keys) on {n_sms} SMs", flush=True)

    # -- 3. kernels against their plain versions ---------------------------
    cases = _hist_cases(np.random.default_rng(0))
    for samples, valid, edges in cases:
        s, v, e = (torch.from_numpy(a) for a in (samples, valid, edges))
        want = ref.ref_latency_hist(s, v, e)
        for mask in (v, v > 0):
            got = LH.latency_hist(s.to(dev), mask.to(dev), e.to(dev))
            torch.cuda.synchronize()
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"latency_hist differs from its plain "
                                     f"version at {tuple(s.shape)}, "
                                     f"mask {mask.dtype}")
    print(f"kernel check: latency_hist == plain version on {len(cases)} "
          f"shapes x (f32, bool) masks, edge cases included")
    n_attn, used = _attention_edge_cases(FA, FD, ref, dev)
    print(f"kernel check: flash_attention and flash_decode within (atol, "
          f"rtol) {ATTN_TOL} of their plain versions in {n_attn} edge cases, "
          f"using at most {used} of it "
          f"(S 1-2048, d 64/128, groups 1/4/6/8, causal and not, strided, "
          f"cache_len 1 / S_max / per row; d = 128 at 16/16 and 32/4 "
          f"heads: prefill S 17/1000/2048, decode B 1/8 x "
          f"S_max 1024/2064 x cache_len 1/17/S_max/per row)", flush=True)
    n_rec, used = _recurrent_edge_cases(FA, FD, RS, ref, dev)
    print(f"kernel check: recurrentgemma's rglru_scan (SCAN_TOL {SCAN_TOL}),"
          f" windowed head-dim-256 flash_attention and group-10 "
          f"head-dim-256 flash_decode (ATTN_TOL) within tolerance of their "
          f"plain versions in {n_rec} edge cases, using at most {used} of "
          f"it", flush=True)
    n_wkv, used = _wkv_edge_cases(WK, ref, dev)
    print(f"kernel check: wkv6 (WKV_TOL {WKV_TOL}, atol relative to the "
          f"output's scale) within tolerance of its plain version in "
          f"{n_wkv} edge cases (B 1/8, S 1-4096, logw model/-5/0/-20, s0 zero "
          f"and given, strided and dense; y and s_last), using at most "
          f"{used} of it", flush=True)
    # -- A6 / A7. the recurrences' backward against their plain versions ---
    t0 = time.perf_counter()
    n_rbwd, used = _recurrence_bwd_edge_cases(RS, WK, ref, dev)
    print(f"kernel check: wkv6_bwd (WKV_TOL) and rglru_scan_bwd (SCAN_TOL), "
          f"through their autograd Functions, within tolerance of autograd "
          f"through the plain forwards, relative to each gradient's largest "
          f"entry, in {n_rbwd} edge cases (wkv6: B 1/4, S 1/17/32/33/1024/"
          f"4096, logw model/-5/0/-20, s0 and ds_last zero and given; "
          f"rglru: B 1/4, S 1/17/32/33/1024/4096, D 2560/77, h0 zero and "
          f"given; strided and dense; f32 and bf16), using at most {used} "
          f"of it, in {time.perf_counter() - t0:.1f} s", flush=True)
    # -- T1. the attention backward against its plain version ---------------
    t0 = time.perf_counter()
    n_bwd = _bwd_edge_cases(FA, ref, dev)
    print(f"kernel check: flash_attention_bwd (dq, dk, dv through the "
          f"autograd Function on the kernel's forward and log-sum-exp) within "
          f"(rtol x largest entry, atol) {BWD_TOL} of autograd through the "
          f"plain forward in {n_bwd} edge cases (S 1/17/127/300/700/1024/"
          f"1500/2048/2112, S_q x S_k 1/17/448/1500 x 1500 and 1 x 300, "
          f"groups 1/2/4/8/10, d 64/128/256, causal, windowed and full; f32 "
          f"and bf16) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _bwd_build_report(FA, n_sms)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    bwd_rec = _bwd_record(FA, ref, dev, flush)
    B_, H_, H_kv_, S_, D_ = TRAIN_SHAPE
    g_ = torch.Generator(device=dev).manual_seed(8)
    train_fa_rec = _prefill_record(
        FA, ref, *(torch.randn((B_, h, S_, D_), generator=g_, device=dev,
                               dtype=torch.bfloat16)
                   for h in (H_, H_kv_, H_kv_)), True, None, flush)
    del g_

    sweep = P.compile_sweep(P.SweepSpec(**GRID))
    if len(sweep) != 32:
        raise AssertionError(f"expected 32 configs, got {len(sweep)}")
    # -- 3b. the execution lanes' step kernel against its plain version ----
    lanes = _exec_lanes_phase(P, PB, EL, ref, sweep, dev)
    plain_ms_step = lanes["plain_ms_step"]
    record, by_mix = None, {}
    for label, w in _mixes(P):
        before = EL.exec_lanes.launches
        samples, mask, edges, n_steps, scan_s = _main_path_tensors(
            PB, sweep, w, dev)
        n_el = EL.exec_lanes.launches - before
        if n_el != -(-n_steps // PB.BLOCK_STEPS):
            raise AssertionError(f"{label}: execute launched exec_lanes "
                                 f"{n_el} times for {n_steps} steps")
        record = _hist_record(LH, ref, samples, mask, edges,
                              f"{label}, full size")
        print(f"kernel {label}: L={samples.shape[0]} N={samples.shape[1]} "
              f"(n_steps {n_steps} x 64 clients), {record['n_valid']} valid "
              f"samples; exact, one device kernel a call "
              f"({record['kernel']}, plan {record['plan']}); latency_hist "
              f"{record['ms']:.4f} ms alone, the call's host wall "
              f"{record['wall_ms']:.4f} ms, plain {record['plain_ms']:.2f} "
              f"ms, bound {record['bound_ms']:.4f} ms ({record['bound_by']};"
              f" {record['bound_ms'] / record['ms']:.3f} of it); "
              f"{LH.latency_hist.launches} launches so far; scan "
              f"{scan_s:.3f} s = {scan_s / n_steps * 1e3:.4f} ms/step "
              f"({n_el} exec_lanes launches; the plain loop "
              f"{plain_ms_step[label]:.3f} ms/step at "
              f"{EXEC_LANES_CUT_COMMANDS} commands)", flush=True)
        record = {k: v for k, v in record.items() if k != "n_valid"}
        by_mix[label] = {k: record[k] for k in ("ms", "wall_ms", "bound_ms")}
        del samples, mask, edges
        torch.cuda.empty_cache()
    record["by_mix"] = by_mix

    # -- 4. the main path --------------------------------------------------
    alpha = P.calibrate_alpha()
    LH.latency_hist.launches = 0
    EL.exec_lanes.launches = 0
    for label, w in _mixes(P):
        peak = sweep.peak_throughput(alpha, w)
        _, x_mva, r_mva = sweep.mva(alpha, n_clients_max=64, workload=w,
                                    device=dev)
        torch.cuda.reset_peak_memory_stats()
        before = LH.latency_hist.launches
        before_el = EL.exec_lanes.launches
        warp_el = EL.exec_lanes.by_kernel["warp"]
        res, scan_dev_ms, _ = _step_run(PB, EL.exec_lanes, sweep.execute,
                                        workload=w, device=dev, **EXECUTE)
        peak_mem = torch.cuda.max_memory_allocated()
        n_el = EL.exec_lanes.launches - before_el
        if n_el != -(-res.n_steps // PB.BLOCK_STEPS):
            raise AssertionError(f"{label}: execute launched exec_lanes "
                                 f"{n_el} times for {res.n_steps} steps")
        if EL.exec_lanes.by_kernel["warp"] - warp_el != n_el:
            raise AssertionError(f"{label}: execute's lanes did not all "
                                 f"take the warp kernel")
        n = EXECUTE["n_commands"]
        if not (np.all(res.completed == n)
                and np.all(res.hist.sum(axis=2) == n)):
            raise AssertionError(f"{label}: a lane did not drain its budget "
                                 f"or lost a latency sample")
        if LH.latency_hist.launches <= before:
            raise AssertionError(f"{label}: execute never launched the "
                                 f"latency_hist kernel")
        for arr in (res.throughput, res.latency_p50, res.latency_p99,
                    x_mva, r_mva):
            if not np.all(np.isfinite(arr)) or not np.all(arr > 0):
                raise AssertionError(f"{label}: non-finite or non-positive "
                                     f"output")
        if not np.all(res.latency_p50 <= res.latency_p99):
            raise AssertionError(f"{label}: p50 above p99")
        t = res.timings
        scan_bound_ms, _ = _bound_ms(kernel_costs.exec_lanes_cost(
            len(res) * EXECUTE["seeds"], res.n_steps, EXECUTE["n_clients"],
            len(P.STATION_ORDER) + 1,
            -(-n // EXECUTE["n_clients"]), False))
        print(f"execute {label}: {len(res)} configs x {EXECUTE['seeds']} "
              f"seeds x {EXECUTE['n_clients']} clients x {n} commands; "
              f"n_steps {res.n_steps}; probe {t['probe']:.2f} s, scan "
              f"{t['scan']:.3f} s ({t['scan'] / res.n_steps * 1e3:.4f} "
              f"ms/step; exec_lanes {n_el} launches of the warp kernel, "
              f"{scan_dev_ms:.2f} ms on the card, "
              f"{scan_dev_ms / res.n_steps * 1e3:.3f} us a step, "
              f"bound {scan_bound_ms:.3f} ms (bytes: the serial chain, not "
              f"the bytes, sets the time); the plain loop "
              f"{plain_ms_step[label]:.3f} ms/step at "
              f"{EXEC_LANES_CUT_COMMANDS} commands), hist+sums "
              f"{t['hist'] * 1e3:.1f} ms; peak device memory "
              f"{peak_mem / 2**30:.2f} GiB", flush=True)
        lanes["record"].setdefault("scan_ms_by_mix", {})[label] = \
            scan_dev_ms
        if label == "90% reads":
            lanes["record"].update(
                scan_ms=scan_dev_ms, scan_steps=res.n_steps,
                scan_bound_ms=scan_bound_ms, scan_s=t["scan"])
        for m, cfg in enumerate(res.configs):
            knobs = ",".join(f"{k}={v}" for k, v in sorted(cfg.items())
                             if k != "variant")
            print(f"  {knobs}: {res.throughput[m].mean():.1f} cmd/s "
                  f"(bottleneck law {peak[m]:.1f}, MVA@64 "
                  f"{x_mva[m, -1]:.1f}), p50 {res.latency_p50[m].mean():.4e}"
                  f" s, p99 {res.latency_p99[m].mean():.4e} s")
    launches = LH.latency_hist.launches
    if launches == 0:
        raise AssertionError("the main path launched no latency_hist kernel")
    lanes["record"]["launches"] = EL.exec_lanes.launches
    if EL.exec_lanes.launches == 0:
        raise AssertionError("the main path launched no exec_lanes kernel")

    # -- 5. the card against the CPU ---------------------------------------
    small = P.compile_sweep(P.SweepSpec(n_proxy_leaders=(2, 4),
                                        grids=((2, 2),), n_replicas=(2, 3)))
    kw = dict(workload=P.MIXED_50_50, n_commands=64, seeds=2, n_clients=8)
    on_gpu = small.execute(device=dev, **kw)
    on_cpu = small.execute(device="cpu", **kw)
    for field in ("hist", "n_writes", "completed", "throughput",
                  "station_msgs"):
        if not np.array_equal(getattr(on_gpu, field), getattr(on_cpu, field)):
            raise AssertionError(f"cuda and cpu runs differ in {field}")
    np.testing.assert_allclose(on_gpu.latency_mean, on_cpu.latency_mean,
                               rtol=1e-9)
    for a, b in zip(small.mva(alpha, 64, device=dev)[1:],
                    small.mva(alpha, 64, device="cpu")[1:]):
        if not np.array_equal(a, b):
            raise AssertionError("cuda and cpu MVA surfaces differ")
    expo = small.execute(device=dev, exponential_service=True, **kw)
    if not np.all(expo.hist.sum(axis=2) == kw["n_commands"]):
        raise AssertionError("exponential-service lanes did not drain")
    print("cuda == cpu on a 4-config x 2-seed grid (hist, drains, "
          "makespans, msgs/cmd exact; mean latency rtol 1e-9; MVA bit for "
          "bit); exponential service drains on the card")

    # -- 5b. the steady-state solves: MVA and fluid --------------------------
    steady = _steady_state_phase(P, MV, FL, ref, sweep, alpha, dev)

    # -- 6. the transient path: token engine, autotune, autoscale ----------
    transient, transient_lanes = _transient_phase(P, PT, LH, TL, ref, sweep,
                                                  alpha, dev)

    # -- 7.-9b. the serving paths --------------------------------------------
    served = {}
    for arch, plan in SERVE.items():
        served[arch] = _serve_phase(
            arch, **plan, kernels=dict(rglru_scan=RS, wkv6=WK,
                                       flash_attention=FA, flash_decode=FD),
            ref=ref, dev=dev)
        # the fleet's protocol objects refer to each other, so its weights
        # are freed by the collector, not when the phase returns; without
        # this the next phase's peak memory would count them
        gc.collect()
        torch.cuda.empty_cache()

    # -- 10. the card against the CPU on the models -------------------------
    for arch in SERVE:
        _model_cuda_vs_cpu(dev, arch)

    # -- T2.-T3. the training path; W. whisper-tiny ---------------------------
    train = _train_phase(FA, ref, dev, bwd_rec["ms"])
    _grad_check_phase(FA, RS, WK, ref, dev)
    # -- T4.-T5b. the recurrent models' training paths -----------------------
    rec_train = {arch: _recurrent_train_phase(arch, FA, RS, WK, dev)
                 for arch in ("recurrentgemma-2b", "rwkv6-7b")}
    _recurrent_grad_phase("recurrentgemma-2b",
                          rec_train["recurrentgemma-2b"]["layers"], FA, RS,
                          WK, ref, dev)
    _recurrent_grad_phase("rwkv6-7b", T5B_LAYERS, FA, RS, WK, ref, dev)
    rec_records = _recurrence_bwd_records(FA, RS, WK, ref, dev, flush)
    for arch, path in (("recurrentgemma-2b", "recurrentgemma-2b training"),
                       ("rwkv6-7b", "rwkv6-7b training")):
        for name, rec in rec_records[path].items():
            rec["launches"] = rec_train[arch]["launches"][name]
    _fault_phase(dev)
    whisper = _whisper_phase(FA, FD, ref, dev, flush)
    # -- D. the distributed runtime ------------------------------------------
    distributed = _distributed_phase(
        FA, FD, dev, dict(flash_attention=train_fa_rec,
                          flash_attention_bwd=bwd_rec))
    # -- R. the roofline on the card's constants -----------------------------
    _roofline_phase()
    print(f"smoke: every phase passed in {time.perf_counter() - t_start:.1f}"
          f" s", flush=True)

    # the backwards have no Pallas counterpart: the reference differentiates
    # its jnp oracle of the attention forward and its model-path
    # recurrences (wkv6_chunked, the associative rglru_scan)
    where = {
        "rglru_scan": ("rglru_scan.cu", "kernels/rglru_scan.py:23"),
        "wkv6": ("wkv6.cu", "kernels/rwkv6_scan.py:24"),
        "flash_attention": ("flash_attention.cu",
                            "kernels/flash_attention.py:34"),
        "flash_attention_bwd": ("flash_attention_bwd.cu",
                                "models/attention.py:76"),
        "flash_decode": ("decode_attention.cu",
                         "kernels/decode_attention.py:31"),
        "rglru_scan_bwd": ("rglru_scan_bwd.cu", "models/rglru.py:68"),
        "wkv6_bwd": ("wkv6_bwd.cu", "models/rwkv6.py:153")}
    rows = [dict(name="latency_hist", route="cuda",
                 source="src/repro_torch/kernels/csrc/latency_hist.cu",
                 replaces="src/repro/kernels/latency_hist.py:23",
                 path="execution", launches=launches, library_ms=None,
                 **record),
            dict(name="latency_hist", route="cuda",
                 source="src/repro_torch/kernels/csrc/latency_hist.cu",
                 replaces="src/repro/kernels/latency_hist.py:23",
                 path="transient", library_ms=None, **transient),
            dict(name="exec_lanes", route="cuda",
                 source="src/repro_torch/kernels/csrc/exec_lanes.cu",
                 replaces="src/repro/core/batched_execution.py:137",
                 path="execution", library_ms=None, **lanes["record"]),
            dict(name="transient_lanes", route="cuda",
                 source="src/repro_torch/kernels/csrc/transient_lanes.cu",
                 replaces="src/repro/core/transient.py:482",
                 path="transient", library_ms=None, **transient_lanes),
            dict(name="mva_scan", route="cuda",
                 source="src/repro_torch/kernels/csrc/mva_scan.cu",
                 replaces="src/repro/core/simulator.py:38",
                 path="steady state", library_ms=None, **steady["mva_scan"]),
            dict(name="fluid_scan", route="cuda",
                 source="src/repro_torch/kernels/csrc/fluid_scan.cu",
                 replaces="src/repro/core/simulator.py:115",
                 path="steady state", library_ms=None,
                 **steady["fluid_scan"])]
    train_fa_rec["launches"] = train["launches"]["flash_attention"]
    bwd_rec["launches"] = train["launches"]["flash_attention_bwd"]
    served["training"] = dict(flash_attention=train_fa_rec,
                              flash_attention_bwd=bwd_rec)
    served["whisper-tiny"] = whisper
    served.update(rec_records)
    served["distributed"] = distributed
    for arch, records in served.items():
        for name, rec in records.items():
            src, tpu = where[name]
            rows.append(dict(name=name, route="cuda",
                             source=f"src/repro_torch/kernels/csrc/{src}",
                             replaces=f"src/repro/{tpu}", path=arch,
                             **rec))
    print(json.dumps({"kernels": rows}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

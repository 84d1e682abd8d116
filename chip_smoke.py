#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (the run then exits non-zero and prints
no result line):

1. device - the card's name and count, and ``nvidia-smi``'s name and
   power limit; without a card the run fails at once;
2. build - compile every CUDA kernel of the port from ``src/`` (one
   ``nvcc`` per source, all started together) and print ``-Xptxas -v``;
3. kernels against their plain versions - small shapes and edge cases
   (the histogram exactly; flash attention and flash decode within
   ``ATTN_TOL``), then the histogram on the execution
   path's own full-size tensors, with its times and bound;
4. the execution path - ``compile_sweep`` of the 32-config
   compartmentalized MultiPaxos grid (f = 1, 2x2 acceptor grid; the
   deployment family of the paper's ablation, arXiv 2012.15762 section 8,
   Fig. 29), its bottleneck law and MVA on the card, and ``.execute`` at
   2048 commands x 8 seeds x 64 clients for the paper's two headline
   mixes; every lane must drain and the histogram kernel must launch;
5. the card against the CPU - the port on ``cuda`` and on ``cpu`` agree on
   a 4-config x 2-seed grid;
6. the serving path - granite-3-2b at full width (40 layers, d_model
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
7. the card against the CPU on the model - granite-3-2b's smoke config in
   float32 on the same weights: logits agree and greedy tokens are equal.

The line before the last is the card's name and power limit; the line
before it, a JSON object describing every kernel; the last line,
``{"ok": true, "device": {...}}``.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

#: H100 SXM device memory rate, float32 rate outside the tensor cores and
#: dense bf16 tensor-core rate (NVIDIA's data sheet, at the full 700 W
#: power limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12

GRID = dict(variants=("compartmentalized",),
            n_proxy_leaders=(2, 3, 4, 5, 6, 7, 8, 10), grids=((2, 2),),
            n_replicas=(2, 3, 4, 6))
EXECUTE = dict(n_commands=2048, seeds=8, n_clients=64, probe_n=96)
SERVE_ARCH = "granite-3-2b"
SERVE_PROMPTS = (17, 128, 256, 512, 1000, 1024, 2048, 2048)
SERVE_NEW = 16
BATCH = dict(n_slots=8, max_len=1024, n_requests=16, prompt=512, max_new=32)
#: (atol, rtol) of each attention kernel against its plain version, by
#: dtype.  float32 as in tests/test_kernels.py:21-23.  bfloat16: both sides
#: round their output to bf16 (one ulp is at most 2^-7 of a value) and the
#: kernel rounds the softmax weights to bf16 for the tensor cores, so the
#: check holds it to about one output ulp plus that; the CPU tests' 2e-2 is
#: for the JAX kernel, whose rounding differs.
ATTN_TOL = {"torch.float32": (2e-5, 2e-5), "torch.bfloat16": (4e-3, 1e-2)}
#: keys per tile of both attention kernels; the planted fault drops one
FAULT_TILE = 64


def _mixes(P):
    return [("write-only", P.Workload(f_write=1.0)),
            ("90% reads", P.Workload.read_mix(0.9))]


def _nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def _hist_bound_ms(samples, mask, edges, n_valid: int):
    """Least time for the histogram on this card: every mask byte and every
    valid sample read once, edges read and counts written once; against a
    compare-and-add per mask byte plus a lower-bound search per valid
    sample."""
    lanes, n = samples.shape
    bins = edges.shape[1] - 1
    nbytes = (lanes * n * mask.element_size() + 4 * n_valid
              + edges.numel() * 4 + lanes * bins * 4)
    ops = lanes * n + n_valid * (int(np.ceil(np.log2(bins + 2))) + 1)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def _time_graph_ms(fn, flush, reps: int) -> float:
    """Device time of ``fn``: its launches captured once in a CUDA graph and
    replayed ``reps`` times, each after an L2 flush, between CUDA events.
    The host's Python is outside the window (the replay is queued while
    the flush runs), so a kernel of a few microseconds is timed as itself,
    not as its wrapper's overhead."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as CUDA graphs ask
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
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


def _tol_ratio(got, want) -> float:
    """Largest |got - want| / (atol + rtol |want|) at want's dtype
    (``ATTN_TOL``): above 1 fails the check."""
    atol, rtol = ATTN_TOL[str(want.dtype)]
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


def _close(name: str, got, want, what: str) -> float:
    """Max abs error of a kernel against its plain version; raises past
    the dtype's tolerance (``ATTN_TOL``)."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    if not bool(torch.isfinite(got).all()) or _tol_ratio(got, want) > 1.0:
        raise AssertionError(f"{name} differs from its plain version at "
                             f"{what}: max abs err {err:.3e}, (atol, rtol) "
                             f"{ATTN_TOL[str(want.dtype)]}")
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
    inputs; cache lengths of 1, of S_max and different per row.  Every
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
                             (1, 6, 1, 77, 128)]:
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
                             (4, 6, 1, 300, 64), (2, 64, 8, 4096, 128)]:
        for dt in (torch.float32, torch.bfloat16):
            q = _randn(rng, (B, H, D), dt, dev)
            k, v = (_randn(rng, (B, H_kv, S, D), dt, dev) for _ in "kv")
            mixed = rng.integers(1, S + 1, size=B)
            mixed[0] = S
            for lens in (np.ones(B), np.full(B, S), mixed):
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


def _attention_bound_ms(n_pairs: int, d: int, n_bytes: int, dtype):
    """Least time for attention on this card: 4 d flops per computed
    (query, key) pair at the dtype's peak rate (bf16 tensor cores, or
    float32 outside them), against every input read and output written
    once at the memory rate."""
    import torch
    rate = PEAK_BF16_OPS_PER_S if dtype == torch.bfloat16 else \
        PEAK_F32_OPS_PER_S
    t_ops = 4.0 * d * n_pairs / rate * 1e3
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else
                                 "operations")


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


def _serving_path(FA, FD, ref, dev):
    """Phase 6: granite-3-2b at full width behind the compartmentalized
    fleet, then the continuous batcher; the attention kernels' launches are
    counted over exactly this run.  Returns the two kernels' records."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving.scheduler import ContinuousBatcher, Request
    from repro_torch.serving.server import ServingDeployment

    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=dev)
    t0 = time.perf_counter()
    v1 = init_params(cfg, gen.manual_seed(0), device=dev)
    v2 = init_params(cfg, gen.manual_seed(1), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in v1.parameters())
    print(f"serve: {cfg.name} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, {cfg.dtype()}), {n_params:,} parameters "
          f"({n_params * 2 / 1e9:.2f} GB) x 2 versions drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in SERVE_PROMPTS]
    batch_prompts = [rng.integers(0, cfg.vocab_size, BATCH["prompt"]).tolist()
                     for _ in range(BATCH["n_requests"])]
    dep = ServingDeployment(cfg, n_replicas=3, n_proxy_leaders=3,
                            grid=(2, 2), n_clients=2,
                            consistency="linearizable", device=dev)

    # catch the full-width tensors the path hands each kernel: the first
    # prefill at the longest prompt, the last decode call at batch 1 (the
    # longest cache, full) and at the batcher's 8 slots
    caught = {}
    real_fa, real_fd = ops.flash_attention, ops.flash_decode

    def catch_fa(q, k, v, *, causal=True):
        if q.shape[2] == max(SERVE_PROMPTS) and "fa" not in caught:
            caught["fa"] = (q, k, v, causal)
        return real_fa(q, k, v, causal=causal)

    def catch_fd(q, k_cache, v_cache, cache_len):
        caught[f"fd{q.shape[0]}"] = (q, k_cache, v_cache, cache_len)
        return real_fd(q, k_cache, v_cache, cache_len)

    torch.cuda.reset_peak_memory_stats()
    FA.flash_attention.launches = 0
    FD.flash_decode.launches = 0
    ops.flash_attention, ops.flash_decode = catch_fa, catch_fd
    try:
        dep.push_weights(v1)
        served, req_s = [], []
        for i, p in enumerate(prompts):
            if i == 4:
                dep.push_weights(v2)
            slot = dep.rsm.leader.next_slot
            torch.cuda.synchronize()
            t = time.perf_counter()
            served.append(dep.infer(p, max_new=SERVE_NEW, client=i % 2))
            torch.cuda.synchronize()
            req_s.append(time.perf_counter() - t)
            if dep.rsm.leader.next_slot != slot:
                raise AssertionError("an inference moved the leader's log: "
                                     "reads must be leaderless")
        fa_dep = FA.flash_attention.launches
        fd_dep = FD.flash_decode.launches
        cb = ContinuousBatcher(cfg, v1, n_slots=BATCH["n_slots"],
                               max_len=BATCH["max_len"], device=dev)
        reqs = [Request(rid=i, prompt=p, max_new=BATCH["max_new"])
                for i, p in enumerate(batch_prompts)]
        for r in reqs:
            cb.submit(r)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cb.run_until_drained()
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t
    finally:
        ops.flash_attention, ops.flash_decode = real_fa, real_fd
    fa_launches = FA.flash_attention.launches
    fd_launches = FD.flash_decode.launches
    peak_mem = torch.cuda.max_memory_allocated()

    L = cfg.n_layers
    versions = [v for v, _ in served]
    if versions != ["v1"] * 4 + ["v2"] * 4:
        raise AssertionError(f"served versions {versions}")
    for _, toks in served:
        if len(toks) != SERVE_NEW or not all(0 <= t < cfg.vocab_size
                                             for t in toks):
            raise AssertionError(f"bad served tokens {toks}")
    loads = dep.replica_loads()
    if sum(loads) != len(prompts) or max(loads) >= sum(loads):
        raise AssertionError(f"read loads {loads} not spread over replicas")
    if (fa_dep, fd_dep) != (L * len(prompts), L * len(prompts) * SERVE_NEW):
        raise AssertionError(f"fleet launched flash_attention {fa_dep} and "
                             f"flash_decode {fd_dep} times, not {L} per "
                             f"prefill and {L} per decode step")
    if not all(r.done and len(r.out) == BATCH["max_new"] for r in reqs):
        raise AssertionError("the continuous batcher did not drain")
    if (fa_launches - fa_dep, fd_launches - fd_dep) != (
            L * len(reqs), L * cb.steps_executed):
        raise AssertionError("the batcher's launches are not 40 per prefill "
                             "and 40 per decode step")
    direct = _greedy(cfg, v1, prompts[0], SERVE_NEW, dev)
    if list(served[0][1]) != direct:
        raise AssertionError(f"request 0 served {served[0][1]}, a direct "
                             f"decode gives {direct}")
    n_tok = BATCH["n_requests"] * BATCH["max_new"]
    print(f"serve: 8 requests, versions {versions}, read loads {loads}, the "
          f"leader's log unmoved by reads, request 0 == direct decode; "
          f"request wall s {[round(x, 3) for x in req_s]} (prompt "
          f"{list(SERVE_PROMPTS)} + {SERVE_NEW} tokens each); batcher "
          f"{BATCH['n_requests']} x {BATCH['prompt']}-token prompts x "
          f"{BATCH['max_new']} new in {BATCH['n_slots']} slots: "
          f"{cb.steps_executed} steps, occupancy {cb.mean_occupancy:.2f}, "
          f"{batch_s:.2f} s = {n_tok / batch_s:.1f} tokens/s with prefills; "
          f"launches on the path: flash_attention {fa_launches}, "
          f"flash_decode {fd_launches}; peak device memory "
          f"{peak_mem / 2**30:.2f} GiB", flush=True)

    # the path's own times, off the counted run
    pre_ms = {}
    for n in sorted(set(SERVE_PROMPTS)):
        toks = torch.tensor([prompts[SERVE_PROMPTS.index(n)]],
                            dtype=torch.int32, device=dev)
        prefill(cfg, v1, toks, cache_len=n + SERVE_NEW)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill(cfg, v1, toks, cache_len=n + SERVE_NEW)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        pre_ms[n] = sorted(times)[1]
    toks = torch.tensor([prompts[-1]], dtype=torch.int32, device=dev)
    _, caches = prefill(cfg, v1, toks, cache_len=toks.shape[1] + 32)
    tok = toks[:, -1:]
    step_ms = {}
    for b, state in ((1, (caches, tok)), (BATCH["n_slots"],
                                          (cb.caches, cb.tokens))):
        c, t_in = state
        c = [dict(e) for e in c]
        decode_step(cfg, v1, c, t_in)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(16):
            _, c = decode_step(cfg, v1, c, t_in)
        torch.cuda.synchronize()
        step_ms[b] = (time.perf_counter() - t) * 1e3 / 16
    n_ops = _count_ops(lambda: decode_step(cfg, v1, [dict(e) for e in caches],
                                           tok))
    print(f"serve times (host clock, synchronized): prefill ms by prompt "
          f"length {{{', '.join(f'{n}: {m:.2f}' for n, m in pre_ms.items())}"
          f"}}; decode step {step_ms[1]:.2f} ms at batch 1 (cache "
          f"{max(SERVE_PROMPTS)}+), "
          f"{step_ms[BATCH['n_slots']]:.2f} ms at batch "
          f"{BATCH['n_slots']} (cache ~{BATCH['prompt'] + 2 * BATCH['max_new']}"
          f") = {BATCH['n_slots'] * 1e3 / step_ms[BATCH['n_slots']]:.1f} "
          f"tokens/s; {L} flash_attention launches per prefill, {L} "
          f"flash_decode per step; one batch-1 decode step dispatches "
          f"{n_ops} PyTorch operators = {step_ms[1] * 1e3 / n_ops:.1f} us of "
          f"host time each", flush=True)

    # both kernels on the full-width tensors the path handed them
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    records = {}
    q, k, v, causal = caught["fa"]
    B, H, S, D = q.shape
    want = ref.ref_attention(q, k, v, causal=causal)
    got = FA.flash_attention(q, k, v, causal=causal)
    err = _close("flash_attention", got, want, f"full width {tuple(q.shape)}")
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound, by = _attention_bound_ms(pairs, D, nbytes, q.dtype)
    # the planted fault: the last KV tile skipped, which under causal masking
    # changes only the last query tile's rows
    last = slice(S - FAULT_TILE, S)
    early = slice(0, S - FAULT_TILE)
    faulty = ref.ref_attention(q[:, :, last], k[:, :, early], v[:, :, early],
                               causal=False)
    used, fault = (_tol_ratio(got, want),
                   _tol_ratio(faulty, want[:, :, last]))
    records["flash_attention"] = dict(
        max_abs_err=err,
        ms=_time_graph_ms(lambda: FA.flash_attention(q, k, v, causal=causal),
                          flush, 20),
        plain_ms=_time_graph_ms(
            lambda: ref.ref_attention(q, k, v, causal=causal), flush, 3),
        library_ms=_time_graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), flush, 20),
        bound_ms=bound, bound_by=by)
    print(f"kernel flash_attention at the prefill's {tuple(q.shape)} q, "
          f"{tuple(k.shape)} k/v {q.dtype} causal={causal}: max abs err "
          f"{err:.3e} = {used:.3f} of the tolerance (the last KV tile "
          f"skipped reads {fault:.3f}); device times (graph replay, cold L2) "
          + ", ".join(f"{key} {val:.4f}" for key, val in
                      records["flash_attention"].items()
                      if key.endswith("ms")) + f" ({by})", flush=True)
    for key in (f"fd{BATCH['n_slots']}", "fd1"):
        q, kc, vc, cl = caught[key]
        want = ref.ref_decode(q, kc, vc, cl)
        got = FD.flash_decode(q, kc, vc, cl)
        err = _close("flash_decode", got, want,
                     f"full width {tuple(q.shape)} x {tuple(kc.shape)}")
        n_valid = int(cl.sum())
        H, H_kv, D = q.shape[1], kc.shape[1], q.shape[2]
        nbytes = (2 * q.numel() + 2 * H_kv * D * n_valid) * q.element_size() \
            + 4 * cl.numel()
        bound, by = _attention_bound_ms(H * n_valid, D, nbytes, q.dtype)
        mask = (torch.arange(kc.shape[2], device=dev)[None, None, None, :]
                < cl[:, None, None, None])
        # the planted fault: each row's last (partial) KV tile skipped
        short = torch.clamp((cl - 1) // FAULT_TILE * FAULT_TILE, min=1)
        used, fault = (_tol_ratio(got, want),
                       _tol_ratio(ref.ref_decode(q, kc, vc, short), want))
        rec = dict(
            max_abs_err=err,
            ms=_time_graph_ms(lambda: FD.flash_decode(q, kc, vc, cl), flush,
                              50),
            plain_ms=_time_graph_ms(lambda: ref.ref_decode(q, kc, vc, cl),
                                    flush, 20),
            library_ms=_time_graph_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
                flush, 50),
            bound_ms=bound, bound_by=by)
        print(f"kernel flash_decode at batch {q.shape[0]}: q "
              f"{tuple(q.shape)}, caches {tuple(kc.shape)} {q.dtype}, "
              f"cache_len {cl.tolist()}: max abs err {err:.3e} = "
              f"{used:.3f} of the tolerance (the last KV tile skipped reads "
              f"{fault:.3f}); device times (graph replay, cold L2) " +
              ", ".join(f"{k_} {v_:.4f}" for k_, v_ in rec.items()
                        if k_.endswith("ms")) + f" ({by})", flush=True)
        records["flash_decode"] = rec  # the batch-1 call, the fleet's
    records["flash_attention"]["launches"] = fa_launches
    records["flash_decode"]["launches"] = fd_launches
    return records


def _model_cuda_vs_cpu(dev) -> None:
    """Phase 7: the smoke config in float32 on the same weights, on the
    card and on the host: logits agree, greedy and served tokens equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.serving.server import ServingDeployment

    cfg = get_config(SERVE_ARCH).smoke()
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
    print(f"cuda == cpu on {cfg.name} (float32, head dim {cfg.head_dim}): "
          f"logits within rtol/atol 1e-4 (max abs diff "
          f"{float((lg.cpu() - lc).abs().max()):.2e}), greedy tokens and "
          f"three served requests equal", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.core as P
    from repro_torch.core import batched_execution as PB
    from repro_torch.kernels import decode_attention as FD
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import latency_hist as LH
    from repro_torch.kernels import ref
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
    kernels = (("latency_hist.cu", LH), ("flash_attention.cu", FA),
               ("decode_attention.cu", FD))
    with ThreadPoolExecutor(len(kernels)) as pool:
        logs = list(pool.map(lambda kv: kv[1].build(), kernels))
    print(f"build: {', '.join(k for k, _ in kernels)} in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, together)")
    for (src, _), log in zip(kernels, logs):
        for line in log.splitlines():
            print(f"  ptxas {src}: {line.strip()}")

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
          f"cache_len 1 / S_max / per row)", flush=True)

    sweep = P.compile_sweep(P.SweepSpec(**GRID))
    if len(sweep) != 32:
        raise AssertionError(f"expected 32 configs, got {len(sweep)}")
    record = None
    for label, w in _mixes(P):
        samples, mask, edges, n_steps, scan_s = _main_path_tensors(
            PB, sweep, w, dev)
        want = ref.ref_latency_hist(samples, mask, edges)
        got = LH.latency_hist(samples, mask, edges)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        if err != 0 or not torch.equal(got, want):
            raise AssertionError(f"{label}: full-size latency_hist differs "
                                 f"from its plain version (max {err})")
        n_valid = int(mask.sum())
        ms = _time_ms(lambda: LH.latency_hist(samples, mask, edges), 3, 20)
        plain_ms = _time_ms(
            lambda: ref.ref_latency_hist(samples, mask, edges), 1, 2)
        bound_ms, bound_by = _hist_bound_ms(samples, mask, edges, n_valid)
        print(f"kernel {label}: L={samples.shape[0]} N={samples.shape[1]} "
              f"(n_steps {n_steps} x 64 clients), {n_valid} valid samples; "
              f"exact; latency_hist {ms:.4f} ms, plain {plain_ms:.2f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}); "
              f"{LH.latency_hist.launches} launches so far; scan "
              f"{scan_s:.1f} s = {scan_s / n_steps * 1e3:.3f} ms/step",
              flush=True)
        record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by)
        del samples, mask, edges, want, got
        torch.cuda.empty_cache()

    # -- 4. the main path --------------------------------------------------
    alpha = P.calibrate_alpha()
    LH.latency_hist.launches = 0
    for label, w in _mixes(P):
        peak = sweep.peak_throughput(alpha, w)
        _, x_mva, r_mva = sweep.mva(alpha, n_clients_max=64, workload=w,
                                    device=dev)
        torch.cuda.reset_peak_memory_stats()
        before = LH.latency_hist.launches
        res = sweep.execute(workload=w, device=dev, **EXECUTE)
        peak_mem = torch.cuda.max_memory_allocated()
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
        print(f"execute {label}: {len(res)} configs x {EXECUTE['seeds']} "
              f"seeds x {EXECUTE['n_clients']} clients x {n} commands; "
              f"n_steps {res.n_steps}; probe {t['probe']:.2f} s, scan "
              f"{t['scan']:.2f} s ({t['scan'] / res.n_steps * 1e3:.3f} "
              f"ms/step), hist+sums {t['hist'] * 1e3:.1f} ms; peak device "
              f"memory {peak_mem / 2**30:.2f} GiB", flush=True)
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
        np.testing.assert_allclose(a, b, rtol=1e-5)
    expo = small.execute(device=dev, exponential_service=True, **kw)
    if not np.all(expo.hist.sum(axis=2) == kw["n_commands"]):
        raise AssertionError("exponential-service lanes did not drain")
    print("cuda == cpu on a 4-config x 2-seed grid (hist, drains, "
          "makespans, msgs/cmd exact; mean latency rtol 1e-9; MVA rtol "
          "1e-5); exponential service drains on the card")

    # -- 6. the serving path ----------------------------------------------
    attn = _serving_path(FA, FD, ref, dev)

    # -- 7. the card against the CPU on the model ---------------------------
    _model_cuda_vs_cpu(dev)

    print(json.dumps({"kernels": [
        dict(name="latency_hist", route="cuda",
             source="src/repro_torch/kernels/csrc/latency_hist.cu",
             replaces="src/repro/kernels/latency_hist.py:23",
             launches=launches, library_ms=None, **record),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:34",
             **attn["flash_attention"]),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:31",
             **attn["flash_decode"])]}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

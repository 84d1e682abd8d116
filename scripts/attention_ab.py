#!/usr/bin/env python3
"""Time the port's attention kernels against an earlier version of
their sources, in one process on one card.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/base
    PYTHONPATH=src python3 scripts/attention_ab.py \\
        --baseline build/base/src/repro_torch/kernels/csrc [--only backward]

The baseline directory holds an earlier ``flash_attention.cu``,
``decode_attention.cu`` (with the C entry points of the two-launch decode:
``flash_decode_launch`` without the arrival counters, as before the
one-launch bfloat16 kernel) and ``flash_attention_bwd.cu`` (with the
three-launch entry point ``flash_attention_bwd_launch`` of the
``mma.sync`` backward: 24 strides, a dense float32 delta).  Each is built
with ``nvcc`` as ``kernels/_build.py`` builds the port's own, into
``build/ab/``.  At the serving paths' shapes (granite-3-2b's 2048-token
prefill and decode at batch 1 and 8; recurrentgemma-2b's 3000-token
windowed prefill and decode at batch 1 and 8, in the models' strided
layouts) and, for the backward, at granite-3-2b's training shape,
whisper-tiny's three train-step shapes, qwen3-moe-30b-a3b's d = 128
heads on 2048 tokens and recurrentgemma-2b's d = 256 training shape,
each kernel is held to the other
and timed as ``chip_smoke.py`` times it (CUDA-graph replay after an L2
flush), in turns baseline, current, current, baseline, beside SDPA (its
backward for the backward, captured through autograd); a backward shape
whose head dim the baseline's entry point refuses in bfloat16
(``cudaErrorInvalidValue``) is skipped with a line that says so.  For each
backward shape one ``torch.profiler`` window of each version splits the
device time between its launches (:func:`_split_ms`).  Prints one line
per shape and a JSON object of every time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as FD  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

#: (name, B, H, H_kv, S, d, window) of the prefills; decode (name, B, H,
#: H_kv, S_max, d, cache_len)
PREFILLS = [("granite prefill 2048", 1, 32, 8, 2048, 64, None),
            ("recurrentgemma prefill 3000", 1, 10, 1, 3000, 256, 2048)]
#: (name, B, H, H_kv, S_q, S_k, d, causal) of the backward: granite-3-2b's
#: training shape, whisper-tiny's train step (cross-attention, its
#: encoder, its decoder), qwen3-moe-30b-a3b's heads (32 over 4, d = 128)
#: on a 2048-token sequence and recurrentgemma-2b's training shape (10
#: heads over 1, d = 256; its 2048-key window covers all 1024 keys, so
#: causal is the same function)
BACKWARDS = [("granite train 4x1024", 4, 32, 8, 1024, 1024, 64, True),
             ("whisper cross 16x1500", 2, 6, 6, 16, 1500, 64, False),
             ("whisper encoder 1500", 2, 6, 6, 1500, 1500, 64, False),
             ("whisper causal 16", 2, 6, 6, 16, 16, 64, True),
             ("qwen3-moe d128 2048", 1, 32, 4, 2048, 2048, 128, True),
             ("recurrentgemma train d256", 4, 10, 1, 1024, 1024, 256, True)]
DECODES = [("granite decode b1", 1, 32, 8, 2064, 64, 2064),
           ("granite decode b8", 8, 32, 8, 1024, 64, 576),
           ("recurrentgemma decode b1", 1, 10, 1, 2048, 256, 2048),
           ("recurrentgemma decode b8", 8, 10, 1, 2048, 256, 576)]


def _build_lib(path: Path) -> ctypes.CDLL:
    out = ROOT / "build" / "ab" / f"base_{path.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), _build.ARCH, *_build.FLAGS, "-o",
                    str(out), str(path)], check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _time_graph_ms(fn, flush, reps: int = 50, stream=None) -> float:
    """``stream``: where to warm up and capture (a backward through
    autograd runs on its forward's stream); by default a new one."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
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
    return sum(a.elapsed_time(b) for a, b in events) / reps


def _model_view(shape, gen):
    """A (B, H, S, d) bf16 view of a (B, S, H, d) tensor, as the model
    hands it in."""
    B, H, S, D = shape
    return torch.randn((B, S, H, D), generator=gen, device="cuda",
                       dtype=torch.bfloat16).transpose(1, 2)


def _base_prefill(lib, q, k, v, window):
    B, H, S, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    st = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                    for s in t.stride()[:3]))
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_void_p]
    err = fn(1, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, H, k.shape[1], S, 1, window or 0, 1.0 / math.sqrt(D), st,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def _base_decode(lib, q, kc, vc, cl, plan):
    B, H, D = q.shape
    H_kv, S_max = kc.shape[1], kc.shape[2]
    n_splits, split_len = plan
    group = H // H_kv
    ws = torch.empty(B * H_kv * n_splits * (group * D + 2 * group),
                     dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    st = (ctypes.c_longlong * 10)(*q.stride()[:2], *kc.stride()[:3],
                                   *vc.stride()[:3], *out.stride()[:2])
    fn = lib.flash_decode_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_void_p]
    err = fn(1, D, q.data_ptr(), kc.data_ptr(), vc.data_ptr(), cl.data_ptr(),
             ws.data_ptr(), out.data_ptr(), B, H, H_kv, S_max, n_splits,
             split_len, 1.0 / math.sqrt(D), st,
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def _old_split_plan(batch, n_kv_heads, s_max, n_sms):
    """The split plan that went with the two-launch decode: 64-key tiles,
    about two blocks per SM, no more splits than tiles."""
    n_tiles = max(1, -(-s_max // 64))
    want = -(-2 * n_sms // max(1, batch * n_kv_heads))
    n_splits = min(max(1, want), n_tiles)
    split_len = -(-n_tiles // n_splits) * 64
    return -(-s_max // split_len), split_len


class Refused(Exception):
    """The baseline's entry point returned cudaErrorInvalidValue: it does
    not take this head dim and dtype."""


def _base_bwd(lib, q, k, v, out, lse, dout, causal):
    """The baseline's backward: (dq, dk, dv) from its C entry point."""
    B, H, S, D = q.shape
    dq = torch.empty((B, S, H, D), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    st = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, out, dout, dq, dk,
                                                dv) for s in t.stride()[:3]))
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + \
        [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p,
                              ctypes.c_void_p]
    err = fn(1, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, k.shape[1],
             S, k.shape[2], int(causal), 0, 1.0 / math.sqrt(D), st,
             torch.cuda.current_stream().cuda_stream)
    if err == 1:  # cudaErrorInvalidValue
        raise Refused(D)
    assert err == 0, err
    return dq, dk, dv


def _split_ms(fn, reps: int = 5) -> dict:
    """Device ms a call of ``fn`` by launch, from one ``torch.profiler``
    window of ``reps`` calls: delta, dq, dk/dv (the ``mma.sync`` or CUDA-
    core backward's three launches), or delta, "dq + dk/dv" (the
    ``wgmma`` backward's one launch of both roles) and, with key or group
    splits, the merge."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0.0))
        kind = ("delta" if "delta" in evt.key else
                "dq + dk/dv" if "bwd_wgmma" in evt.key else
                "merge" if "merge" in evt.key else
                "dk/dv" if "dkdv" in evt.key else
                "dq" if "dq" in evt.key else None)
        if kind and us > 0:
            split[kind] = split.get(kind, 0.0) + us / 1e3 / reps
    return split


def _diff(got, want) -> float:
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def _turns(name, base_fn, new_fn, lib_fn, flush, times, lib_stream=None):
    got, want = new_fn(), base_fn()
    torch.cuda.synchronize()
    err = _diff(got, want)
    base = [_time_graph_ms(base_fn, flush)]
    new = [_time_graph_ms(new_fn, flush), _time_graph_ms(new_fn, flush)]
    base.append(_time_graph_ms(base_fn, flush))
    sdpa = _time_graph_ms(lib_fn, flush, stream=lib_stream)
    times[name] = dict(baseline_ms=base, current_ms=new, sdpa_ms=sdpa,
                       max_abs_diff=err)
    print(f"{name}: baseline {base[0]:.4f} / {base[1]:.4f} ms, current "
          f"{new[0]:.4f} / {new[1]:.4f} ms, SDPA {sdpa:.4f} ms; max |current "
          f"- baseline| {err:.3e}", flush=True)


def _backward_ab(base_bwd, gen, flush, times) -> None:
    """The backward at each of ``BACKWARDS`` that the baseline takes, on
    the forward kernel's own output and log-sum-exp, in the models' (B, S,
    H, d) layouts."""
    for name, B, H, H_kv, Sq, Sk, D, causal in BACKWARDS:
        q, do = (_model_view((B, H, Sq, D), gen) for _ in "qo")
        k, v = (_model_view((B, H_kv, Sk, D), gen) for _ in "kv")
        out, lse = FA._launch(q, k, v, causal, None, with_lse=True)
        base_fn = lambda: _base_bwd(base_bwd, q, k, v, out, lse, do, causal)
        new_fn = lambda: FA.flash_attention_bwd(q, k, v, out, lse, do,
                                                causal=causal)
        try:
            base_fn()
        except Refused:
            why = f"the baseline's backward refuses d = {D} in bfloat16"
            times[name] = {"skipped": why}
            print(f"{name}: skipped, {why}", flush=True)
            continue
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            sdpa_out = F.scaled_dot_product_attention(
                *leaves, is_causal=causal, enable_gqa=H != H_kv)
        torch.cuda.current_stream().wait_stream(side)
        _turns(name, base_fn, new_fn, lambda: torch.autograd.grad(
            sdpa_out, leaves, do, retain_graph=True), flush, times,
            lib_stream=side)
        split = {"baseline": _split_ms(base_fn), "current": _split_ms(new_fn)}
        times[name]["split_ms"] = split
        print(f"{name}: device ms a call by launch (profiler) " + "; ".join(
            f"{who} " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            for who, parts in split.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="directory of the earlier flash_attention.cu, "
                         "decode_attention.cu and flash_attention_bwd.cu")
    ap.add_argument("--only", choices=("all", "forward", "backward"),
                    default="all", help="the forward kernels (prefill and "
                    "decode), the backward, or all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times = {}
    if args.only in ("all", "backward"):
        base_bwd = _build_lib(args.baseline / "flash_attention_bwd.cu")
        FA.build()
        for name, regs, st, ld in _build.ptxas_report(FA.build_bwd()):
            print(f"  ptxas flash_attention_bwd.cu {name}: {regs} registers,"
                  f" spill stores {st} B, loads {ld} B", flush=True)
        _backward_ab(base_bwd, gen, flush, times)
    if args.only in ("all", "forward"):
        _forward_ab(args.baseline, gen, flush, times)
    print(json.dumps({"device": smi, "times": times}))
    return 0


def _forward_ab(baseline: Path, gen, flush, times) -> None:
    """The prefill and decode kernels at ``PREFILLS`` and ``DECODES``."""
    base_fa = _build_lib(baseline / "flash_attention.cu")
    base_fd = _build_lib(baseline / "decode_attention.cu")
    FA.build()
    FD.build()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, B, H, H_kv, S, D, window in PREFILLS:
        q = _model_view((B, H, S, D), gen)
        k, v = (_model_view((B, H_kv, S, D), gen) for _ in "kv")
        if window is None:
            sdpa = dict(is_causal=True)
        else:
            pos = torch.arange(S, device="cuda")
            gap = pos[:, None] - pos[None, :]
            sdpa = dict(attn_mask=(gap >= 0) & (gap < window))
        _turns(name, lambda: _base_prefill(base_fa, q, k, v, window),
               lambda: FA.flash_attention(q, k, v, window=window),
               lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True,
                                                      **sdpa),
               flush, times)
    for name, B, H, H_kv, S, D, n in DECODES:
        q = torch.randn((B, H, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        kc, vc = (_model_view((B, H_kv, S, D), gen) for _ in "kv")
        cl = torch.full((B,), n, dtype=torch.int32, device="cuda")
        mask = (torch.arange(S, device="cuda")[None, None, None, :]
                < cl[:, None, None, None])
        plan = _old_split_plan(B, H_kv, S, n_sms)
        _turns(name, lambda: _base_decode(base_fd, q, kc, vc, cl, plan),
               lambda: FD.flash_decode(q, kc, vc, cl),
               lambda: F.scaled_dot_product_attention(
                   q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True),
               flush, times)


if __name__ == "__main__":
    sys.exit(main())

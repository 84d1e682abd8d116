#!/usr/bin/env python3
"""Time the port's recurrence kernels against an earlier version of their
sources, in one process on one card.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/base
    PYTHONPATH=src python3 scripts/recurrence_ab.py \\
        --baseline build/base/src/repro_torch/kernels/csrc

The baseline directory holds an earlier ``wkv6.cu``, ``rglru_scan.cu`` and
``wkv6_bwd.cu`` (those of ``111099d``, the parent of the chunked WKV
backward): ``wkv6`` and ``rglru_scan`` with the C entry points they have
now (the RG-LRU scan is called through the current wrapper with the
baseline's library in its place), ``wkv6_bwd`` with the serial form's
entry point and workspace (carried here as ``_base_wkv6_bwd``).  All are
built with ``nvcc`` as ``kernels/_build.py`` builds the port's own, into
``build/ab/``.  At the paths' shapes (rwkv6-7b's WKV at 64 heads of 64,
bf16 r, k and v and float32 logw in the dense (B, S, H, d) layout its time
mix hands over: prefills of 4096 and 512 tokens from zero, decode at
batch 1 and 8 from a state; its backward at T5's training shape, 4 x 1024
tokens, no starting state and s_last unused; recurrentgemma-2b's float32
RG-LRU at width 2560: prefills of 3000 and 512 steps from zero, decode at
batch 1 and 8 from h0) each current kernel is held to the baseline within
``chip_smoke.py``'s ``WKV_TOL`` and ``SCAN_TOL`` (the backward's relative
to each gradient's largest entry; the script fails past them) and both are
timed as ``chip_smoke.py`` times them (CUDA-graph replay after an L2
flush, replays queued behind a sleep on the card), in turns baseline,
current, current, baseline.  Prints one line per shape and a JSON object
of every time.

With ``--phases`` it also builds the current ``wkv6.cu`` with
``WKV6_PHASE_CLOCKS`` defined and prints, at the two prefills, the cycles
a chunk each warp of the first block spends in each phase, and
``wkv6_bwd.cu`` with ``WKV6_BWD_PHASE_CLOCKS`` defined, and prints the
same at T5's shape (the sources' notes name the phases): which phase sets
the chunk's time.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (  # noqa: E402
    SCAN_TOL,
    WKV_TOL,
    _grad_ratio,
    _tol_ratio,
    _wkv_ratio,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rglru_scan as RS  # noqa: E402
from repro_torch.kernels import wkv6 as WK  # noqa: E402

#: (name, B, S) of the WKV calls at 64 heads of 64; decode starts from s0
WKV_SHAPES = [("wkv6 prefill 4096", 1, 4096), ("wkv6 prefill 512", 1, 512),
              ("wkv6 decode b1", 1, 1), ("wkv6 decode b8", 8, 1)]
#: (name, B, S) of the RG-LRU scans at width 2560; decode starts from h0
SCAN_SHAPES = [("rglru_scan prefill 3000", 1, 3000),
               ("rglru_scan prefill 512", 1, 512),
               ("rglru_scan decode b1", 1, 1),
               ("rglru_scan decode b8", 8, 1)]
#: (name, B, S) of the WKV backward: T5's training shape
BWD_SHAPES = [("wkv6_bwd T5 4 x 1024", 4, 1024)]
HEADS = HEAD_DIM = 64
WIDTH = 2560
#: the serial backward's plan (the baseline's): steps a chunk, value
#: columns a block by head dim
_OLD_BWD_CHUNK = 16
_OLD_BWD_COLUMNS = {16: 16, 32: 32, 64: 16, 128: 8}


#: what a prefill block's warps do in each marked phase (csrc/wkv6.cu)
PRODUCER_PHASES = ("wait buffer", "wait copy", "A1", "A1 barrier", "A2",
                   "A2 barrier")
CONSUMER_PHASES = ("wait factors", "S'", "B", "B barrier", "C",
                   "C barrier")
#: what the backward's warps do in each marked phase (csrc/wkv6_bwd.cu)
BWD_PHASES = ("wait copy", "fwd factors", "fwd update", "sums and factors",
              "scores and dr inter", "dS staged", "products", "dlogw and du",
              "step by step")


def _build_lib(path: Path, tag: str = "base", *flags: str) -> ctypes.CDLL:
    out = ROOT / "build" / "ab" / f"{tag}_{path.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), _build.ARCH, *_build.FLAGS,
                           *flags, "-o", str(out), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def _wkv_argtypes(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``wkv6_launch``'s argument types (the same before and after the
    chunked form)."""
    lib.wkv6_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 2)
    return lib


def _time_graph_ms(fn, flush, reps: int = 50) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def _base_wkv6(lib, r, k, v, logw, u, s0):
    B, S, H, D = r.shape
    y = torch.empty((B, S, H, D), dtype=r.dtype, device=r.device)
    s_last = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    st = [x for t in (r, k, v, logw) for x in t.stride()[:3]]
    st += list(s0.stride()[:2]) if s0 is not None else [0, 0]
    err = lib.wkv6_launch(1, D, r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
             u.data_ptr(), s0.data_ptr() if s0 is not None else None,
             y.data_ptr(), s_last.data_ptr(), B, S, H,
             (ctypes.c_longlong * 14)(*st),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return y, s_last


@contextlib.contextmanager
def _library(module, attr: str, lib: ctypes.CDLL):
    """``module``'s loaded library ``attr`` replaced by ``lib`` (whose
    entry point takes the same arguments) for the duration."""
    old = getattr(module, attr)
    setattr(module, attr, lib)
    try:
        yield
    finally:
        setattr(module, attr, old)


def _same_argtypes(lib: ctypes.CDLL, like: ctypes.CDLL, fn: str):
    getattr(lib, fn).argtypes = getattr(like, fn).argtypes
    getattr(lib, fn).restype = getattr(like, fn).restype
    return lib


def _base_wkv6_bwd(lib, r, k, v, logw, u, dy):
    """The serial backward's call (no s0, no ds_last): its column blocks'
    partials, du's partials and checkpoints every 16 steps in one
    workspace."""
    B, S, H, D = r.shape
    vb = _OLD_BWD_COLUMNS[D]
    ncb, n, chunks = D // vb, B * S * H * D, -(-S // _OLD_BWD_CHUNK)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw = torch.empty_like(logw)
    du = torch.empty((H, D), dtype=torch.float32, device=r.device)
    ws = torch.empty(3 * ncb * n + ncb * B * H * D + chunks * B * H * D * D,
                     dtype=torch.float32, device=r.device)
    st = (ctypes.c_longlong * 15)(
        *[x for t in (r, k, v, logw, dy) for x in t.stride()[:3]])
    err = lib.wkv6_bwd_launch(
        1, D, vb, r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None, dy.data_ptr(), None, dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(), None, ws.data_ptr(),
        B, S, H, st, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return dr, dk, dv, dlogw, du


def _turns(name, base_fn, new_fn, ratio, flush, times):
    """Hold ``new_fn``'s outputs to ``base_fn``'s (``ratio`` of got and
    want above 1, or a value that is not finite, fails) and time both."""
    got, want = new_fn(), base_fn()
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    scale = max(float(w.float().abs().max()) for w in want)
    used = max(ratio(g, w) for g, w in zip(got, want))
    if not (used <= 1.0 and all(bool(torch.isfinite(g).all()) for g in got)):
        raise AssertionError(f"{name}: the current kernel is {used:.3f} of "
                             f"the tolerance from the baseline (max abs "
                             f"diff {err:.3e})")
    base = [_time_graph_ms(base_fn, flush)]
    new = [_time_graph_ms(new_fn, flush), _time_graph_ms(new_fn, flush)]
    base.append(_time_graph_ms(base_fn, flush))
    times[name] = dict(baseline_ms=base, current_ms=new, max_abs_diff=err,
                       max_abs=scale, tolerance_used=used)
    print(f"{name}: baseline {base[0]:.4f} / {base[1]:.4f} ms, current "
          f"{new[0]:.4f} / {new[1]:.4f} ms; max |current - baseline| "
          f"{err:.3e} (max |baseline| {scale:.3e}), {used:.3f} of the "
          f"tolerance", flush=True)


def _phases(lib, r, k, v, logw, u):
    """Cycles a chunk by warp and phase of one prefill's first block, from
    the instrumented build ``lib``."""
    B, S, H, D = r.shape
    y = torch.empty_like(r)
    s_last = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    st = [x for t in (r, k, v, logw) for x in t.stride()[:3]] + [0, 0]
    clocks = (ctypes.c_uint * (16 * 6))()
    err = lib.wkv6_launch(1, D, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          logw.data_ptr(), u.data_ptr(), None, y.data_ptr(),
                          s_last.data_ptr(), B, S, H,
                          (ctypes.c_longlong * 14)(*st),
                          torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    torch.cuda.synchronize()
    assert lib.wkv6_phase_clocks(clocks) == 0
    n_chunks = -(-S // WK.CHUNK[D])
    return [[clocks[6 * w + p] / n_chunks for p in range(6)]
            for w in range(16)]


def _bwd_phases(lib, r, k, v, logw, u, dy):
    """Cycles a chunk by warp and phase of the backward's first block at
    these inputs, from the instrumented build ``lib`` (called through the
    current wrapper with ``lib`` in place of its library)."""
    clocks = (ctypes.c_uint * (8 * len(BWD_PHASES)))()
    with _library(WK, "_bwd_lib", lib):
        WK.wkv6_bwd(r, k, v, logw, u, None, dy)
    torch.cuda.synchronize()
    assert lib.wkv6_bwd_phase_clocks(clocks) == 0
    n_chunks = WK.bwd_plan(r.shape[1], r.shape[3])[1]
    n = len(BWD_PHASES)
    return [[clocks[n * w + p] / n_chunks for p in range(n)]
            for w in range(8)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="directory of the earlier wkv6.cu and rglru_scan.cu")
    ap.add_argument("--phases", action="store_true",
                    help="also print the WKV prefill's cycles by phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("recurrence_ab: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    WK.build()
    WK.build_bwd()
    RS.build()
    base_wkv = _wkv_argtypes(_build_lib(args.baseline / "wkv6.cu"))
    base_rs = _same_argtypes(_build_lib(args.baseline / "rglru_scan.cu"),
                             RS._lib, "rglru_scan_launch")
    base_bwd = _build_lib(args.baseline / "wkv6_bwd.cu")
    base_bwd.wkv6_bwd_launch.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3
        + [ctypes.c_void_p] * 2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    times, phases = {}, {}

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def wkv_inputs(B, S):
        r, k, v = (draw(B, S, HEADS, HEAD_DIM).bfloat16() for _ in "rkv")
        logw = torch.clamp(-torch.exp(draw(B, S, HEADS, HEAD_DIM) - 1.0),
                           min=-5.0)
        u = draw(HEADS, HEAD_DIM) * 0.1
        s0 = draw(B, HEADS, HEAD_DIM, HEAD_DIM) if S == 1 else None
        return r, k, v, logw, u, s0

    for name, B, S in WKV_SHAPES:
        args_ = wkv_inputs(B, S)
        _turns(name, lambda: _base_wkv6(base_wkv, *args_),
               lambda: WK.wkv6(*args_), _wkv_ratio, flush, times)
    for name, B, S in BWD_SHAPES:
        r, k, v, logw, u, _ = wkv_inputs(B, S)
        dy = draw(B, S, HEADS, HEAD_DIM).bfloat16()
        _turns(name, lambda: _base_wkv6_bwd(base_bwd, r, k, v, logw, u, dy),
               lambda: WK.wkv6_bwd(r, k, v, logw, u, None, dy)[:5],
               lambda g, w: _grad_ratio(g, w, WKV_TOL), flush, times)

    def base_scan(x, a, h0):
        with _library(RS, "_lib", base_rs):
            return RS.rglru_scan(x, a, h0)

    for name, B, S in SCAN_SHAPES:
        x = draw(B, S, WIDTH)
        a = torch.rand((B, S, WIDTH), generator=gen, device="cuda") * 0.5 \
            + 0.5
        h0 = draw(B, WIDTH) if S == 1 else None
        _turns(name, lambda: base_scan(x, a, h0),
               lambda: RS.rglru_scan(x, a, h0),
               lambda g, w: _tol_ratio(g, w, SCAN_TOL), flush, times)
    if args.phases:
        lib = _wkv_argtypes(_build_lib(ROOT / "src" / "repro_torch" /
                                       "kernels" / "csrc" / "wkv6.cu",
                                       "phases", "-DWKV6_PHASE_CLOCKS"))
        lib.wkv6_phase_clocks.argtypes = [ctypes.c_void_p]
        for name, B, S in WKV_SHAPES[:2]:
            rows = _phases(lib, *wkv_inputs(B, S)[:5])
            phases[name] = rows
            print(f"{name}: cycles a chunk by phase, warps of block 0")
            for w, row in enumerate(rows):
                role, names = (("consumer", CONSUMER_PHASES) if w < 8 else
                               ("producer", PRODUCER_PHASES))
                print(f"  warp {w:2d} ({role}): " + ", ".join(
                    f"{n} {c:.0f}" for n, c in zip(names, row))
                    + f"; total {sum(row):.0f}", flush=True)
        src = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
        lib = _same_argtypes(_build_lib(src / "wkv6_bwd.cu", "phases",
                                        "-DWKV6_BWD_PHASE_CLOCKS"),
                             WK._bwd_lib, "wkv6_bwd_launch")
        lib.wkv6_bwd_phase_clocks.argtypes = [ctypes.c_void_p]
        for name, B, S in BWD_SHAPES:
            r, k, v, logw, u, _ = wkv_inputs(B, S)
            dy = draw(B, S, HEADS, HEAD_DIM).bfloat16()
            rows = _bwd_phases(lib, r, k, v, logw, u, dy)
            phases[name] = rows
            print(f"{name}: cycles a chunk by phase (the walk forward's "
                  f"phases over its chunks but the last), warps of block 0")
            for w, row in enumerate(rows):
                print(f"  warp {w}: " + ", ".join(
                    f"{n} {c:.0f}" for n, c in zip(BWD_PHASES, row))
                    + f"; total {sum(row):.0f}", flush=True)
    print(json.dumps({"device": smi, "times": times, "phases": phases}))
    return 0

if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (the run then exits non-zero and prints
no result line):

1. device - the card's name and count, and ``nvidia-smi``'s name and
   power limit; without a card the run fails at once;
2. build - compile every CUDA kernel of the port from ``src/`` (one
   ``nvcc`` per source, all started together) and print ``-Xptxas -v``;
3. kernels against their plain versions - small shapes and edge cases,
   then the main path's own full-size tensors; exact equality, with the
   kernel's and the plain version's times and the kernel's bound;
4. the main path - ``compile_sweep`` of the 32-config compartmentalized
   MultiPaxos grid (f = 1, 2x2 acceptor grid; the deployment family of the
   paper's ablation, arXiv 2012.15762 section 8, Fig. 29), its bottleneck
   law and MVA on the card, and ``.execute`` at 2048 commands x 8 seeds x
   64 clients for the paper's two headline mixes; every lane must drain
   and every kernel of the path must launch;
5. the card against the CPU - the port on ``cuda`` and on ``cpu`` agree on
   a 4-config x 2-seed grid.

The line before the last is the card's name and power limit; the line
before it, a JSON object describing every kernel; the last line,
``{"ok": true, "device": {...}}``.  Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: H100 SXM device memory rate and float32 rate outside the tensor cores
#: (NVIDIA's data sheet, at the full 700 W power limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

GRID = dict(variants=("compartmentalized",),
            n_proxy_leaders=(2, 3, 4, 5, 6, 7, 8, 10), grids=((2, 2),),
            n_replicas=(2, 3, 4, 6))
EXECUTE = dict(n_commands=2048, seeds=8, n_clients=64, probe_n=96)


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.core as P
    from repro_torch.core import batched_execution as PB
    from repro_torch.kernels import latency_hist as LH
    from repro_torch.kernels import ref
    dev = torch.device("cuda")

    # -- 1. device ---------------------------------------------------------
    smi = _nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {smi}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    log = LH.build()
    print(f"build: latency_hist.cu in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        print(f"  ptxas: {line.strip()}")

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

    print(json.dumps({"kernels": [dict(
        name="latency_hist", route="cuda",
        source="src/repro_torch/kernels/csrc/latency_hist.cu",
        replaces="src/repro/kernels/latency_hist.py:23",
        launches=launches, library_ms=None, **record)]}))
    print(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

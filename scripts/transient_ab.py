#!/usr/bin/env python3
"""Time the transient path of this tree against an earlier tree's, in turns
on one card, and split the step kernels' cycles by phase.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/transient_ab.py --baseline build/parent [--phases]

Each turn is a child process that imports ``repro_torch`` from one tree's
``src/`` (the two trees share the package's name) and runs on the card,
after a small warm-up run that builds the kernels: phase 6's transient grid
at both mixes (``chip_smoke.py``'s ``GRID``, ``TRANSIENT`` and
``TRANSIENT_CRASH``: 32 configs x 8 seeds x 64 clients x 4000 steps, a
leader crash at 40-60 %), with its ``timings["scan"]`` and peak device
memory, then the same run for the step kernel's device time (CUDA events
around each launch, each queued behind a sleep on the card, summed; the
kernel a launch plan picks, on this tree the warp kernel);
``autotune(objective="p99_under_failover")`` at budget 19; and
``autotune_policy`` at ``benchmarks/autoscale.py``'s settings, each on the
host's clock.  The settings and the last two runs are ``chip_smoke.py``'s
(``_failover_ranking``, ``_autoscale_policy``), from this tree.  Turns:
baseline, current, current, baseline.  Every turn's results must be equal
(the grid's flows, histograms and queue sums, the ranking's pick and p99,
the policy's numbers), else the script exits non-zero.  ``nvidia-smi``'s
SM clock, temperature and power draw are printed before and after, a line
per turn, and a JSON object of every time last.

``--phases`` also builds this tree's ``transient_lanes.cu`` with
``TRANSIENT_LANES_PHASE_CLOCKS`` defined (and the baseline's, if it has
them): each kernel then adds the cycles one thread of lane 0 spends in each
phase of a step (the source names the phases) to a device table.  For each
kernel (``--kernels``, default both) and mix it runs the same grid in this
process and prints the cycles a step by phase beside the run's
microseconds a step, each build's registers and spills by kernel
(``-Xptxas -v``), and the uninstrumented warp kernel's time at 1, 2 and 4
lanes a block.  ``--phases-only`` skips the turns.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _child(tree: Path) -> int:
    """One turn: the runs on ``tree``'s package; prints one JSON line."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    import repro_torch.core as P
    from repro_torch.core import transient as PT
    from repro_torch.kernels import transient_lanes as TL
    sys.path.insert(1, str(ROOT))
    import chip_smoke as CS
    if Path(P.__file__).resolve().parents[2] != (tree / "src").resolve():
        raise RuntimeError(f"imported {P.__file__}, not {tree}'s package")
    dev = torch.device("cuda")
    alpha = P.calibrate_alpha()
    digest = hashlib.sha256()
    # warm-up: builds the kernels the path runs
    small = P.compile_sweep(P.SweepSpec(n_proxy_leaders=(2,),
                                        grids=((2, 2),), n_replicas=(2,)))
    small.transient(alpha, n_clients=8, seeds=2, n_steps=16, device=dev)
    sweep = P.compile_sweep(P.SweepSpec(**CS.GRID))
    out = {"scan_s": {}, "kernel_ms": {}, "peak_gib": {}}
    for label, w in CS._mixes(P):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = sweep.transient(alpha, workload=w,
                              events=[P.Event(*CS.TRANSIENT_CRASH)],
                              device=dev, **CS.TRANSIENT)
        out["scan_s"][label] = res.timings["scan"]
        _, out["kernel_ms"][label], _ = CS._step_run(
            PT, TL.transient_lanes, sweep.transient, alpha, workload=w,
            events=[P.Event(*CS.TRANSIENT_CRASH)], device=dev,
            kernel="transient_lanes", keys=CS.TRANSIENT_STATE, lead=True,
            **CS.TRANSIENT)
        out["peak_gib"][label] = torch.cuda.max_memory_allocated() / 2 ** 30
        for arr in (res.flows, res.hist, res.queue_sums):
            digest.update(np.ascontiguousarray(arr).tobytes())
    tune, out["autotune_failover_s"] = CS._failover_ranking(P, alpha, dev)
    digest.update(repr((sorted(tune.best_config.items()),
                        float(tune.best_p99))).encode())
    _, _, got, out["autotune_policy_s"] = CS._autoscale_policy(P, alpha, dev)
    digest.update(json.dumps(got, sort_keys=True).encode())
    out["digest"] = digest.hexdigest()
    print(json.dumps(out), flush=True)
    return 0


#: the phases each kernel marks, in the source's order
PHASES = {"block": ("loads", "stations (b)", "barrier 1", "clients (c)",
                    "barrier 2", "(d)+outputs"),
          "warp": ("chunk staging", "window+(b)+ballot", "(d)",
                   "clients (c)", "keep outputs", "chunk stores")}
N_PHASES = 6


def _phases(baseline: Path, kernels) -> dict:
    """The phase split of the step kernels on the transient grid, in this
    process on this tree's package: {"mix, source, kernel": split}."""
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as CS
    import repro_torch.core as P
    from repro_torch.core import transient as PT
    from repro_torch.kernels import _build
    from repro_torch.kernels import transient_lanes as TL
    from exec_lanes_ab import build_lib, forced_plan, report, type_like

    dev = torch.device("cuda")
    alpha = P.calibrate_alpha()
    report("current", _build.ptxas_report(TL.build()))
    current = TL._lib
    src = Path(TL.__file__).parent / "csrc" / "transient_lanes.cu"
    sources = {"current": src}
    base_src = baseline / "src/repro_torch/kernels/csrc/transient_lanes.cu"
    if "TRANSIENT_LANES_PHASE_CLOCKS" in base_src.read_text():
        sources["baseline"] = base_src
    else:
        print("the baseline has no phase clocks: its block kernel's split "
              "is the current block kernel's where the two are the same "
              "code", flush=True)
    libs = {}
    for name, path in sources.items():
        lib, rows = build_lib(path, f"phases_{name}",
                              ("-DTRANSIENT_LANES_PHASE_CLOCKS",))
        report(f"{name} with phase clocks", rows)
        type_like(lib, current, ["transient_lanes_launch",
                                 "transient_lanes_warp_launch"])
        lib.transient_lanes_phase_clocks.argtypes = [ctypes.c_void_p,
                                                     ctypes.c_int]
        lib.transient_lanes_phase_clocks.restype = ctypes.c_int
        libs[name] = lib

    def grid(lib, plan, w):
        real_lib, real_plan = TL._lib, TL.plan
        TL._lib, TL.plan = lib, plan
        try:
            _, ms, _ = CS._step_run(
                PT, TL.transient_lanes, sweep.transient, alpha, workload=w,
                events=[P.Event(*CS.TRANSIENT_CRASH)], device=dev,
                kernel="transient_lanes", keys=CS.TRANSIENT_STATE,
                lead=True, **CS.TRANSIENT)
        finally:
            TL._lib, TL.plan = real_lib, real_plan
        return ms

    sweep = P.compile_sweep(P.SweepSpec(**CS.GRID))
    n = CS.TRANSIENT["n_steps"]
    out = {}
    table = (ctypes.c_ulonglong * (2 * (N_PHASES + 1)))()
    for label, w in CS._mixes(P):
        grid(current, TL.plan, w)   # builds and warms up
        for name, lib in libs.items():
            for kernel in kernels:
                lib.transient_lanes_phase_clocks(None, 1)
                ms = grid(lib, forced_plan(TL, kernel), w)
                if lib.transient_lanes_phase_clocks(ctypes.addressof(table),
                                                    1) != 0:
                    raise RuntimeError("transient_lanes_phase_clocks failed")
                row = np.array(table, dtype=np.float64).reshape(
                    2, N_PHASES + 1)[0 if kernel == "block" else 1]
                if row[N_PHASES] != n:
                    raise AssertionError(f"{kernel}: the clocks cover "
                                         f"{row[N_PHASES]} steps, not {n}")
                cyc = {p: row[i] / n for i, p in enumerate(PHASES[kernel])}
                split = dict(cycles=cyc, total=sum(cyc.values()),
                             us_per_step=ms / n * 1e3)
                out[f"{label}, {name}, {kernel}"] = split
                parts = ", ".join(f"{k} {v:.1f}" for k, v in cyc.items())
                print(f"phases {label}, {name} source, {kernel} kernel, {n} "
                      f"steps: {split['total']:.1f} cycles a step ({parts}); "
                      f"{split['us_per_step']:.3f} us a step instrumented",
                      flush=True)
        if "warp" in kernels:
            for lpb in (1, 2, 4):
                ms = grid(current, forced_plan(TL, "warp", lpb), w)
                out[f"{label}, warp at {lpb} lanes a block"] = ms
                print(f"{label}: the warp kernel at {lpb} lanes a block: "
                      f"{ms:.4f} ms ({ms / n * 1e3:.4f} us a step)",
                      flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="an earlier tree of the repository")
    ap.add_argument("--phases", action="store_true",
                    help="split a step's cycles by phase")
    ap.add_argument("--phases-only", action="store_true",
                    help="the phase split alone, no turns")
    ap.add_argument("--kernels", default="block,warp",
                    help="the kernels --phases splits")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return _child(args.child)
    if args.baseline is None:
        ap.error("--baseline is required")
    print(f"before: {_clocks()}", flush=True)
    phases = {}
    if args.phases or args.phases_only:
        phases = _phases(args.baseline.resolve(), args.kernels.split(","))
        if args.phases_only:
            print(f"after: {_clocks()}", flush=True)
            print(json.dumps({"phases": phases}))
            return 0
    trees = {"baseline": args.baseline.resolve(), "current": ROOT}
    runs = {"baseline": [], "current": []}
    digests = set()
    for turn in ("baseline", "current", "current", "baseline"):
        proc = subprocess.run([sys.executable, __file__, "--child",
                               str(trees[turn])], capture_output=True,
                              text=True, timeout=900, cwd=str(ROOT))
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise RuntimeError(f"the {turn} turn failed ({proc.returncode})")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        digests.add(out.pop("digest"))
        runs[turn].append(out)
        scans = " / ".join(f"{k} {v:.4f} s"
                           for k, v in out["scan_s"].items())
        kernel = " / ".join(f"{k} {v:.4f} ms"
                            for k, v in out["kernel_ms"].items())
        print(f"{turn}: transient grid scan {scans} (the step kernel on the "
              f"card {kernel}), peak "
              f"{max(out['peak_gib'].values()):.3f} GiB; "
              f"autotune p99_under_failover {out['autotune_failover_s']:.2f}"
              f" s; autotune_policy {out['autotune_policy_s']:.2f} s",
              flush=True)
    if len(digests) != 1:
        raise AssertionError(f"the turns' results differ: {len(digests)} "
                             f"digests")
    print("every turn's results equal (grid flows, histograms, queue sums; "
          "the ranking's pick and p99; the policy's numbers)", flush=True)
    for label in runs["current"][0]["kernel_ms"]:
        best = {turn: min(r["kernel_ms"][label] for r in runs[turn])
                for turn in runs}
        print(f"{label}: the step kernel current / baseline "
              f"{best['current'] / best['baseline']:.3f} (best of two "
              f"each: {best['current']:.4f} / {best['baseline']:.4f} ms)",
              flush=True)
    print(f"after: {_clocks()}", flush=True)
    print(json.dumps(dict(runs=runs, phases=phases)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the steady-state solves (``CompiledSweep.mva`` and ``.fluid``) of
this tree and, with ``--baseline``, of an earlier one, on one card.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/steady_state_ab.py [--baseline build/parent]

On the Fig. 29 grid (``chip_smoke.py``'s ``GRID``: 32 configs, K = 15
station columns, write-only) each tree runs, in a child process of its
own: ``mva`` at ``n_clients_max`` 64 and 512, the same two calls sharded
over 32 shards (``[M, S, K]`` flattened to ``[M, 480]``) and ``fluid`` at
64 clients and 2000 steps.  For each call it prints the host wall of one
whole call (median of 5, after one warm call: the demand table, the copies
and the solve), the card's busy time in it and its kernel launches and
copies, both from ``torch.profiler`` over one call, and the operators it
dispatched (a dispatch mode around one call).  With a baseline the trees
run in turns baseline, current, current, baseline, and the outputs of the
two trees must agree (bit for bit where both run the same code; within
float32 rtol 1e-5 otherwise) or the script exits non-zero.  Prints one
line per call and tree and a JSON object of every figure last.

Each turn also times the ``mva_scan`` launch alone at the grid's demands,
(32, 15) at n 64 and 512 and the sharded (32, 480) at n 512: CUDA events
around one ``ops.mva_scan`` call queued behind a sleep on the card, so the
wrapper's host work is outside the window (``chip_smoke._alone_ms``,
median of ``ALONE_REPS``),
with the tree's row-sum plan (``mva_scan.plan``, where it has one) and
the cycles a step at the SM clock ``nvidia-smi`` reads after the timing.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the calls timed, by name: (solve, n_clients, shards)
CALLS = (("mva", 64, 1), ("mva", 512, 1), ("mva", 64, 32),
         ("mva", 512, 32), ("fluid", 64, 1))
FLUID_STEPS = 2000
REPS = 5
#: the mva_scan launch timed alone: (name, shards, n_max)
ALONE = (("mva_scan (32, 15) n 64", 1, 64),
         ("mva_scan (32, 15) n 512", 1, 512),
         ("mva_scan (32, 480) n 512", 32, 512))
ALONE_REPS = 9


def _label(solve: str, n: int, shards: int) -> str:
    where = f", {shards} shards" if shards > 1 else ""
    return (f"{solve} n_clients_max {n}{where}" if solve == "mva" else
            f"{solve} {n} clients x {FLUID_STEPS} steps{where}")


def _child(tree: Path, grid: dict, out: Path) -> None:
    """Measure every call on ``tree``'s package; write figures and
    outputs to ``out`` (an ``.npz`` beside a ``.json``)."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.utils._python_dispatch import TorchDispatchMode

    import repro_torch.core as P

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    dev = torch.device("cuda")
    sweep = P.compile_sweep(P.SweepSpec(**grid))
    alpha = P.calibrate_alpha()
    w = P.Workload(f_write=1.0)
    figures, arrays = {}, {}
    for solve, n, shards in CALLS:
        sharding = P.ShardingSpec(n_shards=shards) if shards > 1 else None
        if solve == "mva":
            def call():
                return sweep.mva(alpha, n_clients_max=n, workload=w,
                                 sharding=sharding, device=dev)[1:]
        else:
            def call():
                return (sweep.fluid(alpha, n, workload=w, sharding=sharding,
                                    n_steps=FLUID_STEPS, device=dev),)
        outs = call()
        walls = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            walls.append(time.perf_counter() - t0)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        busy_us, kernels, copies = 0.0, 0, 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            busy_us += (getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0))
            if "memcpy" in e.name.lower() or "memset" in e.name.lower():
                copies += 1
            else:
                kernels += 1
        Count.n = 0
        with Count():
            call()
        label = _label(solve, n, shards)
        figures[label] = dict(
            wall_ms=statistics.median(walls) * 1e3,
            walls_ms=[t * 1e3 for t in walls], device_ms=busy_us / 1e3,
            kernels=kernels, copies=copies, ops=Count.n)
        for i, a in enumerate(outs):
            arrays[f"{label}/{i}"] = np.asarray(a)
    figures["alone"] = _mva_alone(sweep, alpha, w, arrays)
    np.savez(out.with_suffix(".npz"), **arrays)
    out.with_suffix(".json").write_text(json.dumps(figures))


def _mva_alone(sweep, alpha, w, arrays: dict) -> dict:
    """The ``mva_scan`` launch alone at ``ALONE``'s shapes, each call
    queued behind a sleep on the card; its outputs go into ``arrays``."""
    import numpy as np
    import torch

    import repro_torch.core as P
    from repro_torch.kernels import mva_scan as MV
    sys.path.insert(1, str(ROOT))
    from chip_smoke import _alone_ms
    dev = torch.device("cuda")
    plan = getattr(MV, "plan", None)
    figures = {}
    for name, shards, n_max in ALONE:
        sharding = P.ShardingSpec(n_shards=shards) if shards > 1 else None
        d = sweep.demands(w, sharding=sharding)
        if shards > 1:
            d = P.flatten_shards(d)
        d = torch.from_numpy((d / alpha).astype(np.float32)).to(dev)
        outs = MV.mva_scan(d, 0.0, n_max)
        for i, a in enumerate(outs):
            arrays[f"{name}/{i}"] = a.cpu().numpy()
        ms = _alone_ms(lambda: MV.mva_scan(d, 0.0, n_max), ALONE_REPS)
        mhz = float(_smi_field("clocks.sm").split()[0])
        figures[name] = dict(
            shape=list(d.shape), n_max=n_max, ms=ms,
            sm_mhz=mhz, cycles_a_step=ms * 1e-3 * mhz * 1e6 / n_max,
            plan=repr(plan(d.shape[1])) if plan else None)
    return figures


def _smi_field(field: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def _run_tree(tree: Path, grid: dict, out: Path) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
           str(tree.resolve()), "--grid", json.dumps(grid), "--out",
           str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: the child failed ({proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    return json.loads(out.with_suffix(".json").read_text())


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="the root of an earlier tree (git archive)")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--grid", help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        _child(args.child, json.loads(args.grid), args.out)
        return 0
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import GRID
    grid = {k: v for k, v in GRID.items()}
    scratch = ROOT / "build" / "steady_state_ab"
    scratch.mkdir(parents=True, exist_ok=True)
    print(f"before: {_smi()}", flush=True)
    turns = (["baseline", "current", "current", "baseline"]
             if args.baseline else ["current", "current"])
    trees = {"baseline": args.baseline, "current": ROOT}
    runs = {"baseline": [], "current": []}
    for i, turn in enumerate(turns):
        out = scratch / f"{i}_{turn}"
        figs = _run_tree(trees[turn], grid, out)
        runs[turn].append(figs)
        for label, f in figs.pop("alone").items():
            print(f"{turn:8s} {label}: kernel alone {f['ms']:.4f} ms "
                  f"(median of {ALONE_REPS}, queued behind a sleep), "
                  f"{f['cycles_a_step']:.1f} cycles a step at "
                  f"{f['sm_mhz']:.0f} MHz; plan {f['plan']}", flush=True)
            figs[f"alone: {label}"] = f
        for label, f in figs.items():
            if label.startswith("alone: "):
                continue
            print(f"{turn:8s} {label}: host wall {f['wall_ms']:.3f} ms "
                  f"(median of {REPS}), device busy {f['device_ms']:.3f} ms,"
                  f" {f['kernels']} kernel launches + {f['copies']} copies, "
                  f"{f['ops']} operators dispatched", flush=True)
    outs = {turn: np.load(scratch / f"{turns.index(turn)}_{turn}.npz")
            for turn in set(turns)}
    if args.baseline:
        for key in outs["current"].files:
            a, b = outs["baseline"][key], outs["current"][key]
            if not np.array_equal(a, b, equal_nan=True):
                np.testing.assert_allclose(b, a, rtol=1e-5, err_msg=key)
                print(f"  {key}: within rtol 1e-5, not bitwise (max rel "
                      f"{float(np.nanmax(np.abs(b - a) / np.abs(a))):.3e})")
    for name, _, _ in ALONE:
        key = f"alone: {name}"
        best = {turn: min(r[key]["ms"] for r in runs[turn])
                for turn in runs if runs[turn]}
        line = f"{name}: kernel alone, best of two: current " \
               f"{best['current']:.4f} ms"
        if "baseline" in best:
            line += (f", baseline {best['baseline']:.4f} ms (current / "
                     f"baseline {best['current'] / best['baseline']:.3f})")
        print(line, flush=True)
    print(f"after: {_smi()}", flush=True)
    print(json.dumps({"nvidia_smi": _smi(), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

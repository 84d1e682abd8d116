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
    np.savez(out.with_suffix(".npz"), **arrays)
    out.with_suffix(".json").write_text(json.dumps(figures))


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
        for label, f in figs.items():
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
    print(f"after: {_smi()}", flush=True)
    print(json.dumps({"nvidia_smi": _smi(), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

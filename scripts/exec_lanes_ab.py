#!/usr/bin/env python3
"""Time the execution lanes' step kernels against an earlier version of
their source, in one process on one card, and split a step's cycles by
phase.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/base
    PYTHONPATH=src python3 scripts/exec_lanes_ab.py \\
        --baseline build/base/src/repro_torch/kernels/csrc/exec_lanes.cu \\
        [--phases]

The baseline ``exec_lanes.cu`` must have the block kernel's C entry point
the current one has (``exec_lanes_launch``); it is built with ``nvcc`` as
``kernels/_build.py`` builds the port's own, into ``build/ab/``, and called
through the current wrapper with its library in the current one's place
and the launch plan held to the block kernel (a baseline without the warp
kernel has no other).  The current source runs as the main path runs it:
its launch plan picks the warp kernel at these lanes.  On the Fig. 29
grid's lanes (``chip_smoke.py``'s ``EXECUTE``: 32 configs x 8 seeds x 64
clients, 2048 commands) at both mixes, each version runs the whole
deterministic execute's step loop through ``_execute_batch``, timed as
``chip_smoke.py`` times a kernel alone (CUDA events around each launch,
each queued behind a sleep on the card so that the wrapper's Python is
outside the window, summed), in
turns baseline, current, current, baseline; the two must agree bit for bit
(completion masks, latencies, drain counts, makespans).  ``nvidia-smi``'s
SM clock, temperature and power draw are printed before and after, and
each build's registers and spills by kernel (``-Xptxas -v``).

``--phases`` also builds the current source (and the baseline, if it has
them) with ``EXEC_LANES_PHASE_CLOCKS`` defined: each kernel then adds the
cycles one thread of lane 0 spends in each phase of a step (the source
names the phases) to a device table.  For each kernel (``--kernels``,
default both) and mix it runs the same scan and prints the cycles a step
by phase beside the run's microseconds a step, and times the uninstrumented
warp kernel at 1, 2 and 4 lanes a block.  ``--phases-only`` skips the A/B
turns.  Prints a JSON object of every number last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (EXECUTE, GRID, _block_plan, _mixes,  # noqa: E402
                        _step_run)
from repro_torch import core as P  # noqa: E402
from repro_torch.core import batched_execution as PB  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import exec_lanes as EL  # noqa: E402

#: the phases each kernel marks, in the source's order
PHASES = {"block": ("loads", "stations (d)+(b)", "barrier 1",
                    "clients (c)+(a)", "barrier 2"),
          "warp": ("chunk staging", "(b)+ballot", "clients (c)+(a)",
                   "syncwarp", "(d)", "chunk end")}
N_PHASES = 6


def build_lib(path: Path, tag: str, defines=()) -> tuple:
    """``nvcc`` of ``path`` into ``build/ab/<tag>_<stem>.so`` with the
    port's flags and ``defines``: (the library, the ``-Xptxas -v`` report's
    rows: kernel, registers, spill store and load bytes)."""
    out = ROOT / "build" / "ab" / f"{tag}_{path.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), _build.ARCH, *_build.FLAGS,
                           *defines, "-o", str(out), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stderr}")
    return (ctypes.CDLL(str(out)),
            _build.ptxas_report(proc.stdout + proc.stderr))


def clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def type_like(lib, current, names) -> None:
    for name in names:
        fn, like = getattr(lib, name), getattr(current, name)
        fn.argtypes, fn.restype = like.argtypes, like.restype


def forced_plan(mod, kernel: str, lanes_per_block=None):
    """A launch plan for ``mod`` (the ``exec_lanes`` or ``transient_lanes``
    module) that takes ``kernel`` ("block" or "warp", at
    ``lanes_per_block`` lanes a block if given) for every lane."""
    if kernel == "block":
        return _block_plan(mod)
    real = mod.plan

    def plan(n_lanes, n_clients, n_columns, n_sms=132):
        how = real(n_lanes, n_clients, n_columns, n_sms)
        if how.kernel != "warp":
            raise ValueError(f"{n_clients} clients x {n_columns} columns "
                             f"take no warp kernel")
        lpb = lanes_per_block or how.lanes_per_block
        return EL.LaunchPlan("warp", -(-n_lanes // lpb), 32 * lpb,
                             how.clients_per_thread, lpb)
    return plan


def report(label: str, rows) -> None:
    for name, regs, spill_st, spill_ld in rows:
        print(f"  ptxas {label}: {name}: {regs} registers, {spill_st} / "
              f"{spill_ld} bytes spill stores / loads", flush=True)


def scan(lib, plan, inp, n_clients, n_steps):
    """One deterministic scan through ``lib`` under ``plan``: (outputs,
    device ms)."""
    real_lib, real_plan = EL._lib, EL.plan
    EL._lib, EL.plan = lib, plan
    try:
        out, ms, _ = _step_run(PB, EL.exec_lanes, PB._execute_batch, inp,
                               n_clients, n_steps, False, lead=True)
    finally:
        EL._lib, EL.plan = real_lib, real_plan
    return out, ms


def phase_split(lib, kernel: str, inp, n_clients, n_steps) -> dict:
    """The scan through an instrumented ``lib`` on ``kernel``: cycles a
    step by phase (lane 0's thread), their sum and the run's us a step."""
    table = (ctypes.c_ulonglong * (2 * (N_PHASES + 1)))()
    if lib.exec_lanes_phase_clocks(None, 1) != 0:
        raise RuntimeError("exec_lanes_phase_clocks failed")
    _, ms = scan(lib, forced_plan(EL, kernel), inp, n_clients, n_steps)
    if lib.exec_lanes_phase_clocks(ctypes.addressof(table), 1) != 0:
        raise RuntimeError("exec_lanes_phase_clocks failed")
    row = np.array(table, dtype=np.float64).reshape(2, N_PHASES + 1)[
        0 if kernel == "block" else 1]
    steps = row[N_PHASES]
    if steps != n_steps:
        raise AssertionError(f"{kernel}: the clocks cover {steps} steps, "
                             f"not {n_steps}")
    cyc = {name: row[i] / steps for i, name in enumerate(PHASES[kernel])}
    return dict(cycles=cyc, total=sum(cyc.values()),
                us_per_step=ms / n_steps * 1e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="an earlier exec_lanes.cu")
    ap.add_argument("--phases", action="store_true",
                    help="split a step's cycles by phase")
    ap.add_argument("--phases-only", action="store_true",
                    help="the phase split alone, no A/B turns")
    ap.add_argument("--kernels", default="block,warp",
                    help="the kernels --phases splits")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(f"before: {clocks()}", flush=True)
    report("current", _build.ptxas_report(EL.build()))
    current = EL._lib
    base, rows = build_lib(args.baseline, "base")
    report("baseline", rows)
    type_like(base, current, ["exec_lanes_launch"])
    libs = {"baseline": base, "current": current}
    plans = {"baseline": forced_plan(EL, "block"), "current": EL.plan}

    sweep = P.compile_sweep(P.SweepSpec(**GRID))
    seeds = np.arange(EXECUTE["seeds"], dtype=np.int32)
    n_clients = EXECUTE["n_clients"]
    times, phases, lpb_times = {}, {}, {}
    instrumented = {}
    if args.phases or args.phases_only:
        src = EL.__file__.replace("exec_lanes.py", "csrc/exec_lanes.cu")
        sources = {"current": Path(src)}
        if "EXEC_LANES_PHASE_CLOCKS" in args.baseline.read_text():
            sources["baseline"] = args.baseline
        else:
            print("the baseline has no phase clocks: its block kernel's "
                  "split is the current block kernel's where the two are "
                  "the same code", flush=True)
        for name, path in sources.items():
            lib, rows = build_lib(path, f"phases_{name}",
                                  ("-DEXEC_LANES_PHASE_CLOCKS",))
            report(f"{name} with phase clocks", rows)
            type_like(lib, current, ["exec_lanes_launch",
                                     "exec_lanes_warp_launch"])
            lib.exec_lanes_phase_clocks.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_int]
            lib.exec_lanes_phase_clocks.restype = ctypes.c_int
            instrumented[name] = lib
    for label, w in _mixes(P):
        low = PB._lower_configs(sweep.configs, w,
                                n_commands=EXECUTE["n_commands"],
                                seeds_arr=seeds, n_clients=n_clients,
                                probe_n=EXECUTE["probe_n"])
        inp = PB._lane_inputs(low, "cuda")
        n = low.n_steps
        for name, lib in instrumented.items():
            for kernel in args.kernels.split(","):
                split = phase_split(lib, kernel, inp, n_clients, n)
                phases[f"{label}, {name}, {kernel}"] = split
                parts = ", ".join(f"{k} {v:.1f}"
                                  for k, v in split["cycles"].items())
                print(f"phases {label}, {name} source, {kernel} kernel, {n} "
                      f"steps: {split['total']:.1f} cycles a step ({parts}); "
                      f"{split['us_per_step']:.3f} us a step instrumented",
                      flush=True)
        if instrumented and "warp" in args.kernels.split(","):
            for lpb in (1, 2, 4):
                _, ms = scan(current, forced_plan(EL, "warp", lpb), inp,
                             n_clients, n)
                lpb_times[f"{label}, {lpb}"] = ms
                print(f"{label}: the warp kernel at {lpb} lanes a block: "
                      f"{ms:.3f} ms ({ms / n * 1e3:.4f} us a step)",
                      flush=True)
        if args.phases_only:
            continue
        runs = {"baseline": [], "current": []}
        first = {}
        for turn in ("baseline", "current", "current", "baseline"):
            out, ms = scan(libs[turn], plans[turn], inp, n_clients, n)
            runs[turn].append(ms)
            if turn in first:
                del out
                continue
            first[turn] = out
        for a, b, name in zip(first["baseline"], first["current"],
                              ("fin", "lat", "done_w", "done_r", "t_last")):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}: the versions differ in "
                                     f"{name}")
        del first
        torch.cuda.empty_cache()
        times[label] = dict(steps=n, launches=-(-n // PB.BLOCK_STEPS),
                            **{k: v for k, v in runs.items()})
        ratio = min(runs["current"]) / min(runs["baseline"])
        print(f"{label}: {n} steps, baseline "
              f"{' / '.join(f'{t:.2f}' for t in runs['baseline'])} ms, "
              f"current {' / '.join(f'{t:.2f}' for t in runs['current'])} "
              f"ms on the card (us a step: baseline "
              f"{min(runs['baseline']) / n * 1e3:.3f}, current "
              f"{min(runs['current']) / n * 1e3:.3f}; current / baseline "
              f"{ratio:.3f}); bitwise equal", flush=True)
    print(f"after: {clocks()}", flush=True)
    print(json.dumps(dict(times=times, phases=phases,
                          warp_lanes_per_block_ms=lpb_times)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

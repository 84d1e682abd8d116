#!/usr/bin/env python3
"""Time the execution lanes' step kernel against an earlier version of its
source, in one process on one card.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/base
    PYTHONPATH=src python3 scripts/exec_lanes_ab.py \\
        --baseline build/base/src/repro_torch/kernels/csrc/exec_lanes.cu

The baseline ``exec_lanes.cu`` must have the C entry point the current one
has (``exec_lanes_launch``); it is built with ``nvcc`` as
``kernels/_build.py`` builds the port's own, into ``build/ab/``, and called
through the current wrapper with its library in the current one's place.
On the Fig. 29 grid's lanes (``chip_smoke.py``'s ``EXECUTE``: 32 configs x
8 seeds x 64 clients, 2048 commands) at both mixes, each version runs the
whole deterministic execute's step loop through ``_execute_batch``, timed
as ``chip_smoke.py`` times it (CUDA events around each launch, summed), in
turns baseline, current, current, baseline; the two must agree bit for bit
(completion masks, latencies, drain counts, makespans).  ``nvidia-smi``'s
SM clock, temperature and power draw are printed before and after.
Prints one line per mix and a JSON object of every time.
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

from chip_smoke import EXECUTE, GRID, _mixes, _step_run  # noqa: E402
from repro_torch import core as P  # noqa: E402
from repro_torch.core import batched_execution as PB  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import exec_lanes as EL  # noqa: E402


def _build_lib(path: Path) -> ctypes.CDLL:
    out = ROOT / "build" / "ab" / f"base_{path.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), _build.ARCH, *_build.FLAGS, "-o",
                           str(out), str(path)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stderr}")
    return ctypes.CDLL(str(out))


def _clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="an earlier exec_lanes.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(f"before: {_clocks()}", flush=True)
    EL.build()
    current = EL._lib
    base = _build_lib(args.baseline)
    base.exec_lanes_launch.argtypes = current.exec_lanes_launch.argtypes
    base.exec_lanes_launch.restype = current.exec_lanes_launch.restype
    libs = {"baseline": base, "current": current}

    sweep = P.compile_sweep(P.SweepSpec(**GRID))
    seeds = np.arange(EXECUTE["seeds"], dtype=np.int32)
    n_clients = EXECUTE["n_clients"]
    times = {}
    for label, w in _mixes(P):
        low = PB._lower_configs(sweep.configs, w,
                                n_commands=EXECUTE["n_commands"],
                                seeds_arr=seeds, n_clients=n_clients,
                                probe_n=EXECUTE["probe_n"])
        inp = PB._lane_inputs(low, "cuda")
        n = low.n_steps
        runs = {"baseline": [], "current": []}
        first = {}
        for turn in ("baseline", "current", "current", "baseline"):
            EL._lib = libs[turn]
            try:
                out, ms, _ = _step_run(PB, EL.exec_lanes, PB._execute_batch,
                                       inp, n_clients, n, False)
            finally:
                EL._lib = current
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
        print(f"{label}: {n} steps, baseline "
              f"{' / '.join(f'{t:.2f}' for t in runs['baseline'])} ms, "
              f"current {' / '.join(f'{t:.2f}' for t in runs['current'])} "
              f"ms on the card (us a step: baseline "
              f"{min(runs['baseline']) / n * 1e3:.3f}, current "
              f"{min(runs['current']) / n * 1e3:.3f}); bitwise equal",
              flush=True)
    print(f"after: {_clocks()}", flush=True)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())

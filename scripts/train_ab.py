#!/usr/bin/env python3
"""Time rwkv6-7b's training step (``chip_smoke.py``'s phase T5) on this
tree against an earlier tree, in turns, on one card.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/train_ab.py --baseline build/parent

Each run is a child process that imports its tree's own ``chip_smoke.py``
and runs its ``_recurrent_train_phase`` for ``ARCH`` (rwkv6-7b: its
trainer at full width, cut to the depth whose reckoned peak fits, batch
4 x 1024, 4 steps, the last traced; the kernels built from that tree's
sources into its own gitignored ``build/``), in turns baseline, current,
current, baseline.  Hosts differ from call to call, so the two trees'
step times are compared only within one call.  Prints each run's lines of
the phase (steady step ms, tokens/s, peak GiB, the traced step's device
time by kind) and, last, one JSON object of every run's numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-7b"
ORDER = ("baseline", "current", "current", "baseline")
TIMEOUT_S = 600  # a run: its kernels' build and 4 steps

CHILD = """
import json, sys, torch
tree = sys.argv[1]
sys.path[:0] = [tree, tree + "/src"]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as C
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rglru_scan as RS
from repro_torch.kernels import wkv6 as WK
rec = C._recurrent_train_phase(sys.argv[2], FA, RS, WK, torch.device("cuda"))
print("RESULT " + json.dumps(rec), flush=True)
"""


def _run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tree), ARCH],
                          capture_output=True, text=True, timeout=TIMEOUT_S,
                          cwd=tree)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: rc {proc.returncode}\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    rec = None
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            rec = json.loads(line[len("RESULT "):])
        elif "traced step" in line or "steady step" in line:
            print(f"  {line.strip()}", flush=True)
    if rec is None:
        raise RuntimeError(f"{tree}: no result\n{proc.stdout[-4000:]}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="root of the earlier tree (with its chip_smoke.py)")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}", flush=True)
    trees = {"baseline": args.baseline.resolve(), "current": ROOT}
    runs = {"baseline": [], "current": []}
    for who in ORDER:
        print(f"{who} ({trees[who]}):", flush=True)
        runs[who].append(_run(trees[who]))
    for who, recs in runs.items():
        steps = ", ".join(f"{r['step_ms']:.1f}" for r in recs)
        print(f"{ARCH} {who}: steady step ms {steps}", flush=True)
    print(json.dumps({"device": smi, "arch": ARCH, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

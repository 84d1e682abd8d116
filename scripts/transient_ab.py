#!/usr/bin/env python3
"""Time the transient path of this tree against an earlier tree's, in turns
on one card.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/transient_ab.py --baseline build/parent

Each turn is a child process that imports ``repro_torch`` from one tree's
``src/`` (the two trees share the package's name) and runs on the card,
after a small warm-up run that builds the kernels: phase 6's transient grid
at both mixes (``chip_smoke.py``'s ``GRID``, ``TRANSIENT`` and
``TRANSIENT_CRASH``: 32 configs x 8 seeds x 64 clients x 4000 steps, a
leader crash at 40-60 %), with its ``timings["scan"]`` and peak device
memory; ``autotune(objective="p99_under_failover")`` at budget 19; and
``autotune_policy`` at ``benchmarks/autoscale.py``'s settings, each on the
host's clock.  The settings and the last two runs are ``chip_smoke.py``'s
(``_failover_ranking``, ``_autoscale_policy``), from this tree.  Turns:
baseline, current, current, baseline.  Every turn's results must be equal
(the grid's flows, histograms and queue sums, the ranking's pick and p99,
the policy's numbers), else the script exits non-zero.  ``nvidia-smi``'s
SM clock, temperature and power draw are printed before and after, a line
per turn, and a JSON object of every time last.
"""
from __future__ import annotations

import argparse
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
    out = {"scan_s": {}, "peak_gib": {}}
    for label, w in CS._mixes(P):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res = sweep.transient(alpha, workload=w,
                              events=[P.Event(*CS.TRANSIENT_CRASH)],
                              device=dev, **CS.TRANSIENT)
        out["scan_s"][label] = res.timings["scan"]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="an earlier tree of the repository")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return _child(args.child)
    if args.baseline is None:
        ap.error("--baseline is required")
    print(f"before: {_clocks()}", flush=True)
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
        print(f"{turn}: transient grid scan {scans}, peak "
              f"{max(out['peak_gib'].values()):.3f} GiB; "
              f"autotune p99_under_failover {out['autotune_failover_s']:.2f}"
              f" s; autotune_policy {out['autotune_policy_s']:.2f} s",
              flush=True)
    if len(digests) != 1:
        raise AssertionError(f"the turns' results differ: {len(digests)} "
                             f"digests")
    print("every turn's results equal (grid flows, histograms, queue sums; "
          "the ranking's pick and p99; the policy's numbers)", flush=True)
    print(f"after: {_clocks()}", flush=True)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the histogram kernel (``latency_hist``) of this tree and, with
``--baseline``, of an earlier one, in turns on one card.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/latency_hist_ab.py [--baseline build/parent]

Each turn is a child process that imports ``repro_torch`` from one tree's
``src/`` (the two trees share the package's name) and bins the tensors the
main path hands the kernel, caught on their way into it (``chip_smoke.py``'s
settings, from this tree):

- the transient run's call: phase 6's grid, write-only, 8 seeds x 64
  clients x 4000 steps with the leader crash: [256, 4000] samples, a bool
  mask, 96 bins (``core/transient.py:_bin_block``);
- both execution calls: phase 4's ``execute`` at 90 % reads ([256,
  7,503,872], 64 bins, a bool mask) and write-only;
- one of ``chip_smoke._hist_cases``' shapes, (3, 20001, 96) with a float32
  mask and its edge cases.

For each call it prints, with ``chip_smoke.py``'s own yardsticks, the
kernel alone (``_alone_ms``: CUDA events around one call, queued behind a
sleep on the card so that the wrapper's host work is outside the window;
median of ``REPS``), the host wall of one whole call (``_host_wall_ms``,
to a synchronize; median of ``REPS``), the device kernels one call
launches (``_device_kernels``, a ``torch.profiler`` window over one call:
the kernel and any fill before it) and the bound (``_hist_bound_ms``).  The
counts of every turn must be equal bit for bit, else the script exits
non-zero.  Turns: baseline, current, current, baseline (current, current
without a baseline).  ``--chunk`` caps also time this tree's long-lane
route with ``latency_hist.CHUNK`` set to each (counts held equal), to
size its chunks.  ``nvidia-smi``'s name, power limit and SM clock are
printed before and after, and a JSON object of every figure last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 7


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
         "clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _child(tree: Path, out: Path, chunks: list) -> None:
    """Measure every call on ``tree``'s package (and again at each cap of
    ``chunks`` where the long-lane route reads ``latency_hist.CHUNK``);
    write the figures to ``out.json`` and the counts to ``out.npz``."""
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    import repro_torch.core as P
    from repro_torch.core import batched_execution as PB
    from repro_torch.core import transient as PT
    from repro_torch.kernels import latency_hist as LH
    sys.path.insert(1, str(ROOT))
    import chip_smoke as CS
    if Path(P.__file__).resolve().parents[2] != (tree / "src").resolve():
        raise RuntimeError(f"imported {P.__file__}, not {tree}'s package")
    dev = torch.device("cuda")
    alpha = P.calibrate_alpha()
    sweep = P.compile_sweep(P.SweepSpec(**CS.GRID))

    def transient_call():
        caught = {}
        kernel = PT.latency_hist

        def catch(samples, valid, edges):
            caught.update(samples=samples.clone(), mask=valid.clone(),
                          edges=edges.clone())
            return kernel(samples, valid, edges)

        PT.latency_hist = catch
        try:
            sweep.transient(alpha, workload=P.Workload(f_write=1.0),
                            events=[P.Event(*CS.TRANSIENT_CRASH)],
                            device=dev, **CS.TRANSIENT)
        finally:
            PT.latency_hist = kernel
        return caught["samples"], caught["mask"], caught["edges"]

    def execution_call(w):
        return lambda: CS._main_path_tensors(PB, sweep, w, dev)[:3]

    def hist_case():
        s, v, e = CS._hist_cases(np.random.default_rng(0))[4]
        return tuple(torch.from_numpy(a).to(dev) for a in (s, v, e))

    mixes = dict(CS._mixes(P))
    calls = {"transient [256, 4000]": transient_call,
             "execution, 90% reads": execution_call(mixes["90% reads"]),
             "execution, write-only": execution_call(mixes["write-only"]),
             "hist case (3, 20001, 96), f32 mask": hist_case}
    figures, counts = {}, {}
    for label, make in calls.items():
        samples, mask, edges = make()
        torch.cuda.synchronize()

        def call():
            return LH.latency_hist(samples, mask, edges)

        counts[label] = call().cpu().numpy()
        alone = CS._alone_ms(call, REPS)
        wall = CS._host_wall_ms(call, REPS)
        kernels = CS._device_kernels(call)
        n_valid = int((mask > 0).sum())
        bound_ms, bound_by = CS._hist_bound_ms(samples, mask, edges, n_valid)
        plan = getattr(LH, "launch_plan", None)
        by_chunk = {}
        if chunks and hasattr(LH, "CHUNK"):
            default = LH.CHUNK
            for cap in chunks:
                LH.CHUNK = cap
                if not np.array_equal(call().cpu().numpy(), counts[label]):
                    raise AssertionError(f"{label}: CHUNK {cap} changed the "
                                         f"counts")
                by_chunk[cap] = dict(alone_ms=CS._alone_ms(call, REPS),
                                     plan=repr(LH.launch_plan(samples)))
            LH.CHUNK = default
        figures[label] = dict(by_chunk=by_chunk,
            shape=list(samples.shape), bins=edges.shape[1] - 1,
            mask=str(mask.dtype), n_valid=n_valid,
            alone_ms=alone, wall_ms=wall, launches=len(kernels),
            kernels=kernels, bound_ms=bound_ms, bound_by=bound_by,
            plan=repr(plan(samples)) if plan else None)
        del samples, mask, edges
        torch.cuda.empty_cache()
    figures["smi"] = _smi()
    np.savez(out.with_suffix(".npz"), **counts)
    out.with_suffix(".json").write_text(json.dumps(figures))


def _run_tree(tree: Path, out: Path, chunks: list) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
           str(tree.resolve()), "--out", str(out)]
    cmd += [f"--chunk={c}" for c in chunks]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=str(ROOT))
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: the child failed ({proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    return json.loads(out.with_suffix(".json").read_text())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="the root of an earlier tree (git archive)")
    ap.add_argument("--chunk", type=int, action="append", default=[],
                    help="also time this tree's long-lane route with "
                         "latency_hist.CHUNK set to this cap (repeatable)")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        _child(args.child, args.out, args.chunk)
        return 0
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    scratch = ROOT / "build" / "latency_hist_ab"
    scratch.mkdir(parents=True, exist_ok=True)
    print(f"before: {_smi()}", flush=True)
    turns = (["baseline", "current", "current", "baseline"]
             if args.baseline else ["current", "current"])
    trees = {"baseline": args.baseline, "current": ROOT}
    runs = {"baseline": [], "current": []}
    counts = []
    for i, turn in enumerate(turns):
        out = scratch / f"{i}_{turn}"
        figs = _run_tree(trees[turn], out, args.chunk)
        smi = figs.pop("smi")
        runs[turn].append(figs)
        counts.append(np.load(out.with_suffix(".npz")))
        print(f"{turn} ({smi}):", flush=True)
        for label, f in figs.items():
            print(f"  {label}: {f['shape']} x {f['bins']} bins, {f['mask']}"
                  f" mask, {f['n_valid']} valid; kernel alone "
                  f"{f['alone_ms']:.4f} ms (median of {REPS}, queued behind"
                  f" a sleep), host wall {f['wall_ms']:.4f} ms, "
                  f"{f['launches']} launches a call ({f['kernels']}), bound "
                  f"{f['bound_ms']:.4f} ms ({f['bound_by']}; the kernel "
                  f"{f['alone_ms'] / f['bound_ms']:.2f}x); plan "
                  f"{f['plan']}", flush=True)
            for cap, g in f["by_chunk"].items():
                print(f"    CHUNK {cap}: kernel alone {g['alone_ms']:.4f} ms"
                      f" (the bound {f['bound_ms'] / g['alone_ms']:.3f} of "
                      f"it); plan {g['plan']}", flush=True)
    for c in counts[1:]:
        for key in counts[0].files:
            if not np.array_equal(counts[0][key], c[key]):
                raise AssertionError(f"{key}: the turns' counts differ")
    print("every turn's counts equal bit for bit", flush=True)
    for label in runs["current"][0]:
        best = {turn: min(r[label]["alone_ms"] for r in runs[turn])
                for turn in runs if runs[turn]}
        line = f"{label}: kernel alone, best of two: current " \
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

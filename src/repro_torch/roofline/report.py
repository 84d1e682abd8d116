"""The roofline table from the port's dry-run records (port of
``roofline/report.py``).

  PYTHONPATH=src python -m repro_torch.roofline.report [--results DIR] \
      [--tag TAG] [--mesh single|multi]

Prints the markdown table, the three hillclimb picks and the counts of
ok, skipped and failed cells.  Reads ``results/dryrun_torch/`` (what
``python -m repro_torch.launch.dryrun`` writes) unless told otherwise.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from .analysis import load_cells, markdown_table, pick_hillclimb_cells

DEFAULT = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(DEFAULT))
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default=None, choices=[None, "single", "multi"])
    args = ap.parse_args()

    cells = load_cells(args.results, tag=args.tag)
    if args.mesh:
        cells = [c for c in cells if c.mesh == args.mesh]
    print(markdown_table(cells))
    ok = [c for c in cells if c.status == "ok"]
    if ok:
        print("\n### Hillclimb targets\n")
        try:
            picks = pick_hillclimb_cells(cells)
            for k, c in picks.items():
                print(f"- **{k}**: {c.arch} x {c.shape} "
                      f"({c.dominant}-bound, MFU_est={c.mfu_est:.3f}, "
                      f"T={c.step_s:.3e}s) - {c.note}")
        except ValueError:
            pass
        print(f"\n{len(ok)} ok, "
              f"{sum(c.status == 'skipped' for c in cells)} skipped, "
              f"{sum(c.status == 'error' for c in cells)} errors")


if __name__ == "__main__":
    main()

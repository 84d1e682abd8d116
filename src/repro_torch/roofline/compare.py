"""Compare roofline terms across policy variants of the same cell (port of
``roofline/compare.py``).

  PYTHONPATH=src python -m repro_torch.roofline.compare \
      results/dryrun_torch/granite-3-2b__train_4k__single*.json
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from .analysis import analyze_record


def describe(path: str) -> None:
    rec = json.loads(Path(path).read_text())
    c = analyze_record(rec)
    tag = rec.get("tag") or "baseline"
    if c.status != "ok":
        print(f"{tag:24s} {c.status}: {c.note}")
        return
    print(f"{tag:24s} compute={c.compute_s:9.3e}  memory={c.memory_s:9.3e}  "
          f"collective={c.collective_s:9.3e}  T={c.step_s:9.3e}  "
          f"dom={c.dominant:10s}  MFU={c.mfu_est:6.3f}  useful={c.usefulness:5.2f}")


def main() -> None:
    for p in sys.argv[1:]:
        describe(p)


if __name__ == "__main__":
    main()

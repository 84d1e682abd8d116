"""The paper's story in one script, on the PyTorch port: walk the six
compartmentalizations and watch the bottleneck move and throughput climb
(Fig. 29 live).

The twin of ``examples/compartmentalization_demo.py``, from
``repro_torch``; the latency-throughput knee (MVA) runs on the chosen
device.

  PYTHONPATH=src python examples/torch_compartmentalization_demo.py \
      [--device cuda|cpu]
"""
import argparse

from repro_torch.core import (
    Workload,
    ablation_steps,
    calibrate_alpha,
    compartmentalized_model,
    mixed_workload_speedup,
    mva_curve,
)
from repro_torch.core.analytical import PAPER_MULTIPAXOS_UNBATCHED


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the MVA solve runs (default cuda)")
    args = ap.parse_args()
    alpha = calibrate_alpha(PAPER_MULTIPAXOS_UNBATCHED)
    print(f"calibration: one anchor (vanilla MultiPaxos = 25k cmd/s) "
          f"-> alpha = {alpha:.0f} msgs/s per node\n")

    print(f"{'configuration':58s} {'peak cmd/s':>12s}  bottleneck")
    for name, model in ablation_steps():
        peak = model.peak_throughput(alpha)
        bn, _ = model.bottleneck()
        bar = "#" * int(peak / 3500)
        print(f"{name:58s} {peak:12,.0f}  {bn:8s} {bar}")

    print("\nmixed workloads (the 16x headline), one Workload value each:")
    for w in (Workload(name="write-only"),
              Workload(f_write=0.5, name="50% reads"),
              Workload.read_mix(0.9, name="90% reads"),
              Workload.read_mix(1.0, name="100% reads")):
        mp, cm, speedup = mixed_workload_speedup(w, alpha)
        print(f"  {w.name:12s}: MultiPaxos {mp:9,.0f} -> "
              f"Compartmentalized {cm:9,.0f}  ({speedup:.1f}x)")

    print(f"\nlatency-throughput knee (MVA on {args.device}, 512 "
          f"closed-loop clients):")
    model = compartmentalized_model(f=1, n_proxy_leaders=10, grid_rows=2,
                                    grid_cols=2, n_replicas=4)
    _, x, r = mva_curve(model, alpha, n_clients_max=512, device=args.device)
    for n in (1, 8, 64, 256, 512):
        print(f"  {n:4d} clients: {x[n-1]:9,.0f} cmd/s at "
              f"{r[n-1]*1e6:7.1f} us median latency")

    print("\n(next: examples/torch_autotune_demo.py searches the whole "
          "config space under a machine budget)")


if __name__ == "__main__":
    main()

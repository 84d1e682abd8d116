"""Find me the best deployment for a machine budget - on the PyTorch port.

The twin of ``examples/autotune_demo.py``: the same search over the
discrete config space under a budget and the same greedy
bottleneck-migration staircase (Fig. 29), from ``repro_torch``.  The
search itself is numpy; the last section re-ranks the best deployments by
their p99 under a leader crash, which runs the transient token engine on
the chosen device.

  PYTHONPATH=src python examples/torch_autotune_demo.py [budget] \
      [--device cuda|cpu]
"""
import argparse

from repro_torch.core import Workload, autotune, calibrate_alpha
from repro_torch.core.analytical import PAPER_MULTIPAXOS_UNBATCHED


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("budget", nargs="?", type=int, default=19)
    ap.add_argument("--device", default="cuda",
                    help="where the transient engine runs (default cuda)")
    args = ap.parse_args()
    budget = args.budget
    alpha = calibrate_alpha(PAPER_MULTIPAXOS_UNBATCHED)
    print(f"machine budget: {budget}  (paper's hand-tuned deployment uses "
          f"19)\n")

    for workload in (Workload(name="write-only"),
                     Workload(f_write=0.5, name="50% reads"),
                     Workload.read_mix(0.9, name="90% reads")):
        try:
            res = autotune(budget=budget, alpha=alpha, workload=workload)
        except ValueError as e:
            raise SystemExit(f"error: {e}")
        c = res.best_config
        print(f"== {workload.name}: best of {res.n_candidates} "
              f"candidate deployments ==")
        print(f"   {res.best_peak:,.0f} cmd/s on {res.machines} machines "
              f"(bottleneck: {res.best_bottleneck})")
        print(f"   proxies={c['n_proxy_leaders']} "
              f"grid={c['grid_rows']}x{c['grid_cols']} "
              f"replicas={c['n_replicas']}")
        print("   bottleneck migration (greedy staircase):")
        for t in res.trace:
            print(f"     step {t.step:2d}  {t.label:34s} {t.machines:3d} "
                  f"machines {t.peak:12,.0f} cmd/s  -> {t.bottleneck}")
        print()

    print("with batching enabled (amortizes the sequencing leader):")
    res = autotune(budget=budget, alpha=alpha, workload=Workload(),
                   batching=True)
    c = res.best_config
    print(f"   {res.best_peak:,.0f} cmd/s on {res.machines} machines "
          f"(bottleneck: {res.best_bottleneck}); batchers={c['n_batchers']} "
          f"unbatchers={c['n_unbatchers']} B={c['batch_size']}")

    print("\nsame budget when batches only half fill (bursty arrivals close "
          "them early):")
    res = autotune(budget=budget, alpha=alpha,
                   workload=Workload(batch_fill=0.5, arrival="bursty"),
                   batching=True)
    print(f"   {res.best_peak:,.0f} cmd/s on {res.machines} machines "
          f"(bottleneck: {res.best_bottleneck}) - the Workload carries the "
          f"fill hint; no per-call kwargs")

    print(f"\nre-ranked by p99 under a leader crash (transient engine on "
          f"{args.device}, 8 seeds x 64 clients x 4000 steps):")
    res = autotune(budget=budget, alpha=alpha, workload=Workload(),
                   objective="p99_under_failover",
                   transient_kwargs=dict(device=args.device))
    c = res.best_config
    print(f"   proxies={c['n_proxy_leaders']} "
          f"grid={c['grid_rows']}x{c['grid_cols']} "
          f"replicas={c['n_replicas']}: {res.best_peak:,.0f} cmd/s on "
          f"{res.machines} machines, p99 {res.best_p99 * 1e3:.2f} ms")


if __name__ == "__main__":
    main()

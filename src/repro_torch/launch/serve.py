"""Serving launcher: compartmentalized inference fleet at smoke scale (port
of ``launch/serve.py``).

Brings up batchers -> leader/proxies/acceptor-grid -> model replicas ->
unbatchers, pushes weights through the replicated log, then serves
inference requests as leaderless reads.  The model runs on ``--device``
(cuda unless told otherwise; without a card pass ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --requests 12 --replicas 3 --consistency linearizable --device cpu

``--arch`` takes any config the port runs (``models/model.py:MIXERS`` and
``CHANNELS``): the dense decoders, recurrentgemma-2b, rwkv6-7b and the
mixture-of-experts deepseek-moe-16b and qwen3-moe-30b-a3b (whose smoke
configs, as the reference's, run their experts densely).
"""
from __future__ import annotations

import argparse
import time

from ..configs import get_config
from ..core.device import resolve_device
from ..models import init_params
from ..serving.server import ServingDeployment


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--consistency", default="linearizable",
                    choices=["linearizable", "sequential", "eventual"])
    ap.add_argument("--push-update-midway", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).smoke()
    params = init_params(cfg, 0, device=device)
    fleet = ServingDeployment(cfg, n_replicas=args.replicas, n_clients=2,
                              consistency=args.consistency, device=device)
    v = fleet.push_weights(params)
    print(f"arch={cfg.name} replicas={args.replicas} device={device} "
          f"weights v{v} installed")

    t0 = time.time()
    half = args.requests // 2
    for i in range(args.requests):
        if args.push_update_midway and i == half:
            params2 = init_params(cfg, 1, device=device)
            v = fleet.push_weights(params2)
            print(f"[weight update] v{v} committed through the log")
        version, toks = fleet.infer([1 + i % 7, 2, 3], max_new=args.max_new,
                                    client=i % 2)
        print(f"req {i:3d} served at weights {version}: tokens={list(toks)}")
    dt = time.time() - t0
    loads = fleet.replica_loads()
    print(f"done: {args.requests} requests in {dt:.1f}s; "
          f"per-replica read loads: {loads} "
          f"(leaderless reads spread across replicas)")


if __name__ == "__main__":
    main()

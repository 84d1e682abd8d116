#!/usr/bin/env python3
"""The port's distributed runtime across cards: four NCCL ranks on four
cards of one host, one process each, on 2 x 2 meshes.

    python3 scripts/distributed_nccl.py                # four cards
    python3 scripts/distributed_nccl.py --device cpu   # four gloo ranks

The checks are ``chip_smoke.py``'s phase D functions, which that script
runs at one rank (one card cannot hold two NCCL ranks); here each rank
runs them on (2, 2) meshes, so the exchanges cross cards.  Rank r runs on
``cuda:r`` (NCCL through a ``FileStore`` under the checkout's
``build/``).  At full width on the cards (the smoke configs with
``--device cpu``):

* A. ``_dist_grad_mean``: the hierarchical gradient mean over (pod=2,
  data=2), on rank-dependent float32 tensors of granite-3-2b's shapes (4
  layers), against one ``all_reduce`` of the same tree; the int8
  exchange across pods on equal trees within its bound, and its error on
  the rank-dependent ones;
* B. ``_dist_decode``: the distributed split-KV decode over (data=2,
  model=2) at granite's decode shapes (batch 8, 2048 cached rows, 1024 a
  model rank) against ``flash_decode`` on the whole cache;
* C. ``_dist_moe``: deepseek-moe-16b's all-to-all MoE layer over (data=2,
  model=2) on the input a prefill of 4 x 2048 tokens hands it (2048
  tokens a rank), against the dense layer and the kept choices' sum;
* D. ``_dist_train``: one ZeRO-1 sharded train step of granite-3-2b (4
  layers, batch 4 x 1024) over (data=2, model=2) against the unsharded
  step on the whole batch on each rank, with each step's peak memory;
* E. ``_dist_a2a_train``: the sharded train step of deepseek-moe-16b cut
  to 2 layers (reduced: depth; a dense layer, then a MoE layer of 64
  experts) with ``moe_impl="a2a"`` over (data=1, model=4), batch 4 x
  2048, against the unsharded step with the dense MoE layer (drop-free
  capacity).

Rank 0 prints one line a check and a JSON object of every number last;
any failed check exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

WORLD = 4


def _worker(rank: int, store: str, device_type: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as FD
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.runtime.steps import params_specs

    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", rank)
        kw = dict(backend="nccl", device_id=dev)
    else:
        torch.set_num_threads(2)
        dev = torch.device("cpu")
        kw = dict(backend="gloo")
    dist.init_process_group(rank=rank, world_size=WORLD, store=dist.FileStore(
        store, WORLD), **kw)
    try:
        granite = get_config("granite-3-2b")
        granite = (dataclasses.replace(granite, n_layers=4) if cuda
                   else granite.smoke())
        deepseek = get_config("deepseek-moe-16b")
        if not cuda:
            deepseek = deepseek.smoke()
        mesh = init_device_mesh(dev.type, (2, 2),
                                mesh_dim_names=("data", "model"))
        pod_mesh = init_device_mesh(dev.type, (2, 2),
                                    mesh_dim_names=("pod", "data"))
        gen = torch.Generator(device=dev).manual_seed(100 + rank)
        tree = {n: torch.randn(tuple(p.shape), generator=gen, device=dev)
                for n, p in params_specs(granite).named_parameters()}
        t0 = time.perf_counter()
        out = dict(grad_mean=smoke._dist_grad_mean(pod_mesh, tree, dev,
                                                   tag="A "))
        del tree
        out["decode"] = smoke._dist_decode(
            FD, mesh, dev, granite, (8,) if cuda else (4,),
            2048 if cuda else 64, tag="B ")
        out["moe"] = smoke._dist_moe(mesh, dev, deepseek, 4,
                                     2048 if cuda else 8, tag="C ")
        out["train"], _, _ = smoke._dist_train(
            FA, dev, mesh, granite, 4, 1024 if cuda else 16, tag="D ")
        a2a_mesh = init_device_mesh(dev.type, (1, 4),
                                    mesh_dim_names=("data", "model"))
        moe_cfg = (dataclasses.replace(deepseek, n_layers=2) if cuda
                   else deepseek)
        out["a2a_train"] = smoke._dist_a2a_train(
            dev, a2a_mesh, moe_cfg, 4, 2048 if cuda else 8,
            tag="E (reduced: depth 28 -> 2 layers) " if cuda else "E ")
        smoke._say(f"every check passed on {WORLD} ranks in "
                   f"{time.perf_counter() - t0:.1f} s")
        smoke._say(json.dumps(out, default=str))
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch.multiprocessing as mp
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()
    if args.device == "cuda":
        if torch.cuda.device_count() < WORLD:
            print(f"distributed_nccl: needs {WORLD} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        import subprocess
        from concurrent.futures import ThreadPoolExecutor
        from repro_torch.kernels import decode_attention as FD
        from repro_torch.kernels import flash_attention as FA
        # built once here, one nvcc each, so the ranks load them
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(lambda b: b(), (FA.build, FA.build_bwd, FD.build)))
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        mp.spawn(_worker, args=(os.path.join(tmp, "store"), args.device),
                 nprocs=WORLD, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

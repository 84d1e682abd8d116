"""Dry run: a per-device accounting of one step of every (architecture x
input shape x mesh) cell (port of ``launch/dryrun.py``).

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's memory and cost analyses and the partitioned
HLO.  The port has no compiler: it runs the port's own step once, on
fake tensors, as rank 0 of a fake process group of the mesh's size, and
counts what that rank's program does:

* **the group and the mesh** - ``init_process_group("fake")`` of world
  size 256 (or 512), a CPU ``DeviceMesh`` over it (:func:`fake_mesh`): a
  collective returns at once and moves nothing.  A process holds one
  group; each mesh gets its own, destroyed after it.  Never in a process
  that holds a real group (the tests run the dry run in a child);
* **the step** - the model built on fake tensors (``FakeTensorMode``:
  shapes and dtypes, nothing allocated), laid out by ``ShardingPolicy``
  (``distribute_model``, ``sharded_opt_state``, ``sharded_caches``), and
  the sharded step of ``runtime/steps.py``: ``make_train_step`` (forward,
  remat backward, AdamW), ``make_prefill_step`` or ``make_serve_step``;
* **the kernels** - on fake tensors each hand-written kernel's wrapper
  returns fake outputs and adds its operations and bytes
  (``roofline/kernel_costs.py``) instead of launching; it never runs the
  plain version, which would hold the whole S x S score matrix (and count
  the causal upper half) that the kernel never holds.  The backward
  kernels (the attention's, ``wkv6_bwd`` and ``rglru_scan_bwd``) count
  themselves the same way through their autograd Functions.

Each record has the keys ``roofline/analysis.analyze_record`` reads:

* ``cost_analysis``: ``"flops"`` is ``FlopCounterMode``'s count (its
  formulas, counted by :class:`_Flops`) plus the kernels'; ``"bytes
  accessed"`` the operand and result bytes of every dispatched operator
  that is not a view, plus the kernels' - eager and unfused, the same
  crude upper bound as the reference's CPU number;
* ``collectives``: ``roofline/hlo.CollectiveCounter``'s per-device result
  bytes under the HLO names;
* ``memory_analysis``: ``argument_size_in_bytes`` the rank's parameters,
  moments and rows of the batch (or caches and token);
  ``output_size_in_bytes`` the step's outputs; ``alias_size_in_bytes``
  what the step updates in place (parameters and moments when training,
  caches when decoding: what the reference donates);
  ``peak_memory_in_bytes`` the most bytes of fake storage alive at once
  (the arguments and the whole batch each rank is handed included; a
  storage counts until the program drops its last reference: the step
  holds no tensor in a reference cycle, so the count does not depend on
  when the collector runs) and ``temp_size_in_bytes`` that less what was
  alive when the step began;
* ``trace_seconds`` in place of the reference's ``compile_seconds``;
  ``accounting_depths`` is ``[n_layers]``: eager counting sees every
  layer, so there is no scan body counted once and no extrapolation
  (:func:`_reduced_depths` is kept for the test that checks the counts
  are affine in depth).

A lever the port lacks is recorded ``status: "error"`` with its name:
``--remat-policy dots`` (the port's remat recomputes the whole layer,
``models/model.py``) and ``--kv-dtype int8`` (no int8 KV cache).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Each cell writes ``results/dryrun_torch/<arch>__<shape>__<mesh>[__tag]
.json``; ``python -m repro_torch.roofline.report`` reads them.  Cells run
side by side, one a process, as many as the host has cores.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import SHAPES, all_configs, get_config, skip_reason
from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from ..roofline import kernel_costs
from ..roofline.hlo import CollectiveCounter, tensor_bytes
from .mesh import MeshShape, make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: levers the port does not have: (the config field, its value) -> why
MISSING_LEVERS = {
    ("remat_policy", "dots"): (
        "lever --remat-policy dots: the port has no selective remat; its "
        "remat recomputes the whole layer (models/model.py)"),
    ("cache_dtype", "int8"): (
        "lever --kv-dtype int8: the port has no int8 KV cache (the decode "
        "kernel takes float32 or bfloat16)"),
}


@contextlib.contextmanager
def fake_mesh(shape: MeshShape):
    """This process as rank 0 of a fake process group of the mesh's size,
    and a CPU ``DeviceMesh`` of ``shape`` over it; the group is destroyed
    after the block."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: a "
                           "process group is initialised here already")
    world = 1
    for n in shape.sizes:
        world *= n
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield init_device_mesh("cpu", tuple(shape.sizes),
                               mesh_dim_names=tuple(shape.axis_names))
    finally:
        dist.destroy_process_group()


class _Flops(TorchDispatchMode):
    """``FlopCounterMode``'s total - its formulas
    (``torch.utils.flop_counter.flop_registry``), and the decomposition of
    an operator it has none for - without its module tracker, whose hooks
    keep the step's tensors in reference cycles until the collector runs
    (so the live bytes the dry run counts would depend on when it ran)."""

    def __init__(self) -> None:
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        if (func not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


class _Account(CollectiveCounter):
    """Collectives (as :class:`CollectiveCounter`), the bytes every
    operator that is not a view reads and writes, and the bytes of fake
    storage alive, with their peak."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, weakref.ref] = {}

    def hold(self, t) -> None:
        """Count ``t``'s storage alive until it is freed (a ``DTensor``:
        its local block's)."""
        t = getattr(t, "_local_tensor", t)
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            self.live -= n
            self._storages.pop(key, None)

        self._storages[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if not func.is_view:
            self.bytes_accessed += tensor_bytes(args) + tensor_bytes(out)
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.hold(t)
        return out


def _leaves(tree):
    """The tensors of a tree (dicts, lists, tuples, a module's
    parameters)."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _local_bytes(tree) -> int:
    """Bytes of the rank's blocks of a tree's tensors (a ``DTensor``: its
    local block)."""
    return sum(tensor_bytes(t) for t in _leaves(tree))


def _batch(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The whole batch every rank is handed (zeros: fake tensors)."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.zeros((B, S), dtype=torch.int32),
             "labels": torch.zeros((B, S), dtype=torch.int32)}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((B, cfg.encoder_seq_len, cfg.d_model),
                                      dtype=cfg.cdtype())
    if shape.kind == "prefill":
        del batch["labels"]
    return batch


def account(cfg: ModelConfig, shape: ShapeSpec, mesh_shape: MeshShape,
            policy_kwargs: Optional[dict] = None) -> dict:
    """One step of ``cfg`` at ``shape`` on a mesh of ``mesh_shape``
    counted on fake tensors: the record's ``cost_analysis``,
    ``collectives``, ``memory_analysis``, ``kernels`` (each kernel's
    calls, operations and bytes) and ``trace_seconds``.  Raises what the
    step raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.model import Transformer, cache_specs
    from ..runtime.sharding import (ShardingPolicy, distribute_model,
                                    local_chunk, sharded_caches,
                                    sharded_opt_state)
    from ..runtime.steps import (make_prefill_step, make_serve_step,
                                 make_train_step)

    for (field, value), why in MISSING_LEVERS.items():
        if getattr(cfg, field) == value:
            raise NotImplementedError(why)
    t0 = time.perf_counter()
    with fake_mesh(mesh_shape) as mesh, FakeTensorMode(
            allow_non_fake_inputs=True):
        policy = ShardingPolicy(cfg, mesh, **(policy_kwargs or {}))
        model = distribute_model(Transformer(cfg, None, "cpu"), policy)
        if shape.kind == "train":
            opt = sharded_opt_state(policy, model)
            batch = _batch(cfg, shape)
            args = (model, opt, batch)
            step = make_train_step(cfg, policy=policy)
            aliased = [model, opt]
        elif shape.kind == "prefill":
            batch = _batch(cfg, shape)
            args = (model, batch)
            step = make_prefill_step(cfg, policy=policy)
            aliased = []
        else:
            caches = sharded_caches(policy, cache_specs(
                cfg, shape.global_batch, shape.seq_len))
            batch = {"token": torch.zeros((shape.global_batch, 1),
                                          dtype=torch.int32)}
            args = (model, caches, batch["token"])
            step = make_serve_step(cfg, policy=policy)
            aliased = [caches]
        b_specs = policy.batch_shardings(batch)
        local_batch = sum(tensor_bytes(local_chunk(v, b_specs[k][:1], mesh))
                          for k, v in batch.items())
        arg_bytes = _local_bytes(args[:-1]) + local_batch
        acct = _Account()
        for t in _leaves(args):
            acct.hold(t)
        start = acct.live
        kernel_costs.reset()
        with _Flops() as flops, acct:
            out = step(*args)
        out_bytes = _local_bytes(out)
        alias_bytes = _local_bytes(aliased)
    kc = dict(kernel_costs.COUNTS)
    kernels = {}
    for key, n in kc.items():
        name, _, what = key.rpartition(".")
        if name:
            kernels.setdefault(name, {})[what] = n
    return {
        "trace_seconds": round(time.perf_counter() - t0, 2),
        "cost_analysis": {
            "flops": float(flops.total + kc.get("flops", 0)),
            "bytes accessed": float(acct.bytes_accessed + kc.get("bytes", 0)),
            "flop_counter_flops": float(flops.total),
            "kernel_flops": float(kc.get("flops", 0)),
        },
        "collectives": {op: dict(v) for op, v in acct.stats.items()},
        "memory_analysis": {
            "argument_size_in_bytes": int(arg_bytes),
            "output_size_in_bytes": int(out_bytes),
            "alias_size_in_bytes": int(alias_bytes),
            "peak_memory_in_bytes": int(acct.peak),
            "temp_size_in_bytes": int(max(acct.peak - start, 0)),
        },
        "kernels": kernels,
    }


def _reduced_depths(cfg: ModelConfig) -> tuple:
    """Two reduced layer counts (L_a, L_b) preserving the segment pattern
    (the reference's: it extrapolated its unrolled compiles from them; the
    port counts every layer, and a test checks the full-depth count is
    the affine extrapolation from these two)."""
    prefix = cfg.moe_layer_start
    period = len(cfg.block_pattern)
    return prefix + 2 * period, prefix + 4 * period


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             policy_kwargs: Optional[dict] = None, tag: str = "",
             verbose: bool = True, cfg_overrides: Optional[dict] = None,
             shape: Optional[ShapeSpec] = None,
             mesh_shape: Optional[MeshShape] = None) -> dict:
    """One dry-run cell: the record of :func:`account` at full depth, or
    ``status`` "skipped" (the reference's skip reasons) or "error".  ``shape``
    and ``mesh_shape`` override the named shape and production mesh (the
    card's smoke run holds a step of its own size against the card); the
    record then carries the shape as ``shape_spec``, which
    ``roofline/analysis.analyze_record`` reads."""
    cfg = dataclasses.replace(get_config(arch), **(cfg_overrides or {}))
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "tag": tag, "policy": dict(policy_kwargs or {})}
    if shape is not None and shape != SHAPES.get(shape_name):
        record["shape_spec"] = dataclasses.asdict(shape)
    shape = shape or SHAPES[shape_name]
    record["kind"] = shape.kind
    reason = skip_reason(cfg, shape_name)
    if reason:
        record.update(status="skipped", skip_reason=reason)
        return record
    mesh_shape = mesh_shape or make_production_mesh(
        multi_pod=(mesh_kind == "multi"))
    n_dev = 1
    for n in mesh_shape.sizes:
        n_dev *= n
    record["n_devices"] = n_dev
    try:
        record.update(status="ok", **account(cfg, shape, mesh_shape,
                                             policy_kwargs))
        record["accounting_depths"] = [cfg.n_layers]
        if verbose:
            ma, ca = record["memory_analysis"], record["cost_analysis"]
            coll = sum(v["bytes"] for v in record["collectives"].values())
            print(f"[ok] {arch} x {shape_name} x {mesh_kind} "
                  f"trace={record['trace_seconds']:.1f}s "
                  f"flops/dev={ca['flops']:.3e} coll_bytes/dev={coll:.3e} "
                  f"args={ma['argument_size_in_bytes'] / 2**30:.2f}GiB "
                  f"temp={ma['temp_size_in_bytes'] / 2**30:.2f}GiB",
                  flush=True)
    except Exception as e:
        record.update(status="error", error=repr(e),
                      traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[ERROR] {arch} x {shape_name} x {mesh_kind}: {e!r}",
                  flush=True)
    return record


def save_record(record: dict, out_dir: Path = RESULTS_DIR) -> Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"__{record['tag']}" if record.get("tag") else ""
    path = out_dir / (f"{record['arch']}__{record['shape']}"
                      f"__{record['mesh']}{tag}.json")
    path.write_text(json.dumps(record, indent=1, default=str))
    return path


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--tag", default="", help="policy-variant tag for output")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--flat-qkv", action="store_true",
                    help="shard q/k/v on flat head*dim even if heads don't "
                         "divide")
    ap.add_argument("--kv-dtype", default="",
                    help="KV-cache dtype override (e.g. int8)")
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="zero-pad attention heads to this count (exact "
                         "math: padded w_o rows are zero); makes head-wise "
                         "TP divide the model axis")
    ap.add_argument("--pad-kv-heads", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true",
                    help="FSDP over the model axis (params gathered per use)")
    ap.add_argument("--seq-dp", action="store_true",
                    help="context parallelism: sequence dim over the pod axis "
                         "when the batch can't use it")
    ap.add_argument("--remat-policy", default="",
                    choices=["", "full", "dots"])
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation checkpointing entirely")
    ap.add_argument("--moe-impl", default="",
                    choices=["", "gshard", "dense", "a2a"])
    ap.add_argument("--dp-only", action="store_true",
                    help="pure data parallelism: replicate params, batch over "
                         "(pod,data,model); pair with --zero1")
    ap.add_argument("--no-seq-cache", action="store_true",
                    help="disable sequence sharding of decode caches")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells whose result JSON already exists")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args()

    policy_kwargs = {}
    if args.zero1:
        policy_kwargs["zero1"] = True
    if args.flat_qkv:
        policy_kwargs["shard_qkv_by_flat_dim"] = True
    if args.no_seq_cache:
        policy_kwargs["seq_shard_cache"] = False
    if args.dp_only:
        policy_kwargs["dp_only"] = True
    if args.fsdp:
        policy_kwargs["fsdp"] = True
    if args.seq_dp:
        policy_kwargs["seq_dp"] = True
    cfg_overrides = {}
    if args.kv_dtype:
        cfg_overrides["cache_dtype"] = args.kv_dtype
    if args.remat_policy:
        cfg_overrides["remat_policy"] = args.remat_policy
    if args.no_remat:
        cfg_overrides["remat"] = False
    if args.moe_impl:
        cfg_overrides["moe_impl"] = args.moe_impl
    if args.pad_heads:
        base = get_config(args.arch) if args.arch else None
        cfg_overrides["n_heads"] = args.pad_heads
        cfg_overrides["n_kv_heads"] = args.pad_kv_heads or args.pad_heads
        if base is not None:
            cfg_overrides["d_head"] = base.head_dim
    cfg_overrides = cfg_overrides or None

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        archs = sorted(all_configs())
        shapes = list(SHAPES)
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        archs, shapes = [args.arch], [args.shape]

    out_dir = Path(args.out)
    n_ok = n_skip = n_err = 0
    todo = []
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"__{args.tag}" if args.tag else ""
                existing = out_dir / f"{arch}__{shape}__{mesh_kind}{tag}.json"
                if args.resume and existing.exists():
                    rec = json.loads(existing.read_text())
                    if rec.get("status") in ("ok", "skipped"):
                        n_ok += rec["status"] == "ok"
                        n_skip += rec["status"] == "skipped"
                        continue
                todo.append((arch, shape, mesh_kind))
    # the train cells take longest: first, so the workers end together
    todo.sort(key=lambda c: SHAPES[c[1]].kind != "train")
    t0 = time.perf_counter()
    kw = dict(policy_kwargs=policy_kwargs, tag=args.tag,
              cfg_overrides=cfg_overrides, out_dir=out_dir)
    # one cell a process, as many side by side as the host has cores
    jobs = min(len(todo), os.cpu_count() or 1)
    if jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(jobs, mp_context=multiprocessing.
                                 get_context("spawn")) as pool:
            statuses = list(pool.map(_run_and_save, todo,
                                     [kw] * len(todo)))
    else:
        statuses = [_run_and_save(cell, kw) for cell in todo]
    n_ok += statuses.count("ok")
    n_skip += statuses.count("skipped")
    n_err += statuses.count("error")
    print(f"done: ok={n_ok} skipped={n_skip} errors={n_err} in "
          f"{time.perf_counter() - t0:.1f} s ({jobs} process"
          f"{'es' if jobs > 1 else ''})")
    if n_err:
        raise SystemExit(1)


def _run_and_save(cell, kw: dict) -> str:
    """One cell, its record written; its status.  Each process runs one
    cell at a time, and holds no process group between cells."""
    arch, shape, mesh_kind = cell
    kw = dict(kw)
    out_dir = kw.pop("out_dir")
    rec = run_cell(arch, shape, mesh_kind, **kw)
    save_record(rec, out_dir)
    gc.collect()
    return rec["status"]


if __name__ == "__main__":
    main()

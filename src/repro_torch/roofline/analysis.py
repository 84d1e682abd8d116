"""Roofline analysis over the dry-run records (port of
``roofline/analysis.py``), on one NVIDIA H100 SXM's constants.

Per (arch x shape x mesh) cell, three terms in seconds:

    compute    = FLOPs_per_device   / 989 TFLOP/s (dense bf16, tensor cores)
    memory     = HBM_bytes_per_device / 3.35 TB/s
    collective = coll_bytes_per_device /  50 GB/s per card

(the dry run's counts are already per-device - each rank's program is
counted - so the "devices x" denominators of the global form cancel.)

The link rate is one 400 Gb/s NDR InfiniBand port per card, eight cards
a node as a DGX H100 lays them out: every model-axis group (16
consecutive ranks) and every data-axis group (stride 16) of both
production meshes spans more than one node, so its collectives cross the
network.  NVLink's 450 GB/s a direction joins only the 8 cards of a node
and is not used for these meshes.

HBM bytes: the dry run's "bytes accessed" sums every dispatched operator's
operand and result bytes, eager and unfused - a gross upper bound on the
card's memory traffic (fused kernels keep elementwise chains on chip).
The memory term therefore uses an analytical model, with the counted
number kept as ``memory_hlo_upper_s``:

    train:  read params (fwd + remat-refwd + bwd = 3x) + write params
            + read/write f32 moments (grad, m, v)        [argument+output
            bytes from memory_analysis cover params/opt/batch]
            + 3x residual-stream activation traffic (store fwd boundary,
            re-read at bwd, grad stream)
    decode: read params + KV cache once (weight streaming) + small writes
    prefill: read params + 2x activation stream + cache writes

Step-time estimate T = max(terms) (perfect overlap); the dominant term is
the bottleneck the perf loop iterates on.  We also report:

  * MODEL_FLOPS = 6*N*D (train) / 2*N*D (prefill) / 2*N_active*B (decode),
  * usefulness  = MODEL_FLOPS / (FLOPs_per_device * n_devices)  - how
    much of the counted compute is "useful" (catches remat/redundancy
    waste; < 1 means overhead),
  * MFU_est     = MODEL_FLOPS / (n_devices * PEAK * T).

A weight-streaming lower bound (param + KV bytes once per step) is
reported alongside.

The card's rates, one copy (``chip_smoke.py``'s bounds read them too):
dense bf16 and TF32 on the tensor cores, float32 on the CUDA cores, the
memory rate; NVIDIA's data sheet, H100 SXM at its full 700 W limit.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from ..configs import SHAPES, get_config
from ..configs.shapes import ShapeSpec

PEAK_FLOPS = 989e12          # dense bf16 per card (tensor cores)
PEAK_TF32_FLOPS = 495e12     # dense TF32 per card (tensor cores)
PEAK_F32_FLOPS = 67e12       # float32 per card (CUDA cores)
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 50e9               # bytes/s per card: one 400 Gb/s NDR port

#: the peak of each kind of operation ``kernel_costs`` names
PEAK_BY_RATE = {"bf16": PEAK_FLOPS, "tf32": PEAK_TF32_FLOPS,
                "f32": PEAK_F32_FLOPS}


@dataclass
class CellRoofline:
    arch: str
    shape: str
    mesh: str
    status: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    memory_hlo_upper_s: float = 0.0
    collective_s: float = 0.0
    weight_stream_s: float = 0.0
    dominant: str = ""
    step_s: float = 0.0
    model_flops: float = 0.0
    hlo_flops_global: float = 0.0
    usefulness: float = 0.0
    mfu_est: float = 0.0
    n_devices: int = 0
    note: str = ""
    tag: str = ""


def _spec(shape) -> ShapeSpec:
    """A shape of ``SHAPES`` by name, or a ``ShapeSpec`` as it is (a
    record's ``shape_spec``: a size its caller chose)."""
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def _record_shape(rec: dict):
    """The record's shape: its ``shape_spec`` where it has one, else the
    name of one of ``SHAPES``."""
    if "shape_spec" in rec:
        return ShapeSpec(**rec["shape_spec"])
    return rec["shape"]


def model_flops_for(arch: str, shape_name) -> float:
    cfg = get_config(arch)
    spec = _spec(shape_name)
    if spec.kind == "train":
        tokens = spec.global_batch * spec.seq_len
        return 6.0 * cfg.n_active_params() * tokens
    if spec.kind == "prefill":
        tokens = spec.global_batch * spec.seq_len
        return 2.0 * cfg.n_active_params() * tokens
    # decode: one token per sequence
    return 2.0 * cfg.n_active_params() * spec.global_batch


def _param_bytes(arch: str) -> float:
    cfg = get_config(arch)
    return cfg.n_params() * 2.0  # bf16


def _kv_bytes(arch: str, shape_name) -> float:
    cfg = get_config(arch)
    spec = _spec(shape_name)
    if spec.kind != "decode":
        return 0.0
    per_layer = {"attn": spec.seq_len, "xattn": spec.seq_len,
                 "local_attn": min(cfg.attn_window or spec.seq_len,
                                   spec.seq_len)}
    total = 0.0
    for t in cfg.layer_types():
        if t in per_layer:
            total += (spec.global_batch * per_layer[t]
                      * cfg.n_kv_heads * cfg.head_dim * 2 * 2)  # K+V bf16
        elif t == "rwkv6":
            total += (spec.global_batch * cfg.n_heads
                      * cfg.head_dim * cfg.head_dim * 4)
        elif t == "rglru":
            total += spec.global_batch * cfg.rnn_width * 4
    return total


def _activation_bytes_per_device(arch: str, shape_name,
                                 n_dev: int) -> float:
    """Residual-stream activation traffic per device (remat policy: store
    one boundary tensor per layer; 3 touches for train, 2 for prefill)."""
    cfg = get_config(arch)
    spec = _spec(shape_name)
    if spec.kind == "decode":
        return 0.0
    # batch is sharded over the data axes; model axis keeps full tokens
    dp = max(n_dev // 16, 1)  # model axis is 16 wide on both meshes
    tokens_dev = spec.global_batch * spec.seq_len / dp
    touches = 3.0 if spec.kind == "train" else 2.0
    return touches * cfg.n_layers * tokens_dev * cfg.d_model * 2.0


def analyze_record(rec: dict) -> CellRoofline:
    cell = CellRoofline(arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
                        status=rec["status"], tag=rec.get("tag", ""))
    if rec["status"] != "ok":
        cell.note = rec.get("skip_reason", rec.get("error", ""))[:120]
        return cell
    n_dev = rec.get("n_devices", 256)
    cost = rec.get("cost_analysis", {})
    flops_dev = float(cost.get("flops", 0.0))
    bytes_hlo_dev = float(cost.get("bytes accessed", 0.0))
    coll_dev = sum(v["bytes"] for v in rec.get("collectives", {}).values())
    ma = rec.get("memory_analysis", {})
    arg_bytes = float(ma.get("argument_size_in_bytes", 0.0))
    out_bytes = float(ma.get("output_size_in_bytes", 0.0))
    # donated buffers alias inputs: count the traffic once
    out_bytes = max(out_bytes - float(ma.get("alias_size_in_bytes", 0.0)), 0.0)
    shape = _record_shape(rec)
    act_bytes = _activation_bytes_per_device(rec["arch"], shape, n_dev)

    cell.n_devices = n_dev
    cell.compute_s = flops_dev / PEAK_FLOPS
    cell.memory_s = (arg_bytes + out_bytes + act_bytes) / HBM_BW
    cell.memory_hlo_upper_s = bytes_hlo_dev / HBM_BW
    cell.collective_s = coll_dev / LINK_BW
    cell.weight_stream_s = ((_param_bytes(rec["arch"])
                             + _kv_bytes(rec["arch"], shape))
                            / n_dev / HBM_BW)
    terms = {"compute": cell.compute_s, "memory": cell.memory_s,
             "collective": cell.collective_s}
    cell.dominant = max(terms, key=terms.get)  # type: ignore[arg-type]
    cell.step_s = max(terms.values())
    cell.model_flops = model_flops_for(rec["arch"], shape)
    cell.hlo_flops_global = flops_dev * n_dev
    cell.usefulness = (cell.model_flops / cell.hlo_flops_global
                       if cell.hlo_flops_global else 0.0)
    cell.mfu_est = (cell.model_flops / (n_dev * PEAK_FLOPS * cell.step_s)
                    if cell.step_s else 0.0)
    cell.note = _advice(cell)
    return cell


def _advice(cell: CellRoofline) -> str:
    if cell.dominant == "collective":
        return ("reduce TP activation all-reduces (sequence-parallel / "
                "DP-heavier layout / compressed cross-pod)")
    if cell.dominant == "memory":
        if cell.shape.startswith(("decode", "long")):
            return ("weight+KV streaming bound: raise batch per card or "
                    "shrink cache dtype (int8 KV)")
        return "increase fusion / remat policy; raise arithmetic intensity"
    return "compute-bound: good placement; tune kernel tiling next"


def load_cells(results_dir: str, tag: str = "") -> List[CellRoofline]:
    cells = []
    for p in sorted(Path(results_dir).glob("*.json")):
        rec = json.loads(p.read_text())
        if rec.get("tag", "") != tag:
            continue
        cells.append(analyze_record(rec))
    return cells


def markdown_table(cells: List[CellRoofline]) -> str:
    head = ("| arch | shape | mesh | compute s | memory s | collective s | "
            "dominant | T=max s | MFU_est | useful | note |\n"
            "|---|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for c in cells:
        if c.status == "skipped":
            rows.append(f"| {c.arch} | {c.shape} | {c.mesh} | - | - | - | "
                        f"skipped | - | - | - | {c.note} |")
        elif c.status == "error":
            rows.append(f"| {c.arch} | {c.shape} | {c.mesh} | - | - | - | "
                        f"ERROR | - | - | - | {c.note} |")
        else:
            rows.append(
                f"| {c.arch} | {c.shape} | {c.mesh} "
                f"| {c.compute_s:.3e} | {c.memory_s:.3e} "
                f"| {c.collective_s:.3e} | **{c.dominant}** | {c.step_s:.3e} "
                f"| {c.mfu_est:.3f} | {c.usefulness:.2f} | {c.note} |")
    return head + "\n".join(rows) + "\n"


def pick_hillclimb_cells(cells: List[CellRoofline]) -> Dict[str, CellRoofline]:
    """The three assignment-mandated targets: worst roofline fraction, most
    collective-bound, most representative of the paper's technique."""
    ok = [c for c in cells if c.status == "ok" and c.mesh == "single"]
    # MFU is meaningful for token-dense cells; decode cells are judged by
    # bandwidth utilisation (weight streaming / step time)
    dense = [c for c in ok if c.shape.startswith(("train", "prefill"))]
    worst_mfu = min(dense or ok,
                    key=lambda c: c.mfu_est if c.mfu_est > 0 else 1e9)
    most_coll = max(ok, key=lambda c: (c.collective_s / max(c.step_s, 1e-30)))
    # the paper's technique = read/write path decoupling -> serving decode
    decode = [c for c in ok if c.shape.startswith(("decode", "long"))]
    representative = max(decode, key=lambda c: c.step_s) if decode else ok[0]
    return {"worst_mfu": worst_mfu, "most_collective": most_coll,
            "paper_representative": representative}

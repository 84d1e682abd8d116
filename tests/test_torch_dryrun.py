"""The port's dry run (``repro_torch/launch/dryrun.py``) and a2a probe
(``repro_torch/launch/moe_a2a_probe.py``) on fake process groups.

A process holds one process group, so the cells run in one child process
(a module fixture) and leave their records in a JSON file the tests read:

* granite-3-2b ``train_4k`` on the (16, 16) mesh: ok; its argument bytes
  the policy's per-device bf16 parameters, float32 moments (m and v) and
  rows of the batch (the arithmetic of ``chip_smoke.py``'s phase D1),
  exactly; its all-gathers exactly the parameters gathered at use, and
  all-reduces (their gradients summed over "data");
* the same cell at full depth equal to the affine extrapolation from its
  two ``_reduced_depths`` (to 1e-9 relative: every layer is counted, and
  each adds the same); the smaller of these run again with the collector
  off, with the same peak memory, exactly;
* rwkv6-7b ``train_4k`` ok, its WKV backward counted once a layer, and
  recurrentgemma-2b ``train_4k`` ok, its RG-LRU backward counted once an
  RG-LRU layer and the attention backward once a local-attention layer;
  granite ``long_500k`` skipped with the reference's reason; a decode
  cell ok;
* the reference's own ``analyze_record`` reading a port record;
* the probe on a fake (2, 2) mesh: four all-to-alls of E x C x d
  elements each (two forward, two backward), exactly.

In this process: real CPU tensors take the kernels' plain versions, never
the fake branch (a real CUDA tensor launches the kernel: the gpu test).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

CHILD = """
import dataclasses, gc, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.moe_a2a_probe import probe
out = {}
cfg = get_config("granite-3-2b")
out["train"] = dryrun.run_cell("granite-3-2b", "train_4k", "single",
                               verbose=False)
for L in dryrun._reduced_depths(cfg):
    out[f"train_{L}"] = dryrun.run_cell(
        "granite-3-2b", "train_4k", "single", verbose=False,
        cfg_overrides={"n_layers": L})
gc.disable()  # the same cell with the collector off
out["train_nogc"] = dryrun.run_cell(
    "granite-3-2b", "train_4k", "single", verbose=False,
    cfg_overrides={"n_layers": dryrun._reduced_depths(cfg)[0]})
gc.enable()
out["rwkv_train"] = dryrun.run_cell("rwkv6-7b", "train_4k", "single",
                                    verbose=False)
out["rg_train"] = dryrun.run_cell("recurrentgemma-2b", "train_4k", "single",
                                  verbose=False)
out["long"] = dryrun.run_cell("granite-3-2b", "long_500k", "single",
                              verbose=False)
out["decode"] = dryrun.run_cell("granite-3-2b", "decode_32k", "single",
                                verbose=False)
small = dataclasses.replace(get_config("qwen3-moe-30b-a3b").smoke(),
                            param_dtype="bfloat16",
                            compute_dtype="bfloat16")
out["probe"] = probe(small, MeshShape(("data", "model"), (2, 2)), batch=8,
                     seq=16, verbose=False)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "cells.json"
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(CHILD), str(path)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(path.read_text())


def test_train_cell_argument_bytes_are_the_policys(cells):
    """The rank's bf16 parameters and float32 m and v, from the policy's
    specs on the (16, 16) mesh (each split dim divided by its axes' sizes),
    its 16 rows of the tokens and labels, and the int32 step counter."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.sharding import ShardingPolicy, _axes
    from repro_torch.runtime.steps import params_specs

    rec = cells["train"]
    assert rec["status"] == "ok", rec.get("error")
    cfg = get_config("granite-3-2b")
    mesh = make_production_mesh()
    model = params_specs(cfg)
    numel = {n: p.numel() for n, p in model.named_parameters()}
    policy = ShardingPolicy(cfg, mesh)

    def per_device(specs, width):
        total = 0
        for n, spec in specs.items():
            parts = 1
            for entry in spec:
                for a in _axes(entry):
                    parts *= mesh.shape[a]
            assert numel[n] % parts == 0, n
            total += numel[n] * width // parts
        return total

    params = per_device(policy.params_shardings(model), 2)
    moments = per_device(policy.opt_state_shardings(model)["m"], 8)
    batch = 2 * (256 // 16) * 4096 * 4
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] == params + moments + batch + 4
    assert ma["alias_size_in_bytes"] == params + moments + 4
    assert ma["output_size_in_bytes"] > ma["alias_size_in_bytes"]
    assert ma["peak_memory_in_bytes"] > ma["argument_size_in_bytes"]
    # every parameter split over "model" gathered whole at use: a layer's
    # twice (its forward and its remat recompute), the model's own once;
    # the gradients summed over "data" (all-reduces: no parameter is split
    # over a batch axis under this policy, so none is reduce-scattered)
    specs = policy.params_shardings(model)
    n_gather = gathered = 0
    for n, p in model.named_parameters():
        if any(e is not None for e in specs[n]):
            times = 2 if n.startswith("layers.") else 1
            n_gather += times
            gathered += times * p.numel() * 2
    coll = rec["collectives"]
    assert coll["all-gather"] == {"count": n_gather, "bytes": gathered}
    assert coll["all-reduce"]["count"] > 0
    assert "reduce-scatter" not in coll
    assert rec["accounting_depths"] == [cfg.n_layers]
    # the attention kernels counted, forward twice (remat) and backward once
    # a layer
    kernels = rec["kernels"]
    assert kernels["flash_attention"]["calls"] == 2 * cfg.n_layers
    assert kernels["flash_attention_bwd"]["calls"] == cfg.n_layers
    assert rec["cost_analysis"]["flops"] == pytest.approx(
        rec["cost_analysis"]["flop_counter_flops"]
        + rec["cost_analysis"]["kernel_flops"], rel=1e-12)


def test_full_depth_is_the_affine_extrapolation_of_reduced_depths(cells):
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _reduced_depths
    L = get_config("granite-3-2b").n_layers
    L_a, L_b = _reduced_depths(get_config("granite-3-2b"))
    a, b, full = cells[f"train_{L_a}"], cells[f"train_{L_b}"], cells["train"]

    def extrapolate(get):
        return get(a) + (get(b) - get(a)) / (L_b - L_a) * (L - L_a)

    for key in ("flops", "bytes accessed"):
        get = lambda r, key=key: r["cost_analysis"][key]  # noqa: E731
        assert get(full) == pytest.approx(extrapolate(get), rel=1e-9), key
    for op in full["collectives"]:
        for field in ("count", "bytes"):
            get = lambda r, op=op, f=field: r["collectives"][op][f]  # noqa
            assert get(full) == pytest.approx(extrapolate(get),
                                              rel=1e-9), (op, field)


def test_peak_memory_does_not_wait_for_the_collector(cells):
    """A storage counts as live until the program drops its last
    reference: the reduced-depth train cell run again with the collector
    off has the same peak and temporary bytes, exactly (a tensor held in
    a reference cycle would stay counted there until the end)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _reduced_depths
    L_a = _reduced_depths(get_config("granite-3-2b"))[0]
    on, off = cells[f"train_{L_a}"], cells["train_nogc"]
    assert off["status"] == "ok"
    for key in ("peak_memory_in_bytes", "temp_size_in_bytes"):
        assert off["memory_analysis"][key] == on["memory_analysis"][key]
    assert (on["memory_analysis"]["temp_size_in_bytes"]
            > on["memory_analysis"]["argument_size_in_bytes"] // 100)


def test_rwkv6_train_cell_counts_one_wkv_backward_a_layer(cells):
    """rwkv6-7b's train step runs on fake tensors through the WKV
    Function: one ``wkv6_bwd`` a layer, and the forward twice a layer (the
    forward and its recompute under remat)."""
    from repro_torch.configs import get_config
    rec = cells["rwkv_train"]
    assert rec["status"] == "ok", rec.get("error")
    L = get_config("rwkv6-7b").n_layers
    assert rec["kernels"]["wkv6_bwd"]["calls"] == L
    assert rec["kernels"]["wkv6"]["calls"] == 2 * L
    assert rec["kernels"]["wkv6_bwd"]["flops"] > 0


def test_recurrentgemma_train_cell_counts_its_backward_kernels(cells):
    """recurrentgemma-2b's train step: one ``rglru_scan_bwd`` for each of
    its 18 RG-LRU layers and one ``flash_attention_bwd`` for each of its 8
    local-attention layers, the forwards twice (remat)."""
    rec = cells["rg_train"]
    assert rec["status"] == "ok", rec.get("error")
    k = rec["kernels"]
    assert k["rglru_scan_bwd"]["calls"] == 18
    assert k["flash_attention_bwd"]["calls"] == 8
    assert k["rglru_scan"]["calls"] == 36
    assert k["flash_attention"]["calls"] == 16


def test_long_context_cell_skipped_with_the_references_reason(cells):
    from repro.configs import get_config, skip_reason
    rec = cells["long"]
    assert rec["status"] == "skipped"
    assert rec["skip_reason"] == skip_reason(get_config("granite-3-2b"),
                                             "long_500k")


def test_decode_cell_is_ok(cells):
    """A decode step over a 32k cache split along its sequence over
    "model": ok, with the caches updated in place (aliased), and the
    split-KV combine's all-reduces among its collectives."""
    rec = cells["decode"]
    assert rec["status"] == "ok", rec.get("error")
    ma = rec["memory_analysis"]
    assert 0 < ma["alias_size_in_bytes"] < ma["argument_size_in_bytes"]
    assert rec["collectives"]["all-reduce"]["count"] >= 3 * 40
    assert rec["cost_analysis"]["flops"] > 0


def test_reference_analyze_record_reads_a_port_record(cells):
    from repro.roofline.analysis import analyze_record as ref_analyze

    from repro_torch.roofline.analysis import analyze_record
    for key in ("train", "decode", "rwkv_train"):
        theirs, mine = ref_analyze(cells[key]), analyze_record(cells[key])
        assert theirs.status == mine.status
        if mine.status == "ok":
            assert theirs.compute_s > 0 and theirs.memory_s > 0
            assert mine.model_flops == theirs.model_flops
            assert mine.hlo_flops_global == theirs.hlo_flops_global


def test_probe_all_to_all_bytes_are_analytic(cells):
    """Per rank 2 x 2 x 16 tokens routed to 8 experts, top-2, capacity
    factor 1.25: C = ceil(2 x 32 x 1.25 / 8) = 10; each exchange moves
    the (E, C, d) buffer in bf16, two forward and two backward."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import _capacity
    cfg = get_config("qwen3-moe-30b-a3b").smoke()
    T = 8 // 4 * 16
    C = _capacity(cfg.moe, T)
    a2a = cells["probe"]["a2a"]["collectives"]["all-to-all"]
    assert a2a["count"] == 4
    assert a2a["bytes"] == 4 * cfg.moe.n_experts * C * cfg.d_model * 2
    assert "all-to-all" not in cells["probe"]["gshard"]["collectives"]
    assert cells["probe"]["gshard"]["flops"] > 0


def test_real_cpu_tensors_take_the_plain_versions():
    """A real CPU tensor runs the plain version and counts nothing: the
    fake branch is for fake tensors only."""
    from repro_torch.kernels import ops, ref
    from repro_torch.roofline import kernel_costs
    kernel_costs.reset()
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 8, 16, generator=gen)
    k = torch.randn(1, 1, 8, 16, generator=gen)
    assert torch.equal(ops.flash_attention(q, k, k),
                       ref.ref_attention(q, k, k))
    cl = torch.tensor([5], dtype=torch.int32)
    assert torch.equal(ops.flash_decode(q[:, :, 0], k, k, cl),
                       ref.ref_decode(q[:, :, 0], k, k, cl))
    x = torch.randn(1, 6, 4, generator=gen)
    assert torch.equal(ops.rglru_scan(x, x), ref.ref_rglru(x, x))
    r = torch.randn(1, 3, 2, 16, generator=gen)
    u = torch.randn(2, 16, generator=gen)
    assert all(torch.equal(a, b) for a, b in zip(
        ops.wkv6(r, r, r, -torch.ones_like(r), u),
        ref.ref_wkv6(r, r, r, -torch.ones_like(r), u)))
    s = torch.rand(2, 32, generator=gen)
    e = torch.linspace(0, 1, 9).repeat(2, 1)
    assert torch.equal(ops.latency_hist(s, s > 0.5, e),
                       ref.ref_latency_hist(s, s > 0.5, e))
    assert not kernel_costs.COUNTS


def test_fake_tensors_take_the_counted_branch():
    """Fake tensors return fake outputs of the kernel's shapes and add its
    operations and bytes, never launching (no launch counted)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.roofline import kernel_costs
    kernel_costs.reset()
    before = (FA.flash_attention.launches, FA.flash_attention_bwd.launches)
    with FakeTensorMode():
        q = torch.zeros(2, 4, 64, 64, dtype=torch.bfloat16,
                        requires_grad=True)
        k = torch.zeros(2, 2, 64, 64, dtype=torch.bfloat16,
                        requires_grad=True)
        out = ops.flash_attention(q, k, k)
        out.float().sum().backward()
        assert out.shape == q.shape and q.grad.shape == q.shape
    assert kernel_costs.COUNTS["flash_attention.calls"] == 1
    assert kernel_costs.COUNTS["flash_attention_bwd.calls"] == 1
    assert kernel_costs.COUNTS["flash_attention.flops"] == \
        kernel_costs.flash_attention_cost(2, 4, 2, 64, 64, 64, 2, True)[0]
    assert (FA.flash_attention.launches,
            FA.flash_attention_bwd.launches) == before


@pytest.mark.gpu
def test_real_cuda_tensors_launch_the_kernels():
    """A real CUDA tensor launches the kernel (counted) and counts no
    costs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.roofline import kernel_costs
    kernel_costs.reset()
    before = FA.flash_attention.launches
    q = torch.zeros(1, 2, 64, 64, dtype=torch.bfloat16, device="cuda")
    ops.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert not kernel_costs.COUNTS
    np.testing.assert_array_equal(
        ops.flash_attention(q, q, q).float().cpu().numpy(), 0.0)

"""Twin of ``tests/test_roofline.py`` for the port's roofline
(``repro_torch/roofline/``), on one H100's constants, plus what the port
adds: the collective counter over a fake process group and the
hand-written kernels' operation and byte counts.

* the reference's five tests on the same HLO sample and fake record, read
  against the port's constants;
* for all 10 configs x 4 shapes, ``model_flops_for``, ``_param_bytes``,
  ``_kv_bytes`` and ``_activation_bytes_per_device`` exactly the
  reference's (the same config data and formulas);
* ``analyze_record`` on the same record: every term times its constant
  the reference's to 1e-12 relative (only the constants differ; the
  rounding of one division and one multiplication apart);
* ``CollectiveCounter`` on a fake group (in a child process: a process
  holds one group) records each torch collective under its HLO name with
  its per-device result bytes;
* ``kernel_costs``: the forward's count at a non-causal shape equals
  ``FlopCounterMode``'s count of the plain attention's two products, and
  the bounds ``PERF.md`` section 6 states (rows 2 and 2b) come out of it.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.roofline import analysis, kernel_costs  # noqa: E402
from repro_torch.roofline.analysis import (  # noqa: E402
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    analyze_record,
    model_flops_for,
)
from repro_torch.roofline.hlo import (  # noqa: E402
    collective_stats,
    total_collective_bytes,
)

SRC = Path(__file__).resolve().parents[1] / "src"

HLO_SAMPLE = """
HloModule jit_step

fused_computation {
  ...
}

ENTRY main {
  %p0 = bf16[2048,512]{1,0} parameter(0)
  %ar = bf16[2048,512]{1,0} all-reduce(%p0), replica_groups={}
  %ag = f32[128,64]{1,0} all-gather(%ar), dimensions={0}
  %rs = f32[64,64]{1,0} reduce-scatter(%ag), dimensions={0}
  %a2a = bf16[32]{0} all-to-all(%rs), dimensions={0}
  %cp = s32[16]{0} collective-permute(%a2a), source_target_pairs={{0,1}}
  %ars = bf16[100]{0} all-reduce-start(%cp)
  %ard = bf16[100]{0} all-reduce-done(%ars)
  ROOT %out = bf16[100]{0} copy(%ard)
}
"""


def test_collective_stats_counts_and_bytes():
    stats = collective_stats(HLO_SAMPLE)
    assert stats["all-reduce"]["count"] == 2  # plain + -start (not -done)
    assert stats["all-reduce"]["bytes"] == 2048 * 512 * 2 + 100 * 2
    assert stats["all-gather"]["bytes"] == 128 * 64 * 4
    assert stats["reduce-scatter"]["bytes"] == 64 * 64 * 4
    assert stats["all-to-all"]["bytes"] == 32 * 2
    assert stats["collective-permute"]["bytes"] == 16 * 4
    assert total_collective_bytes(HLO_SAMPLE) == sum(
        v["bytes"] for v in stats.values())


def _fake_record(flops=1e14, bytes_acc=1e12, ar_bytes=5e10, n_dev=256):
    return {
        "arch": "granite-3-2b", "shape": "train_4k", "mesh": "single",
        "status": "ok", "n_devices": n_dev,
        "cost_analysis": {"flops": flops, "bytes accessed": bytes_acc},
        "collectives": {"all-reduce": {"count": 10, "bytes": ar_bytes}},
        "memory_analysis": {"argument_size_in_bytes": 3e9,
                            "output_size_in_bytes": 3e9},
    }


def test_roofline_terms():
    cell = analyze_record(_fake_record())
    assert cell.compute_s == pytest.approx(1e14 / PEAK_FLOPS)
    assert cell.collective_s == pytest.approx(5e10 / LINK_BW)
    assert cell.memory_hlo_upper_s == pytest.approx(1e12 / HBM_BW)
    assert cell.memory_s > 6e9 / HBM_BW  # args+outputs+activations
    assert cell.dominant in ("compute", "memory", "collective")
    assert cell.step_s == max(cell.compute_s, cell.memory_s, cell.collective_s)
    assert 0 < cell.mfu_est < 1.5


def test_model_flops_scales_with_kind():
    train = model_flops_for("granite-3-2b", "train_4k")
    prefill = model_flops_for("granite-3-2b", "prefill_32k")
    decode = model_flops_for("granite-3-2b", "decode_32k")
    # same token count => train = 3x prefill per token
    assert train / (256 * 4096) == pytest.approx(
        3 * prefill / (32 * 32768), rel=1e-6)
    assert decode == pytest.approx(prefill / (32 * 32768) * 128, rel=1e-6)


def test_moe_uses_active_params():
    dense_like = model_flops_for("qwen3-moe-30b-a3b", "train_4k")
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-moe-30b-a3b")
    assert dense_like == pytest.approx(
        6.0 * cfg.n_active_params() * 256 * 4096)
    assert cfg.n_active_params() < 0.25 * cfg.n_params()


def test_skipped_record_passthrough():
    rec = {"arch": "granite-3-2b", "shape": "long_500k", "mesh": "single",
           "status": "skipped", "skip_reason": "full attention"}
    cell = analyze_record(rec)
    assert cell.status == "skipped"
    assert "full attention" in cell.note


def test_constants_are_the_cards():
    """The H100 SXM's dense bf16 rate, memory rate and one 400 Gb/s NDR
    port a card; nothing of the TPU's."""
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 50e9)
    assert analysis.PEAK_BY_RATE == {"bf16": 989e12, "tf32": 495e12,
                                     "f32": 67e12}
    port = SRC / "repro_torch"
    for path in port.rglob("*.py"):
        text = path.read_text()
        assert "197e12" not in text and "819e9" not in text, path


def _all_configs():
    from repro_torch.configs import all_configs
    return sorted(all_configs())


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
@pytest.mark.parametrize("arch", _all_configs())
def test_analytic_terms_equal_the_reference(arch, shape):
    from repro.roofline import analysis as ref
    assert analysis.model_flops_for(arch, shape) == \
        ref.model_flops_for(arch, shape)
    assert analysis._param_bytes(arch) == ref._param_bytes(arch)
    assert analysis._kv_bytes(arch, shape) == ref._kv_bytes(arch, shape)
    for n_dev in (1, 256, 512):
        assert analysis._activation_bytes_per_device(arch, shape, n_dev) \
            == ref._activation_bytes_per_device(arch, shape, n_dev)


@pytest.mark.parametrize("n_dev", [256, 512])
def test_analyze_record_terms_equal_the_reference_times_constants(n_dev):
    """Every term of the port's cell times the port's constant is the
    reference's term times the reference's constant: only the constants
    differ.  The MFU and the step follow the dominant term, which the
    constants may change."""
    from repro.roofline import analysis as ref
    rec = _fake_record(n_dev=n_dev)
    rec["memory_analysis"]["alias_size_in_bytes"] = 1e9
    mine, theirs = analyze_record(rec), ref.analyze_record(rec)
    for term, c_mine, c_ref in (
            ("compute_s", PEAK_FLOPS, ref.PEAK_FLOPS),
            ("memory_s", HBM_BW, ref.HBM_BW),
            ("memory_hlo_upper_s", HBM_BW, ref.HBM_BW),
            ("collective_s", LINK_BW, ref.ICI_BW),
            ("weight_stream_s", HBM_BW, ref.HBM_BW)):
        assert getattr(mine, term) * c_mine == pytest.approx(
            getattr(theirs, term) * c_ref, rel=1e-12), term
    for field in ("model_flops", "hlo_flops_global", "usefulness",
                  "n_devices", "status"):
        assert getattr(mine, field) == getattr(theirs, field), field
    terms = {"compute": mine.compute_s, "memory": mine.memory_s,
             "collective": mine.collective_s}
    assert mine.step_s == max(terms.values())
    assert mine.dominant == max(terms, key=terms.get)
    assert mine.mfu_est == pytest.approx(
        mine.model_flops / (n_dev * PEAK_FLOPS * mine.step_s), rel=1e-12)


COUNTER_BODY = """
import json
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import (Partial, Replicate, Shard,
                                      distribute_tensor, DTensor)
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.roofline.hlo import CollectiveCounter
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {}
x = torch.zeros(64, dtype=torch.float32)
for name, call in (
        ("all_reduce", lambda: dist.all_reduce(x)),
        ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
            torch.zeros(256), x)),
        ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
            torch.zeros(16), x)),
        ("all_to_all_single", lambda: dist.all_to_all_single(
            torch.zeros(64), x)),
        ("full_tensor", lambda: distribute_tensor(
            torch.zeros(8, 6, dtype=torch.bfloat16), mesh,
            [Replicate(), Shard(0)]).full_tensor()),
        ("partial_to_shard", lambda: DTensor.from_local(
            torch.zeros(8, 6), mesh, [Replicate(), Partial()]).redistribute(
            mesh, [Replicate(), Shard(0)]).to_local()),
        ("partial_to_replicate", lambda: DTensor.from_local(
            torch.zeros(8, 6), mesh, [Partial(), Replicate()]).redistribute(
            mesh, [Replicate(), Replicate()]).to_local())):
    counter = CollectiveCounter()
    with counter:
        call()
    out[name] = {op: dict(v) for op, v in counter.stats.items()}
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_collective_counter_names_and_result_bytes():
    """Each collective under its HLO name with its per-device result
    bytes: an all-gather its gathered output, a reduce-scatter its shard,
    an all-reduce and an all-to-all their output; ``torch.distributed``'s
    calls and ``DTensor``'s redistributions alike."""
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(COUNTER_BODY)],
        capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["all_reduce"] == {"all-reduce": {"count": 1, "bytes": 256}}
    assert got["all_gather_into_tensor"] == {
        "all-gather": {"count": 1, "bytes": 1024}}
    assert got["reduce_scatter_tensor"] == {
        "reduce-scatter": {"count": 1, "bytes": 64}}
    assert got["all_to_all_single"] == {
        "all-to-all": {"count": 1, "bytes": 256}}
    # an (8, 6) bf16 tensor in blocks of 4 rows over "model": gathered whole
    assert got["full_tensor"] == {"all-gather": {"count": 1,
                                                 "bytes": 8 * 6 * 2}}
    # a partial (8, 6) float32 sum to blocks of 4 rows: the shard
    assert got["partial_to_shard"] == {
        "reduce-scatter": {"count": 1, "bytes": 4 * 6 * 4}}
    assert got["partial_to_replicate"] == {
        "all-reduce": {"count": 1, "bytes": 8 * 6 * 4}}


def test_kernel_flops_equal_the_plain_attentions_products():
    """At a non-causal shape with GQA every pair is computed: the
    forward's 4 d flops a pair are ``FlopCounterMode``'s count of the
    plain version's two products (q k^T and p v), exactly."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.ref import ref_attention
    B, H, H_kv, S_q, S_k, D = 2, 4, 2, 24, 40, 16
    q = torch.zeros(B, H, S_q, D)
    k = torch.zeros(B, H_kv, S_k, D)
    with FlopCounterMode(display=False) as fc:
        ref_attention(q, k, k, causal=False)
    flops, nbytes, rate = kernel_costs.flash_attention_cost(
        B, H, H_kv, S_q, S_k, D, 4, causal=False)
    assert flops == fc.get_total_flops()
    assert nbytes == (2 * q.numel() + 2 * k.numel()) * 4
    assert rate == "f32"


def test_kernel_costs_give_perf_md_bounds():
    """``PERF.md`` section 6: the forward's bound at q (1, 32, 2048, 64)
    causal bf16, 0.0174 ms, and the backward's at (4, 32, 1024, 64) with
    8 kv heads, 0.0435 ms (43.0 GFLOP), both bound by operations; a
    window counts min(i + 1, w) keys a query."""
    flops, nbytes, rate = kernel_costs.flash_attention_cost(
        1, 32, 32, 2048, 2048, 64, 2, causal=True)
    ms = flops / analysis.PEAK_BY_RATE[rate] * 1e3
    assert f"{ms:.4f}" == "0.0174" and ms > nbytes / HBM_BW * 1e3
    flops, nbytes, rate = kernel_costs.flash_attention_bwd_cost(
        4, 32, 8, 1024, 1024, 64, 2, causal=True)
    ms = flops / analysis.PEAK_BY_RATE[rate] * 1e3
    assert f"{ms:.4f}" == "0.0435" and f"{flops / 1e9:.1f}" == "43.0"
    assert ms > nbytes / HBM_BW * 1e3
    for S, w in ((10, 4), (4, 10), (3000, 2048)):
        assert kernel_costs.attention_pairs(S, S, True, w) == sum(
            min(i + 1, w) for i in range(S))

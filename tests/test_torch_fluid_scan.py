"""The fluid pipeline's kernel module: the plain loop against the
reference's scan, the wrapper, and on a card (``-m gpu``) the CUDA kernel
against the plain loop.

On the CPU ``ref_fluid_scan`` (what ``ops.fluid_scan`` runs there) must
stay within float32 rtol 1e-5 of the reference's jitted
``_fluid_scan_batch`` - done and every step's flow - on the 100-config
grid at both mixes, sharded over 32 shards (480 columns), and in the edge
cases: one column, a zero-demand column (it serves its whole queue), a
zero row, rows no multiple of a block's 4, 33 and 600 columns (two a
lane; past the kernel's registers), 1, 2 and 0 steps.  The wrapper must
refuse what the kernel does not take.  On a card the kernel
(``csrc/fluid_scan.cu``) must equal the plain loop run on the card bit
for bit, its CUDA-graph replays must repeat bitwise, and
``CompiledSweep.fluid`` on the card must equal the CPU's bit for bit in
one launch a call.  The card's machine has no JAX: this file imports it
only inside the CPU cases, and there runs ``python -m pytest --noconftest
-m gpu tests/test_torch_fluid_scan.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.core import simulator as PS  # noqa: E402
from repro_torch.kernels import fluid_scan as FL  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.roofline import kernel_costs  # noqa: E402

RTOL = 1e-5
N_CLIENTS = 64.0
DT = 1.0 / 2000


def _grid(mod):
    # the 100-config grid of tests/test_torch_simulator.py
    return mod.SweepSpec(n_proxy_leaders=(1, 2, 4, 7, 10),
                         grids=((3, 1), (2, 2), (2, 3), (3, 3)),
                         n_replicas=(2, 3, 4, 5, 6), batch_sizes=(1,))


def _random(m, k, zero_col=None, zero_row=None, seed=0):
    d = np.random.default_rng(seed).uniform(1e-6, 1e-4, size=(m, k))
    if zero_col is not None:
        d[:, zero_col] = 0.0
    if zero_row is not None:
        d[zero_row] = 0.0
    return d.astype(np.float32)


#: name -> (demands, n_steps)
EDGE = {
    "1-step": (_random(32, 15), 1),
    "2-steps": (_random(32, 15, seed=1), 2),
    "K-1": (_random(7, 1, seed=2), 64),
    "zero-column": (_random(32, 15, zero_col=3, seed=3), 300),
    "last-column-zero": (_random(8, 15, zero_col=14, seed=4), 300),
    "zero-row": (_random(8, 15, zero_row=2, seed=5), 50),
    "5-rows": (_random(5, 15, seed=6), 33),
    "K-33": (_random(6, 33, zero_col=32, seed=7), 70),
    "K-600": (_random(9, 600, zero_col=599, seed=8), 100),
    "0-steps": (_random(3, 15, seed=9), 0),
}


def _reference(d, n_steps, n_clients=N_CLIENTS, dt=DT):
    jax = pytest.importorskip("jax")
    from repro.core import simulator as RS
    jnp = jax.numpy
    done, flows = RS._fluid_scan_batch(
        jnp.asarray(d), jnp.asarray(n_clients, dtype="float32"),
        jnp.asarray(dt, dtype="float32"), n_steps)
    return np.asarray(done), np.asarray(flows)


def _assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32, what
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("f_write", [1.0, 0.1])
def test_plain_loop_matches_reference_on_the_grid(f_write):
    import repro.core as R
    d = (R.compile_sweep(_grid(R)).demands(R.Workload(f_write=f_write))
         / R.calibrate_alpha()).astype(np.float32)
    assert d.shape[0] == 100
    done, flows = ref.ref_fluid_scan(torch.from_numpy(d), N_CLIENTS, DT,
                                     2000)
    want_done, want_flows = _reference(d, 2000)
    _assert_close(done, want_done, "done")
    _assert_close(flows, want_flows, "flows")


def test_plain_loop_matches_reference_sharded():
    import repro.core as R
    sweep = R.compile_sweep(_grid(R))
    d = (R.flatten_shards(sweep.demands(R.MIXED_50_50,
                                        sharding=R.ShardingSpec(32)))
         / R.calibrate_alpha()).astype(np.float32)[::7]
    assert d.shape == (15, 32 * len(R.STATION_ORDER))  # 480 at K = 15
    done, flows = ref.ref_fluid_scan(torch.from_numpy(d), N_CLIENTS, DT,
                                     500)
    want_done, want_flows = _reference(d, 500)
    _assert_close(done, want_done, "done")
    _assert_close(flows, want_flows, "flows")


@pytest.mark.parametrize("name", list(EDGE))
def test_edge_cases_match_reference(name):
    d, n_steps = EDGE[name]
    done, flows = ops.fluid_scan(torch.from_numpy(d), N_CLIENTS, DT, n_steps)
    assert done.shape == (d.shape[0],)
    assert flows.shape == (d.shape[0], n_steps)
    want_done, want_flows = _reference(d, n_steps)
    _assert_close(done, want_done, "done")
    _assert_close(flows, want_flows, "flows")
    if name == "zero-row":
        # each station passes its whole queue on a step: the pool goes
        # round the 15 stations and completes every 15th step
        want = torch.zeros(n_steps)
        want[14::15] = N_CLIENTS
        assert torch.equal(flows[2], want)


def test_cpu_path_launches_nothing():
    before = FL.fluid_scan.launches
    PS.fluid_throughput_from_demands(_random(4, 15), 16, n_steps=40,
                                     device="cpu")
    assert ops.fluid_scan is FL.fluid_scan
    assert FL.fluid_scan.launches == before == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    d = torch.from_numpy(_random(4, 15))
    with pytest.raises(TypeError, match="float32"):
        ops.fluid_scan(d.double(), N_CLIENTS, DT, 8)
    for bad in (d[0], d[None], d[:, :0]):
        with pytest.raises(ValueError, match=r"\(M, K >= 1\)"):
            ops.fluid_scan(bad, N_CLIENTS, DT, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fluid_scan(d.t(), N_CLIENTS, DT, 8)
    with pytest.raises(ValueError, match="n_steps"):
        ops.fluid_scan(d, N_CLIENTS, DT, -1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.fluid_scan(d.to("meta"), N_CLIENTS, DT, 8)


def test_fake_tensors_count_the_kernel_and_launch_nothing():
    from torch._subclasses.fake_tensor import FakeTensorMode
    kernel_costs.reset()
    before = FL.fluid_scan.launches
    with FakeTensorMode():
        d = torch.empty((32, 15), dtype=torch.float32)
        done, flows = ops.fluid_scan(d, N_CLIENTS, DT, 2000)
        assert done.shape == (32,) and flows.shape == (32, 2000)
    flops, nbytes, rate = kernel_costs.fluid_scan_cost(32, 2000, 15)
    assert kernel_costs.COUNTS["fluid_scan.calls"] == 1
    assert kernel_costs.COUNTS["fluid_scan.flops"] == flops
    assert kernel_costs.COUNTS["fluid_scan.bytes"] == nbytes
    assert FL.fluid_scan.launches == before
    kernel_costs.reset()


def test_cost_counts_the_demands_the_flows_and_done():
    flops, nbytes, rate = kernel_costs.fluid_scan_cost(32, 2000, 15)
    assert rate == "f32"
    assert nbytes == 4 * 32 * 15 + 4 * 32 * 2000 + 4 * 32
    assert flops == 32 * (2 * 15 + 2000 * (3 * 15 + 1))


# -- the kernel, on a card --------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(EDGE) + ["K-480", "K-128"])
def test_cuda_kernel_matches_plain_loop_bit_for_bit(name):
    _cuda()
    if name in EDGE:
        d, n_steps = EDGE[name]
    else:
        d, n_steps = _random(32, int(name[2:]), seed=10), 2000
    d = torch.from_numpy(d).cuda()
    before = FL.fluid_scan.launches
    got = FL.fluid_scan(d, N_CLIENTS, DT, n_steps)
    want = ref.ref_fluid_scan(d, N_CLIENTS, DT, n_steps)
    torch.cuda.synchronize()
    assert FL.fluid_scan.launches - before == int(n_steps > 0)
    for a, b, what in zip(got, want, ("done", "flows")):
        assert torch.equal(a, b), what


@pytest.mark.gpu
def test_cuda_graph_replays_are_bitwise_equal():
    _cuda()
    d = torch.from_numpy(_random(32, 480, seed=11)).cuda()
    first = [t.clone() for t in FL.fluid_scan(d, N_CLIENTS, DT, 2000)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        FL.fluid_scan(d, N_CLIENTS, DT, 2000)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = FL.fluid_scan(d, N_CLIENTS, DT, 2000)
    for _ in range(20):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, first))


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [None, 32])
def test_cuda_sweep_fluid_is_one_launch_and_equals_the_cpu(shards):
    _cuda()
    sweep = P.compile_sweep(_grid(P))
    alpha = P.calibrate_alpha()
    sharding = P.ShardingSpec(shards) if shards else None
    before = FL.fluid_scan.launches
    on_gpu = sweep.fluid(alpha, 64, workload=P.MIXED_50_50,
                         sharding=sharding, device="cuda")
    assert FL.fluid_scan.launches - before == 1
    on_cpu = sweep.fluid(alpha, 64, workload=P.MIXED_50_50,
                         sharding=sharding, device="cpu")
    np.testing.assert_array_equal(on_gpu, on_cpu)

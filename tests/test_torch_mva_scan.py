"""The MVA recursion's kernel module: the plain loop against the reference's
scan, the wrapper, and on a card (``-m gpu``) the CUDA kernel against the
plain loop.

On the CPU ``ref_mva_scan`` (what ``ops.mva_scan`` runs there) must stay
within float32 rtol 1e-5 of the reference's jitted ``_mva_scan_batch``
(the two sum a row in different orders) on the 100-config grid at both
mixes, sharded over 32 shards (480 columns), with think time, and in the
edge cases: one client, one column, a zero-demand column, a zero row at
think 0 (inf, then NaN, in both), rows no multiple of a block's 4, 33 and
600 columns (two a lane; past the kernel's registers), no clients.  The
wrapper must refuse what the kernel does not take.  On a card the kernel
(``csrc/mva_scan.cu``) must equal the plain loop run on the card bit for
bit, its CUDA-graph replays must repeat bitwise, and ``CompiledSweep.mva``
on the card must equal the CPU's bit for bit in one launch a call.  The
card's machine has no JAX: this file imports it only inside the CPU
cases, and there runs ``python -m pytest --noconftest -m gpu
tests/test_torch_mva_scan.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.kernels import mva_scan as MV  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.roofline import kernel_costs  # noqa: E402

RTOL = 1e-5


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


#: name -> (demands, think, n_max)
EDGE = {
    "n_max-1": (_random(32, 15), 0.0, 1),
    "K-1": (_random(7, 1, seed=1), 0.0, 64),
    "zero-column": (_random(32, 15, zero_col=3, seed=2), 0.0, 64),
    "zero-row-think-0": (_random(8, 15, zero_row=2, seed=3), 0.0, 16),
    "think-0.01": (_random(32, 15, seed=4), 0.01, 200),
    "5-rows": (_random(5, 15, seed=5), 0.0, 33),
    "K-33": (_random(6, 33, zero_col=32, seed=6), 0.0, 70),
    "K-600": (_random(9, 600, zero_col=599, seed=7), 0.002, 40),
    "n_max-0": (_random(3, 15, seed=8), 0.0, 0),
}


def _reference(d, think, n_max):
    jax = pytest.importorskip("jax")
    from repro.core import simulator as RS
    x, r = RS._mva_scan_batch(jax.numpy.asarray(d),
                              jax.numpy.asarray(think, dtype="float32"),
                              n_max)
    return np.asarray(x), np.asarray(r)


def _assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("f_write", [1.0, 0.1])
def test_plain_loop_matches_reference_on_the_grid(f_write):
    import repro.core as R
    d = (R.compile_sweep(_grid(R)).demands(R.Workload(f_write=f_write))
         / R.calibrate_alpha()).astype(np.float32)
    assert d.shape[0] == 100
    x, r = ref.ref_mva_scan(torch.from_numpy(d), 0.0, 64)
    want_x, want_r = _reference(d, 0.0, 64)
    _assert_close(x, want_x, "X")
    _assert_close(r, want_r, "R")


def test_plain_loop_matches_reference_sharded_with_think_time():
    import repro.core as R
    sweep = R.compile_sweep(_grid(R))
    d = (R.flatten_shards(sweep.demands(R.MIXED_50_50,
                                        sharding=R.ShardingSpec(32)))
         / R.calibrate_alpha()).astype(np.float32)[::7]
    assert d.shape == (15, 32 * len(R.STATION_ORDER))  # 480 at K = 15
    for think in (0.0, 1e-4):
        x, r = ref.ref_mva_scan(torch.from_numpy(d), think, 48)
        want_x, want_r = _reference(d, think, 48)
        _assert_close(x, want_x, f"X, think {think}")
        _assert_close(r, want_r, f"R, think {think}")


@pytest.mark.parametrize("name", list(EDGE))
def test_edge_cases_match_reference(name):
    d, think, n_max = EDGE[name]
    x, r = ops.mva_scan(torch.from_numpy(d), think, n_max)
    assert x.shape == r.shape == (d.shape[0], n_max)
    want_x, want_r = _reference(d, think, n_max)
    _assert_close(x, want_x, "X")
    _assert_close(r, want_r, "R")
    if name == "zero-row-think-0":
        assert torch.isinf(x[2, 0]) and torch.isnan(x[2, 1:]).all()


def _documented_row_sum(d: np.ndarray) -> np.ndarray:
    """A first step's R (q = 0, so r_k = d_k) summed in the order
    ``csrc/mva_scan.cu`` documents, written out in numpy: up to 512
    columns, the row zero-padded to the power of two at or above K and
    summed by the strided pairwise tree (each level adds the upper half
    onto the lower); past 512, 32 partial sums in column order, then the
    xor butterfly over them."""
    m, k = d.shape
    p = MV.plan(k)
    if p.width:
        part = np.zeros((m, p.lanes * p.width), dtype=np.float32)
        part[:, :k] = d
        while part.shape[1] > 1:
            half = part.shape[1] // 2
            part = part[:, :half] + part[:, half:]
        return part[:, 0]
    return _butterfly_row_sum(d)


def _butterfly_row_sum(d: np.ndarray) -> np.ndarray:
    """32 partial sums in column order (column c into partial c mod 32),
    then the xor butterfly at offsets 16, 8, 4, 2, 1."""
    m, k = d.shape
    padded = np.zeros((m, -(-k // 32) * 32), dtype=np.float32)
    padded[:, :k] = d
    part = np.zeros((m, 32), dtype=np.float32)
    for lo in range(0, padded.shape[1], 32):
        part = part + padded[:, lo:lo + 32]
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, np.arange(32) ^ off]
    return part[:, 0]


def _column_order_sum(d: np.ndarray) -> np.ndarray:
    total = np.zeros(d.shape[0], dtype=np.float32)
    for c in range(d.shape[1]):
        total = total + d[:, c]
    return total


def test_row_sum_runs_in_the_documented_order():
    """A first step's R is its row's sum in the kernel's order at K = 200
    (``plan``: 32 lanes of 8 columns): the strided pairwise tree over 256
    zero-padded columns; on these rows that differs from the sum in column
    order and from 32 partial sums then a butterfly."""
    rng = np.random.default_rng(11)
    d = (10.0 ** rng.uniform(-8, 0, size=(16, 200))).astype(np.float32)
    assert MV.plan(200) == MV.Plan("lanes", 8, 32)
    _, r = ref.ref_mva_scan(torch.from_numpy(d), 0.0, 1)
    want = _documented_row_sum(d)
    np.testing.assert_array_equal(r[:, 0].numpy(), want)
    assert (_column_order_sum(d) != want).any()
    assert (_butterfly_row_sum(d) != want).any()


@pytest.mark.parametrize("k", [1, 2, 7, 15, 16, 17, 31, 32])
def test_row_sum_up_to_32_columns_is_the_one_warp_butterfly(k):
    """Up to 32 columns the strided tree is the order of one column a lane
    on a whole warp and an xor butterfly at 16, ..., 1 (its additions past
    K add zeros, which is exact): the order the kernel took before one
    thread held a row, so the MVA surfaces there did not move."""
    rng = np.random.default_rng(100 + k)
    d = (10.0 ** rng.uniform(-8, 0, size=(64, k))).astype(np.float32)
    np.testing.assert_array_equal(_documented_row_sum(d),
                                  _butterfly_row_sum(d))


@pytest.mark.parametrize("k", [1, 8, 15, 32, 33, 512, 600])
def test_row_sum_order_on_each_route(k):
    """The same at the routes' widths: one thread a row (K 1, 8), 8
    columns a lane on 2 to 32 lanes (15, 32, 33), a warp of 16 columns
    a lane (512), the global-memory walk (600); past one column the
    order differs from the column order's on these rows."""
    rng = np.random.default_rng(k)
    d = (10.0 ** rng.uniform(-8, 0, size=(64, k))).astype(np.float32)
    _, r = ref.ref_mva_scan(torch.from_numpy(d), 0.0, 1)
    want = _documented_row_sum(d)
    np.testing.assert_array_equal(r[:, 0].numpy(), want)
    if k > 1:
        assert (_column_order_sum(d) != want).any()


@pytest.mark.parametrize("k, route, width, lanes", [
    (1, "thread", 1, 1), (5, "thread", 8, 1), (8, "thread", 8, 1),
    (15, "lanes", 8, 2), (16, "lanes", 8, 2), (17, "lanes", 8, 4),
    (32, "lanes", 8, 4), (33, "lanes", 8, 8), (200, "lanes", 8, 32),
    (256, "lanes", 8, 32), (257, "lanes", 16, 32), (480, "lanes", 16, 32),
    (512, "lanes", 16, 32), (513, "global", 0, 32), (600, "global", 0, 32)])
def test_plan_is_a_function_of_k(k, route, width, lanes):
    """With N the power of two at or above K: one thread a row up to 8
    columns, 8 columns a lane on N / 8 lanes up to 256, a warp of N / 32
    columns a lane up to 512, the global walk past that."""
    p = MV.plan(k)
    assert p == MV.Plan(route, width, lanes)
    assert p.width == 0 or p.lanes * p.width >= k
    assert p.width == 0 or p.lanes * p.width < 2 * max(k, 32)


def test_cpu_path_launches_nothing():
    before = MV.mva_scan.launches
    P.mva_curves_from_demands(_random(4, 15), 16, device="cpu")
    assert ops.mva_scan is MV.mva_scan
    assert MV.mva_scan.launches == before == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    d = torch.from_numpy(_random(4, 15))
    with pytest.raises(TypeError, match="float32"):
        ops.mva_scan(d.double(), 0.0, 8)
    for bad in (d[0], d[None]):
        with pytest.raises(ValueError, match=r"\(M, K\)"):
            ops.mva_scan(bad, 0.0, 8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.mva_scan(d.t(), 0.0, 8)
    with pytest.raises(ValueError, match="n_max"):
        ops.mva_scan(d, 0.0, -1)
    with pytest.raises(ValueError, match="exceed"):
        ops.mva_scan(d, 0.0, 2 ** 24)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.mva_scan(d.to("meta"), 0.0, 8)


def test_fake_tensors_count_the_kernel_and_launch_nothing():
    from torch._subclasses.fake_tensor import FakeTensorMode
    kernel_costs.reset()
    before = MV.mva_scan.launches
    with FakeTensorMode():
        d = torch.empty((32, 15), dtype=torch.float32)
        x, r = ops.mva_scan(d, 0.0, 512)
        assert x.shape == r.shape == (32, 512)
    flops, nbytes, rate = kernel_costs.mva_scan_cost(32, 512, 15)
    assert kernel_costs.COUNTS["mva_scan.calls"] == 1
    assert kernel_costs.COUNTS["mva_scan.flops"] == flops
    assert kernel_costs.COUNTS["mva_scan.bytes"] == nbytes
    assert MV.mva_scan.launches == before
    kernel_costs.reset()


def test_cost_counts_the_demands_and_both_outputs():
    flops, nbytes, rate = kernel_costs.mva_scan_cost(32, 512, 15)
    assert rate == "f32"
    assert nbytes == 4 * 32 * 15 + 2 * 4 * 32 * 512
    assert flops == 32 * 512 * (4 * 15 + 2)


# -- the kernel, on a card --------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _bits_equal(a, b):
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan], b[~nan]))


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(EDGE) + ["K-480", "K-128"])
def test_cuda_kernel_matches_plain_loop_bit_for_bit(name):
    _cuda()
    if name in EDGE:
        d, think, n_max = EDGE[name]
    else:
        d, think, n_max = _random(32, int(name[2:]), seed=9), 0.0, 512
    d = torch.from_numpy(d).cuda()
    before = MV.mva_scan.launches
    got = MV.mva_scan(d, think, n_max)
    want = ref.ref_mva_scan(d, think, n_max)
    torch.cuda.synchronize()
    assert MV.mva_scan.launches - before == int(n_max > 0)
    for a, b, what in zip(got, want, "XR"):
        assert _bits_equal(a, b), what


#: (rows, columns, think, n_max) on every route and split: one thread a
#: row (K up to 8), 8 columns a lane on 2-32 lanes (9-256), a warp of 16
#: columns a lane (257-512), the global walk (past 512); rows no
#: multiple of a warp's, n_max no multiple of the 32-step chunk
ROUTE_CASES = [(37, k, think, n) for k, think, n in (
    (1, 0.0, 70), (2, 0.0, 33), (8, 0.0, 40), (9, 0.0, 96),
    (15, 0.0, 512), (16, 1e-3, 100), (17, 0.0, 31), (32, 0.0, 65),
    (33, 0.0, 64), (64, 2e-3, 97), (200, 0.0, 40), (256, 0.0, 33),
    (257, 0.0, 35), (480, 0.0, 512), (512, 0.0, 32), (513, 0.0, 50),
    (600, 1e-3, 45))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=[f"K{k}-n{n}" for _, k, _, n in ROUTE_CASES])
def test_cuda_routes_match_plain_loop_bit_for_bit(case):
    """Each route of ``plan`` against the plain loop on the card, bit for
    bit, one launch a call."""
    _cuda()
    m, k, think, n_max = case
    d = torch.from_numpy(_random(m, k, zero_col=k // 2, seed=k)).cuda()
    before = MV.mva_scan.launches
    got = MV.mva_scan(d, think, n_max)
    want = ref.ref_mva_scan(d, think, n_max)
    torch.cuda.synchronize()
    assert MV.mva_scan.launches - before == 1
    for a, b, what in zip(got, want, "XR"):
        assert _bits_equal(a, b), (MV.plan(k), what)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [15, 480, 600], ids=["thread", "lanes",
                                                   "global"])
def test_cuda_graph_replays_on_each_route_are_bitwise_equal(k):
    _cuda()
    d = torch.from_numpy(_random(32, k, seed=12)).cuda()
    want = ref.ref_mva_scan(d, 0.0, 200)
    first = [t.clone() for t in MV.mva_scan(d, 0.0, 200)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        MV.mva_scan(d, 0.0, 200)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = MV.mva_scan(d, 0.0, 200)
    for _ in range(20):
        for t in outs:
            t.fill_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, first))
    assert all(_bits_equal(a, b) for a, b in zip(first, want))


@pytest.mark.gpu
def test_cuda_graph_replays_are_bitwise_equal():
    _cuda()
    d = torch.from_numpy(_random(32, 480, seed=10)).cuda()
    first = [t.clone() for t in MV.mva_scan(d, 0.0, 512)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        MV.mva_scan(d, 0.0, 512)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = MV.mva_scan(d, 0.0, 512)
    for _ in range(20):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, first))


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [None, 32])
def test_cuda_sweep_mva_is_one_launch_and_equals_the_cpu(shards):
    _cuda()
    sweep = P.compile_sweep(_grid(P))
    alpha = P.calibrate_alpha()
    sharding = P.ShardingSpec(shards) if shards else None
    before = MV.mva_scan.launches
    on_gpu = sweep.mva(alpha, 512, workload=P.MIXED_50_50,
                       sharding=sharding, device="cuda")
    assert MV.mva_scan.launches - before == 1
    on_cpu = sweep.mva(alpha, 512, workload=P.MIXED_50_50,
                       sharding=sharding, device="cpu")
    for a, b in zip(on_gpu, on_cpu):
        np.testing.assert_array_equal(a, b)

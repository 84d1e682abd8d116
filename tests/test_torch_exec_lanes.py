"""The execution lanes' step loop: the plain loop in blocks, its draws, the
wrapper, and on a card (``-m gpu``) the CUDA kernel against the plain loop.

``tests/test_torch_batched_execution.py`` holds the port's engine to the
reference's scan bit for bit; here the engine's blocks of steps must equal
one block in every draw mode, the generator mode's chunks of draws must
repeat for a seed, and
the wrapper must refuse what the kernel does not take; the launch plan
must give the main path's lanes the warp kernel and cover every client and
column.  On a card both kernels (``csrc/exec_lanes.cu``: one warp a lane up
to 128 clients and 32 columns, one block a lane past either, cases on both
sides of each border) must equal the plain loop run on the card bit for
bit - completion masks, latencies, the state after the run, drain counts
and makespans - deterministic, with injected and with generator draws, and
CUDA-graph replays must repeat bitwise.  The card's machine has
no JAX, and this file imports none: there run ``python -m pytest
--noconftest -m gpu tests/test_torch_exec_lanes.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.core import batched_execution as PB  # noqa: E402
from repro_torch.kernels import exec_lanes as EL  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.roofline import kernel_costs  # noqa: E402

STATE = ("stage", "rank", "enter_t", "op_i", "q", "work")
K = 15


def _lanes(n_clients, n_commands, seed, *, active=None, zero_read=False,
           draws=False, max_steps=None, k=K, device="cpu"):
    """Synthetic lane inputs: 2 configs x 2 seeds of ``n_clients`` clients
    over ``k`` stations, ``n_commands`` ops a lane split round-robin (fewer
    commands than clients leaves clients with a zero budget), write
    classes drawn per seed.  ``active`` picks the stations on the path
    (default: a random half, the first always); ``zero_read`` gives the
    read path zero demands at two active stations (rate 1e30: a station
    that drains every step).  Returns (LaneInputs, n_steps, drains):
    n_steps is the lowering's drain bound (x 4 with draws) cut to
    ``max_steps``, and ``drains`` says that it was not cut."""
    rng = np.random.default_rng(seed)
    m, s = 2, 2
    if active is None:
        active = rng.uniform(size=(m, k)) < 0.5
        active[:, 0] = True
    active = np.broadcast_to(active, (m, k)).copy()
    d_w = np.where(active, rng.uniform(0.5, 2.0, (m, k)), 0.0)
    d_r = np.where(active, rng.uniform(0.2, 1.0, (m, k)), 0.0)
    if zero_read:
        for i in range(m):
            d_r[i, np.nonzero(active[i])[0][:2]] = 0.0
    entry, nxt = PB._routing(active)
    n_ops = max(-(-n_commands // n_clients), 1)
    cls = np.zeros((m, s, n_clients, n_ops), np.int64)
    budget = np.zeros((m, n_clients), np.int64)
    for i in range(n_commands):
        budget[:, i % n_clients] += 1
    for c in range(n_clients):
        cls[:, :, c, :budget[0, c]] = rng.uniform(
            size=(m, s, budget[0, c])) < 0.4
    blend = 0.4 * d_w + 0.6 * d_r
    dt = blend.max(axis=1) / 4.0
    hot = np.maximum(d_w, d_r)
    steps = ((n_commands + n_clients) * hot.sum(axis=1) / dt
             + (n_commands + n_clients) * active.sum(axis=1))
    bound = int(np.ceil((4.0 if draws else 1.3) * steps.max())) + 8
    n_steps = min(bound, max_steps or bound)
    lane_draws = (rng.exponential(size=(m, s, n_steps + 1, k))
                  if draws == "injected" else None)
    inp = P.lane_inputs_from_numpy(d_w, d_r, entry, nxt, cls, budget, dt,
                                   np.arange(s, dtype=np.int32) + seed,
                                   lane_draws, device=device)
    return inp, n_steps, n_steps == bound


def _run(inp, n_clients, n_steps, exponential, block_steps, steps,
         draw_steps=None):
    """``_execute_batch`` with ``steps`` as its step function, launching
    blocks of ``block_steps`` steps (and drawing chunks of ``draw_steps``);
    returns its five outputs and the state after the run."""
    seen = {}

    def step_fn(**kw):
        seen.update(kw)
        steps(**kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(PB, "exec_lanes", step_fn)
    mp.setattr(PB, "BLOCK_STEPS", block_steps)
    if draw_steps is not None:
        mp.setattr(PB, "DRAW_STEPS", draw_steps)
    try:
        out = PB._execute_batch(inp, n_clients, n_steps, exponential)
    finally:
        mp.undo()
    return out, {key: seen[key] for key in STATE}


def _launches(n_steps, block_steps):
    """Blocks of at most ``block_steps`` steps, none crossing a chunk of
    draws: the launches of one execute."""
    return sum(-(-(min(c0 + PB.DRAW_STEPS, n_steps) - c0) // block_steps)
               for c0 in range(0, n_steps, PB.DRAW_STEPS))


def _assert_runs_equal(a, b, what):
    (out_a, state_a), (out_b, state_b) = a, b
    names = ("fin", "lat", "done_w", "done_r", "t_last")
    for name, x, y in zip(names, out_a, out_b):
        assert torch.equal(x, y), f"{what}: {name}"
    for key in STATE:
        assert torch.equal(state_a[key], state_b[key]), f"{what}: {key}"


# -- the plain loop, on the CPU -----------------------------------------------


@pytest.mark.parametrize("block", [1, 7, None], ids=["1", "7", "n_steps"])
@pytest.mark.parametrize("mode", ["deterministic", "injected", "generator"])
def test_blocks_of_steps_equal_one_block(mode, block):
    # chunks of 50 steps' draws: blocks of 7 end where a chunk ends, and
    # in the generator mode the draws stay what the chunks make them
    expo = mode != "deterministic"
    inp, n_steps, _ = _lanes(6, 23, seed=1, max_steps=301,
                             draws="injected" if mode == "injected" else False)
    whole = _run(inp, 6, n_steps, expo, n_steps, ref.ref_exec_lanes, 50)
    got = _run(inp, 6, n_steps, expo, block or n_steps, ref.ref_exec_lanes,
               50)
    _assert_runs_equal(whole, got, f"{mode}, blocks of {block}")
    assert whole[0][0].any()


def test_default_blocks_tile_the_draw_chunks():
    assert PB.DRAW_STEPS % PB.BLOCK_STEPS == 0
    for n_steps in (1, 1023, 1024, 1025, 117_248):
        assert _launches(n_steps, PB.BLOCK_STEPS) \
            == -(-n_steps // PB.BLOCK_STEPS)


def test_block_draws_repeat_for_a_seed():
    inp, n_steps, _ = _lanes(6, 12, seed=2)
    first, blocks = PB._draw_source(inp, n_steps, True)
    again, blocks_again = PB._draw_source(inp, n_steps, True)
    assert torch.equal(first, again)
    for i0, i1 in ((0, 7), (7, 20)):
        a, b = blocks(i0, i1), blocks_again(i0, i1)
        assert a.shape == (4, i1 - i0, K) and a.dtype == torch.float32
        assert torch.equal(a, b) and bool((a >= 0).all())
    other = PB.LaneInputs(**{**inp.__dict__, "seeds": inp.seeds + 1})
    assert not torch.equal(PB._draw_source(other, n_steps, True)[0], first)
    # deterministic: ones and no block draws; injected: views of the draws
    ones, none = PB._draw_source(inp, n_steps, False)
    assert torch.equal(ones, torch.ones_like(first)) and none(0, 5) is None
    inj, n_inj, _ = _lanes(6, 12, seed=2, draws="injected")
    start, view = PB._draw_source(inj, n_inj, True)
    assert view(3, 9).data_ptr() == inj.draws[:, 4].data_ptr()
    assert torch.equal(start, inj.draws[:, 0])


def test_generator_mode_lanes_drain():
    sweep = P.compile_sweep(P.SweepSpec(n_proxy_leaders=(2, 4),
                                        grids=((2, 2),), n_replicas=(2,)))
    res = sweep.execute(workload=P.MIXED_50_50, n_commands=40, seeds=2,
                        n_clients=8, exponential_service=True, device="cpu")
    assert np.all(res.completed == 40)
    assert np.all(res.hist.sum(axis=2) == 40)
    assert np.all(np.isfinite(res.latency_p99))


def test_cpu_execute_launches_nothing():
    before = EL.exec_lanes.launches
    P.run_variant_batched("multipaxos", n_commands=16, seeds=1, device="cpu")
    assert ops.exec_lanes is EL.exec_lanes
    assert EL.exec_lanes.launches == before == 0


def _call_args(n_lanes=2, n_clients=3, k1=4, n_ops=2, n_steps=5):
    f32 = dict(dtype=torch.float32)
    i64 = dict(dtype=torch.int64)
    return dict(
        rate_w=torch.zeros((n_lanes, k1), **f32),
        rate_r=torch.zeros((n_lanes, k1), **f32),
        finishes_at=torch.zeros((n_lanes, k1), dtype=torch.bool),
        arrive_at=torch.zeros((n_lanes, k1), **i64),
        cls=torch.zeros((n_lanes, n_clients, n_ops + 1), **i64),
        budget=torch.zeros((n_lanes, n_clients), **i64),
        t_ends=torch.zeros((n_steps, n_lanes), **f32),
        draws=torch.zeros((n_lanes, n_steps, k1 - 1), **f32),
        stage=torch.full((n_lanes, n_clients), k1 - 1, **i64),
        rank=torch.zeros((n_lanes, n_clients), **i64),
        enter_t=torch.zeros((n_lanes, n_clients), **f32),
        op_i=torch.zeros((n_lanes, n_clients), **i64),
        q=torch.zeros((n_lanes, k1), **i64),
        work=torch.zeros((n_lanes, k1), **f32),
        fin_all=torch.zeros((n_lanes, n_steps, n_clients), dtype=torch.bool),
        lat_all=torch.zeros((n_lanes, n_steps, n_clients), **f32),
        i0=0, i1=n_steps)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    EL.exec_lanes(**_call_args())   # well formed: runs the plain loop
    bad = [
        (TypeError, dict(work=torch.zeros((2, 4), dtype=torch.float64))),
        (TypeError, dict(stage=torch.full((2, 3), 3, dtype=torch.int32))),
        (TypeError, dict(fin_all=torch.zeros((2, 5, 3)))),
        (TypeError, dict(cls=torch.zeros((2, 3, 3), dtype=torch.int8))),
        (ValueError, dict(rate_w=torch.zeros((2, 5)))),
        (ValueError, dict(t_ends=torch.zeros((4, 2)))),
        (ValueError, dict(draws=torch.zeros((2, 4, 3)))),
        (ValueError, dict(cls=torch.zeros((2, 2, 3), dtype=torch.int64))),
        (ValueError, dict(i0=3, i1=2)),
        (ValueError, dict(i1=6)),
    ]
    for err, change in bad:
        with pytest.raises(err):
            EL.exec_lanes(**{**_call_args(), **change})
    with pytest.raises(ValueError):
        EL.exec_lanes(**{key: v.to("meta") if torch.is_tensor(v) else v
                         for key, v in _call_args().items()})
    mixed = _call_args()
    mixed["q"] = mixed["q"].to("meta")
    with pytest.raises(ValueError):
        EL.exec_lanes(**mixed)
    assert EL.exec_lanes.launches == 0


def test_launch_plan_covers_every_client_and_station():
    for n in (1, 6, 33, 64, 100, 1024, 1025, 2048, 3000, 4096, 4097, 5000,
              70_000):
        threads, cpt = EL.launch_plan(n, K + 1)
        assert threads % 32 == 0 and K + 1 <= threads <= 1024
        assert cpt & (cpt - 1) == 0 and threads * cpt >= n
        assert cpt == 1 or threads * (cpt // 2) < n
        assert (cpt <= 4) == (n <= EL.REGISTER_CLIENTS)


@pytest.mark.parametrize("n_sms", [132, 16])
def test_plan_takes_the_warp_kernel_where_a_lane_fits_a_warp(n_sms):
    # the main path's Fig. 29 lanes: 256 of 64 clients over 16 columns
    main = EL.plan(256, 64, K + 1, n_sms)
    assert main.kernel == "warp" and main.clients_per_thread == 2
    assert main.lanes_per_block == (2 if n_sms == 132 else 4)
    for n_lanes in (1, 3, 4, 130, 256, 1000):
        for n in (1, 31, 32, 33, 64, 65, 100, 128, 129, 1500, 5000):
            for cols in (2, 16, 31, 32, 33, 64):
                how = EL.plan(n_lanes, n, cols, n_sms)
                warp = n <= EL.WARP_CLIENTS and cols <= EL.WARP_COLUMNS
                assert how.kernel == ("warp" if warp else "block")
                if not warp:
                    assert (how.threads, how.clients_per_thread) \
                        == EL.launch_plan(n, cols)
                    assert how.blocks == n_lanes
                    assert how.lanes_per_block == 1
                    continue
                lpb, cpt = how.lanes_per_block, how.clients_per_thread
                # every client and column of every lane has its thread
                assert cpt in (1, 2, 4) and 32 * cpt >= n
                assert cpt == 1 or 16 * cpt < n
                assert cols <= 32 and how.threads == 32 * lpb
                assert how.blocks * lpb >= n_lanes
                assert (how.blocks - 1) * lpb < n_lanes
                # the fewest lanes a block whose blocks fit one an SM
                assert lpb in (1, 2, 4)
                assert how.blocks <= n_sms or lpb == EL.WARP_LANES_PER_BLOCK
                assert lpb == 1 or -(-n_lanes // (lpb // 2)) > n_sms


@pytest.mark.parametrize("lo,hi", [(1, 2), (1, 1025), (1, 45_825),
                                   (1, 117_249),
                                   ((1 << 24) - 4095, (1 << 24) + 1)],
                         ids=["1", "1024", "45824", "117248", "2**24"])
def test_end_times_are_the_step_count_times_dt(lo, hi):
    # the warp kernel computes step i's end time as __fmul_rn((float)(i +
    # 1), dt) with dt the table's first row, where the block kernel and the
    # plain loop read t_ends, the engine's float32 arange(1, n_steps + 1) *
    # dt: the two are one rounding of an exact step count times dt, equal
    # for every step count the paths use (up to 2 ** 24)
    dt = torch.tensor([1e-5, 3.3e-6, 0.1, 7.0, 1.0 / 3.0],
                      dtype=torch.float32)
    t_ends = (torch.arange(lo, hi, dtype=torch.float32)[:, None]
              * dt[None, :])
    steps = np.arange(lo, hi, dtype=np.float64)
    assert np.array_equal(steps.astype(np.float32).astype(np.float64), steps)
    want = steps.astype(np.float32)[:, None] * dt.numpy()[None, :]
    assert want.dtype == np.float32
    np.testing.assert_array_equal(t_ends.numpy(), want)


def test_fake_tensors_count_the_kernel_and_change_nothing():
    from torch._subclasses.fake_tensor import FakeTensorMode

    kernel_costs.reset()
    with FakeTensorMode():
        EL.exec_lanes(**{key: torch.empty_like(v) if torch.is_tensor(v)
                         else v for key, v in _call_args().items()})
    flops, nbytes, rate = kernel_costs.exec_lanes_cost(2, 5, 3, 4, 2, True)
    assert kernel_costs.COUNTS["exec_lanes.calls"] == 1
    assert kernel_costs.COUNTS["exec_lanes.bytes"] == nbytes
    assert kernel_costs.COUNTS["exec_lanes.flops"] == flops
    assert rate == "f32" and EL.exec_lanes.launches == 0
    kernel_costs.reset()


def test_cost_counts_the_outputs_and_the_class_reads():
    # the Fig. 29 grid's 90 %-read execute: fin and lat are 9.6 GB, the
    # rest (a byte a class, the step length a lane, the state) 1.25 MB
    ops_, nbytes, _ = kernel_costs.exec_lanes_cost(256, 117_248, 64, 16, 32,
                                                   False)
    most = 256 * 117_248 * 64 * 5
    assert most < nbytes < most + 2 ** 21
    assert nbytes - most == 256 * (64 * 33 + 64 * 4 + 16 * 13 + 4
                                   + 2 * (64 * 16 + 16 * 8))
    assert ops_ == 256 * 117_248 * (64 + 3 * 16)
    assert kernel_costs.exec_lanes_cost(1, 10, 4, 16, 3, True)[1] \
        == kernel_costs.exec_lanes_cost(1, 10, 4, 16, 3, False)[1] + 600


# -- the kernel, on a card --------------------------------------------------

GPU_CASES = {
    "n1": dict(n_clients=1, n_commands=9),
    "n6-zero-budget": dict(n_clients=6, n_commands=4),
    "n33": dict(n_clients=33, n_commands=40),
    "n64": dict(n_clients=64, n_commands=64),
    "n100": dict(n_clients=100, n_commands=130),
    "all-15-active": dict(n_clients=8, n_commands=16,
                          active=np.ones(K, bool)),
    "zero-demand-reads": dict(n_clients=8, n_commands=24, zero_read=True),
    "n1500": dict(n_clients=1500, n_commands=1600),
    "n5000-global-state": dict(n_clients=5000, n_commands=5200),
    # the warp kernel's borders: 128 clients / 32 columns take it, 129
    # clients / 33 columns the block kernel
    "n128-warp": dict(n_clients=128, n_commands=160),
    "n129-block": dict(n_clients=129, n_commands=160),
    "cols32-warp": dict(n_clients=40, n_commands=60, k=31),
    "cols33-block": dict(n_clients=40, n_commands=60, k=32),
}
#: steps a gpu case runs at most (the plain loop on the card takes a few
#: hundred microseconds a step); a case whose drain bound is below it must
#: drain
GPU_MAX_STEPS = 1500


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["deterministic", "injected", "generator"])
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_cuda_kernel_matches_plain_loop_bit_for_bit(case, mode):
    _cuda()
    kw = GPU_CASES[case]
    inp, n_steps, drains = _lanes(
        seed=3, draws=mode if mode != "deterministic" else False,
        max_steps=GPU_MAX_STEPS, device="cuda", **kw)
    n = kw["n_clients"]
    expo = mode != "deterministic"
    block = 97   # n_steps is no multiple of it
    before = EL.exec_lanes.launches
    kernel = EL.plan(4, n, kw.get("k", K) + 1).kernel
    by_kernel = EL.exec_lanes.by_kernel[kernel]
    got = _run(inp, n, n_steps, expo, block, EL.exec_lanes)
    torch.cuda.synchronize()
    assert EL.exec_lanes.launches - before == _launches(n_steps, block)
    assert EL.exec_lanes.by_kernel[kernel] - by_kernel \
        == _launches(n_steps, block)
    want = _run(inp, n, n_steps, expo, block, ref.ref_exec_lanes)
    torch.cuda.synchronize()
    _assert_runs_equal(want, got, f"{case}, {mode}")
    assert EL.exec_lanes.launches - before == _launches(n_steps, block)
    if drains:   # every lane drained its budget
        total = int(inp.budget.sum(dim=1)[0])
        assert torch.equal(got[0][2] + got[0][3],
                           torch.full_like(got[0][2], total))


@pytest.mark.gpu
def test_cuda_execute_runs_the_kernel_and_equals_the_cpu():
    _cuda()
    kw = dict(workload=P.MIXED_50_50, n_commands=64, seeds=2, n_clients=8)
    sweep = P.compile_sweep(P.SweepSpec(n_proxy_leaders=(2, 4),
                                        grids=((2, 2),), n_replicas=(2, 3)))
    before = EL.exec_lanes.launches
    warp = EL.exec_lanes.by_kernel["warp"]
    on_gpu = sweep.execute(device="cuda", **kw)
    assert EL.exec_lanes.launches - before == -(-on_gpu.n_steps
                                                // PB.BLOCK_STEPS)
    assert EL.exec_lanes.by_kernel["warp"] - warp \
        == EL.exec_lanes.launches - before
    on_cpu = sweep.execute(device="cpu", **kw)
    for field in ("hist", "completed", "throughput", "station_msgs"):
        np.testing.assert_array_equal(getattr(on_gpu, field),
                                      getattr(on_cpu, field))


@pytest.mark.gpu
@pytest.mark.parametrize("n_clients", [64, 200], ids=["warp", "block"])
def test_cuda_graph_replays_are_bitwise_equal(n_clients):
    _cuda()
    inp, n_steps, _ = _lanes(n_clients, n_clients, seed=4, draws="injected",
                             max_steps=GPU_MAX_STEPS, device="cuda")
    start = {}

    def snapshot(**kw):
        if not start:
            start.update({key: v.clone() for key, v in kw.items()
                          if torch.is_tensor(v)})
        EL.exec_lanes(**kw)

    want, _ = _run(inp, n_clients, n_steps, True, 128, snapshot)
    tables = {key: start[key] for key in ("rate_w", "rate_r", "finishes_at",
                                          "arrive_at", "cls", "budget",
                                          "t_ends")}
    state = {key: start[key].clone() for key in STATE}
    fin = torch.empty_like(want[0])
    lat = torch.empty_like(want[1])

    def steps():
        for key in STATE:
            state[key].copy_(start[key])
        for i0 in range(0, n_steps, 128):
            i1 = min(i0 + 128, n_steps)
            EL.exec_lanes(**tables, draws=inp.draws[:, i0 + 1:i1 + 1],
                          **state, fin_all=fin, lat_all=lat, i0=i0, i1=i1)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps()
    for _ in range(20):
        fin.zero_()
        lat.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(fin, want[0]) and torch.equal(lat, want[1])

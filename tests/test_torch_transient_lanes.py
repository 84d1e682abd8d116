"""The transient lanes' step loop: the plain loop in blocks against the
reference's scan, the wrapper, and on a card (``-m gpu``) the CUDA kernel
against the plain loop.

On the CPU the port's ``_transient_batch`` runs the plain loop
(``ref_transient_lanes``) in blocks of 1, 7 and 1024 steps and must equal
the reference's jitted scan bit for bit - flows, completions, float32
latency sums, histograms and queue sums - deterministic and with the
reference's own draws injected, over a crash window, a zero-demand window,
equal step bounds, a single-station deployment, 30, 32, 33 and 120 station
columns (2 and 8 shards) and 1, 128, 129, 1025 and 4100 clients.  The
wrapper must refuse what the kernel does not take; the launch plan must
give the main path's lanes the warp kernel and cover every client and
station.  On a card both kernels (``csrc/transient_lanes.cu``: one warp a
lane up to 128 clients and 32 stations, one block a lane past either) must
equal the plain loop run on the card bit for bit - flows, latencies, the
state after the run and the queue sums - deterministic, with injected and
with generator draws, and CUDA-graph replays must repeat bitwise.  The
card's machine has no JAX: this file
imports it only inside the CPU cases, and there runs ``python -m pytest
--noconftest -m gpu tests/test_torch_transient_lanes.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as P  # noqa: E402
from repro_torch.core import transient as PT  # noqa: E402
from repro_torch.core.analytical import STATION_INDEX  # noqa: E402
from repro_torch.kernels import latency_hist as LH  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import transient_lanes as TL  # noqa: E402
from repro_torch.roofline import kernel_costs  # noqa: E402

STATE = ("stage", "rank", "enter_t", "q", "work", "qsum")
OUTPUTS = STATE + ("flows", "lat1")
N_BINS = 24
SEEDS = np.array([0, 3], np.int32)
ALPHA = P.calibrate_alpha()


def _sweep():
    return P.compile_sweep(P.SweepSpec(n_proxy_leaders=(2, 4),
                                       grids=((2, 2),), n_replicas=(2, 3)))


def _demands(name, n_steps):
    """(demands[W, M, K], step_bounds[W]) of a named case."""
    sweep = _sweep()
    base = sweep.demands(P.WRITE_ONLY) / ALPHA
    k = base.shape[1]
    if name == "crash-and-zero-demand":
        return P.build_schedule(
            base, [P.Event("leader", 0.3, 0.5, P.CRASH),
                   P.Event("proxy", 0.6, 0.8, 0.0)], n_steps)
    if name == "equal-bounds":
        # window 1 is empty: its start equals window 2's
        return P.schedule_from_demands(
            [base, base * 2.0, base * 0.5, base], [0.0, 0.4, 0.4, 0.7],
            n_steps)
    if name == "single-station":
        row = np.zeros((2, k))
        row[:, STATION_INDEX["leader"]] = [1e-5, 2e-5]
        return P.build_schedule(row, [P.Event("leader", 0.5, 0.7, 3.0)],
                                n_steps)
    if name in ("k32", "k33"):
        # the warp kernel's border: 32 stations take it, 33 do not
        k = int(name[1:])
        rng = np.random.default_rng(k)
        row = np.where(rng.uniform(size=(2, k)) < 0.6,
                       rng.uniform(1e-5, 3e-5, (2, k)), 0.0)
        row[:, 0] = 2e-5
        return P.build_schedule(row, [P.Event(0, 0.4, 0.6, 3.0)], n_steps)
    if name.startswith("shards-"):
        spec = P.ShardingSpec(n_shards=int(name.split("-")[1]))
        flat = P.flatten_shards(sweep.demands(P.WRITE_ONLY, sharding=spec))
        # shard 1's leader crashes
        crash = P.Event(k + STATION_INDEX["leader"], 0.4, 0.6, P.CRASH)
        return P.build_schedule(flat / ALPHA, [crash], n_steps)
    return P.build_schedule(base, [P.Event("leader", 0.4, 0.6, P.CRASH)],
                            n_steps)


#: name -> (n_clients, n_steps); the demands come from ``_demands``
CASES = {
    "crash-and-zero-demand": (12, 300),
    "equal-bounds": (12, 300),
    "single-station": (5, 200),
    "shards-2": (16, 300),
    "shards-8": (16, 300),
    "n1": (1, 200),
    "n1025": (1025, 60),
    "n4100": (4100, 40),
    "n128": (128, 80),
    "n129": (129, 80),
    "k32": (12, 200),
    "k33": (12, 200),
}


def _inputs(name):
    """The engine's numpy inputs of a case, as ``simulate_transient``
    derives them: (d, bounds, dt, entry, nxt, edges, n_clients, n_steps,
    warmup)."""
    n_clients, n_steps = CASES[name]
    d, bounds = _demands(name, n_steps)
    active = d.max(axis=0) > 0
    entry, nxt = PT._routing(active)
    dt = d.max(axis=2).min(axis=0) / 4.0
    rtt = np.maximum((d * active[None]).sum(axis=2).min(axis=0), 1e-12)
    lo = rtt * 0.5
    hi = np.maximum(n_steps * dt, lo * 10.0)
    edges = lo[:, None] * ((hi / lo) ** (1.0 / N_BINS))[:, None] ** \
        np.arange(N_BINS + 1)[None, :]
    return d, bounds, dt, entry, nxt, edges, n_clients, n_steps, n_steps // 4


def _draws(name, k):
    n_steps = CASES[name][1]
    return np.random.default_rng(30).exponential(
        size=(SEEDS.size, n_steps + 1, k)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(name, mode):
    """The reference's ``_transient_batch`` on a case, with its own draws
    in the injected mode: (outputs, the draws it used or None)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.core import transient as RT
    d, bounds, dt, entry, nxt, edges, n, n_steps, warmup = _inputs(name)
    expo = mode == "injected"
    out = [np.asarray(x) for x in RT._transient_batch(
        jnp.asarray(d), jnp.asarray(bounds), jnp.asarray(dt),
        jnp.asarray(entry), jnp.asarray(nxt), jnp.asarray(edges),
        jnp.asarray(SEEDS), n_clients=n, n_steps=n_steps,
        warmup_steps=warmup, n_bins=N_BINS, exponential=expo)]
    draws = None
    if expo:
        draws = np.stack([np.asarray(jax.random.exponential(
            jax.random.fold_in(jax.random.key(0), int(s)),
            (n_steps + 1, d.shape[2]))) for s in SEEDS])
    return out, draws


def _run(inp, name, exponential, block, steps):
    """The port's ``_transient_batch`` on a case with ``steps`` as its step
    function, in blocks of ``block`` steps; returns its five outputs and
    the tensors of the last call (the state after the run, the flows and
    latencies)."""
    n_clients, n_steps = CASES[name]
    seen = {}

    def step_fn(*args, **kw):
        seen.update(kw)
        steps(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(PT, "transient_lanes", step_fn)
    mp.setattr(PT, "BLOCK_STEPS", block)
    try:
        out = PT._transient_batch(inp, n_clients, n_steps, n_steps // 4,
                                  N_BINS, exponential)
    finally:
        mp.undo()
    return out, {key: seen[key] for key in OUTPUTS}


# -- the plain loop, on the CPU -----------------------------------------------

PLAIN = ([("crash-and-zero-demand", b) for b in (1, 7, 1024)]
         + [(name, 7) for name in CASES if name != "crash-and-zero-demand"])


@pytest.mark.parametrize("mode", ["deterministic", "injected"])
@pytest.mark.parametrize("name,block", PLAIN,
                         ids=[f"{n}-blocks-of-{b}" for n, b in PLAIN])
def test_plain_loop_in_blocks_equals_reference_scan(name, block, mode):
    want, ref_draws = _reference(name, mode)
    d, bounds, dt, entry, nxt, edges, *_ = _inputs(name)
    inp = P.transient_inputs_from_numpy(d, bounds, dt, entry, nxt, edges,
                                        SEEDS, ref_draws, device="cpu")
    got, last = _run(inp, name, mode == "injected", block,
                     ref.ref_transient_lanes)
    want = list(want)
    if (name, mode) == ("n1", "deterministic"):
        # At one client XLA fuses the reference's end time into the
        # latency and contracts ``(i + 1) * dt - enter_t`` into one fused
        # multiply-add (at the other client counts it rounds the product
        # first, as the port does everywhere).  Its latency sum is then the
        # port's latencies recomputed with that one rounding, summed in
        # step order; the port's own sum is its latencies' plain sum.
        lat_fma, lat_plain = _latency_sums(last, inp.dt, CASES[name][1] // 4)
        np.testing.assert_array_equal(lat_fma.reshape(want[2].shape),
                                      want[2])
        want[2] = lat_plain.reshape(want[2].shape)
    for what, a, b in zip(["flows", "done", "lat_sum", "hist", "qsum"],
                          want, got):
        assert b.dtype == a.dtype and b.shape == a.shape, what
        np.testing.assert_array_equal(b, a, err_msg=what)
    assert got[1].min() > 0, "a lane finished nothing past the warmup"


def _latency_sums(last, dt, warmup):
    """[L] float32 running sums, in step order, of each lane's recorded
    latencies: computed as one fused multiply-add from the end time and
    the finisher's entry time, and as the port's plain values.  A lane's
    one client enters at its previous finish (0 at the start)."""
    flows, lat1 = last["flows"].numpy(), last["lat1"].numpy()
    out = np.zeros((2, flows.shape[0]), np.float32)
    for lane, dt_l in enumerate(dt.numpy()):
        enter = np.float32(0.0)
        for i in np.nonzero(flows[lane])[0]:
            t_end = np.float32(np.float32(i + 1) * dt_l)
            # exact in float64, then one rounding: a fused multiply-add
            fused = np.float32(np.float64(i + 1) * np.float64(dt_l)
                               - np.float64(enter))
            assert lat1[lane, i] == np.float32(t_end - enter)
            if i >= warmup:
                out[0, lane] = np.float32(out[0, lane] + fused)
                out[1, lane] = np.float32(out[1, lane] + lat1[lane, i])
            enter = t_end
    return out[0], out[1]


def test_cpu_transient_launches_nothing():
    before = TL.transient_lanes.launches
    P.simulate_transient(np.array([1e-5, 2e-5, 1e-5]), n_clients=8, seeds=2,
                         n_steps=50, device="cpu")
    assert ops.transient_lanes is TL.transient_lanes
    assert TL.transient_lanes.launches == before == 0


@pytest.mark.parametrize("exponential", [False, True])
def test_zero_steps_equal_the_reference(exponential):
    """A run of no steps: the reference's zero-length scan leaves each
    lane's float32 latency sum at zero; every field of both packages'
    results is equal, NaN to NaN (the throughput over no measured time)."""
    jax = pytest.importorskip("jax")
    import dataclasses
    from repro.core import transient as RT
    d = np.array([[0.001, 0.002, 0.0005]])
    want = RT.simulate_transient(d, n_steps=0, seeds=2,
                                 exponential_service=exponential)
    draws = None
    if exponential:  # the reference's own, [S, n_steps + 1, K]
        draws = np.stack([np.asarray(jax.random.exponential(
            jax.random.fold_in(jax.random.key(0), s), (1, 3)))
            for s in range(2)])
    got = P.simulate_transient(d, n_steps=0, seeds=2,
                               exponential_service=exponential, draws=draws,
                               device="cpu")
    assert got.flows.shape == (1, 2, 0)
    assert np.isnan(got.throughput).all()
    for field in dataclasses.fields(want):
        if field.name != "timings":
            np.testing.assert_array_equal(getattr(got, field.name),
                                          getattr(want, field.name),
                                          err_msg=field.name)


def test_more_than_one_finish_a_step_raises():
    name = "crash-and-zero-demand"
    d, bounds, dt, entry, nxt, edges, *_ = _inputs(name)
    inp = P.transient_inputs_from_numpy(d, bounds, dt, entry, nxt, edges,
                                        SEEDS, device="cpu")

    def corrupt(*args, **kw):
        ref.ref_transient_lanes(*args, **kw)
        kw["flows"][1, kw["i0"]] = 2

    with pytest.raises(RuntimeError, match="finished 2 commands"):
        _run(inp, name, False, 1024, corrupt)


def _call_args(n_lanes=4, n_clients=3, k=5, n_windows=2, n_steps=6,
               n_seeds=2):
    f32 = dict(dtype=torch.float32)
    i64 = dict(dtype=torch.int64)
    return dict(
        rates=torch.ones((n_windows, n_lanes, k), **f32),
        window_of=torch.zeros((n_steps,), dtype=torch.int32),
        dt=torch.ones((n_lanes,), **f32),
        finishes_at=torch.zeros((n_lanes, k), dtype=torch.bool),
        arrive_at=torch.zeros((n_lanes, k), **i64),
        draws=torch.ones((n_seeds, n_steps + 1, k), **f32),
        stage=torch.zeros((n_lanes, n_clients), **i64),
        rank=torch.arange(n_clients).repeat(n_lanes, 1),
        enter_t=torch.zeros((n_lanes, n_clients), **f32),
        q=torch.zeros((n_lanes, k), **i64).index_fill_(1, torch.tensor([0]),
                                                       n_clients),
        work=torch.ones((n_lanes, k), **f32),
        qsum=torch.zeros((n_lanes, n_windows, k), **f32),
        flows=torch.zeros((n_lanes, n_steps), dtype=torch.int32),
        lat1=torch.zeros((n_lanes, n_steps), **f32),
        i0=0, i1=n_steps)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    TL.transient_lanes(**_call_args())   # well formed: runs the plain loop
    bad = [
        (TypeError, dict(work=torch.zeros((4, 5), dtype=torch.float64))),
        (TypeError, dict(stage=torch.zeros((4, 3), dtype=torch.int32))),
        (TypeError, dict(window_of=torch.zeros((6,), dtype=torch.int64))),
        (TypeError, dict(flows=torch.zeros((4, 6)))),
        (TypeError, dict(finishes_at=torch.zeros((4, 5), dtype=torch.int8))),
        (ValueError, dict(rates=torch.zeros((2, 4, 6)))),
        (ValueError, dict(qsum=torch.zeros((4, 3, 5)))),
        (ValueError, dict(lat1=torch.zeros((4, 5)))),
        (ValueError, dict(draws=torch.zeros((2, 6, 5)))),
        (ValueError, dict(draws=torch.zeros((3, 7, 5)))),
        (ValueError, dict(dt=torch.zeros((4, 1)))),
        (ValueError, dict(i0=3, i1=2)),
        (ValueError, dict(i1=7)),
    ]
    for err, change in bad:
        with pytest.raises(err):
            TL.transient_lanes(**{**_call_args(), **change})
    with pytest.raises(ValueError):
        TL.transient_lanes(**{key: v.to("meta") if torch.is_tensor(v) else v
                              for key, v in _call_args().items()})
    mixed = _call_args()
    mixed["q"] = mixed["q"].to("meta")
    with pytest.raises(ValueError):
        TL.transient_lanes(**mixed)
    # what only the kernel refuses: more stations than threads a block,
    # views where it reads flat tables, draws strided along the stations
    wide = _call_args(k=TL.MAX_STATIONS + 1)
    with pytest.raises(ValueError, match="station columns"):
        TL._launch(**wide)
    strided = _call_args()
    strided["work"] = torch.ones((5, 4)).t()
    with pytest.raises(ValueError, match="contiguous"):
        TL._launch(**strided)
    strided = _call_args()
    strided["draws"] = torch.ones((2, 5, 7)).transpose(1, 2)
    with pytest.raises(ValueError, match="unit stride"):
        TL._launch(**strided)
    assert TL.transient_lanes.launches == 0


def test_launch_plan_covers_every_client_and_station():
    for k in (1, 15, 30, 120, 1000, TL.MAX_STATIONS):
        for n in (1, 5, 33, 64, 1024, 1025, 2048, 4096, 4100, 70_000):
            threads, cpt = TL.launch_plan(n, k)
            assert threads % 32 == 0 and k <= threads <= 1024
            assert cpt & (cpt - 1) == 0 and threads * cpt >= n
            assert cpt == 1 or threads * (cpt // 2) < n
            assert (cpt <= 4) == (n <= 4096)


@pytest.mark.parametrize("n_sms", [132, 16])
def test_plan_takes_the_warp_kernel_where_a_lane_fits_a_warp(n_sms):
    # the main path's Fig. 29 lanes: 256 of 64 clients over 15 stations
    main = TL.plan(256, 64, 15, n_sms)
    assert main.kernel == "warp" and main.clients_per_thread == 2
    for n_lanes in (1, 3, 4, 130, 256, 1000):
        for n in (0, 1, 32, 33, 64, 65, 128, 129, 1025, 5000):
            for k in (1, 15, 30, 32, 33, 120, TL.MAX_STATIONS):
                how = TL.plan(n_lanes, n, k, n_sms)
                warp = n <= 128 and k <= 32
                assert how.kernel == ("warp" if warp else "block")
                if not warp:
                    assert (how.threads, how.clients_per_thread) \
                        == TL.launch_plan(n, k)
                    assert how.blocks == n_lanes
                    continue
                lpb, cpt = how.lanes_per_block, how.clients_per_thread
                # every client and station of every lane has its thread
                assert cpt in (1, 2, 4) and 32 * cpt >= n and k <= 32
                assert cpt == 1 or 16 * cpt < n
                assert how.threads == 32 * lpb and lpb in (1, 2, 4)
                assert how.blocks * lpb >= n_lanes
                assert (how.blocks - 1) * lpb < n_lanes
                assert how.blocks <= n_sms or lpb == 4
                assert lpb == 1 or -(-n_lanes // (lpb // 2)) > n_sms


@pytest.mark.parametrize("lo,hi", [(1, 4001), (1, 2501),
                                   ((1 << 24) - 4095, (1 << 24) + 1)],
                         ids=["4000", "2500", "2**24"])
def test_kernel_end_time_equals_the_plain_loops(lo, hi):
    # the kernels compute step i's end time as __fmul_rn((float)(i + 1),
    # dt): one rounding of an exact step count times dt; the plain loop's
    # float32 arange(i0 + 1, i1 + 1) * dt is the same for every step count
    # up to 2 ** 24
    _, _, dt, *_ = _inputs("crash-and-zero-demand")
    dt = torch.tensor(np.concatenate([dt, [1e-5, 3.3e-6, 1.0 / 3.0]]),
                      dtype=torch.float32)
    plain = (torch.arange(lo, hi, dtype=torch.float32)[:, None]
             * dt[None, :])
    steps = np.arange(lo, hi, dtype=np.float64)
    assert np.array_equal(steps.astype(np.float32).astype(np.float64), steps)
    kernel = steps.astype(np.float32)[:, None] * dt.numpy()[None, :]
    assert kernel.dtype == np.float32
    np.testing.assert_array_equal(plain.numpy(), kernel)


def test_fake_tensors_count_the_kernel_and_change_nothing():
    from torch._subclasses.fake_tensor import FakeTensorMode

    kernel_costs.reset()
    with FakeTensorMode():
        TL.transient_lanes(**{key: torch.empty_like(v) if torch.is_tensor(v)
                              else v for key, v in _call_args().items()})
    flops, nbytes, rate = kernel_costs.transient_lanes_cost(4, 6, 3, 5, 2, 2)
    assert kernel_costs.COUNTS["transient_lanes.calls"] == 1
    assert kernel_costs.COUNTS["transient_lanes.bytes"] == nbytes
    assert kernel_costs.COUNTS["transient_lanes.flops"] == flops
    assert rate == "f32" and TL.transient_lanes.launches == 0
    kernel_costs.reset()


def test_cost_counts_the_outputs_the_draws_and_the_state():
    # the transient grid: 256 lanes x 64 clients x 15 stations, 3 windows,
    # 8 seeds, 4000 steps: flows and latencies 8.19 MB, draws 1.92 MB
    ops_, nbytes, _ = kernel_costs.transient_lanes_cost(256, 4000, 64, 15, 3,
                                                        8)
    outputs, draws = 256 * 4000 * 8, 8 * 4000 * 15 * 4
    rest = (4000 * 4 + 256 * 4 + 3 * 256 * 15 * 4 + 256 * 15 * 5
            + 2 * 256 * (64 * 12 + 15 * 8) + 2 * 256 * 3 * 15 * 4)
    assert nbytes == outputs + draws + rest
    assert ops_ == 256 * 4000 * (2 + 4 * 15)
    assert kernel_costs.transient_lanes_cost(2, 10, 4, 15, 1, 0)[1] + 600 \
        == kernel_costs.transient_lanes_cost(2, 10, 4, 15, 1, 1)[1]


# -- the kernel, on a card --------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _card_inputs(name, mode):
    d, bounds, dt, entry, nxt, edges, *_ = _inputs(name)
    draws = _draws(name, d.shape[2]) if mode == "injected" else None
    return P.transient_inputs_from_numpy(d, bounds, dt, entry, nxt, edges,
                                         SEEDS, draws, device="cuda")


def _assert_runs_equal(a, b, what):
    (out_a, last_a), (out_b, last_b) = a, b
    for name, x, y in zip(["flows", "done", "lat_sum", "hist", "qsum"],
                          out_a, out_b):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {name}")
    for key in OUTPUTS:
        assert torch.equal(last_a[key], last_b[key]), f"{what}: {key}"


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["deterministic", "injected", "generator"])
@pytest.mark.parametrize("name", list(CASES))
def test_cuda_kernel_matches_plain_loop_bit_for_bit(name, mode):
    _cuda()
    inp = _card_inputs(name, mode)
    expo = mode != "deterministic"
    n_steps = CASES[name][1]
    block = 97   # no multiple of it is a window bound or n_steps
    before = TL.transient_lanes.launches
    kernel = TL.plan(inp.dt.shape[0], CASES[name][0],
                     inp.demands_w.shape[2]).kernel
    by_kernel = TL.transient_lanes.by_kernel[kernel]
    got = _run(inp, name, expo, block, TL.transient_lanes)
    torch.cuda.synchronize()
    assert TL.transient_lanes.launches - before == -(-n_steps // block)
    assert TL.transient_lanes.by_kernel[kernel] - by_kernel \
        == -(-n_steps // block)
    want = _run(inp, name, expo, block, ref.ref_transient_lanes)
    torch.cuda.synchronize()
    _assert_runs_equal(want, got, f"{name}, {mode}")
    assert TL.transient_lanes.launches - before == -(-n_steps // block)
    assert got[0][0].sum() > 0


@pytest.mark.gpu
def test_cuda_transient_runs_the_kernel_and_equals_the_cpu():
    _cuda()
    sweep = _sweep()
    kw = dict(workload=P.MIXED_50_50, n_clients=16, seeds=2, n_steps=2500,
              events=[P.Event("leader", 0.4, 0.6, P.CRASH)])
    before, hist_before = TL.transient_lanes.launches, LH.latency_hist.launches
    warp = TL.transient_lanes.by_kernel["warp"]
    on_gpu = sweep.transient(ALPHA, device="cuda", **kw)
    assert TL.transient_lanes.launches - before == -(-2500
                                                     // PT.BLOCK_STEPS)
    assert TL.transient_lanes.by_kernel["warp"] - warp \
        == TL.transient_lanes.launches - before
    assert LH.latency_hist.launches - hist_before == 1
    on_cpu = sweep.transient(ALPHA, device="cpu", **kw)
    for field in ("flows", "completed", "hist", "queue_sums", "throughput",
                  "latency_mean", "latency_p99"):
        np.testing.assert_array_equal(getattr(on_gpu, field),
                                      getattr(on_cpu, field), err_msg=field)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["crash-and-zero-demand", "n1025"],
                         ids=["warp", "block"])
def test_cuda_graph_replays_are_bitwise_equal(name):
    _cuda()
    n_steps = CASES[name][1]
    inp = _card_inputs(name, "injected")
    start = {}

    def snapshot(*args, **kw):
        if not start:
            start.update(args=args, state={key: kw[key].clone()
                                           for key in STATE})
        TL.transient_lanes(*args, **kw)

    _, want = _run(inp, name, True, 64, snapshot)
    state = {key: v.clone() for key, v in start["state"].items()}
    flows = torch.empty_like(want["flows"])
    lat1 = torch.empty_like(want["lat1"])

    def steps():
        for key in STATE:
            state[key].copy_(start["state"][key])
        for i0 in range(0, n_steps, 64):
            TL.transient_lanes(*start["args"], **state, flows=flows,
                               lat1=lat1, i0=i0, i1=min(i0 + 64, n_steps))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        steps()
    for _ in range(20):
        flows.zero_()
        lat1.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(flows, want["flows"])
        assert torch.equal(lat1, want["lat1"])
        for key in STATE:
            assert torch.equal(state[key], want[key]), key

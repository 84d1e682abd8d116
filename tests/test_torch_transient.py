"""The port's transient token engine against the reference's.

Engine level: the same numpy inputs go through the reference's jitted scan
and the port's eager step loop (via ``transient_inputs_from_numpy``),
deterministic and with the reference's own ``jax.random`` draws injected;
flows, completions, histograms, queue sums and the float32 latency sums
are equal bit for bit (a lane finishes at most one command a step, so the
per-step latency sum is exact in any order, and the running sum is taken
in step order: the tolerance on ``latency_mean`` is zero).  Entry-point
level: ``simulate_transient``, ``transient_throughput`` and
``CompiledSweep.transient`` (events, bursty arrivals, sharding) of both
packages give equal results.  Then twins of the reference's transient
tests, run on the port's own service draws.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import transient as RT  # noqa: E402
from repro_torch.core import transient as PT  # noqa: E402
from repro_torch.core.analytical import PAPER_MULTIPAXOS_UNBATCHED  # noqa
from repro_torch.core.simulator import demand_vector  # noqa: E402

ALPHA = P.calibrate_alpha(PAPER_MULTIPAXOS_UNBATCHED)
CPU = dict(device="cpu")
CMP = P.compartmentalized_model(f=1, n_proxy_leaders=10, grid_rows=2,
                                grid_cols=2, n_replicas=4)
#: TransientResult fields two equal runs agree on exactly
EXACT = ["dt", "flows", "throughput", "latency_mean", "latency_p50",
         "latency_p99", "completed", "hist", "bin_edges", "queue_sums"]


@pytest.fixture(autouse=True)
def _same_station_vocabulary():
    """The station vocabulary is append-only and process-wide: give the
    port the reference's columns, so both packages lower to the same K."""
    P.api._allocate_stations(tuple(R.STATION_ORDER))


def _assert_results_equal(a, b):
    """a: the reference's TransientResult, b: the port's."""
    assert (b.n_steps, b.warmup_steps) == (a.n_steps, a.warmup_steps)
    for field in EXACT:
        x, y = getattr(a, field), getattr(b, field)
        assert y.dtype == x.dtype, field
        np.testing.assert_array_equal(y, x, err_msg=field)


def _reference_draws(seeds, n_steps, k):
    """The reference's service draws: one stream per seed, shared by every
    deployment."""
    return np.stack([np.asarray(jax.random.exponential(
        jax.random.fold_in(jax.random.key(0), int(s)), (n_steps + 1, k)))
        for s in seeds])


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------

N_CLIENTS, N_BINS = 12, 24
SEEDS = np.array([0, 3], np.int32)


def _engine_inputs(n_steps):
    """Four deployments over five windows: a leader crash, then a window
    that zeroes the proxies' demand ("free" service)."""
    sweep = P.compile_sweep(P.SweepSpec(n_proxy_leaders=(2, 4),
                                        n_replicas=(2, 3)))
    base = sweep.demands(P.WRITE_ONLY) / ALPHA
    d, bounds = P.build_schedule(
        base, [P.Event("leader", 0.3, 0.5, P.CRASH),
               P.Event("proxy", 0.6, 0.8, 0.0)], n_steps)
    active = d.max(axis=0) > 0
    entry, nxt = PT._routing(active)
    dt = d.max(axis=2).min(axis=0) / 4.0
    rtt = np.maximum((d * active[None]).sum(axis=2).min(axis=0), 1e-12)
    lo = rtt * 0.5
    hi = np.maximum(n_steps * dt, lo * 10.0)
    edges = lo[:, None] * ((hi / lo) ** (1.0 / N_BINS))[:, None] ** \
        np.arange(N_BINS + 1)[None, :]
    assert np.any(d == 0.0) and np.any(d >= P.CRASH * d.min(where=d > 0,
                                                            initial=1.0))
    return d, bounds, dt, entry, nxt, edges


@pytest.mark.parametrize("n_steps", [600, 2500],
                         ids=["one-partial-block", "three-blocks"])
@pytest.mark.parametrize("exponential", [False, True],
                         ids=["deterministic", "injected-draws"])
def test_engine_matches_reference_scan_exactly(exponential, n_steps):
    d, bounds, dt, entry, nxt, edges = _engine_inputs(n_steps)
    warmup = n_steps // 4
    want = [np.asarray(x) for x in RT._transient_batch(
        jnp.asarray(d), jnp.asarray(bounds), jnp.asarray(dt),
        jnp.asarray(entry), jnp.asarray(nxt), jnp.asarray(edges),
        jnp.asarray(SEEDS), n_clients=N_CLIENTS, n_steps=n_steps,
        warmup_steps=warmup, n_bins=N_BINS, exponential=exponential)]
    draws = (_reference_draws(SEEDS, n_steps, d.shape[2]) if exponential
             else None)
    inp = P.transient_inputs_from_numpy(d, bounds, dt, entry, nxt, edges,
                                        SEEDS, draws, device="cpu")
    got = PT._transient_batch(inp, N_CLIENTS, n_steps, warmup, N_BINS,
                              exponential)
    for name, a, b in zip(["flows", "done", "lat_sum", "hist", "qsum"],
                          want, got):
        assert b.dtype == a.dtype and b.shape == a.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    flows, done, _, hist, _ = got
    assert done.min() > 0 and flows.sum() > done.sum()
    np.testing.assert_array_equal(hist.sum(axis=2), done)


def test_lanes_share_draws_by_seed_only():
    """Common random numbers: every deployment under seed s sees the same
    draws, and a lane's draws do not depend on the other seeds in the
    list."""
    k = len(P.STATION_ORDER)
    both = PT._seed_draws(np.array([3, 5], np.int32), 40, k)
    alone = PT._seed_draws(np.array([5], np.int32), 40, k)
    assert both.shape == (2, 41, k)
    torch.testing.assert_close(both[1], alone[0], rtol=0, atol=0)
    assert not torch.equal(both[0], both[1])
    # two copies of one deployment, under seeds (3, 5) and under (5,)
    d = np.stack([demand_vector(CMP), demand_vector(CMP)]) / ALPHA
    pair = P.simulate_transient(d, n_clients=16, seeds=(3, 5), n_steps=400,
                                **CPU)
    single = P.simulate_transient(d[:1], n_clients=16, seeds=(5,),
                                  n_steps=400, **CPU)
    np.testing.assert_array_equal(pair.flows[0], pair.flows[1])
    np.testing.assert_array_equal(pair.hist[0], pair.hist[1])
    np.testing.assert_array_equal(pair.flows[0, 1], single.flows[0, 0])
    np.testing.assert_array_equal(pair.hist[1, 1], single.hist[0, 0])
    assert not np.array_equal(pair.flows[0, 0], pair.flows[0, 1])


def test_nan_latency_lands_in_bin_zero_on_the_transient_path():
    """The transient path bins with the ``latency_hist`` kernel's rule,
    ``#{j : edges_j < lat} - 1`` clipped, so a NaN lands in bin 0.  (The
    reference's in-scan ``jnp.searchsorted`` would put a NaN past the last
    edge, in the last bin; the engine's latencies are differences of
    finite times, so no input of the engine tells the two apart.)"""
    edges = torch.tensor([[1.0, 2.0, 4.0, 8.0]])
    lat = torch.tensor([[[float("nan"), 3.0, 0.5, 9.0, 2.0]]])
    rec = torch.ones_like(lat, dtype=torch.bool)
    got = PT._bin_block(lat, rec, edges)
    np.testing.assert_array_equal(got.numpy(), [[3, 1, 1]])
    assert got.dtype == torch.int32
    # the same rule as the kernel's plain version, samples past the ends
    # clipped into the end bins
    rec[0, 0, 0] = False
    np.testing.assert_array_equal(PT._bin_block(lat, rec, edges).numpy(),
                                  [[2, 1, 1]])
    ref_bins = jnp.clip(jnp.searchsorted(jnp.asarray(edges[0].numpy()),
                                         jnp.asarray([np.nan, 3.0])) - 1,
                        0, 2)
    np.testing.assert_array_equal(np.asarray(ref_bins), [2, 1])


def test_wrong_draw_shape_raises():
    d, bounds, dt, entry, nxt, edges = _engine_inputs(600)
    inp = P.transient_inputs_from_numpy(
        d, bounds, dt, entry, nxt, edges, SEEDS,
        np.ones((2, 600, d.shape[2]), np.float32), device="cpu")
    with pytest.raises(ValueError, match="draws must be"):
        PT._transient_batch(inp, N_CLIENTS, 600, 150, N_BINS, True)


# ---------------------------------------------------------------------------
# Entry-point level: both packages, same inputs
# ---------------------------------------------------------------------------


def _schedule(pkg):
    base = pkg.compile_sweep(pkg.SweepSpec(n_proxy_leaders=(2, 6),
                                           grids=((3, 1), (2, 2)),
                                           n_replicas=(2,))
                             ).demands(pkg.Workload(f_write=0.5)) / ALPHA
    return pkg.build_schedule(base, [pkg.Event("leader", 0.4, 0.6, 1e9),
                                     pkg.Event("replica", 0.7, 0.9, 0.5)],
                              800)


@pytest.mark.parametrize("exponential", [False, True],
                         ids=["deterministic", "injected-draws"])
def test_simulate_transient_matches_reference(exponential):
    sched, bounds = _schedule(R)
    kw = dict(n_clients=24, seeds=(1, 4, 9), n_steps=800, n_bins=48,
              exponential_service=exponential)
    a = R.simulate_transient(sched, bounds, **kw)
    draws = (_reference_draws((1, 4, 9), 800, sched.shape[2])
             if exponential else None)
    p_sched, p_bounds = _schedule(P)
    np.testing.assert_array_equal(p_sched, sched)
    np.testing.assert_array_equal(p_bounds, bounds)
    b = P.simulate_transient(p_sched, p_bounds, draws=draws, **kw, **CPU)
    _assert_results_equal(a, b)
    np.testing.assert_array_equal(b.window_queue_depth(bounds),
                                  a.window_queue_depth(bounds))
    np.testing.assert_array_equal(b.window_throughput(bounds),
                                  a.window_throughput(bounds))
    for x, y in zip(b.throughput_trace(16), a.throughput_trace(16)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(b.seed_mean_p99(), a.seed_mean_p99())
    assert b.timings["scan"] > 0


def test_transient_throughput_matches_reference():
    a = R.transient_throughput(R.multipaxos_model(f=1), ALPHA, n_clients=16,
                               workload=R.Workload(f_write=0.5), seeds=2,
                               n_steps=500, exponential_service=False)
    b = P.transient_throughput(P.multipaxos_model(f=1), ALPHA, n_clients=16,
                               workload=P.Workload(f_write=0.5), seeds=2,
                               n_steps=500, exponential_service=False, **CPU)
    _assert_results_equal(a, b)


CASES = {
    "events": dict(events=[("leader", 0.4, 0.6, 1e9)]),
    "bursty": dict(workload=dict(f_write=1.0, arrival="bursty",
                                 burst_factor=3.0, n_bursts=2)),
    "sharded": dict(sharding=2, workload=dict(f_write=1.0, skew_p=0.6),
                    events=[("leader", 0.5, 0.7, 1e9), (3, 0.2, 0.3, 2.0)]),
}


def _sweep_transient(pkg, case, **kw):
    c = CASES[case]
    sweep = pkg.compile_sweep(pkg.SweepSpec(n_proxy_leaders=(3, 5),
                                            n_replicas=(2, 4)))
    w = pkg.Workload(**c.get("workload", dict(f_write=1.0)))
    events = [pkg.Event(*e) for e in c.get("events", [])]
    sharding = (pkg.ShardingSpec(c["sharding"]) if "sharding" in c
                else None)
    return sweep.transient(ALPHA, n_clients=20, workload=w, events=events,
                           sharding=sharding, n_steps=600, seeds=2, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_compiled_sweep_transient_matches_reference(case):
    a = _sweep_transient(R, case, exponential_service=False)
    b = _sweep_transient(P, case, exponential_service=False, **CPU)
    _assert_results_equal(a, b)
    assert a.queue_sums.shape[2] > 1          # a scheduled run
    # the reference's draws, injected through the sweep's keywords
    k = a.queue_sums.shape[3]
    draws = _reference_draws((0, 1), 600, k)
    _assert_results_equal(_sweep_transient(R, case),
                          _sweep_transient(P, case, draws=draws, **CPU))


def test_sharded_events_match_reference():
    from repro.core.sweep import _sharded_events as ref_events
    from repro_torch.core.sweep import _sharded_events
    k = len(P.STATION_ORDER)
    evs = [("leader", 0.1, 0.2, 3.0), (2, 0.3, 0.4, 2.0),
           (k + 1, 0.5, 0.6, 5.0)]
    want = ref_events([R.Event(*e) for e in evs], k, 3)
    got = _sharded_events([P.Event(*e) for e in evs], k, 3)
    assert [(e.station, e.start, e.stop, e.factor) for e in got] == \
        [(e.station, e.start, e.stop, e.factor) for e in want]
    assert len(got) == 7


def test_transient_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = demand_vector(CMP) / ALPHA
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate_transient(d, n_steps=10, seeds=1)
    sweep = P.compile_sweep(P.SweepSpec())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.transient(ALPHA, n_steps=10, seeds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.transient_throughput(CMP, ALPHA, n_steps=10, seeds=1)


# ---------------------------------------------------------------------------
# Twins of the reference's transient tests, on the port's own draws
# ---------------------------------------------------------------------------


def test_steady_state_matches_mva_within_5pct():
    res = P.transient_throughput(CMP, ALPHA, n_clients=64, seeds=8,
                                 n_steps=4000, **CPU)
    _, x_mva, r_mva = P.mva_curve(CMP, ALPHA, n_clients_max=64, **CPU)
    x = float(res.throughput.mean())
    assert x == pytest.approx(float(x_mva[-1]), rel=0.05)
    assert float(res.latency_mean.mean()) == pytest.approx(
        float(r_mva[-1]), rel=0.10)
    assert np.all(res.latency_p50 <= res.latency_p99)
    assert float(res.latency_p99.mean()) > float(res.latency_p50.mean())


def test_steady_state_matches_fluid():
    res = P.transient_throughput(CMP, ALPHA, n_clients=64, seeds=8,
                                 n_steps=4000, **CPU)
    x_fluid = P.fluid_throughput(CMP, ALPHA, n_clients=64, sim_time=0.05,
                                 **CPU)
    assert float(res.throughput.mean()) == pytest.approx(x_fluid, rel=0.05)


def test_des_is_the_reference_oracle():
    mp = P.multipaxos_model(f=1)
    x_des, _ = P.des_throughput(mp, ALPHA, n_clients=64, n_commands=5000,
                                deterministic_service=False)
    res = P.transient_throughput(mp, ALPHA, n_clients=64, seeds=8,
                                 n_steps=4000, **CPU)
    assert float(res.throughput.mean()) == pytest.approx(x_des, rel=0.10)


def test_des_warmup_removes_coldstart_bias():
    _, x_mva, _ = P.mva_curve(CMP, ALPHA, n_clients_max=64, **CPU)
    x_cold, _ = P.des_throughput(CMP, ALPHA, n_clients=64, n_commands=2000,
                                 warmup_commands=0)
    x_warm, _ = P.des_throughput(CMP, ALPHA, n_clients=64, n_commands=2000)
    err_cold = abs(x_cold - x_mva[-1]) / x_mva[-1]
    err_warm = abs(x_warm - x_mva[-1]) / x_mva[-1]
    assert err_warm < err_cold
    assert err_warm < 1e-6


def test_single_station_deployment():
    un = P.unreplicated_model()
    res = P.transient_throughput(un, ALPHA, n_clients=16, seeds=8,
                                 n_steps=4000, **CPU)
    assert float(res.throughput.mean()) == pytest.approx(
        un.peak_throughput(ALPHA), rel=0.10)


def test_batched_sweep_16x8_lanes_one_call():
    compiled = P.compile_sweep(P.SweepSpec(n_proxy_leaders=(2, 4, 6, 10),
                                           grids=((3, 1), (2, 2)),
                                           n_replicas=(2, 4)))
    assert len(compiled) == 16
    res = compiled.transient(ALPHA, n_clients=64, seeds=8, n_steps=3000,
                             **CPU)
    assert res.throughput.shape == (16, 8)
    assert res.flows.shape == (16, 8, 3000)
    peaks = compiled.peak_throughput(ALPHA)
    np.testing.assert_allclose(res.seed_mean_throughput(), peaks, rtol=0.10)


def test_seeded_determinism_and_seed_independence():
    d = demand_vector(CMP) / ALPHA
    a = P.simulate_transient(d, n_clients=32, seeds=(0, 1, 2, 3),
                             n_steps=2000, **CPU)
    b = P.simulate_transient(d, n_clients=32, seeds=(0, 1, 2, 3),
                             n_steps=2000, **CPU)
    np.testing.assert_array_equal(a.flows, b.flows)
    np.testing.assert_array_equal(a.hist, b.hist)
    c = P.simulate_transient(d, n_clients=32, seeds=(7, 8, 9, 10),
                             n_steps=2000, **CPU)
    assert not np.array_equal(a.flows, c.flows)
    assert float(c.throughput.mean()) == pytest.approx(
        float(a.throughput.mean()), rel=0.10)


def test_deterministic_service_is_seed_invariant():
    d = demand_vector(CMP) / ALPHA
    res = P.simulate_transient(d, n_clients=32, seeds=4, n_steps=2000,
                               exponential_service=False, **CPU)
    assert float(res.throughput.std()) == 0.0
    assert float(res.throughput.mean()) == pytest.approx(
        CMP.peak_throughput(ALPHA), rel=0.05)


def test_failover_trace_dips_and_recovers():
    d = demand_vector(CMP) / ALPHA
    sched, bounds = PT.failover_schedule(d, station=0, start=0.4, stop=0.6,
                                         n_steps=5000)
    res = P.simulate_transient(sched, bounds, n_clients=64, seeds=8,
                               n_steps=5000, **CPU)
    _, trace = res.throughput_trace(n_windows=20)
    xm = trace.mean(axis=1)[0]
    pre, dip, post = xm[3:8].mean(), xm[9:11].mean(), xm[15:].mean()
    assert pre > 0
    assert dip < 0.2 * pre
    assert post > 0.85 * pre
    assert float(res.latency_p99.mean()) > 2.0 * float(
        res.latency_p50.mean())


def test_scale_up_steps_throughput():
    m = P.compartmentalized_model(f=1, n_proxy_leaders=2, grid_rows=3,
                                  grid_cols=1, n_replicas=2)
    assert m.bottleneck()[0] == "proxy"
    d = demand_vector(m) / ALPHA
    sched, bounds = P.scale_schedule(d, station=1, at=0.5, factor=0.5,
                                     n_steps=5000)
    res = P.simulate_transient(sched, bounds, n_clients=64, seeds=8,
                               n_steps=5000, **CPU)
    _, trace = res.throughput_trace(n_windows=20)
    xm = trace.mean(axis=1)[0]
    assert xm[14:].mean() == pytest.approx(2.0 * xm[4:9].mean(), rel=0.15)


def test_zero_demand_window_serves_instead_of_stalling():
    m = P.compartmentalized_model(f=1, n_proxy_leaders=2, grid_rows=3,
                                  grid_cols=1, n_replicas=2)
    d = demand_vector(m) / ALPHA
    sched, bounds = P.scale_schedule(d, station=1, at=0.5, factor=0.0,
                                     n_steps=5000)
    res = P.simulate_transient(sched, bounds, n_clients=64, seeds=8,
                               n_steps=5000, **CPU)
    xm = res.window_throughput(bounds, settle=0.3).mean(axis=1)[0]
    assert xm[1] > 1.5 * xm[0]


def test_step_bounds_must_start_at_zero():
    d = demand_vector(CMP) / ALPHA
    sched = np.repeat(d[None, None, :], 2, axis=0)
    with pytest.raises(ValueError):
        P.simulate_transient(sched, np.array([100, 300]), n_steps=1000,
                             **CPU)
    with pytest.raises(ValueError):
        P.simulate_transient(sched, np.array([0, -5]), n_steps=1000, **CPU)


def test_window_throughput_respects_bottleneck_caps():
    m_slow = P.compartmentalized_model(f=1, n_proxy_leaders=2, grid_rows=3,
                                       grid_cols=1, n_replicas=2)
    m_fast = P.compartmentalized_model(f=1, n_proxy_leaders=10, grid_rows=2,
                                       grid_cols=2, n_replicas=4)
    windows = [demand_vector(m_slow) / ALPHA, demand_vector(m_fast) / ALPHA]
    sched, bounds = P.schedule_from_demands(windows, [0.0, 0.5],
                                            n_steps=6000)
    res = P.simulate_transient(sched, bounds, n_clients=128, seeds=8,
                               n_steps=6000, **CPU)
    xm = res.window_throughput(bounds, settle=0.5).mean(axis=1)[0]
    caps = (m_slow.peak_throughput(ALPHA), m_fast.peak_throughput(ALPHA))
    for x, cap in zip(xm, caps):
        assert x <= cap * 1.05
        assert x >= cap * 0.80


def test_schedule_builders():
    base = np.array([[1.0, 2.0, 0.0]])
    sched, bounds = P.build_schedule(
        base, [P.Event(0, 0.25, 0.75, 10.0), P.Event(1, 0.5, 0.75, 2.0)],
        n_steps=100)
    assert list(bounds) == [0, 25, 50, 75]
    np.testing.assert_allclose(sched[:, 0, 0], [1.0, 10.0, 10.0, 1.0])
    np.testing.assert_allclose(sched[:, 0, 1], [2.0, 2.0, 4.0, 2.0])
    s2, _ = P.build_schedule(np.ones((1, 8)),
                             [P.Event("leader", 0.0, 1.0, 3.0)], n_steps=10)
    assert s2[0, 0, 1] == 3.0
    with pytest.raises(ValueError):
        P.schedule_from_demands([base, base], [0.1, 0.5], n_steps=100)
    with pytest.raises(ValueError):
        P.schedule_from_demands([base], [0.0, 0.5], n_steps=100)
    sched2, bounds2 = P.schedule_from_demands([base, 2 * base], [0.0, 0.5],
                                              n_steps=100)
    assert list(bounds2) == [0, 50]
    np.testing.assert_allclose(sched2[1], 2 * base)


# ---------------------------------------------------------------------------
# Twins of the transient cases in the other reference test files
# ---------------------------------------------------------------------------


def test_skip_storm_transient_dips_and_recovers():
    sched, bounds = P.mencius_skip_storm_schedule(
        P.calibrate_alpha(), n_leaders=3, skip_fraction=0.5,
        slow_factor=3.0, n_steps=4000, n_proxy_leaders=10, grid_rows=2,
        grid_cols=2, n_replicas=4)
    res = P.simulate_transient(sched, bounds, n_clients=32, seeds=4,
                               n_steps=4000, **CPU)
    healthy, storm, healed = res.window_throughput(
        bounds, settle=0.4).mean(axis=1)[0]
    assert storm < 0.85 * healthy
    assert healed > 0.9 * healthy


def test_payload_ramp_transient_monotone_while_leader_flat():
    factors = (1.0, 3.0, 9.0)
    sched, bounds = P.spaxos_payload_ramp_schedule(
        P.calibrate_alpha(), payload_factors=factors, n_steps=3000,
        n_disseminators=4, n_stabilizers=5)
    res = P.simulate_transient(sched, bounds, n_clients=32, seeds=4,
                               n_steps=3000, **CPU)
    wt = res.window_throughput(bounds, settle=0.4).mean(axis=1)[0]
    assert wt[0] > wt[1] > wt[2]
    leader_col = P.STATION_ORDER.index("leader")
    np.testing.assert_allclose(sched[:, 0, leader_col],
                               sched[0, 0, leader_col])


def test_transient_throughput_shim():
    with pytest.warns(DeprecationWarning, match="f_write"):
        res = P.transient_throughput(P.multipaxos_model(), ALPHA,
                                     n_clients=8, f_write=0.5, n_steps=400,
                                     seeds=2, **CPU)
    assert res.throughput.shape == (1, 2)


def _resharding_sweep():
    return P.compile_sweep(P.SweepSpec(n_proxy_leaders=(3,),
                                       grids=((2, 2),), n_replicas=(2,)))


def test_resharding_transient_shape():
    w = P.Workload(f_write=1.0, skew_p=0.6)
    sh = P.ShardingSpec(2)
    base = _resharding_sweep().demands(w)[0:1] / ALPHA
    sched, bounds = P.resharding_schedule(base, sh, start=0.4, stop=0.55,
                                          n_steps=1200, workload=w)
    assert sched.shape[0] == 3
    assert sched.shape[-1] == 3 * len(P.STATION_ORDER)
    tr = P.simulate_transient(sched, bounds, n_clients=32, seeds=4,
                              n_steps=1200, **CPU)
    x = tr.window_throughput(bounds)[0].mean(axis=0)
    pre_x, dip_x, post_x = float(x[0]), float(x[1]), float(x[2])
    assert pre_x > 0
    assert dip_x < 0.6 * pre_x, (dip_x, pre_x)
    assert post_x > 1.1 * pre_x, (post_x, pre_x)


def _completion_rate(history, t0, t1):
    n = sum(1 for o in history.ops
            if o.response_time is not None and t0 <= o.response_time < t1)
    return n / (t1 - t0)


def test_leader_crash_replay_matches_transient_dip():
    """The port's transient prediction of a leader crash and the port's
    real cluster replaying it show the same dip-and-recover shape, and
    the history stays linearizable across the failover."""
    alpha = P.calibrate_alpha()
    model = P.variant_spec("compartmentalized").model(
        P.default_config("compartmentalized"), P.WRITE_ONLY)
    base = demand_vector(model, f_write=1.0) / alpha
    sched, bounds = P.failover_schedule(base, "leader", start=0.35,
                                        stop=0.6, n_steps=1200)
    tr = P.simulate_transient(sched, bounds, n_clients=16, seeds=4,
                              n_steps=1200, **CPU)
    centers, x = tr.throughput_trace(n_windows=24)
    frac = centers[0] / centers[0, -1] / (24 / 23.5)
    pre_p = x[0, :, (frac > 0.05) & (frac < 0.3)].mean()
    dip_p = x[0, :, (frac > 0.4) & (frac < 0.55)].mean()
    post_p = x[0, :, (frac > 0.7)].mean()
    assert dip_p < 0.25 * pre_p, (dip_p, pre_p)
    assert post_p > 0.4 * pre_p, (post_p, pre_p)

    cfg = P.DeploymentConfig(f=1, n_proxy_leaders=3, grid=(2, 2),
                             n_replicas=2, state_machine="register", seed=0,
                             client_retries=True, auto_failover=True)
    dep = P.CompartmentalizedMultiPaxos(cfg, n_clients=2)
    for i, c in enumerate(dep.clients):
        c.run_ops([("w", 1000 * i + j) for j in range(300)])
    dep.net.run(until=400)
    dep.net.crash("leader/0")
    dep.net.run(until=1_600)
    assert dep.leaders[1].active, "heartbeats must promote a new leader"
    for c in dep.clients:
        c.leader = "leader/1"
    dep.net.run(until=3_000)
    pre = _completion_rate(dep.history, 0, 400)
    dip = _completion_rate(dep.history, 500, 1_500)
    post = _completion_rate(dep.history, 1_700, 3_000)
    assert pre > 0
    assert dip < 0.25 * pre, (dip, pre)
    assert post > 0.4 * pre, (post, pre)
    assert P.check_linearizable(dep.history, "register")


def _keys_on(sh, shard, tag, n):
    out, i = [], 0
    while len(out) < n:
        k = f"{tag}{i}"
        if sh.shard_of(k) == shard:
            out.append(k)
        i += 1
    return out


def _stream(rng, keys, n, tag):
    ops, v = [], 0
    for _ in range(n):
        k = rng.choice(keys)
        if rng.random() < 0.7:
            ops.append(("put", k, f"{tag}{v}"))
            v += 1
        else:
            ops.append(("get", k))
    return ops


def test_live_resharding_replay_matches_transient_shape():
    """The hot-shard split, predicted by the port's transient engine and
    replayed on the port's real sharded cluster: both dip while the hot
    shard is dark and recover above the pre-split rate; every history
    stays per-key-partition linearizable and the moved keys keep their
    values."""
    from repro_torch.core.sharding import op_key

    w = P.Workload(f_write=1.0, skew_p=0.6)
    sh = P.ShardingSpec(n_shards=2)
    base = _resharding_sweep().demands(w)[0:1] / ALPHA
    sched, bounds = P.resharding_schedule(base, sh, start=0.4, stop=0.55,
                                          n_steps=1200, workload=w)
    x = P.simulate_transient(sched, bounds, n_clients=32, seeds=4,
                             n_steps=1200, **CPU
                             ).window_throughput(bounds)[0].mean(axis=0)
    assert x[1] < 0.6 * x[0] and x[2] > 1.1 * x[0]

    cfg = {"f": 1, "n_proxy_leaders": 3, "grid_rows": 2, "grid_cols": 2,
           "n_replicas": 2}
    hot = 1
    cold_keys = _keys_on(sh, 0, "c", 4)
    keep_keys = _keys_on(sh, hot, "p", 3)
    move_keys = _keys_on(sh, hot, "m", 3)
    move_set = set(move_keys)
    rng = random.Random(7)
    sd = P.ShardedDeployment("compartmentalized", sh, config=cfg,
                             n_clients=2, seed=3)
    parts = sd.submit(_stream(rng, cold_keys, 1000, "a")
                      + _stream(rng, keep_keys + move_keys, 1400, "h"))
    assert len(parts[0]) == 1000 and len(parts[hot]) == 1400
    sd.step_all(until=500.0)
    pre_counts = sd.completed_counts()
    pre = sum(pre_counts) / 500.0
    assert all(c > 0 for c in pre_counts), pre_counts
    for c in sd.shards[hot].clients:
        c.ops[c.op_index:] = [op for op in c.ops[c.op_index:]
                              if op_key(op) not in move_set]
    sd.step_all(until=1300.0, skip=(hot,))
    mid_counts = sd.completed_counts()
    dip = sum(m - p for m, p in zip(mid_counts, pre_counts)) / 800.0
    assert mid_counts[hot] == pre_counts[hot]
    sd.shards[hot].net.run(until=1320.0)
    last = {}
    for o in sorted(sd.shards[hot].history.complete(),
                    key=lambda o: o.response_time):
        if o.op[0] == "put" and o.op[1] in move_set:
            last[o.op[1]] = o.op[2]
    assert last
    dest = P.ShardedDeployment("compartmentalized", P.ShardingSpec(1),
                               config=cfg, n_clients=2, seed=11)
    rng2 = random.Random(11)
    for j, client in enumerate(dest.shards[0].clients):
        mine = [k for i, k in enumerate(move_keys) if i % 2 == j]
        seeded = [k for k in mine if k in last]
        ops = ([("put", k, last[k]) for k in seeded]
               + [("get", k) for k in seeded]
               + (_stream(rng2, mine, 350, f"d{j}") if mine else []))
        if ops:
            client.run_ops(ops)
    post_base = sd.completed_counts()
    sd.step_all(until=2600.0)
    dest.step_all(until=1300.0)
    post_counts = sd.completed_counts()
    post = (sum(p - b for p, b in zip(post_counts, post_base))
            + dest.completed_counts()[0]) / 1300.0
    assert pre > 0
    assert dip < 0.6 * pre, (dip, pre)
    assert post > 1.1 * pre, (post, pre)
    for h in sd.histories + dest.histories:
        assert P.check_linearizable_partitioned(h)
    first_get = {}
    for o in sorted(dest.shards[0].history.complete(),
                    key=lambda o: o.response_time):
        k = op_key(o.op)
        if o.op[0] == "get" and k in last and k not in first_get:
            first_get[k] = o.result
    assert first_get
    for k, v in first_get.items():
        assert v == last[k], (k, v, last[k])

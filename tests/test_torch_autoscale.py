"""The port's autoscale plane against the reference's.

``repro_torch.core.autoscale`` is the reference module carried over (numpy
only); its device work is the transient engine (the capacity probe, one
probe per control window and the full-horizon replay).  With the default
deterministic service both packages take the same actions and measure
the same windows bit for bit, and ``autotune_policy`` at the settings of
``benchmarks/autoscale.py`` reproduces ``BENCH_autoscale.json`` exactly.
Then twins of the reference's autoscale tests (the controller, the grid,
policy search, floors) and of its execution-plane autoscale tests, which
replay the port's plans on the port's real cluster.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core.api import STATION_INDEX, STATION_ORDER  # noqa: E402
from repro_torch.core.sweep import model_for  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ALPHA = P.calibrate_alpha()
W1 = P.Workload(f_write=1.0)
CPU = dict(device="cpu")

BASE = np.array([30e-6, 12e-6, 20e-6])
SRV = np.array([3, 2, 3])
NAMES = ("proxy", "acceptor", "replica")
FAST = dict(seeds=2, probe_steps=400, n_steps=1200, station_names=NAMES)
PFAST = dict(FAST, **CPU)


@pytest.fixture(autouse=True)
def _same_station_vocabulary():
    P.api._allocate_stations(tuple(R.STATION_ORDER))


def _policy(pkg, **kw):
    return pkg.AutoscalePolicy(**kw)


def _assert_traces_equal(a, b):
    """a: the reference's AutoscaleTrace, b: the port's."""
    assert b.label == a.label and b.stations == a.stations
    assert [(x.window, x.station, x.column, x.delta, x.count,
             x.utilization, x.queue_depth) for x in b.actions] == \
        [(x.window, x.station, x.column, x.delta, x.count, x.utilization,
          x.queue_depth) for x in a.actions]
    for field in ("servers0", "load", "population", "counts", "utilization",
                  "queue_depth", "throughput", "p99", "machines",
                  "step_bounds", "replay_window", "replay_spike"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field),
                                      err_msg=field)
    assert b.machine_time == a.machine_time
    for field in ("flows", "hist", "completed", "throughput", "latency_p99",
                  "latency_mean", "queue_sums"):
        np.testing.assert_array_equal(getattr(b.result, field),
                                      getattr(a.result, field),
                                      err_msg=f"result.{field}")


# ---------------------------------------------------------------------------
# Both packages, same plans
# ---------------------------------------------------------------------------


def test_autoscale_grid_matches_reference():
    kw = dict(target_low=0.4, target_high=0.7, cooldown_windows=0,
              min_counts=(("proxy", 2),))
    load = np.asarray(R.diurnal_load(6, low=0.3, sharpness=2.0))
    a = R.autoscale_grid(np.stack([BASE, BASE]), np.stack([SRV, SRV]),
                         [_policy(R, **kw), None], load, **FAST)
    b = P.autoscale_grid(np.stack([BASE, BASE]), np.stack([SRV, SRV]),
                         [_policy(P, **kw), None], load, **PFAST)
    np.testing.assert_array_equal(P.diurnal_load(6, low=0.3, sharpness=2.0),
                                  load)
    for x, y in zip(a, b):
        _assert_traces_equal(x, y)
    assert b[0].actions


def test_compiled_sweep_autoscale_matches_reference():
    kw = dict(target_low=0.4, target_high=0.7, cooldown_windows=0)
    spec = dict(n_proxy_leaders=(3, 4), n_replicas=(3,))
    common = dict(workload=dict(f_write=1.0), seeds=2, probe_steps=400,
                  n_steps=1200)

    def run(pkg, **extra):
        grid = pkg.compile_sweep(pkg.SweepSpec(**spec))
        c = dict(common, workload=pkg.Workload(**common["workload"]))
        return grid.autoscale(ALPHA, [_policy(pkg, **kw), None],
                              pkg.diurnal_load(4, low=0.35), **c, **extra)
    for x, y in zip(run(R), run(P, **CPU)):
        _assert_traces_equal(x, y)


def test_autotune_policy_reproduces_the_benchmark():
    """``autotune_policy`` at the settings of ``benchmarks/autoscale.py``
    (32 diurnal windows, 3 seeds, 4800 steps, deterministic service) gives
    ``BENCH_autoscale.json``'s numbers exactly."""
    want = json.loads((ROOT / "BENCH_autoscale.json").read_text())
    cfg = {"variant": "compartmentalized", "f": 1, "n_proxy_leaders": 8,
           "grid_rows": 2, "grid_cols": 2, "n_replicas": 6,
           "n_batchers": 3, "n_unbatchers": 3}
    floors = (("proxy", 3), ("replica", 2), ("batcher", 2),
              ("unbatcher", 2))
    m = model_for(dict(cfg), W1)
    d_w, _, servers = m.demand_slots()
    k = len(STATION_ORDER)
    base = np.asarray(d_w[:k], dtype=np.float64) / ALPHA
    srv = np.asarray(servers[:k], dtype=np.int64)
    rz = P.resizable_stations("compartmentalized", cfg)
    policies = (
        P.AutoscalePolicy(target_low=0.4, target_high=0.65,
                          cooldown_windows=0, min_counts=floors),
        P.AutoscalePolicy(target_low=0.35, target_high=0.6,
                          cooldown_windows=0, min_counts=floors),
        P.AutoscalePolicy(target_low=0.4, target_high=0.65,
                          cooldown_windows=0, min_counts=floors,
                          queue_high=1.0),
    )
    tune = P.autotune_policy(
        policies, base, srv, P.diurnal_load(want["windows"], low=0.15,
                                            sharpness=2.0),
        p99_slack=1.0, seeds=3, n_steps=4800, resizable=[rz] * 4, **CPU)
    saved = 1.0 - tune.winner.machine_time / tune.static.machine_time
    assert int(srv.sum()) == want["static_machines"] == 25
    assert tune.winner.machine_time == 17.78125
    assert round(tune.winner.machine_time, 4) == \
        want["machine_time_autoscaled"]
    assert tune.static.machine_time == want["machine_time_static"] == 25.0
    assert round(saved, 4) == want["machine_hours_saved_fraction"] == 0.2887
    assert float(tune.winner.peak_p99) == want["peak_p99_autoscaled_s"]
    assert float(tune.static.peak_p99) == want["peak_p99_static_s"]
    assert tune.winner.policy.describe() == want["winner_policy"]
    assert int(tune.winner.trace.machines.min()) == \
        want["trough_floor_machines"] == 14
    assert len(tune.winner.trace.actions) == want["resizes"] == 27


def test_autoscale_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pol = P.AutoscalePolicy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.Controller(pol).run(BASE, SRV, P.diurnal_load(4), **FAST)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.autotune_policy((pol,), BASE, SRV, P.diurnal_load(4), **FAST)


# ---------------------------------------------------------------------------
# Twins of the reference's autoscale tests
# ---------------------------------------------------------------------------


def test_policy_validates_and_normalizes():
    p = P.AutoscalePolicy(min_counts=(("proxy", 2),),
                          max_counts=(("proxy", 5), ("replica", 4)))
    assert p.min_for("proxy") == 2
    assert p.min_for("replica") == 1
    assert p.max_for("proxy") == 5
    assert p.max_for("acceptor") is None
    assert "band [0.45, 0.75]" in p.describe()
    for bad in (dict(target_low=0.8, target_high=0.6),
                dict(target_high=1.5), dict(queue_high=-1.0),
                dict(cooldown_windows=-1), dict(min_counts=(("proxy", 0),)),
                dict(max_counts=(("proxy", 2), ("proxy", 3))),
                dict(min_counts=(("proxy", 5),), max_counts=(("proxy", 3),)),
                dict(machine_budget=0), dict(spike_factor=0.9)):
        with pytest.raises(ValueError):
            P.AutoscalePolicy(**bad)
    with pytest.raises(TypeError):
        P.Controller("not a policy")


def test_diurnal_load_shape_and_sharpness():
    load = P.diurnal_load(12, low=0.25, high=1.0)
    assert load.shape == (12,)
    assert np.isclose(load.min(), 0.25, atol=0.02)
    assert np.isclose(load.max(), 1.0, atol=0.02)
    assert load.argmax() in (5, 6)
    sharp = P.diurnal_load(12, low=0.25, sharpness=2.0)
    assert sharp.sum() < load.sum()
    assert np.isclose(sharp.max(), load.max(), atol=0.02)
    np.testing.assert_array_equal(sharp, R.diurnal_load(12, low=0.25,
                                                        sharpness=2.0))
    for bad in (dict(n_windows=1), dict(n_windows=8, low=0.0),
                dict(n_windows=8, low=0.9, high=0.5),
                dict(n_windows=8, sharpness=0.0)):
        with pytest.raises(ValueError):
            P.diurnal_load(**bad)


def test_flash_crowd_load_plateau():
    load = P.flash_crowd_load(16, base=0.3, peak=1.0, start=0.5, width=0.25)
    assert load.shape == (16,)
    assert np.isclose(load.min(), 0.3)
    plateau = np.nonzero(load == 1.0)[0]
    assert np.array_equal(plateau, np.arange(8, 12))
    with pytest.raises(ValueError):
        P.flash_crowd_load(1)
    with pytest.raises(ValueError):
        P.flash_crowd_load(8, base=0.8, peak=0.5)


def test_reconfiguration_schedule_spikes_one_station_or_whole_row():
    rows = [np.array([2e-5, 1e-5]), np.array([4e-5, 1e-5])]
    starts = [0.0, 0.5]
    dem, bounds = P.reconfiguration_schedule(
        rows, starts, 1000, actions=[(1, "leader")],
        spike_factor=2.0, spike_fraction=0.25)
    assert dem.shape == (3, 1, 2)
    assert np.array_equal(bounds, [0, 500, 625])
    col = STATION_INDEX["leader"]
    assert dem[1, 0, col] == pytest.approx(2.0 * rows[1][col])
    assert dem[1, 0, 1 - col] == pytest.approx(rows[1][1 - col])
    assert np.allclose(dem[2, 0], rows[1])
    dem2, bounds2 = P.reconfiguration_schedule(
        rows, starts, 1000, actions=[(1, None)],
        spike_factor=2.0, spike_fraction=0.25)
    assert np.array_equal(bounds2, bounds)
    assert np.allclose(dem2[1, 0], 2.0 * rows[1])
    assert np.allclose(dem2[2, 0], rows[1])
    _, bounds3 = P.reconfiguration_schedule(rows, starts, 1000,
                                            extra_cuts=[0.25])
    assert np.array_equal(bounds3, [0, 250, 500])
    with pytest.raises(ValueError):
        P.reconfiguration_schedule(rows, starts, 1000, actions=[(1, "tail")])
    with pytest.raises(ValueError):
        P.reconfiguration_schedule(rows, starts, 1000, spike_factor=0.5)


@pytest.fixture(scope="module")
def two_lane():
    pol = P.AutoscalePolicy(target_low=0.4, target_high=0.7,
                            cooldown_windows=0, min_counts=(("proxy", 2),))
    return P.autoscale_grid(
        np.stack([BASE, BASE]), np.stack([SRV, SRV]), [pol, None],
        P.diurnal_load(6, low=0.3, sharpness=2.0), **PFAST)


def test_elastic_lane_breathes_with_the_diurnal_cycle(two_lane):
    el, st = two_lane
    assert el.counts.shape == (6, 3)
    assert len(el.actions) > 0
    assert el.machines.min() < el.machines.max()
    assert el.machine_time < st.machine_time
    assert np.array_equal(el.machines, el.counts.sum(axis=1))
    assert el.machine_time == pytest.approx(el.machines.mean())
    assert el.counts[:, 0].min() >= 2
    assert all(1 <= a.window <= 5 for a in el.actions)
    assert "drain" in el.describe() or "add" in el.describe()


def test_static_lane_is_frozen(two_lane):
    _, st = two_lane
    assert st.policy is None
    assert st.actions == ()
    assert (st.counts == st.counts[0]).all()
    assert st.machine_time == pytest.approx(float(SRV.sum()))


def test_replay_grid_and_predicted_dips(two_lane):
    el, st = two_lane
    assert np.array_equal(el.step_bounds, st.step_bounds)
    assert np.all(np.diff(el.step_bounds) > 0)
    assert el.replay_window.min() == 0 and el.replay_window.max() == 5
    action_windows = {a.window for a in el.actions}
    for w in range(6):
        dip = el.predicted_dip(w)
        if w in action_windows:
            assert dip is not None and 0.0 < dip < 1.0
        else:
            assert dip is None
    assert not st.replay_spike.any()
    assert el.replay_spike.any()
    assert el.replay_rates().shape == el.step_bounds.shape


def test_plan_is_plain_data(two_lane):
    el, _ = two_lane
    plan = el.plan()
    assert len(plan) == len(el.actions)
    for row, act in zip(plan, el.actions):
        assert set(row) == {"window", "station", "delta"}
        assert row["station"] in NAMES
        assert row["delta"] in (-1, 1)
        assert row["window"] == act.window


def test_grid_input_validation():
    with pytest.raises(ValueError):
        P.autoscale_grid(BASE[None, :], SRV[None, :], [None, None],
                         P.diurnal_load(4), **CPU)
    with pytest.raises(ValueError):
        P.autoscale_grid(BASE[None, :], np.array([[3, 2]]), [None],
                         P.diurnal_load(4), **CPU)
    ctl = P.Controller(P.AutoscalePolicy())
    with pytest.raises(ValueError):
        ctl.run(BASE, SRV, np.array([1.0]), **CPU)
    with pytest.raises(ValueError):
        ctl.run(BASE, SRV, np.array([0.5, -0.1, 0.5]), **CPU)
    with pytest.raises(ValueError):
        ctl.run(BASE, SRV, P.diurnal_load(4), peak_utilization=1.5, **CPU)
    with pytest.raises(ValueError):
        ctl.run(BASE, SRV, P.diurnal_load(4), station_names=("a", "b"),
                **CPU)


def test_constant_load_converges_to_zero_actions():
    pol = P.AutoscalePolicy(target_low=0.4, target_high=0.75,
                            cooldown_windows=0)
    tr = P.Controller(pol).run(BASE, SRV, np.full(8, 0.55), **PFAST)
    assert all(a.window <= 2 for a in tr.actions)
    assert (tr.counts[3:] == tr.counts[3]).all()


def test_machine_budget_caps_total_provisioning():
    pol = P.AutoscalePolicy(target_low=0.4, target_high=0.6,
                            cooldown_windows=0, queue_high=1.0,
                            machine_budget=int(SRV.sum()))
    tr = P.Controller(pol).run(
        BASE, SRV, P.flash_crowd_load(8, base=0.3, start=0.4, width=0.4),
        **PFAST)
    assert tr.peak_machines <= int(SRV.sum())


def test_resizable_restricts_actions_to_named_stations():
    pol = P.AutoscalePolicy(target_low=0.4, target_high=0.7,
                            cooldown_windows=0)
    tr = P.Controller(pol).run(BASE, SRV,
                               P.diurnal_load(6, low=0.3, sharpness=2.0),
                               resizable=[("proxy",)], **PFAST)
    assert tr.actions and all(a.station == "proxy" for a in tr.actions)
    assert (tr.counts[:, 1] == SRV[1]).all()
    assert (tr.counts[:, 2] == SRV[2]).all()


@pytest.fixture(scope="module")
def band_sweep():
    pols = tuple(P.AutoscalePolicy(target_low=lo, target_high=hi,
                                   cooldown_windows=0)
                 for lo, hi in ((0.3, 0.55), (0.4, 0.65), (0.5, 0.8)))
    return P.autotune_policy(pols, BASE, SRV,
                             P.diurnal_load(6, low=0.3, sharpness=2.0),
                             p99_slack=10.0, **PFAST)


def test_machine_time_monotone_in_utilization_band(band_sweep):
    mts = [c.machine_time for c in band_sweep.choices[:-1]]
    assert all(a >= b for a, b in zip(mts, mts[1:]))


def test_autotune_policy_picks_cheapest_within_slack(band_sweep):
    tune = band_sweep
    assert len(tune.choices) == 4
    assert tune.static.policy is None
    assert tune.static is tune.choices[-1]
    assert tune.winner in tune.choices
    assert tune.winner.machine_time == min(c.machine_time
                                           for c in tune.choices)
    assert tune.winner.machine_time < tune.static.machine_time
    assert "saved" in tune.describe()


def test_autotune_policy_falls_back_to_static_under_tight_slack():
    pol = P.AutoscalePolicy(target_low=0.5, target_high=0.8,
                            cooldown_windows=0)
    tune = P.autotune_policy((pol,), BASE, SRV,
                             P.diurnal_load(4, low=0.3, sharpness=2.0),
                             p99_slack=1e-6, **PFAST)
    assert tune.winner.policy is None
    assert tune.winner is tune.static
    with pytest.raises(ValueError):
        P.autotune_policy((), BASE, SRV, P.diurnal_load(4), **CPU)
    with pytest.raises(ValueError):
        P.autotune_policy((pol,), BASE, SRV, P.diurnal_load(4),
                          p99_slack=0.0, **CPU)


def test_compiled_sweep_autoscale_is_config_major():
    pol = P.AutoscalePolicy(target_low=0.4, target_high=0.7,
                            cooldown_windows=0)
    grid = P.compile_sweep(P.SweepSpec(n_proxy_leaders=(3, 4),
                                       n_replicas=(3,)))
    traces = grid.autoscale(ALPHA, [pol, None], P.diurnal_load(4, low=0.35),
                            workload=W1, seeds=2, probe_steps=400,
                            n_steps=1200, **CPU)
    assert len(traces) == 2 * len(grid)
    assert [t.label for t in traces] == [
        "compartmentalized/p0", "compartmentalized/p1",
        "compartmentalized/p0", "compartmentalized/p1"]
    for m in range(len(grid)):
        assert traces[2 * m].policy is pol
        assert traces[2 * m + 1].policy is None
        assert traces[2 * m + 1].actions == ()
        srv = grid.models[m].demand_slots()[2]
        assert int(traces[2 * m].servers0.sum()) == int(sum(srv))
    assert not np.array_equal(traces[0].servers0, traces[2].servers0)


def test_min_counts_floor_filters_candidate_configs():
    pol = P.AutoscalePolicy(min_counts=(("proxy", 6),))
    free = P.variant_candidate_configs(14, variants=("compartmentalized",))
    floored = P.variant_candidate_configs(14, variants=("compartmentalized",),
                                          policy=pol)
    assert 0 < len(floored) < len(free)
    col = STATION_INDEX["proxy"]
    for cfg in floored:
        srv = model_for(cfg).demand_slots()[2]
        assert srv[col] == 0 or srv[col] >= 6


def test_autotune_variants_respects_policy_floors():
    pol = P.AutoscalePolicy(min_counts=(("proxy", 6),))
    res = P.autotune_variants(14, ALPHA, W1, variants=("compartmentalized",),
                              policy=pol)
    col = STATION_INDEX["proxy"]
    assert res.winner.model.demand_slots()[2][col] >= 6
    assert res.winner.machines <= 14


# ---------------------------------------------------------------------------
# Twins of the reference's execution-plane autoscale tests
# ---------------------------------------------------------------------------

W = P.Workload(f_write=0.5)


def test_station_knob_map_is_a_true_resize_handle(executable_variant):
    name = executable_variant
    mapping = P.station_knob_map(name)
    assert P.resizable_stations(name) == tuple(sorted(mapping))
    spec = P.variant_spec(name)
    cfg = P.default_config(name)
    base = list(spec.model(cfg, W).demand_slots()[2])
    for station, key in mapping.items():
        assert station in list(STATION_ORDER)
        col = list(STATION_ORDER).index(station)
        up = P.resize_config(name, cfg, station, +1)
        assert up[key] == cfg[key] + 1
        srv = list(spec.model(up, W).demand_slots()[2])
        assert srv[col] == base[col] + 1
        srv[col] -= 1
        assert srv == base
    if not mapping:
        with pytest.raises(ValueError):
            P.resize_config(name, cfg, "proxy", +1)


def test_resize_config_validation():
    cfg = P.default_config("compartmentalized")
    with pytest.raises(ValueError):
        P.resize_config("compartmentalized", cfg, "acceptor", +1)
    with pytest.raises(ValueError):
        P.resize_config("compartmentalized", cfg, "tail", +1)
    with pytest.raises(ValueError):
        P.resize_config("compartmentalized", dict(cfg, n_replicas=1),
                        "replica", -1)
    out = P.resize_config("compartmentalized", cfg, "proxy", -1)
    assert out["n_proxy_leaders"] == cfg["n_proxy_leaders"] - 1
    assert cfg == P.default_config("compartmentalized")


def test_run_autoscaled_plain_plan_adds_a_proxy():
    exe = P.run_autoscaled(
        "compartmentalized",
        [{"window": 1, "station": "proxy", "delta": 1}],
        load=[1.0, 1.0, 0.6], workload=W, n_commands_per_window=18, seed=1)
    assert exe.passed and exe.linearizable and exe.continuity_ok
    assert len(exe.epochs) == 2
    assert (exe.final_config["n_proxy_leaders"]
            == exe.initial_config["n_proxy_leaders"] + 1)
    assert exe.machines[1] == exe.machines[0] + 1
    assert exe.machines[2] == exe.machines[1]
    assert len(exe.dip_rows) == 1
    assert exe.dip_rows[0]["predicted"] is None and exe.dip_rows[0]["ok"]
    assert exe.window_rates[1] < exe.serve_rates[1]
    assert "autoscaled over 3 windows" in exe.describe()


def test_every_resizable_variant_replays_linearizably(executable_variant):
    name = executable_variant
    rz = P.resizable_stations(name)
    if not rz:
        # no resize handles: a plan that resizes anything is refused
        with pytest.raises(ValueError):
            P.run_autoscaled(name,
                             [{"window": 1, "station": "proxy", "delta": 1}],
                             load=[1.0, 1.0], workload=W)
        return
    exe = P.run_autoscaled(name,
                           [{"window": 1, "station": rz[0], "delta": 1}],
                           load=[1.0, 1.0], workload=W,
                           n_commands_per_window=12, seed=2)
    assert exe.passed, exe.describe()
    assert exe.machines[1] == exe.machines[0] + 1
    assert len(exe.epochs) == 2


def test_run_autoscaled_rejects_bad_plans():
    for plan, load, name in (
            ([{"window": 9, "station": "proxy", "delta": 1}], [1.0, 1.0],
             "compartmentalized"),
            ([{"window": 1, "station": "acceptor", "delta": 1}], [1.0, 1.0],
             "compartmentalized"),
            ([], [], "compartmentalized"),
            ([{"window": 1, "station": "proxy", "delta": 1}], [1.0, 1.0],
             "vanilla_multipaxos")):
        with pytest.raises(ValueError):
            P.run_autoscaled(name, plan, load=load, workload=W)


def test_controller_plan_replays_linearizably_with_dip_parity():
    """A plan from the port's transient plane, replayed on the port's real
    cluster: linearizable and state-continuous across every resize, each
    action window's measured dip within tolerance of the transient
    prediction - and the plan itself equal to the reference's."""
    exe_cfg = {"f": 1, "n_proxy_leaders": 4, "grid_rows": 2,
               "grid_cols": 2, "n_replicas": 3}
    kw = dict(alpha=ALPHA, seeds=2, probe_steps=500, n_steps=2000)
    ctl = P.Controller(P.AutoscalePolicy(target_low=0.45, target_high=0.75,
                                         cooldown_windows=0))
    plan = ctl.run_config(exe_cfg, P.diurnal_load(5, low=0.35), workload=W1,
                          **kw, **CPU)
    ref = R.Controller(R.AutoscalePolicy(
        target_low=0.45, target_high=0.75, cooldown_windows=0)).run_config(
        exe_cfg, R.diurnal_load(5, low=0.35), workload=R.Workload(f_write=1.0),
        **kw)
    _assert_traces_equal(ref, plan)
    assert plan.label == "compartmentalized"
    assert len(plan.actions) > 0
    allowed = set(P.resizable_stations("compartmentalized", exe_cfg))
    assert {a.station for a in plan.actions} <= allowed

    exe = P.run_autoscaled("compartmentalized", plan, config=exe_cfg,
                           workload=W1, n_commands_per_window=24, seed=3)
    assert exe.passed, exe.describe()
    assert exe.linearizable and exe.continuity_ok and exe.dips_ok
    assert len(exe.epochs) == len({a.window for a in plan.actions}) + 1
    assert list(exe.machines) == [int(m) for m in plan.machines]
    preds = [r for r in exe.dip_rows if r["predicted"] is not None]
    assert preds
    for r in preds:
        assert abs(r["measured"] - r["predicted"]) <= exe.tolerance
    assert all(got == want for _, want, got in exe.continuity)

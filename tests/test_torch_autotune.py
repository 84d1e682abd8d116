"""The port's autotuners against the reference's.

``repro_torch.core.autotune`` is the reference module carried over (numpy
only); its one device path is ``autotune(objective="p99_under_failover")``,
which ranks a shortlist by the transient engine's p99.  Both packages give
the same Fig. 29 staircase, the same choices and the same scores -
exactly, the failover ranking included (deterministic service, and the
reference's own draws injected).  Then twins of the reference's autotune
tests, on the port.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core.analytical import PAPER_MULTIPAXOS_UNBATCHED  # noqa
from repro_torch.core.sweep import model_for  # noqa: E402

ALPHA = P.calibrate_alpha(PAPER_MULTIPAXOS_UNBATCHED)
CPU = dict(device="cpu")
W1 = P.Workload(f_write=1.0)
GEO_WAN = P.GeoSpec(regions=("us", "eu", "ap"),
                    rtt=((0, 80, 160), (80, 0, 120), (160, 120, 0)))
#: bottleneck_trace(budget=19) with the calibrated alpha: (machines, cmd/s
#: rounded, bottleneck) per rung - the paper's Fig. 29 staircase
FIG29 = [(3, 25_000, "leader"), (8, 46_296, "proxy"), (9, 69_444, "proxy"),
         (10, 92_593, "proxy"), (11, 104_167, "leader")]


@pytest.fixture(autouse=True)
def _same_station_vocabulary():
    P.api._allocate_stations(tuple(R.STATION_ORDER))


def _steps(trace):
    return [(t.step, t.label, t.config, t.machines, t.peak, t.bottleneck)
            for t in trace]


# ---------------------------------------------------------------------------
# Both packages, same answers
# ---------------------------------------------------------------------------


def test_fig29_staircase_exactly():
    trace = P.bottleneck_trace(budget=19, alpha=P.calibrate_alpha(),
                               workload=P.Workload())
    assert [(t.machines, round(t.peak), t.bottleneck)
            for t in trace] == FIG29
    assert _steps(trace) == _steps(R.bottleneck_trace(
        budget=19, alpha=R.calibrate_alpha(), workload=R.Workload()))


@pytest.mark.parametrize("workload", [dict(), dict(f_write=0.5),
                                      dict(f_write=0.1)],
                         ids=["write-only", "50% reads", "90% reads"])
@pytest.mark.parametrize("batching", [False, True],
                         ids=["unbatched", "batched"])
def test_autotune_matches_reference(workload, batching):
    a = R.autotune(budget=19, alpha=ALPHA, workload=R.Workload(**workload),
                   batching=batching)
    b = P.autotune(budget=19, alpha=ALPHA, workload=P.Workload(**workload),
                   batching=batching)
    assert b.best_config == a.best_config
    assert (b.best_peak, b.best_bottleneck, b.machines, b.n_candidates) == \
        (a.best_peak, a.best_bottleneck, a.machines, a.n_candidates)
    assert _steps(b.trace) == _steps(a.trace)


@pytest.mark.parametrize("exponential", [False, True],
                         ids=["deterministic", "injected-draws"])
def test_p99_under_failover_matches_reference(exponential):
    """The failover ranking runs the transient engine over the shortlist:
    same pick and the same p99, to the bit."""
    kw = dict(seeds=4, n_steps=1200, exponential_service=exponential)
    a = R.autotune(budget=14, alpha=ALPHA, workload=R.Workload(),
                   objective="p99_under_failover", shortlist=6,
                   transient_kwargs=kw)
    draws = None
    if exponential:
        k = len(R.STATION_ORDER)
        draws = np.stack([np.asarray(jax.random.exponential(
            jax.random.fold_in(jax.random.key(0), s), (1201, k)))
            for s in range(4)])
    b = P.autotune(budget=14, alpha=ALPHA, workload=P.Workload(),
                   objective="p99_under_failover", shortlist=6,
                   transient_kwargs=dict(kw, draws=draws, **CPU))
    assert b.objective == a.objective == "p99_under_failover"
    assert b.best_config == a.best_config
    assert b.best_p99 == a.best_p99 and np.isfinite(b.best_p99)


def test_autotune_variants_matches_reference():
    contenders = ("compartmentalized", "mencius", "spaxos", "craq")
    a = R.autotune_variants(budget=19, alpha=ALPHA, workload=R.Workload(),
                            variants=contenders)
    b = P.autotune_variants(budget=19, alpha=ALPHA, workload=P.Workload(),
                            variants=contenders)
    assert b.winner.variant == a.winner.variant
    assert b.n_candidates == a.n_candidates
    for v, c in a.per_variant.items():
        got = b.per_variant[v]
        assert (got.config, got.peak, got.machines, got.bottleneck) == \
            (c.config, c.peak, c.machines, c.bottleneck)
    assert P.variant_candidate_configs(14) == R.variant_candidate_configs(14)


def test_autotune_sharded_matches_reference():
    w = dict(f_write=1.0, skew_p=0.6)
    a = R.autotune_sharded(40, ALPHA, R.ShardingSpec(4),
                           workload=R.Workload(**w))
    b = P.autotune_sharded(40, ALPHA, P.ShardingSpec(4),
                           workload=P.Workload(**w))
    assert b.total_peak == a.total_peak
    assert b.bottleneck_shard == a.bottleneck_shard
    assert [(c.shard, c.budget, c.config, c.effective) for c in b.shards] \
        == [(c.shard, c.budget, c.config, c.effective) for c in a.shards]


def test_autotune_placement_beats_single_region():
    """At budget 12 the hub/eu placement wins at a worst-region p99 of 179
    against 216 for the best single region (eu), as in the reference."""
    tune = P.autotune_placement(budget=12, alpha=P.calibrate_alpha(),
                                geo=GEO_WAN, workload=P.Workload(f_write=0.2),
                                n_clients=64, **CPU)
    assert tune.best.machines <= 12
    assert tune.best.placement == "hub/eu"
    assert round(tune.best.worst_p99) == 179
    assert tune.single_region_best.placement == "single/eu"
    assert round(tune.single_region_best.worst_p99) == 216
    assert tune.best.worst_p99 < tune.single_region_best.worst_p99
    assert len(tune.best.region_p99) == len(GEO_WAN.regions)
    assert tune.best.worst_p99 == max(tune.best.region_p99)


# ---------------------------------------------------------------------------
# Twins of the reference's autotune tests
# ---------------------------------------------------------------------------


def test_autotune_meets_paper_deployment_at_same_budget():
    paper = P.compartmentalized_model(f=1, n_proxy_leaders=10, grid_rows=2,
                                      grid_cols=2, n_replicas=4)
    budget = paper.total_machines()
    res = P.autotune(budget=budget, alpha=ALPHA, workload=P.Workload())
    assert res.best_peak >= paper.peak_throughput(ALPHA) * (1 - 1e-9)
    assert res.machines <= budget
    assert res.best_bottleneck == "leader"


def test_autotune_trace_walks_paper_bottleneck_migration():
    trace = P.bottleneck_trace(budget=19, alpha=ALPHA, workload=P.Workload())
    bns = [t.bottleneck for t in trace]
    assert bns[0] == "leader"
    assert bns[1] == "proxy"
    assert bns[-1] == "leader"
    peaks = [t.peak for t in trace]
    assert all(b >= a * 0.999 for a, b in zip(peaks, peaks[1:]))
    assert all(t.machines <= 19 for t in trace)


def test_autotune_read_heavy_scales_replicas():
    res = P.autotune(budget=19, alpha=ALPHA,
                     workload=P.Workload.read_mix(0.9))
    res_w = P.autotune(budget=19, alpha=ALPHA, workload=P.Workload())
    assert res.best_peak > 2.0 * res_w.best_peak
    assert res.best_config["n_replicas"] > 2
    assert any("replica" in t.label for t in res.trace)


def test_autotune_batching_beats_unbatched():
    res_b = P.autotune(budget=19, alpha=ALPHA, workload=P.Workload(),
                       batching=True)
    res_u = P.autotune(budget=19, alpha=ALPHA, workload=P.Workload())
    assert res_b.best_peak > 2.0 * res_u.best_peak
    assert res_b.best_config["n_batchers"] >= 1


def test_autotune_respects_budget():
    for budget in (9, 12, 19):
        res = P.autotune(budget=budget, alpha=ALPHA,
                         workload=P.Workload(f_write=0.5))
        assert res.machines <= budget
        assert all(t.machines <= budget for t in res.trace)
    with pytest.raises(ValueError):
        P.autotune(budget=4, alpha=ALPHA)


def test_autotune_more_budget_never_hurts():
    peaks = [P.autotune(budget=b, alpha=ALPHA,
                        workload=P.Workload.read_mix(0.9)).best_peak
             for b in (10, 14, 19, 24)]
    assert all(b >= a * (1 - 1e-9) for a, b in zip(peaks, peaks[1:]))


def test_autotune_variants_budget_and_winner():
    res = P.autotune_variants(budget=19, alpha=P.calibrate_alpha(),
                              workload=P.Workload())
    assert set(res.per_variant) == {"compartmentalized", "mencius", "spaxos"}
    for choice in res.per_variant.values():
        assert choice.machines <= 19
        assert model_for(choice.config).stations == choice.model.stations
    assert res.winner.peak == max(c.peak for c in res.per_variant.values())
    assert res.winner.variant == "mencius"
    assert (res.winner.peak
            > res.per_variant["compartmentalized"].peak * (1 - 1e-9))


def test_autotune_budget30_with_multileader_contenders():
    contenders = ("compartmentalized", "mencius", "spaxos", "bpaxos", "iss")
    alpha = P.calibrate_alpha()
    res = P.autotune_variants(budget=30, alpha=alpha, workload=P.Workload(),
                              variants=contenders)
    ref = R.autotune_variants(budget=30, alpha=alpha, workload=R.Workload(),
                              variants=contenders)
    assert set(res.per_variant) == set(contenders)
    for choice in res.per_variant.values():
        assert choice.machines <= 30
    assert res.winner.peak == max(c.peak for c in res.per_variant.values())
    assert res.winner.variant == ref.winner.variant
    for v, c in ref.per_variant.items():
        assert (res.per_variant[v].config, res.per_variant[v].peak) == \
            (c.config, c.peak)


def test_autotune_reports_workload_adapted_model():
    w = P.Workload(f_write=0.05, skew_p=0.9, dirty_fraction=1.0)
    res = P.autotune_variants(budget=7, alpha=ALPHA, workload=w,
                              variants=("craq",))
    choice = res.per_variant["craq"]
    assert choice.bottleneck == choice.model.bottleneck(w)[0]
    assert choice.peak == pytest.approx(
        choice.model.peak_throughput(ALPHA, w))
    assert choice.bottleneck == "tail"


def test_autotune_variants_empty_budget_names_per_variant_minimums():
    with pytest.raises(ValueError) as exc:
        P.autotune_variants(budget=5, alpha=ALPHA, workload=P.Workload())
    msg = str(exc.value)
    assert "per-variant minimum machines" in msg
    for variant in ("compartmentalized", "mencius", "spaxos"):
        assert f"{variant} needs >= " in msg
    smallest = min(int(part.split(">= ")[1])
                   for part in msg.split("(")[1].rstrip(")").split(", "))
    res = P.autotune_variants(budget=smallest, alpha=ALPHA,
                              workload=P.Workload())
    assert res.winner.machines <= smallest


def test_autotune_sharded_uniform_is_balanced():
    res = P.autotune_sharded(40, ALPHA, P.ShardingSpec(4), workload=W1)
    budgets = [c.budget for c in res.shards]
    assert sum(budgets) <= 40
    assert max(budgets) - min(budgets) <= 1, budgets
    assert res.total_peak > 0


def test_autotune_sharded_skew_shifts_machines_to_hot_shard():
    w = P.Workload(f_write=1.0, skew_p=0.6)
    sh = P.ShardingSpec(4)
    res = P.autotune_sharded(40, ALPHA, sh, workload=w)
    budgets = {c.shard: c.budget for c in res.shards}
    hot = sh.hot_shard
    assert all(budgets[hot] > b for s, b in budgets.items() if s != hot), \
        budgets
    effs = [c.effective for c in res.shards]
    assert res.total_peak == pytest.approx(min(effs))
    assert res.bottleneck_shard in budgets


def test_autotune_sharded_rejects_starving_budgets():
    with pytest.raises(ValueError):
        P.autotune_sharded(7, ALPHA, P.ShardingSpec(4), workload=W1)


def test_autotune_placement_invariant_under_relabeling():
    alpha = P.calibrate_alpha()
    w = P.Workload(f_write=0.2)
    base = P.autotune_placement(budget=9, alpha=alpha, geo=GEO_WAN,
                                workload=w, n_clients=32, **CPU)
    ref = R.autotune_placement(
        budget=9, alpha=R.calibrate_alpha(), workload=R.Workload(f_write=0.2),
        geo=R.GeoSpec(regions=GEO_WAN.regions, rtt=GEO_WAN.rtt), n_clients=32)
    assert set(base.per_placement) == set(ref.per_placement)
    for name, c in ref.per_placement.items():
        got = base.per_placement[name]
        assert (got.config, got.machines, got.worst_p99, got.region_p99) \
            == (c.config, c.machines, c.worst_p99, c.region_p99)
    for perm in itertools.permutations(range(3)):
        tune = P.autotune_placement(budget=9, alpha=alpha,
                                    geo=GEO_WAN.relabeled(perm),
                                    workload=w, n_clients=32, **CPU)
        assert tune.best.placement == base.best.placement
        assert tune.best.worst_p99 == base.best.worst_p99
        assert set(tune.per_placement) == set(base.per_placement)
        for name, choice in base.per_placement.items():
            assert tune.per_placement[name].worst_p99 == choice.worst_p99
            assert tune.per_placement[name].machines == choice.machines


def test_p99_under_failover_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.autotune(budget=12, alpha=ALPHA, objective="p99_under_failover",
                   shortlist=2, transient_kwargs=dict(seeds=1, n_steps=10))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.autotune_placement(budget=9, alpha=ALPHA, geo=GEO_WAN,
                             n_clients=4)

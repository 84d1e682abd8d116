"""The port's registry and demand tables equal the reference's bit for bit.

The registry (``api.py``) and the demand tables (``analytical.py``) are
carried into ``repro_torch`` as framework-free files; the same variant
names, knob spaces and configs must lower to the same float64 demand rows,
server counts and calibration anchor.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402

VARIANTS = list(R.registered_variants())


@pytest.fixture(autouse=True)
def _same_station_vocabulary():
    """The station vocabulary is append-only and process-wide: a test file
    that ran earlier in this process may have registered variants with new
    stations into the reference.  Give the port the same columns, so both
    packages lower to the same K."""
    P.api._allocate_stations(tuple(R.STATION_ORDER))
WORKLOADS = [R.Workload(f_write=1.0), R.Workload.read_mix(0.9),
             R.Workload(f_write=0.5, skew_p=0.6)]


def _port_workload(w):
    return P.Workload(**{f: getattr(w, f)
                         for f in w.__dataclass_fields__})


def test_station_order_and_variant_sets_equal():
    assert tuple(P.STATION_ORDER) == tuple(R.STATION_ORDER)
    assert P.registered_variants() == R.registered_variants()
    assert P.executable_variants() == R.executable_variants()
    assert len(P.executable_variants()) == 10


def test_calibrate_alpha_equal():
    assert P.calibrate_alpha() == R.calibrate_alpha()
    assert P.calibrate_alpha(30_000.0) == R.calibrate_alpha(30_000.0)


@pytest.mark.parametrize("name", VARIANTS)
def test_demand_slots_and_stacks_equal(name):
    ref_spec, port_spec = R.variant_spec(name), P.variant_spec(name)
    assert port_spec.knob_names() == ref_spec.knob_names()
    ref_cfgs = list(ref_spec.configs(f=1))[:24]
    port_cfgs = list(port_spec.configs(f=1))[:24]
    assert port_cfgs == ref_cfgs
    ref_models = [ref_spec.model(c) for c in ref_cfgs]
    port_models = [port_spec.model(c) for c in port_cfgs]
    for a, b in zip(ref_models, port_models):
        assert b.demand_slots() == a.demand_slots()
    for a, b in zip(R.stack_demands(ref_models),
                    P.stack_demands(port_models)):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("w", WORKLOADS, ids=lambda w: w.describe())
def test_compiled_mixed_variant_sweep_equal(w):
    """compile_sweep over every registered variant, then the numpy planes:
    demands (with workload adapters), peaks, bottlenecks, top_k, subset."""
    spec = dict(variants=tuple(VARIANTS), n_proxy_leaders=(2, 5),
                n_replicas=(2, 4))
    ref = R.compile_sweep(R.SweepSpec(**spec))
    port = P.compile_sweep(P.SweepSpec(**spec))
    wp = _port_workload(w)
    assert port.configs == ref.configs
    np.testing.assert_array_equal(port.demand_write, ref.demand_write)
    np.testing.assert_array_equal(port.demand_read, ref.demand_read)
    np.testing.assert_array_equal(port.machines, ref.machines)
    np.testing.assert_array_equal(port.demands(wp), ref.demands(w))
    alpha = R.calibrate_alpha()
    np.testing.assert_array_equal(port.peak_throughput(alpha, wp),
                                  ref.peak_throughput(alpha, w))
    assert port.bottlenecks(wp) == ref.bottlenecks(w)
    assert port.top_k(alpha, 5, wp, budget=20) == \
        ref.top_k(alpha, 5, w, budget=20)
    sub = [0, 3, len(ref) - 1]
    np.testing.assert_array_equal(port.subset(sub).demands(wp),
                                  ref.subset(sub).demands(w))


def test_sharded_sweep_lowering_equal():
    shard = dict(n_shards=3)
    w = R.Workload(f_write=0.5, skew_p=0.5)
    ref = R.compile_sweep(R.SweepSpec(n_proxy_leaders=(2, 4)))
    port = P.compile_sweep(P.SweepSpec(n_proxy_leaders=(2, 4)))
    alpha = R.calibrate_alpha()
    np.testing.assert_array_equal(
        port.peak_throughput(alpha, _port_workload(w),
                             sharding=P.ShardingSpec(**shard)),
        ref.peak_throughput(alpha, w, sharding=R.ShardingSpec(**shard)))
    assert port.bottlenecks(_port_workload(w),
                            sharding=P.ShardingSpec(**shard)) == \
        ref.bottlenecks(w, sharding=R.ShardingSpec(**shard))

"""The port's batched execution entry points against the reference's.

``validate_batched``, ``measured_capacity``, ``CompiledSweep.execute`` and
the shard and region lanes of ``run_variant_batched`` on the CPU must
reproduce the reference's results, at the tolerances that
``tests/test_torch_batched_execution.py`` states; the port's own seeded
generator must drain every lane.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402

from test_torch_batched_execution import (  # noqa: E402
    N_CMDS,
    _assert_results_equal,
)


@pytest.fixture(autouse=True)
def _same_station_vocabulary():
    """The station vocabulary is append-only and process-wide: a test file
    that ran earlier in this process may have registered variants with new
    stations into the reference.  Give the port the same columns, so both
    packages lower to the same K."""
    P.api._allocate_stations(tuple(R.STATION_ORDER))


def test_port_generator_drains_and_is_seeded():
    """Without injected draws the exponential mode draws from a seeded
    torch.Generator: every lane drains, histogram mass equals the command
    count, and the same seeds give the same run."""
    kw = dict(workload=P.Workload(f_write=0.5), n_commands=24, seeds=2,
              exponential_service=True, device="cpu")
    a = P.run_variant_batched("compartmentalized", **kw)
    b = P.run_variant_batched("compartmentalized", **kw)
    np.testing.assert_array_equal(a.completed, 24)
    np.testing.assert_array_equal(a.hist.sum(axis=2), 24)
    np.testing.assert_array_equal(a.hist, b.hist)
    np.testing.assert_array_equal(a.throughput, b.throughput)
    assert np.all(a.latency_p50 <= a.latency_p99)


@pytest.mark.parametrize("name", ["compartmentalized", "iss"])
def test_validate_batched_rows_equal(name):
    a = R.validate_batched(name, workload=R.MIXED_50_50, n_commands=N_CMDS,
                           seeds=2)
    b = P.validate_batched(name, workload=P.MIXED_50_50, n_commands=N_CMDS,
                           seeds=2, device="cpu")
    assert b.passed == a.passed
    assert b.model_config == a.model_config
    assert [vars(r) for r in b.rows] == [vars(r) for r in a.rows]


def test_measured_capacity_matches_reference():
    a = R.measured_capacity("multipaxos", n_commands=64, seeds=2)
    b = P.measured_capacity("multipaxos", n_commands=64, seeds=2,
                            device="cpu")
    assert b == pytest.approx(a, rel=1e-6)


def test_compiled_sweep_execute_matches_reference():
    spec = dict(n_proxy_leaders=(2, 4), grids=((2, 2),), n_replicas=(2, 3))
    ref, port = R.compile_sweep(R.SweepSpec(**spec)), \
        P.compile_sweep(P.SweepSpec(**spec))
    assert len(port) == 4
    w = 0.9
    a = ref.execute(workload=R.Workload.read_mix(w), n_commands=64, seeds=3,
                    n_clients=8)
    b = port.execute(workload=P.Workload.read_mix(w), n_commands=64, seeds=3,
                     n_clients=8, device="cpu")
    _assert_results_equal(a, b)
    assert set(b.timings) == {"probe", "scan", "hist"}


def test_sharded_and_geo_lanes_match_reference():
    a = R.run_variant_batched("compartmentalized", workload=R.MIXED_50_50,
                              n_commands=N_CMDS, seeds=2,
                              sharding=R.ShardingSpec(n_shards=2))
    b = P.run_variant_batched("compartmentalized", workload=P.MIXED_50_50,
                              n_commands=N_CMDS, seeds=2,
                              sharding=P.ShardingSpec(n_shards=2),
                              device="cpu")
    _assert_results_equal(a, b)
    np.testing.assert_array_equal(b.lane_commands, a.lane_commands)
    rtt = ((0, 8, 16), (8, 0, 12), (16, 12, 0))
    a = R.run_variant_batched("multipaxos", workload=R.WRITE_ONLY,
                              n_commands=N_CMDS, seeds=2,
                              geo=R.GeoSpec(regions=("us", "eu", "ap"),
                                            rtt=rtt))
    b = P.run_variant_batched("multipaxos", workload=P.WRITE_ONLY,
                              n_commands=N_CMDS, seeds=2,
                              geo=P.GeoSpec(regions=("us", "eu", "ap"),
                                            rtt=rtt), device="cpu")
    _assert_results_equal(a, b)
    np.testing.assert_array_equal(b.wan_offset, a.wan_offset)

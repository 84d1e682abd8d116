"""The port's steady-state solves against the reference's.

MVA and the fluid pipeline run in float32 in both packages (the reference
never enables x64), as a loop over the client count / the steps batched
over configs.  The port repeats the arithmetic op by op; a row sum over
the K stations may be reduced in another order, so X and R are held at
float32 rtol 1e-5.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402

ALPHA = R.calibrate_alpha()
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _same_station_vocabulary():
    """The station vocabulary is append-only and process-wide: a test file
    that ran earlier in this process may have registered variants with new
    stations into the reference.  Give the port the same columns, so both
    packages lower to the same K."""
    P.api._allocate_stations(tuple(R.STATION_ORDER))


def _big_spec(mod):
    # the 100-config grid of tests/test_sweep.py
    return mod.SweepSpec(n_proxy_leaders=(1, 2, 4, 7, 10),
                         grids=((3, 1), (2, 2), (2, 3), (3, 3)),
                         n_replicas=(2, 3, 4, 5, 6), batch_sizes=(1,))


@pytest.fixture(scope="module")
def sweeps():
    ref, port = R.compile_sweep(_big_spec(R)), P.compile_sweep(_big_spec(P))
    assert len(ref) == len(port) == 100
    return ref, port


@pytest.mark.parametrize("f_write", [1.0, 0.1])
def test_batched_mva_matches_reference(sweeps, f_write):
    ref, port = sweeps
    c_ref, x_ref, r_ref = ref.mva(ALPHA, n_clients_max=64,
                                  workload=R.Workload(f_write=f_write))
    c, x, r = port.mva(ALPHA, n_clients_max=64,
                       workload=P.Workload(f_write=f_write), device="cpu")
    np.testing.assert_array_equal(c, c_ref)
    assert x.dtype == x_ref.dtype == np.float32
    np.testing.assert_allclose(x, x_ref, rtol=RTOL)
    np.testing.assert_allclose(r, r_ref, rtol=RTOL)


def test_single_model_mva_curve_matches_reference():
    m_ref, m_port = R.compartmentalized_model(), P.compartmentalized_model()
    _, x_ref, r_ref = R.mva_curve(m_ref, ALPHA, n_clients_max=48,
                                  f_write=0.5, think=1e-5)
    _, x, r = P.mva_curve(m_port, ALPHA, n_clients_max=48, f_write=0.5,
                          think=1e-5, device="cpu")
    np.testing.assert_allclose(x, x_ref, rtol=RTOL)
    np.testing.assert_allclose(r, r_ref, rtol=RTOL)


def test_batched_fluid_matches_reference(sweeps):
    ref, port = sweeps
    x_ref = ref.fluid(ALPHA, n_clients=128, sim_time=0.05)
    x = port.fluid(ALPHA, n_clients=128, sim_time=0.05, device="cpu")
    np.testing.assert_allclose(x, x_ref, rtol=RTOL)


def test_fluid_single_and_batch_match_reference():
    refs = [R.multipaxos_model(), R.compartmentalized_model()]
    ports = [P.multipaxos_model(), P.compartmentalized_model()]
    for a, b in zip(refs, ports):
        assert P.fluid_throughput(b, ALPHA, 64, sim_time=0.05,
                                  device="cpu") == pytest.approx(
            R.fluid_throughput(a, ALPHA, 64, sim_time=0.05), rel=RTOL)
    np.testing.assert_allclose(
        P.fluid_throughput_batch(ports, ALPHA, 64, sim_time=0.05,
                                 device="cpu"),
        R.fluid_throughput_batch(refs, ALPHA, 64, sim_time=0.05), rtol=RTOL)


def test_sharded_mva_and_geo_latency_match_reference():
    spec = dict(n_proxy_leaders=(2, 6), n_replicas=(2, 4))
    ref, port = R.compile_sweep(R.SweepSpec(**spec)), \
        P.compile_sweep(P.SweepSpec(**spec))
    _, x_ref, _ = ref.mva(ALPHA, n_clients_max=16,
                          sharding=R.ShardingSpec(n_shards=2))
    _, x, _ = port.mva(ALPHA, n_clients_max=16,
                       sharding=P.ShardingSpec(n_shards=2), device="cpu")
    np.testing.assert_allclose(x, x_ref, rtol=RTOL)
    rtt = ((0, 8, 16), (8, 0, 12), (16, 12, 0))
    g_ref = ref.geo_latency(ALPHA, R.GeoSpec(regions=("us", "eu", "ap"),
                                             rtt=rtt), n_clients=16)
    g = port.geo_latency(ALPHA, P.GeoSpec(regions=("us", "eu", "ap"),
                                          rtt=rtt), n_clients=16,
                         device="cpu")
    np.testing.assert_array_equal(g.wan, g_ref.wan)
    np.testing.assert_allclose(g.p99, g_ref.p99, rtol=RTOL)


def test_des_is_carried_unchanged():
    a = R.des_throughput(R.multipaxos_model(), ALPHA, 8, n_commands=500)
    b = P.des_throughput(P.multipaxos_model(), ALPHA, 8, n_commands=500)
    assert a == b

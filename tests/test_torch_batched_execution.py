"""The port's batched execution plane against the reference's.

Engine level: the same lowered lane inputs go through the reference's
jitted scan and the port's eager step loop (via ``lane_inputs_from_numpy``),
deterministic and with the reference's own ``jax.random`` draws injected;
completion masks, latencies, drain counts and makespans must be equal.
Entry-point level: ``run_variant_batched`` on the CPU must reproduce the
reference's results - counts, costs and histograms exactly; throughput and
quantiles (read off equal makespans and histograms) within rtol 1e-6; the
mean latency within rtol 1e-9, since its float64 sum is taken in another
order.  The other entry points are held the same way in
``tests/test_torch_execute_surfaces.py``.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import batched_execution as RB  # noqa: E402
from repro_torch.core import batched_execution as PB  # noqa: E402

VARIANTS = ["compartmentalized", "multipaxos", "craq", "mencius"]
MIXES = [1.0, 0.5]
N_CMDS = 48
EXACT = ["cost_write", "cost_read", "station_msgs", "n_writes", "completed",
         "hist", "bin_edges", "dt", "seeds"]


@pytest.fixture(autouse=True)
def _same_station_vocabulary():
    """The station vocabulary is append-only and process-wide: a test file
    that ran earlier in this process may have registered variants with new
    stations into the reference.  Give the port the same columns, so both
    packages lower to the same K."""
    P.api._allocate_stations(tuple(R.STATION_ORDER))


def _assert_results_equal(a, b):
    """a: the reference's BatchedExecutionResult, b: the port's."""
    assert b.n_steps == a.n_steps and b.alpha == a.alpha
    assert b.configs == a.configs
    for field in EXACT:
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field),
                                      err_msg=field)
    for field in ("throughput", "latency_p50", "latency_p99"):
        np.testing.assert_allclose(getattr(b, field), getattr(a, field),
                                   rtol=1e-6, err_msg=field)
    np.testing.assert_allclose(b.latency_mean, a.latency_mean, rtol=1e-9)


def _lowered(exponential, f_write=0.5):
    spec = dict(variants=("compartmentalized", "craq"),
                n_proxy_leaders=(2, 4), chain_nodes=(3,))
    sweep = P.compile_sweep(P.SweepSpec(**spec))
    return PB._lower_configs(
        sweep.configs, P.Workload(f_write=f_write), n_commands=24,
        seeds_arr=np.arange(2, dtype=np.int32), n_clients=6,
        exponential_service=exponential)


def test_lowering_defaults_are_execute_configs_defaults():
    """The lowering's keyword defaults are execute_configs's, so a caller
    of the lowering sees the shapes and edges the main path gives."""
    def defaults(fn):
        return {k: p.default
                for k, p in inspect.signature(fn).parameters.items()
                if p.default is not inspect.Parameter.empty}
    lowering = defaults(PB._lower_configs)
    execute = defaults(PB.execute_configs)
    assert lowering == {k: execute[k] for k in lowering}


def _reference_engine(low, exponential):
    out = RB._execute_batch(
        jnp.asarray(low.d_w), jnp.asarray(low.d_r), jnp.asarray(low.entry),
        jnp.asarray(low.nxt), jnp.asarray(low.cls), jnp.asarray(low.budget),
        jnp.asarray(low.dt), jnp.asarray(low.seeds), n_clients=6,
        n_steps=low.n_steps, exponential=exponential)
    return [np.asarray(x) for x in out]


def _reference_draws(low):
    """The exponential draws the reference's lanes make: key(1) folded
    with the config index, then the seed."""
    k = low.d_w.shape[1]
    draws = np.zeros((len(low.dt), low.seeds.size, low.n_steps + 1, k),
                     np.float32)
    for mi in range(len(low.dt)):
        for si, s in enumerate(low.seeds):
            key = jax.random.fold_in(
                jax.random.fold_in(jax.random.key(1), mi), int(s))
            draws[mi, si] = np.asarray(
                jax.random.exponential(key, (low.n_steps + 1, k)))
    return draws


@pytest.mark.parametrize("exponential", [False, True],
                         ids=["deterministic", "injected-draws"])
def test_engine_matches_reference_scan_exactly(exponential):
    low = _lowered(exponential)
    fin_r, lat_r, dw_r, dr_r, tl_r = _reference_engine(low, exponential)
    draws = _reference_draws(low) if exponential else None
    inp = P.lane_inputs_from_numpy(low.d_w, low.d_r, low.entry, low.nxt,
                                   low.cls, low.budget, low.dt, low.seeds,
                                   draws, device="cpu")
    fin, lat, dw, dr, tl = PB._execute_batch(inp, 6, low.n_steps,
                                             exponential)
    m, s = len(low.dt), low.seeds.size
    np.testing.assert_array_equal(fin.numpy().reshape(fin_r.shape), fin_r)
    np.testing.assert_array_equal(lat.numpy().reshape(lat_r.shape), lat_r)
    np.testing.assert_array_equal(dw.numpy().reshape(m, s), dw_r)
    np.testing.assert_array_equal(dr.numpy().reshape(m, s), dr_r)
    np.testing.assert_array_equal(tl.numpy().reshape(m, s), tl_r)
    assert fin_r.any()


@pytest.mark.parametrize("f_write", MIXES, ids=lambda f: f"fw{f:g}")
@pytest.mark.parametrize("name", VARIANTS)
def test_run_variant_batched_matches_reference(name, f_write):
    a = R.run_variant_batched(name, workload=R.Workload(f_write=f_write),
                              n_commands=N_CMDS, seeds=2)
    b = P.run_variant_batched(name, workload=P.Workload(f_write=f_write),
                              n_commands=N_CMDS, seeds=2, device="cpu")
    _assert_results_equal(a, b)

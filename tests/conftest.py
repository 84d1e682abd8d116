"""Registry-derived conformance fixtures.

Any test (in any file under ``tests/``) that takes the
``executable_variant`` fixture is automatically parametrized over every
variant that declares an execution plane - the registry is the single
source of truth, so registering a new variant (e.g. the multi-leader
family: ``bpaxos``, ``iss``) makes it inherit the whole conformance
suite (parity, linearizability, batched<->scalar cross-plane agreement)
with zero test edits, and can never break an unrelated hand-pinned list.
"""
import pytest

from repro.core import GeoSpec, executable_variants


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card with nvcc; skips without one")


def pytest_generate_tests(metafunc):
    if "executable_variant" in metafunc.fixturenames:
        metafunc.parametrize("executable_variant",
                             list(executable_variants()))


@pytest.fixture
def registered_executables():
    """The registry's executable-variant names, resolved at test time."""
    return tuple(executable_variants())


@pytest.fixture
def geo3():
    """A 3-region WAN (us<->eu 8, us<->ap 16, eu<->ap 12 ticks round
    trip) for the registry-derived geo conformance suite: small enough
    that no protocol retry timer fires (the tightest is the proxy
    leader's p2 retry at 40 ticks), so message counts stay
    delay-invariant and every executable variant must hold msgs/cmd
    parity, linearizability AND per-region measured-vs-predicted
    latency under it."""
    return GeoSpec(regions=("us", "eu", "ap"),
                   rtt=((0, 8, 16), (8, 0, 12), (16, 12, 0)))

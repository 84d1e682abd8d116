"""The port's latency histogram against the reference's Pallas kernel.

On the CPU the wrapper runs its plain version, which must equal the
reference's Pallas kernel (interpret mode) and its jnp oracle exactly,
edge cases included; on a card (``-m gpu``) the CUDA kernel must equal the
plain version bit for bit.  The card's machine has no JAX, so the
reference is imported only by the tests that compare with it: there run
``python -m pytest --noconftest -m gpu tests/test_torch_latency_hist.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.latency_hist import latency_hist  # noqa: E402

HIST_SHAPES = [
    # (L lanes, N samples, B bins): tests/test_kernels.py's shapes
    (1, 64, 8),
    (4, 128, 16),
    (3, 96, 24),   # N, B not powers of two
]


def _inputs(shape, seed=0):
    L, N, B = shape
    rng = np.random.default_rng(seed)
    lo = (0.5 + np.arange(L, dtype=np.float32))[:, None]
    edges = (lo * np.logspace(0.0, 2.0, B + 1)[None, :]).astype(np.float32)
    samples = rng.uniform(0.1, 200.0, (L, N)).astype(np.float32)
    valid = (rng.uniform(size=(L, N)) < 0.7).astype(np.float32)
    return samples, valid, edges


def _with_edge_cases(samples, valid, edges):
    """Exact-edge, huge, zero, NaN and +inf samples (all valid), and the
    last lane fully masked."""
    samples, valid = samples.copy(), valid.copy()
    samples[:, 0] = edges[:, 3]
    samples[:, 1] = 1e9
    samples[:, 2] = 0.0
    samples[:, 3] = np.nan
    samples[:, 4] = np.inf
    samples[:, 5] = -np.inf
    valid[:, :6] = 1.0
    valid[-1] = 0.0
    return samples, valid, edges


def _reference(samples, valid, edges):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.latency_hist import latency_hist as pallas_hist

    args = (jnp.asarray(samples), jnp.asarray(valid), jnp.asarray(edges))
    pal = np.asarray(pallas_hist(*args, interpret=True))
    np.testing.assert_array_equal(pal,
                                  np.asarray(jref.ref_latency_hist(*args)))
    return pal


def _port(samples, valid, edges, as_bool=False):
    v = torch.from_numpy(valid)
    if as_bool:
        v = v > 0
    out = latency_hist(torch.from_numpy(samples), v, torch.from_numpy(edges))
    assert out.dtype == torch.int32
    return out.numpy()


@pytest.mark.parametrize("shape", HIST_SHAPES)
@pytest.mark.parametrize("as_bool", [False, True], ids=["f32mask", "bool"])
def test_plain_version_matches_pallas_kernel(shape, as_bool):
    samples, valid, edges = _inputs(shape)
    out = _port(samples, valid, edges, as_bool)
    np.testing.assert_array_equal(out, _reference(samples, valid, edges))
    assert int(out.sum()) == int(valid.sum())


@pytest.mark.parametrize("as_bool", [False, True], ids=["f32mask", "bool"])
def test_edge_cases_match_pallas_kernel(as_bool):
    samples, valid, edges = _with_edge_cases(*_inputs((3, 40, 12), seed=3))
    out = _port(samples, valid, edges, as_bool)
    np.testing.assert_array_equal(out, _reference(samples, valid, edges))
    B = edges.shape[1] - 1
    for lane in range(2):
        # NaN and -inf and 0.0 land in bin 0, 1e9 and +inf in the last bin
        finite = np.isfinite(samples[lane])
        bins = np.clip(np.searchsorted(edges[lane], samples[lane]) - 1,
                       0, B - 1)
        bins[~finite & ~(samples[lane] > 0)] = 0
        expect = np.bincount(bins, weights=valid[lane], minlength=B)
        np.testing.assert_array_equal(out[lane], expect.astype(np.int32))
    assert not out[-1].any()


def test_chunked_plain_version_is_exact(monkeypatch):
    """The plain version bounds its working set by binning N in chunks; a
    tiny chunk (several passes, a ragged last one) gives the same counts."""
    samples, valid, edges = _with_edge_cases(*_inputs((3, 96, 24), seed=7))
    whole = _port(samples, valid, edges)
    monkeypatch.setattr(ref, "_HIST_CHUNK_ELEMS", 3 * 25 * 7)
    np.testing.assert_array_equal(_port(samples, valid, edges), whole)


def test_cpu_dispatch_never_counts_a_launch():
    before = latency_hist.launches
    samples, valid, edges = _inputs((2, 64, 8), seed=5)
    args = (torch.from_numpy(samples), torch.from_numpy(valid),
            torch.from_numpy(edges))
    np.testing.assert_array_equal(ops.latency_hist(*args).numpy(),
                                  ref.ref_latency_hist(*args).numpy())
    assert ops.latency_hist is latency_hist
    assert latency_hist.launches == before == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    samples, valid, edges = (torch.from_numpy(a)
                             for a in _inputs((2, 16, 4)))
    with pytest.raises(TypeError):
        latency_hist(samples.double(), valid, edges)
    with pytest.raises(TypeError):
        latency_hist(samples, valid.int(), edges)
    with pytest.raises(ValueError):
        latency_hist(samples, valid[:, :8], edges)
    with pytest.raises(ValueError):
        latency_hist(samples.to("meta"), valid.to("meta"), edges.to("meta"))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    before = latency_hist.launches
    cases = [_inputs(s, seed=i) for i, s in enumerate(HIST_SHAPES)]
    cases.append(_with_edge_cases(*_inputs((3, 1000, 64), seed=11)))
    cases.append(_with_edge_cases(*_inputs((5, 4099, 96), seed=12)))
    for samples, valid, edges in cases:
        host = [torch.from_numpy(a) for a in (samples, valid, edges)]
        expect = ref.ref_latency_hist(*host)
        for mask in (host[1], host[1] > 0):
            got = latency_hist(host[0].cuda(), mask.cuda(), host[2].cuda())
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), expect)
    assert latency_hist.launches == before + 2 * len(cases)

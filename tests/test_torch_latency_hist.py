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

from repro_torch.kernels import latency_hist as LH  # noqa: E402
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


@pytest.mark.parametrize("lanes, n, route, n_chunks", [
    (256, 0, "lane", 0), (256, 4000, "lane", 0), (3, LH.LANE_N, "lane", 0),
    (3, LH.LANE_N + 1, "chunks", 2), (100, 20_001, "chunks", 5),
    (256, 7_503_872, "chunks", 229), (256, 2_932_736, "chunks", 90),
    (1, 10 ** 6, "chunks", 245), (1000, 10 ** 9, "chunks", 30_518)])
def test_plan_routes_by_lane_length(lanes, n, route, n_chunks):
    """One block a lane up to one pass of it (the transient run's 4000);
    past it chunks of whole 16-entry vectors, at most ``CHUNK`` entries,
    as many as give a 132-multiprocessor card 8 blocks on each while a
    thread keeps a whole vector (the execution plane's 7.5 M entries:
    229)."""
    p = LH.plan(lanes, n, 132)
    assert (p.route, p.n_chunks) == (route, n_chunks)
    if route == "lane":
        assert (p.threads, p.chunk) == (LH.LANE_THREADS, 0)
        return
    assert p.threads == LH.CHUNK_THREADS
    assert p.chunk % 16 == 0 and p.chunk <= LH.CHUNK
    assert (p.n_chunks - 1) * p.chunk < n <= p.n_chunks * p.chunk


# -- the kernel, on a card --------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


#: (L, N, B): N at each route's edge, a lane of N = 0, and long lanes
ROUTE_SHAPES = [(3, 0, 8), (4, 1, 8), (5, LH.LANE_N, 96),
                (5, LH.LANE_N + 1, 96), (2, 300_001, 64), (3, 65_536, 4096),
                (257, 3000, 64)]


def _cuda_case(shape, seed, as_bool):
    samples, valid, edges = _inputs(shape, seed)
    if shape[1] >= 6:
        samples, valid, edges = _with_edge_cases(samples, valid, edges)
    host = [torch.from_numpy(a) for a in (samples, valid, edges)]
    if as_bool:
        host[1] = host[1] > 0
    return host, [t.cuda() for t in host]


@pytest.mark.gpu
@pytest.mark.parametrize("as_bool", [False, True], ids=["f32mask", "bool"])
@pytest.mark.parametrize("shape", ROUTE_SHAPES,
                         ids=[f"{L}x{N}x{B}" for L, N, B in ROUTE_SHAPES])
def test_cuda_routes_match_plain_version_on_garbage_memory(shape, as_bool):
    """Each route bit for bit against the plain version, its output in
    memory the caching allocator hands back full of garbage: no bin may
    depend on a zero fill."""
    _cuda()
    host, dev = _cuda_case(shape, 21, as_bool)
    expect = ref.ref_latency_hist(*host)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    garbage = torch.full((shape[0] * shape[2],), -123_456_789,
                         dtype=torch.int32, device="cuda")
    ptr = garbage.data_ptr()
    del garbage
    before = latency_hist.launches
    got = latency_hist(*dev)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    assert latency_hist.launches == before + 1
    assert torch.equal(got.cpu(), expect)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 4000, 96), (4, 300_001, 64)],
                         ids=["lane", "chunks"])
def test_cuda_graph_replays_are_bitwise_equal(shape):
    _cuda()
    host, dev = _cuda_case(shape, 22, True)
    expect = ref.ref_latency_hist(*host)
    first = latency_hist(*dev).clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        latency_hist(*dev)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = latency_hist(*dev)
    for _ in range(20):
        out.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    assert torch.equal(first.cpu(), expect)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 4000, 96), (4, 300_001, 64)],
                         ids=["lane", "chunks"])
def test_cuda_call_is_one_kernel_launch(shape):
    """A profiler window over one call holds exactly one device kernel:
    no fill before it."""
    _cuda()
    from torch.autograd import DeviceType
    _, dev = _cuda_case(shape, 23, True)
    latency_hist(*dev)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        latency_hist(*dev)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 1 and "hist_" in kernels[0], kernels


@pytest.mark.gpu
def test_cuda_refused_launch_raises(monkeypatch):
    """A plan the source has no kernel for (blocks wider than the chunk
    kernel's) is refused, and the call raises: it never falls back to
    another kernel or the plain version."""
    _cuda()
    _, dev = _cuda_case((2, 300_001, 64), 24, True)
    good = LH.launch_plan(dev[0])
    monkeypatch.setattr(LH, "launch_plan", lambda samples: good._replace(
        threads=LH.CHUNK_THREADS * 2))
    before = latency_hist.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        latency_hist(*dev)
    assert latency_hist.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 300, 1500])
def test_cuda_chunks_route_leaves_its_counters_zeroed(lanes):
    """The last block of each lane resets the lane's arrival counter and
    row of bin sums, so the next call (or a graph replay) starts from
    zero; three calls in a row agree with the plain version."""
    _cuda()
    host, dev = _cuda_case((lanes, LH.LANE_N + 100, 16), 25, True)
    expect = ref.ref_latency_hist(*host)
    for _ in range(3):
        got = latency_hist(*dev)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), expect)
        counters = LH._arrival_counters(dev[0].device, lanes)
        assert int(counters.abs().sum()) == 0
        assert int(LH._lane_sums(dev[0].device, 0).abs().sum()) == 0


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_bit_for_bit():
    _cuda()
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

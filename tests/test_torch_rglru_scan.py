"""The port's RG-LRU scan against the reference's Pallas kernel and oracles.

On the CPU the wrapper runs its plain version (the serial recurrence in
float32), which must agree with the reference's Pallas kernel (interpret
mode) at the kernel tests' tolerances (float32 2e-5, bfloat16 2e-2), with
the reference's serial oracle (from a starting state h0 too, which the
reference folds into the first step), and - through the model-level
``rglru_scan`` - with the reference's associative scan, at rtol/atol 1e-5
(float32 rounding of two summation orders).  On a card (``-m gpu``) the CUDA kernel must agree with
the plain version at the same 1e-5 in float32 and within one bfloat16
rounding (rtol 1e-2) in bfloat16.  The card's machine has no JAX, so the
reference is imported only by the tests that compare with it: there run
``python -m pytest --noconftest -m gpu tests/test_torch_rglru_scan.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    CHANNELS,
    CHUNKS,
    MAX_CHUNK,
    chunk_plan,
    rglru_scan,
)
from repro_torch.models.rglru import rglru_scan as model_scan  # noqa: E402

RGLRU_SHAPES = [
    # (B, S, D, chunk, block_d): tests/test_kernels.py's shapes
    (1, 64, 128, 32, 128),
    (2, 128, 256, 64, 128),
    (2, 96, 128, 32, 64),
]

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)


def tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(B, S, D, seed=0, lo=0.5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, D), dtype=np.float32),
            rng.uniform(lo, 0.999, (B, S, D)).astype(np.float32))


def _torch(arrays, dtype, device="cpu"):
    # float32 -> bfloat16 rounds to nearest even in both packages
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in arrays]


@pytest.mark.parametrize("shape", RGLRU_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_plain_version_matches_pallas_kernel(shape, dtype):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.rglru_scan import rglru_scan as pallas

    B, S, D, chunk, bd = shape
    dt = DTYPES[dtype]
    arrays = _inputs(B, S, D)
    out = rglru_scan(*_torch(arrays, dt))
    assert out.dtype == dt and out.shape == (B, S, D)
    jd = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    x, a = (jnp.asarray(arr, jd) for arr in arrays)
    pal = np.asarray(pallas(x, a, chunk=chunk, block_d=bd, interpret=True),
                     np.float32)
    oracle = np.asarray(jref.ref_rglru(x, a), np.float32)
    np.testing.assert_allclose(pal, oracle, **tol(dt))
    np.testing.assert_allclose(out.float().numpy(), pal, **tol(dt))
    np.testing.assert_allclose(out.float().numpy(), oracle, **tol(dt))


@pytest.mark.parametrize("S", [1, 77])
def test_plain_version_matches_reference_oracle(S):
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    x, a = _inputs(3, S, 40, seed=S, lo=0.3)
    want = np.asarray(jref.ref_rglru(jnp.asarray(x), jnp.asarray(a)))
    got = ref.ref_rglru(*_torch((x, a), torch.float32))
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


@pytest.mark.parametrize("S", [1, 77])
def test_plain_version_from_h0_matches_reference_fold(S):
    """The reference folds h0 into the first step and scans from 0; the
    port's scan starts its carry from h0.  The two are the same sum."""
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    x, a = _inputs(3, S, 40, seed=S + 1, lo=0.3)
    h0 = np.random.default_rng(S).standard_normal((3, 40), dtype=np.float32)
    folded = x.copy()
    folded[:, 0] = x[:, 0] + a[:, 0] * h0
    want = np.asarray(jref.ref_rglru(jnp.asarray(folded), jnp.asarray(a)))
    got = ops.rglru_scan(*_torch((x, a), torch.float32),
                         torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
def test_model_scan_matches_reference_associative_scan(with_h0):
    """``models/rglru.py:rglru_scan`` in both packages: the reference's
    associative scan after its h0 fold, the port's kernel call from h0."""
    import jax.numpy as jnp
    from repro.models.rglru import rglru_scan as jscan

    x, a = _inputs(2, 77, 32, seed=5, lo=0.3)
    h0 = np.random.default_rng(6).standard_normal((2, 32), dtype=np.float32)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    want_h, want_last = jscan(jnp.asarray(x), jnp.asarray(a), jh0)
    h, last = model_scan(*_torch((x, a), torch.float32), th0)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               **SCAN_TOL)
    # decode's single step: h = a h0 + x
    one_h, one_last = model_scan(*_torch((x[:, :1], a[:, :1]), torch.float32),
                                 th0)
    want_one = x[:, 0] + (a[:, 0] * h0 if with_h0 else 0.0)
    np.testing.assert_allclose(one_last.numpy(), want_one, **SCAN_TOL)
    assert one_h.shape == (2, 1, 32)


def test_strided_views_match_contiguous_inputs():
    x, a = _torch(_inputs(2, 30, 48, seed=7), torch.float32)
    contiguous = rglru_scan(x, a)
    views = [t.transpose(0, 1).contiguous().transpose(0, 1) for t in (x, a)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(rglru_scan(*views), contiguous, rtol=0,
                               atol=0)


#: (B, S, D): the main path's (recurrentgemma-2b's prompts and the
#: batcher's, decode at batch 1 and 8), long, and ragged shapes
PLAN_SHAPES = [(1, 3000, 2560), (1, 512, 2560), (8, 512, 2560),
               (1, 2040, 2560), (1, 17, 2560), (1, 1, 2560), (8, 1, 2560),
               (1, 4096, 2560), (64, 4096, 2560), (1, 100_000, 2560),
               (1, 17, 77), (3, 129, 1), (2, 33, 63)]


def test_chunk_plan_covers_the_sequence():
    for B, S, D in PLAN_SHAPES:
        n_chunks, chunk = chunk_plan(B, S, D, 132)
        assert n_chunks >= 1 and (n_chunks - 1) * chunk < S <= n_chunks * chunk
        assert 1 <= chunk <= MAX_CHUNK
        assert S == 1 or chunk in CHUNKS or chunk % 32 == 0
    # batch 1 at full width: enough blocks to cover the card twice
    n_chunks, _ = chunk_plan(1, 3000, 2560, 132)
    assert n_chunks * (2560 // CHANNELS) >= 2 * 132
    n_chunks, _ = chunk_plan(1, 512, 2560, 132)
    assert n_chunks * (2560 // CHANNELS) >= 2 * 132


@pytest.mark.parametrize("shape", [s for s in PLAN_SHAPES
                                   if s[0] * s[1] <= 8 * 4096], ids=str)
def test_launch_plan_covers_every_step_and_channel_once(shape):
    """The blocks of one launch, each (ticket -> chunk, b, channel block)
    as the kernel decodes it, cover every (b, step, channel) exactly once,
    and every earlier chunk a block folds has a lower ticket."""
    B, S, D = shape
    n_chunks, chunk = chunk_plan(B, S, D, 132)
    n_cb = -(-D // CHANNELS)
    cover = np.zeros((B, S, D), np.int32)
    first_ticket = {}
    for job in range(B * n_cb * n_chunks):
        c, rest = divmod(job, B * n_cb)
        b, cb = divmod(rest, n_cb)
        t0, ch0 = c * chunk, cb * CHANNELS
        cover[b, t0:t0 + chunk, ch0:ch0 + CHANNELS] += 1
        first_ticket[(b, cb, c)] = job
        for q in range(c):
            assert first_ticket[(b, cb, q)] < job
    assert (cover == 1).all()


def _fold(pairs, h):
    """h folded through (prod a, h_end) summaries in order."""
    for p, s in pairs:
        h = p * h + s
    return h


def _composite(pairs, shape):
    """(prod a, h_end from 0) of a run of summaries."""
    p, h = torch.ones(shape), torch.zeros(shape)
    for pq, hq in pairs:
        h = pq * h + hq
        p = p * pq
    return p, h


def _one_pass_model(x, a, h0, chunk, parts=4):
    """The one-pass kernel's float32 arithmetic: each quarter of a chunk
    folds its steps from 0 into (prod a, h_end), the quarters fold into
    the chunk's summary; for chunk c each of ``parts`` runs of summaries
    0..c-1 folds into a composite, the composites fold in order from h0
    into the state entering the chunk, and each quarter rescans from the
    state entering it."""
    B, S, D = x.shape
    out = torch.empty_like(x)
    summaries = []
    per = -(-chunk // parts)
    for c, t0 in enumerate(range(0, S, chunk)):
        xs, as_ = x[:, t0:t0 + chunk], a[:, t0:t0 + chunk]
        n = xs.shape[1]
        quarters = []
        for p in range(parts):
            steps = range(p * per, min(n, (p + 1) * per))
            hp, pp = torch.zeros(B, D), torch.ones(B, D)
            for t in steps:
                hp = as_[:, t] * hp + xs[:, t]
                pp = pp * as_[:, t]
            quarters.append((pp, hp))
        per_c = -(-c // parts)
        runs = [_composite(summaries[q * per_c:min(c, (q + 1) * per_c)],
                           (B, D)) for q in range(parts)]
        h = _fold(runs, h0.clone() if h0 is not None else torch.zeros(B, D))
        for p in range(parts):
            for t in range(p * per, min(n, (p + 1) * per)):
                h = as_[:, t] * h + xs[:, t]
                out[:, t0 + t] = h
        summaries.append(_composite(quarters, (B, D)))
    return out


@pytest.mark.parametrize("S", [1, 31, 33, 200, 3000])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=None", "h0"])
def test_one_pass_fold_model_matches_plain_version(S, with_h0):
    """The kernel's order of products, in float32 on the CPU, at the chunk
    the plan gives recurrentgemma-2b's width, held to the serial
    recurrence within ``SCAN_TOL``."""
    x, a = _torch(_inputs(1, S, 256, seed=S, lo=0.3), torch.float32)
    h0 = (torch.from_numpy(np.random.default_rng(S).standard_normal(
        (1, 256), dtype=np.float32)) if with_h0 else None)
    _, chunk = chunk_plan(1, S, 2560, 132)
    got = _one_pass_model(x, a, h0, chunk)
    torch.testing.assert_close(got, ref.ref_rglru(x, a, h0), **SCAN_TOL)


def test_cpu_dispatch_never_counts_a_launch():
    before = rglru_scan.launches
    args = _torch(_inputs(2, 9, 16, seed=8), torch.float32)
    torch.testing.assert_close(ops.rglru_scan(*args), ref.ref_rglru(*args),
                               rtol=0, atol=0)
    assert ops.rglru_scan is rglru_scan
    assert rglru_scan.launches == before == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, a = _torch(_inputs(2, 9, 16), torch.float32)
    with pytest.raises(TypeError):
        rglru_scan(x.double(), a.double())
    with pytest.raises(TypeError):
        rglru_scan(x, a.bfloat16())
    with pytest.raises(ValueError):
        rglru_scan(x, a[:, :4])
    with pytest.raises(ValueError):
        rglru_scan(x[0], a[0])
    with pytest.raises(ValueError):
        rglru_scan(x.to("meta"), a.to("meta"))
    h0 = torch.zeros(2, 16)
    with pytest.raises(ValueError):
        rglru_scan(x, a, h0[:1])
    with pytest.raises(ValueError):
        rglru_scan(x, a, h0[:, None])
    with pytest.raises(TypeError):
        rglru_scan(x, a, h0.bfloat16())
    with pytest.raises(ValueError):
        rglru_scan(x, a, h0.to("meta"))


# (B, S, D): S of 1, ragged 17 and 77, at and past a chunk border (32,
# 33, 64, 129), full chunks, long; widths 1 to 2560, some no multiple of a
# 16-byte piece
GPU_SHAPES = [(1, 1, 2560), (8, 1, 2560), (1, 17, 77), (8, 77, 2560),
              (1, 3000, 2560), (1, 4096, 2560), (3, 129, 1),
              (1, 32, 2560), (2, 33, 2560), (1, 64, 2560), (1, 512, 2560),
              (2, 300, 63)]


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    before = rglru_scan.launches
    n = 0
    for i, (B, S, D) in enumerate(GPU_SHAPES):
        arrays = _inputs(B, S, D, seed=10 + i)
        start = torch.from_numpy(np.random.default_rng(i).standard_normal(
            (B, D), dtype=np.float32))
        for dt, kw in ((torch.float32, SCAN_TOL),
                       (torch.bfloat16, dict(rtol=1e-2, atol=4e-3))):
            for h0 in (None, start):
                host = _torch(arrays, dt)
                dev = [t.cuda() for t in host]
                expect = ref.ref_rglru(*host, h0).float()
                got = rglru_scan(*dev, None if h0 is None else h0.cuda())
                torch.cuda.synchronize()
                n += 1
                np.testing.assert_allclose(
                    got.float().cpu().numpy(), expect.numpy(), **kw,
                    err_msg=f"{(B, S, D)} {dt} h0={h0 is not None}")
    assert rglru_scan.launches == before + n


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 3000, 2560), (1, 512, 2560),
                                   (1, 1, 2560), (8, 1, 2560)], ids=str)
def test_cuda_graph_replays_are_bitwise_equal(shape):
    """50 replays of one captured launch give the bits of the first: the
    ticket, counter and flags are back at zero after every launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    B, S, D = shape
    x, a = _torch(_inputs(B, S, D, seed=3), torch.float32, "cuda")
    h0 = torch.randn(B, D, device="cuda")
    first = rglru_scan(x, a, h0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        rglru_scan(x, a, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rglru_scan(x, a, h0)
    for _ in range(50):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)

"""The port's split-KV flash decode against the reference's Pallas kernel.

On the CPU the wrapper runs its plain version, which must agree with the
reference's Pallas kernel (interpret mode) and its jnp oracle at the
kernel tests' tolerances (float32 2e-5, bfloat16 2e-2), with a different
cache length per row, head dims up to 256 and groups up to 10; on a card (``-m gpu``) the CUDA kernel must agree
with the plain version at the same tolerances.  There run
``python -m pytest --noconftest -m gpu tests/test_torch_flash_decode.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MAX_SPLITS,
    _launch,
    flash_decode,
    split_plan,
)

DECODE_SHAPES = [
    # (B, H, H_kv, S_max, D, block_k): tests/test_kernels.py's shapes
    (2, 4, 2, 128, 32, 32),
    (1, 8, 1, 256, 64, 64),
    (3, 4, 4, 64, 16, 16),
    (2, 6, 1, 128, 16, 32),   # GQA group 6 (nemotron-4-15b's)
    (2, 10, 1, 128, 256, 64),  # MQA group 10 at head dim 256
                               # (recurrentgemma-2b's)
]

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(B, H, H_kv, S, D, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), dtype=np.float32)
    k = rng.standard_normal((B, H_kv, S, D), dtype=np.float32)
    v = rng.standard_normal((B, H_kv, S, D), dtype=np.float32)
    if lens is None:
        lens = rng.integers(1, S + 1, size=B)
        lens[0] = S  # a full row beside the random ones
        if B > 1:
            lens[-1] = 1
    return q, k, v, np.asarray(lens, np.int32)


def _torch(arrays, dtype, device="cpu"):
    q, k, v, lens = arrays
    return ([torch.from_numpy(a).to(device=device, dtype=dtype)
             for a in (q, k, v)] + [torch.from_numpy(lens).to(device)])


def _reference(arrays, dtype, bk):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import flash_decode as pallas

    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q, k, v = (jnp.asarray(a, jd) for a in arrays[:3])
    lens = jnp.asarray(arrays[3])
    pal = np.asarray(pallas(q, k, v, lens, block_k=bk, interpret=True),
                     np.float32)
    oracle = np.asarray(jref.ref_decode(q, k, v, lens), np.float32)
    np.testing.assert_allclose(pal, oracle, **tol(dtype))
    return pal, oracle


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_plain_version_matches_pallas_kernel(shape, dtype):
    B, H, H_kv, S, D, bk = shape
    dt = DTYPES[dtype]
    arrays = _inputs(B, H, H_kv, S, D)
    out = flash_decode(*_torch(arrays, dt))
    assert out.dtype == dt and out.shape == (B, H, D)
    pal, oracle = _reference(arrays, dt, bk)
    np.testing.assert_allclose(out.float().numpy(), pal, **tol(dt))
    np.testing.assert_allclose(out.float().numpy(), oracle, **tol(dt))


def test_strided_cache_views_match_contiguous_caches():
    """The model hands in transposed views of (B, S_max, H_kv, d) caches."""
    q, k, v, lens = _torch(_inputs(3, 8, 2, 50, 32, seed=4), torch.float32)
    contiguous = flash_decode(q, k, v, lens)
    kv = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (k, v)]
    assert not kv[0].is_contiguous()
    torch.testing.assert_close(flash_decode(q, *kv, lens), contiguous,
                               rtol=0, atol=0)


def test_split_plan_covers_the_cache_in_whole_tiles():
    for B, H_kv, S, sms in [(1, 8, 2064, 132), (8, 8, 1024, 132),
                            (1, 1, 1, 132), (64, 40, 100, 132),
                            (1, 8, 64, 132), (1, 1, 2048, 132),
                            (8, 1, 2048, 132), (1, 1, 65536, 132)]:
        n_splits, split_len = split_plan(B, H_kv, S, sms)
        assert split_len % 64 == 0 and 1 <= n_splits <= MAX_SPLITS
        assert (n_splits - 1) * split_len < S <= n_splits * split_len
        # no one-tile split where the cache has two tiles
        assert split_len >= min(2 * 64, -(-S // 64) * 64)
    # batch 1, 8 kv heads: the card's SMs covered once
    n_splits, split_len = split_plan(1, 8, 2064, 132)
    assert 8 * n_splits >= 132 and split_len == 128
    # batch 1, one kv head (recurrentgemma-2b): two-tile splits
    assert split_plan(1, 1, 2048, 132) == (16, 128)
    assert split_plan(8, 1, 2048, 132) == (16, 128)
    # a long cache: no more splits than the last block merges
    assert split_plan(1, 1, 65536, 132) == (64, 1024)


def test_cpu_dispatch_never_counts_a_launch():
    before = flash_decode.launches
    args = _torch(_inputs(2, 4, 2, 16, 16, seed=5), torch.float32)
    torch.testing.assert_close(ops.flash_decode(*args),
                               ref.ref_decode(*args), rtol=0, atol=0)
    assert ops.flash_decode is flash_decode
    assert flash_decode.launches == before == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, lens = _torch(_inputs(2, 4, 2, 16, 16), torch.float32)
    with pytest.raises(TypeError):
        flash_decode(q.double(), k.double(), v.double(), lens)
    with pytest.raises(TypeError):
        flash_decode(q, k, v, lens.float())
    with pytest.raises(ValueError):
        flash_decode(q, k, v, lens[:1])
    with pytest.raises(ValueError):
        flash_decode(q[:, :3], k, v, lens)        # 3 heads over 2
    with pytest.raises(ValueError):
        flash_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                     lens.to("meta"))
    # 12 heads x 256 over one kv head: past the kernel's 2560 outputs
    q, k, v, lens = _torch(_inputs(1, 12, 1, 16, 256), torch.float32)
    with pytest.raises(ValueError, match="2560"):
        _launch(q, k, v, lens)
    # 17 query heads over one kv head: past the bfloat16 kernel's 16 rows
    q, k, v, lens = _torch(_inputs(1, 17, 1, 16, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="16 query heads"):
        _launch(q, k, v, lens)


def _gpu_inputs(case, dt, layout="model"):
    """A case's inputs on the card: q, the caches (dense, or as the model
    hands them in - (B, S_max, H_kv, d) transposed - or with rows d + 1
    apart, which the wrapper must copy), cache_len; and on the host."""
    B, H, H_kv, S, D, seed, lens = case
    host = _torch(_inputs(B, H, H_kv, S, D, seed=seed, lens=lens), dt)
    dev = [t.cuda() for t in host]
    if layout == "model":
        dev[1:3] = [t.transpose(1, 2).contiguous().transpose(1, 2)
                    for t in dev[1:3]]
    elif layout == "odd":
        pads = [torch.zeros(t.shape[:-1] + (D + 1,), dtype=dt,
                            device="cuda") for t in dev[1:3]]
        for p_, t in zip(pads, dev[1:3]):
            p_[..., :D] = t
        dev[1:3] = [p_[..., :D] for p_ in pads]
    return dev, host


def _gpu_check(case, layouts=("dense", "model")):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    before = flash_decode.launches
    n = 0
    for dt in DTYPES.values():
        for layout in layouts:
            dev, host = _gpu_inputs(case, dt, layout)
            expect = ref.ref_decode(*host).float()
            got = flash_decode(*dev)
            torch.cuda.synchronize()
            n += 1
            np.testing.assert_allclose(
                got.float().cpu().numpy(), expect.numpy(), **tol(dt),
                err_msg=f"{case[:5]} {dt} {layout} cache_len "
                        f"{host[3].tolist()}")
    assert flash_decode.launches == before + n


# (B, H, H_kv, S_max, D, cache_len): cache lengths of 1, of S_max and
# different per row (None: drawn, with a full row first and a length-1 row
# last); S_max no multiple of the 64-key tile (17, 1000, 2064, 3000); head
# dims 16 to 256; groups 1, 4, 6, 8 and 10 (recurrentgemma-2b's 2048-row
# ring buffer at batch 1 and 8); and short caches in a long buffer, where
# most splits start past cache_len
GPU_SHAPES = [
    (1, 32, 8, 2064, 64, None), (8, 32, 8, 1024, 64, None),
    (3, 8, 8, 17, 128, None), (2, 48, 8, 1000, 128, None),
    (4, 6, 1, 300, 16, None), (2, 4, 2, 64, 32, None),
    (1, 64, 8, 4096, 128, None), (1, 10, 1, 2048, 256, None),
    (8, 10, 1, 2048, 256, None), (1, 10, 1, 2048, 256, [1]),
    (1, 32, 8, 2064, 64, [1]), (2, 10, 1, 3000, 256, [3000, 2999]),
    (3, 10, 1, 4096, 256, [1, 65, 129]), (4, 32, 8, 8192, 64, [1, 2, 64, 200]),
    (2, 16, 1, 1000, 128, [1000, 1]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(GPU_SHAPES)),
                         ids=[str(c) for c in GPU_SHAPES])
def test_cuda_kernel_matches_plain_version(i):
    B, H, H_kv, S, D, lens = GPU_SHAPES[i]
    _gpu_check((B, H, H_kv, S, D, 10 + i, lens))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(2, 4, 2, 300, 64), (1, 10, 1, 500, 256)],
                         ids=str)
def test_cuda_kernel_copies_caches_it_cannot_read_in_16_bytes(case):
    _gpu_check(case + (60, None), layouts=("odd",))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(1, 10, 1, 2048, 256, [2048]),
                                  (8, 32, 8, 1024, 64, None),
                                  (3, 10, 1, 4096, 256, [1, 65, 129])],
                         ids=str)
def test_cuda_graph_replays_are_bitwise_equal(case):
    """The one-launch kernel leaves its arrival counters at zero, so a CUDA
    graph of it replays: two replays (and an eager call) give the same
    bits, and the replays match the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    B, H, H_kv, S, D, lens = case
    dev, host = _gpu_inputs((B, H, H_kv, S, D, 70, lens), torch.bfloat16)
    eager = flash_decode(*dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_decode(*dev)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode(*dev)
    replays = []
    for _ in range(2):
        out.zero_()
        graph.replay()
        replays.append(out.clone())
    torch.cuda.synchronize()
    assert torch.equal(replays[0], replays[1])
    assert torch.equal(replays[0], eager)
    np.testing.assert_allclose(replays[0].float().cpu().numpy(),
                               ref.ref_decode(*host).float().numpy(),
                               **tol(torch.bfloat16))

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
                            (1, 8, 64, 132)]:
        n_splits, split_len = split_plan(B, H_kv, S, sms)
        assert split_len % 64 == 0 and n_splits >= 1
        assert (n_splits - 1) * split_len < S <= n_splits * split_len
    # batch 1, 8 kv heads: enough splits to fill the card twice over
    n_splits, _ = split_plan(1, 8, 2064, 132)
    assert 8 * n_splits >= 2 * 132


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


# (B, H, H_kv, S_max, D): cache lengths of 1, of S_max and different per
# row; head dims 16 to 256; groups 1, 4, 6, 8 and 10 (recurrentgemma-2b's
# 2048-row ring buffer at batch 1 and 8)
GPU_SHAPES = [
    (1, 32, 8, 2064, 64), (8, 32, 8, 1024, 64), (3, 8, 8, 17, 128),
    (2, 48, 8, 1000, 128), (4, 6, 1, 300, 16), (2, 4, 2, 64, 32),
    (1, 64, 8, 4096, 128), (1, 10, 1, 2048, 256), (8, 10, 1, 2048, 256),
]


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    before = flash_decode.launches
    n = 0
    for i, (B, H, H_kv, S, D) in enumerate(GPU_SHAPES):
        arrays = _inputs(B, H, H_kv, S, D, seed=10 + i)
        for dt in DTYPES.values():
            host = _torch(arrays, dt)
            dev = [t.cuda() for t in host]
            # strided: the model's (B, S_max, H_kv, d) caches, transposed
            views = [dev[0]] + [t.transpose(1, 2).contiguous().transpose(1, 2)
                                for t in dev[1:3]] + [dev[3]]
            expect = ref.ref_decode(*host).float()
            for args in (dev, views):
                got = flash_decode(*args)
                torch.cuda.synchronize()
                n += 1
                np.testing.assert_allclose(
                    got.float().cpu().numpy(), expect.numpy(), **tol(dt),
                    err_msg=f"{(B, H, H_kv, S, D)} {dt}")
    assert flash_decode.launches == before + n

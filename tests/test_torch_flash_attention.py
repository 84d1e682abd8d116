"""The port's flash attention against the reference's Pallas kernel.

On the CPU the wrapper runs its plain version, which must agree with the
reference's Pallas kernel (interpret mode) and its jnp oracle at the
kernel tests' tolerances (float32 2e-5, bfloat16 2e-2), and, windowed
(local attention), with the reference's model-path
``chunked_attention(window=)`` at the same tolerances; on a card
(``-m gpu``) the CUDA kernel must agree with the plain version at the same
tolerances, windowed and at head dim 256 too.  The card's machine has no JAX, so the reference is imported
only by the tests that compare with it: there run
``python -m pytest --noconftest -m gpu tests/test_torch_flash_attention.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    aligned_rows,
    flash_attention,
)

ATTN_SHAPES = [
    # (B, H, H_kv, S, D, block_q, block_k): tests/test_kernels.py's shapes
    (1, 2, 2, 64, 32, 16, 16),
    (2, 4, 2, 128, 64, 32, 64),   # GQA group 2, uneven blocks
    (1, 8, 1, 64, 16, 64, 16),    # MQA
    (2, 2, 2, 96, 32, 32, 32),    # S not a power of two
    (1, 6, 1, 64, 16, 32, 32),    # GQA group 6 (nemotron-4-15b's)
    (1, 10, 1, 64, 256, 32, 32),  # MQA group 10 at head dim 256
                                  # (recurrentgemma-2b's)
]

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(B, H, H_kv, S, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D), dtype=np.float32),
            rng.standard_normal((B, H_kv, S, D), dtype=np.float32),
            rng.standard_normal((B, H_kv, S, D), dtype=np.float32))


def _torch(arrays, dtype, device="cpu"):
    # float32 -> bfloat16 rounds to nearest even in both packages
    return [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in arrays]


def _reference(arrays, dtype, causal, bq, bk):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention as pallas

    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    q, k, v = (jnp.asarray(a, jd) for a in arrays)
    pal = np.asarray(pallas(q, k, v, causal=causal, block_q=bq, block_k=bk,
                            interpret=True), np.float32)
    oracle = np.asarray(jref.ref_attention(q, k, v, causal=causal),
                        np.float32)
    np.testing.assert_allclose(pal, oracle, **tol(dtype))
    return pal, oracle


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_pallas_kernel(shape, dtype, causal):
    B, H, H_kv, S, D, bq, bk = shape
    dt = DTYPES[dtype]
    arrays = _inputs(B, H, H_kv, S, D)
    out = flash_attention(*_torch(arrays, dt), causal=causal)
    assert out.dtype == dt and out.shape == (B, H, S, D)
    pal, oracle = _reference(arrays, dt, causal, bq, bk)
    np.testing.assert_allclose(out.float().numpy(), pal, **tol(dt))
    np.testing.assert_allclose(out.float().numpy(), oracle, **tol(dt))


# (B, H, H_kv, S, D, window, q_block): windows shorter than S (the mask
# runs), one of 1 (the diagonal only), and recurrentgemma-2b's MQA at
# head dim 256
WINDOW_CASES = [
    (2, 4, 1, 12, 16, 8, 16),
    (1, 4, 2, 40, 32, 1, 16),
    (2, 6, 2, 96, 32, 17, 32),
    (1, 10, 1, 80, 256, 32, 32),
]


@pytest.mark.parametrize("case", WINDOW_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_windowed_plain_version_matches_reference_chunked_attention(case,
                                                                    dtype):
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention

    B, H, H_kv, S, D, window, q_block = case
    dt = DTYPES[dtype]
    arrays = _inputs(B, H, H_kv, S, D, seed=window)
    jd = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    # the model path's (B, S, H, d) layout on the reference's side
    q, k, v = (jnp.asarray(a.transpose(0, 2, 1, 3), jd) for a in arrays)
    want = np.asarray(chunked_attention(q, k, v, causal=True, window=window,
                                        q_block=q_block), np.float32)
    out = flash_attention(*_torch(arrays, dt), causal=True, window=window)
    assert out.dtype == dt and out.shape == (B, H, S, D)
    np.testing.assert_allclose(out.float().numpy().transpose(0, 2, 1, 3),
                               want, **tol(dt))
    # a window of S or more is no window
    full = flash_attention(*_torch(arrays, dt), causal=True, window=S)
    torch.testing.assert_close(full, flash_attention(*_torch(arrays, dt)),
                               rtol=0, atol=0)


def test_strided_views_match_contiguous_inputs():
    """The model hands in transposed views of (B, S, H, d) activations."""
    B, H, H_kv, S, D = 2, 8, 2, 40, 32
    q, k, v = _inputs(B, H, H_kv, S, D, seed=4)
    contiguous = flash_attention(*_torch((q, k, v), torch.float32))
    views = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                              ).transpose(1, 2) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(flash_attention(*views), contiguous,
                               rtol=0, atol=0)


def test_cpu_dispatch_never_counts_a_launch():
    before = flash_attention.launches
    args = _torch(_inputs(1, 4, 2, 16, 16, seed=5), torch.float32)
    torch.testing.assert_close(ops.flash_attention(*args),
                               ref.ref_attention(*args), rtol=0, atol=0)
    assert ops.flash_attention is flash_attention
    assert flash_attention.launches == before == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = _torch(_inputs(1, 4, 2, 16, 16), torch.float32)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        flash_attention(q[:, :3], k, v)           # 3 heads over 2
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :8], v[:, :, :8])
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0)


def test_alignment_rule_copies_only_views_a_16_byte_copy_cannot_read():
    """The kernels copy rows in 16-byte pieces: a view with an odd row
    stride or a misaligned start goes through a dense copy, an aligned one
    (the model's transposed activations and caches) through untouched."""
    base = torch.arange(2 * 4 * 9 * 72, dtype=torch.float32).reshape(
        2, 4, 9, 72).to(torch.bfloat16)
    wide = torch.zeros(2, 4, 9, 67, dtype=torch.bfloat16)
    f32 = torch.zeros(3, 5, 36)
    flat = base.flatten()
    for aligned in (base, base[..., :64], base.transpose(1, 2),
                    base[:, 1:2], base[:1],
                    flat[8:8 + 4 * 9 * 64].view(4, 9, 64),  # 16 bytes in
                    f32[..., :32],            # float32: row stride 36
                    # a length-1 dimension's stride is never used
                    torch.zeros(9, 64, dtype=torch.bfloat16).as_strided(
                        (1, 9, 64), (5, 64, 1))):
        assert aligned_rows(aligned) is aligned
    for misaligned in (wide[..., :64],        # row stride 67
                       base[..., 1:65],       # starts 2 bytes in
                       flat[3:3 + 4 * 9 * 64].view(4, 9, 64),  # 6 bytes in
                       f32[..., 2:34],        # float32, starts 8 bytes in
                       wide.float()[..., :64]):  # float32, row stride 67
        got = aligned_rows(misaligned)
        assert got is not misaligned and got.is_contiguous()
        assert got.data_ptr() % 16 == 0
        torch.testing.assert_close(got, misaligned, rtol=0, atol=0)


def _gpu_check(case, causal, window=None, views=("dense", "model")):
    """The CUDA kernel against its plain version at one case, in float32
    and bfloat16, for each layout in ``views``: "dense", "model" (the
    (B, S, H, d) activations transposed, as the model hands them in) and
    "odd" (rows 1 element apart past d, which the wrapper must copy)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    B, H, H_kv, S, D, seed = case
    arrays = _inputs(B, H, H_kv, S, D, seed=seed)
    before = flash_attention.launches
    n = 0
    for dt in DTYPES.values():
        host = _torch(arrays, dt)
        expect = ref.ref_attention(*host, causal=causal,
                                   window=window).float()
        for view in views:
            dev = [t.cuda() for t in host]
            if view == "model":
                dev = [t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in dev]
            elif view == "odd":
                pad = [torch.zeros(t.shape[:-1] + (D + 1,), dtype=dt,
                                   device="cuda") for t in dev]
                for p_, t in zip(pad, dev):
                    p_[..., :D] = t
                dev = [p_[..., :D] for p_ in pad]
                assert dev[0].stride(2) == D + 1
            got = flash_attention(*dev, causal=causal, window=window)
            torch.cuda.synchronize()
            n += 1
            np.testing.assert_allclose(
                got.float().cpu().numpy(), expect.numpy(), **tol(dt),
                err_msg=f"{case} {dt} causal={causal} window={window} "
                        f"{view}")
    assert flash_attention.launches == before + n


# (B, H, H_kv, S, D): the edge shapes of the card check - S of 1, ragged
# S (17, 1000, 2064, 3000: no multiple of the 64- or 32-key tile, nor of
# the 64- or 128-row query tile), whole tiles; head dims 16 to 256 (256 at
# 32-key tiles); groups 1, 4, 6, 8 and 10
GPU_SHAPES = [
    (1, 4, 4, 1, 64), (2, 8, 2, 17, 64), (1, 8, 1, 128, 128),
    (2, 12, 2, 1000, 64), (1, 32, 8, 300, 64), (1, 6, 1, 77, 16),
    (2, 4, 2, 65, 32), (1, 16, 2, 256, 128), (1, 32, 8, 2064, 64),
    (1, 10, 1, 3000, 256), (2, 10, 1, 17, 256), (1, 4, 1, 1000, 256),
    (1, 8, 2, 3000, 128),
]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("i", range(len(GPU_SHAPES)),
                         ids=[str(c) for c in GPU_SHAPES])
def test_cuda_kernel_matches_plain_version(i, causal):
    _gpu_check(GPU_SHAPES[i] + (10 + i,), causal)


# (B, H, H_kv, S, D): a view whose row stride (d + 1) is no multiple of 8
GPU_ODD_STRIDE_SHAPES = [(2, 8, 2, 100, 64), (1, 10, 1, 300, 256),
                         (1, 4, 4, 33, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(GPU_ODD_STRIDE_SHAPES)),
                         ids=[str(c) for c in GPU_ODD_STRIDE_SHAPES])
def test_cuda_kernel_copies_views_it_cannot_read_in_16_bytes(i):
    _gpu_check(GPU_ODD_STRIDE_SHAPES[i] + (50 + i,), True, views=("odd",))


# (B, H, H_kv, S, D, window): recurrentgemma-2b's MQA at head dim 256 with
# its window of 2048 past it and short of it; blocks at exactly i = window
# (windows of 64 and 128, a multiple of the 64-row block) and straddling
# it (windows of 1, 100 and 200); windows no multiple of the 32-key tile
# at head dim 256 (33, 95)
GPU_WINDOW_CASES = [
    (1, 10, 1, 3000, 256, 2048), (1, 10, 1, 2047, 256, 2048),
    (2, 4, 1, 300, 256, 64), (1, 8, 2, 257, 64, 128),
    (1, 6, 1, 77, 128, 1), (2, 10, 1, 500, 256, 100),
    (1, 4, 4, 200, 16, 200), (1, 10, 1, 1000, 256, 33),
    (1, 32, 8, 2064, 64, 95),
]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("i", range(len(GPU_WINDOW_CASES)),
                         ids=[str(c) for c in GPU_WINDOW_CASES])
def test_cuda_kernel_windowed_and_head_dim_256_match_plain_version(i,
                                                                   causal):
    *shape, window = GPU_WINDOW_CASES[i]
    _gpu_check(tuple(shape) + (30 + i,), causal, window, views=("model",))

"""The port's flash-attention gradient against ``jax.grad`` of the
reference's ``chunked_attention``.

On the CPU, ``ops.flash_attention`` runs the plain version, which
autograd differentiates, and ``flash_attention_bwd`` is autograd through
it.  Their dq, dk and dv must equal ``jax.grad`` through the reference's
model-path attention
(``src/repro/models/attention.py:chunked_attention``) on the same q, k, v
and cotangent, in float32, within 1e-5 of each gradient's largest entry:
causal, windowed, non-causal with S_q != S_k (cross-attention), GQA
groups 1, 3 and 4.  The forward's S_q != S_k is held to the reference
too.  On a card (``-m gpu``) the CUDA backward kernel must agree with
autograd through the plain forward, replays must give the same bits, and
the forward kernel's log-sum-exp must equal the scores' logsumexp; there
run ``python -m pytest --noconftest -m gpu
tests/test_torch_flash_attention_bwd.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
)

# (B, S_q, S_k, H, H_kv, d, causal, window): the model's (B, S, H, d) layout
CASES = [
    (2, 24, 24, 4, 4, 16, True, None),     # causal, MHA
    (1, 40, 40, 8, 2, 32, True, None),     # causal, GQA group 4
    (2, 33, 33, 6, 2, 16, True, 7),        # windowed (local attention)
    (1, 17, 50, 6, 6, 64, False, None),    # cross-attention, S_q < S_k
    (2, 30, 9, 4, 1, 32, False, None),     # cross-attention, S_q > S_k, MQA
    (1, 1, 23, 3, 1, 16, False, None),     # one query row
    (1, 20, 20, 6, 2, 16, False, None),    # full self-attention, group 3
]
IDS = [f"B{c[0]}-Sq{c[1]}-Sk{c[2]}-H{c[3]}/{c[4]}-d{c[5]}-"
       f"{'causal' if c[6] else 'full'}{'-w%d' % c[7] if c[7] else ''}"
       for c in CASES]


def _inputs(case, seed):
    B, Sq, Sk, H, H_kv, D = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, H_kv, D), dtype=np.float32),
            rng.standard_normal((B, Sk, H_kv, D), dtype=np.float32),
            rng.standard_normal((B, Sq, H, D), dtype=np.float32))


def _reference_grads(q, k, v, dout, causal, window):
    import jax
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention

    def f(q_, k_, v_):
        out = chunked_attention(q_, k_, v_, causal=causal, window=window,
                                q_block=8)
        return jnp.sum(out * dout), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_grads(q, k, v, dout, causal, window):
    """The model's call: (B, S, H, d) transposed to (B, H, S, d)."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                              vt.transpose(1, 2), causal=causal,
                              window=window).transpose(1, 2)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_gradients_match_jax_grad_of_reference_chunked_attention(i):
    case = CASES[i]
    causal, window = case[6], case[7]
    q, k, v, dout = _inputs(case, seed=i)
    want_out, want = _reference_grads(q, k, v, dout, causal, window)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    got_out, got = _port_grads(q, k, v, dout, causal, window)
    np.testing.assert_allclose(got_out, want_out, rtol=2e-5, atol=2e-5)
    # the backward's wrapper on CPU tensors: autograd through the plain
    # version, in the kernel's (B, H, S, d) layout
    wrapped = flash_attention_bwd(
        *(torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)), None,
        None, torch.from_numpy(dout).transpose(1, 2), causal=causal,
        window=window)
    for got in (got, [g.transpose(1, 2).numpy() for g in wrapped]):
        for name, g, w in zip("qkv", got, want):
            assert g.shape == w.shape
            scale = float(np.abs(w).max())
            assert np.abs(g - w).max() <= 1e-5 * scale, (name, scale)
    # the CPU path launches no kernel
    assert (flash_attention.launches, flash_attention_bwd.launches) == before


@pytest.mark.parametrize("i", [3, 4, 5], ids=[IDS[i] for i in (3, 4, 5)])
def test_forward_with_other_key_length_and_lse_match_reference(i):
    """S_q != S_k (no mask): the output against the reference's
    chunked_attention.  Only the kernel writes a log-sum-exp; it is held
    to the float64 logsumexp of these scores on the card
    (``test_cuda_forward_lse_matches_float64_logsumexp``)."""
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention

    case = CASES[i]
    q, k, v, _ = _inputs(case, seed=20 + i)
    want = np.asarray(chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=False))
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = ops.flash_attention(qt, kt, vt, causal=False)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                               rtol=2e-5, atol=2e-5)


def test_no_grad_or_frozen_inputs_take_the_plain_forward():
    q, k, v, _ = _inputs(CASES[0], seed=7)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt)
    assert out.grad_fn is None
    qg = qt.detach().requires_grad_()
    with torch.no_grad():
        assert ops.flash_attention(qg, kt, vt).grad_fn is None
    # on the CPU autograd differentiates the plain version itself
    assert ops.flash_attention(qg, kt, vt).grad_fn is not None
    assert not isinstance(ops.flash_attention(qg, kt, vt).grad_fn,
                          FlashAttention._backward_cls)


def test_causal_and_windowed_calls_need_equal_lengths():
    q, k, v, _ = _inputs(CASES[3], seed=1)
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    with pytest.raises(ValueError):
        flash_attention(qt, kt, vt, causal=True)
    with pytest.raises(ValueError):
        flash_attention(qt, kt, vt, causal=False, window=4)
    with pytest.raises(ValueError):
        flash_attention(qt, kt[:, :, :0], vt[:, :, :0], causal=False)


def test_recurrences_differentiate_on_the_cpu():
    """The plain recurrences are differentiable, so rwkv6 and
    recurrentgemma train on the CPU (their kernels have no backward yet:
    see the gpu test below)."""
    x = torch.randn(1, 5, 8, requires_grad=True)
    a = torch.rand(1, 5, 8)
    ops.rglru_scan(x, a).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    r = torch.randn(1, 4, 2, 16, requires_grad=True)
    y, _ = ops.wkv6(r, torch.randn(1, 4, 2, 16), torch.randn(1, 4, 2, 16),
                    -torch.rand(1, 4, 2, 16), torch.randn(2, 16))
    y.sum().backward()
    assert r.grad is not None


def _gpu_case(case, dtype, seed):
    B, Sq, Sk, H, H_kv, D, causal, window = case
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, Sq, D, generator=g).to("cuda", dtype)
    k = torch.randn(B, H_kv, Sk, D, generator=g).to("cuda", dtype)
    v = torch.randn(B, H_kv, Sk, D, generator=g).to("cuda", dtype)
    do = torch.randn(B, H, Sq, D, generator=g).to("cuda", dtype)
    return q, k, v, do


# (B, S_q, S_k, H, H_kv, d, causal, window) at the kernel's head dims
GPU_CASES = [
    (2, 17, 17, 8, 2, 64, True, None), (1, 1, 1500, 6, 6, 64, False, None),
    (1, 448, 1500, 6, 6, 64, False, None), (2, 127, 127, 8, 1, 128, True,
                                            None),
    (1, 300, 300, 4, 1, 256, True, 100), (1, 1500, 1500, 6, 6, 64, False,
                                          None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("i", range(len(GPU_CASES)),
                         ids=[str(c) for c in GPU_CASES])
def test_cuda_backward_matches_autograd_through_plain_version(i, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    case = GPU_CASES[i]
    causal, window = case[6], case[7]
    q, k, v, do = _gpu_case(case, dt, seed=i)
    qq, kk, vv = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(
        ref.ref_attention(qq, kk, vv, causal=causal, window=window),
        (qq, kk, vv), do.float())
    before = flash_attention_bwd.launches
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = flash_attention(qg, kg, vg, causal=causal, window=window)
    got = torch.autograd.grad(out, (qg, kg, vg), do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    # float32: 1e-5 of the largest entry; bf16 inputs, outputs and P
    # rounding: 2e-2 of it
    rel = 1e-5 if dt == torch.float32 else 2e-2
    for name, g_, w in zip("qkv", got, want):
        scale = float(w.abs().max()) or 1.0
        err = float((g_.float() - w).abs().max())
        assert err <= rel * scale, (name, err, scale)
    again = torch.autograd.grad(
        flash_attention(qg, kg, vg, causal=causal, window=window),
        (qg, kg, vg), do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_recurrence_kernels_raise_under_autograd_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    x = torch.randn(1, 5, 8, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.rglru_scan(x, torch.rand(1, 5, 8, device="cuda"))
    r = torch.randn(1, 4, 2, 16, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ops.wkv6(r, r.detach(), r.detach(), -torch.rand_like(r.detach()),
                 torch.randn(2, 16, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("i", range(len(GPU_CASES)),
                         ids=[str(c) for c in GPU_CASES])
def test_cuda_forward_lse_matches_float64_logsumexp(i):
    """The log-sum-exp the forward kernel writes for the backward, in
    float32, against the float64 logsumexp of the masked scaled scores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from repro_torch.kernels.flash_attention import _launch

    B, Sq, Sk, H, H_kv, D, causal, window = GPU_CASES[i]
    q, k, v, _ = _gpu_case(GPU_CASES[i], torch.float32, seed=40 + i)
    _, lse = _launch(q, k, v, causal, window, with_lse=True)
    qg = q.double().reshape(B, H_kv, H // H_kv, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.double()) / D ** 0.5
    if causal or window is not None:
        diff = (torch.arange(Sq, device="cuda")[:, None]
                - torch.arange(Sk, device="cuda")[None, :])
        mask = diff >= 0 if causal else torch.ones_like(diff, dtype=bool)
        if window is not None:
            mask &= diff < window
        s = s.masked_fill(~mask, float("-inf"))
    want = torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    torch.testing.assert_close(lse.double(), want, rtol=1e-6, atol=1e-5)

"""The port's WKV recurrence against the reference's Pallas kernel and oracles.

On the CPU the wrapper runs its plain version (the serial recurrence with a
float32 state, in the model's (B, S, H, d) layout), which must agree with
the reference's Pallas kernel (interpret mode, reached through
``.transpose(1, 2)`` views) at the kernel tests' tolerances (float32
rtol 1e-3 / atol 1e-4, bfloat16 2e-2); with the reference's serial oracle
``wkv6_serial`` from a nonzero starting state at rtol/atol 1e-5 (the same
recurrence, summed in another order); and with the chunked form
``wkv6_chunked`` (the reference's prefill) at 1e-4, the tolerance the
reference's own test holds its chunked form to against its serial one.
On a card (``-m gpu``) the CUDA kernel must agree with the plain version
within ``|got - want| <= atol * max(1, max|want|) + rtol * |want|``:
atol 1e-5 (both sum in float32 in different orders, and the rounding
error of a sum grows with its terms: with logw = 0 the state, and y with
it, grows with S, to |y| ~ 2,800 at S = 4096, where the serial float32
recurrence is 3.2e-3 off in float64) and rtol 1e-5 in float32, 1e-2 in
bfloat16 (one rounding of the output, at most 2^-7 of it).  The card's
machine has no JAX, so the reference is imported only by the tests that
compare with it: there run
``python -m pytest --noconftest -m gpu tests/test_torch_wkv6.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6  # noqa: E402

WKV_SHAPES = [
    # (B, H, S, D, chunk): tests/test_kernels.py's shapes
    (1, 2, 64, 16, 16),
    (2, 2, 96, 32, 32),
    (1, 4, 128, 64, 32),
]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
SERIAL_TOL = dict(rtol=1e-5, atol=1e-5)
CHUNKED_TOL = dict(rtol=1e-4, atol=1e-4)
#: the card's kernel against the plain version: (atol relative to the
#: output's scale, rtol) by dtype
CARD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 1e-2)}


def tol(dtype):
    return (dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16
            else dict(rtol=1e-3, atol=1e-4))


def _inputs(B, S, H, D, seed=0, logw=None):
    """r, k, v, logw (B, S, H, D), u (H, D) and a state s0 (B, H, D, D), as
    float32 numpy arrays; logw as the model's decay_log gives it (in
    [-5, 0)), or the constant given."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D), dtype=np.float32)
               for _ in "rkv")
    if logw is None:
        lw = np.maximum(-np.exp(rng.standard_normal((B, S, H, D)) - 1.0),
                        -5.0).astype(np.float32)
    else:
        lw = np.full((B, S, H, D), logw, np.float32)
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((B, H, D, D), dtype=np.float32)
    return r, k, v, lw, u, s0


def card_tol(want, dtype):
    atol, rtol = CARD_TOL[dtype]
    return dict(atol=atol * max(1.0, float(want.abs().max())), rtol=rtol)


def _torch(arrays, dtype=torch.float32, device="cpu"):
    """r, k, v in ``dtype`` (float32 -> bfloat16 rounds to nearest even in
    both packages), logw, u and s0 in float32."""
    r, k, v, lw, u, s0 = (torch.from_numpy(a).to(device) for a in arrays)
    return (r.to(dtype), k.to(dtype), v.to(dtype), lw, u, s0)


@pytest.mark.parametrize("shape", WKV_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_plain_version_matches_pallas_kernel(shape, dtype):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.rwkv6_scan import wkv6 as pallas

    B, H, S, D, chunk = shape
    dt = DTYPES[dtype]
    jd = jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32
    # the TPU kernel's (B, H, S, d) layout; the port reads it through views
    rng = np.random.default_rng(6)
    r, k, v = (rng.standard_normal((B, H, S, D), dtype=np.float32)
               for _ in "rkv")
    lw = np.maximum(-np.exp(rng.standard_normal((B, H, S, D)) - 1.0),
                    -5.0).astype(np.float32)
    u = (rng.standard_normal((H, D)) * 0.1).astype(np.float32)
    jr, jk, jv = (jnp.asarray(a, jd) for a in (r, k, v))
    pal = np.asarray(pallas(jr, jk, jv, jnp.asarray(lw), jnp.asarray(u),
                            chunk=chunk, interpret=True), np.float32)
    oracle = np.asarray(jref.ref_wkv6(jr, jk, jv, jnp.asarray(lw),
                                      jnp.asarray(u)), np.float32)
    np.testing.assert_allclose(pal, oracle, **tol(dt))

    tr, tk, tv = (torch.from_numpy(a).to(dt).transpose(1, 2)
                  for a in (r, k, v))
    tlw = torch.from_numpy(lw).transpose(1, 2)
    assert not tr.is_contiguous()
    y, s_last = wkv6(tr, tk, tv, tlw, torch.from_numpy(u))
    assert y.dtype == dt and y.shape == (B, S, H, D)
    assert s_last.dtype == torch.float32 and s_last.shape == (B, H, D, D)
    got = y.float().transpose(1, 2).numpy()
    np.testing.assert_allclose(got, pal, **tol(dt))
    np.testing.assert_allclose(got, oracle, **tol(dt))


@pytest.mark.parametrize("S", [1, 33, 100])
@pytest.mark.parametrize("impl", ["serial", "chunked"])
def test_plain_version_from_s0_matches_model_oracles(S, impl):
    """``ref_wkv6`` from a nonzero state against the reference's two
    evaluations: serial (its decode step) and chunked at 32 (its prefill,
    which pads S to a multiple of the chunk)."""
    import jax.numpy as jnp
    from repro.models.rwkv6 import wkv6_chunked, wkv6_serial

    arrays = _inputs(2, S, 3, 16, seed=S)
    r, k, v, lw, u, s0 = (jnp.asarray(a) for a in arrays)
    if impl == "serial":
        want_y, want_s = wkv6_serial(r, k, v, lw, u, s0)
        kw = SERIAL_TOL
    else:
        want_y, want_s = wkv6_chunked(r, k, v, lw, u, s0, chunk=32)
        kw = CHUNKED_TOL
    y, s_last = ops.wkv6(*_torch(arrays))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **kw)
    np.testing.assert_allclose(s_last.numpy(), np.asarray(want_s), **kw)


def test_state_carried_across_two_calls_equals_one_call():
    r, k, v, lw, u, s0 = _torch(_inputs(2, 70, 2, 16, seed=3))
    y, s = wkv6(r, k, v, lw, u, s0)
    h = 33
    y1, s1 = wkv6(r[:, :h], k[:, :h], v[:, :h], lw[:, :h], u, s0)
    y2, s2 = wkv6(r[:, h:], k[:, h:], v[:, h:], lw[:, h:], u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, **SERIAL_TOL)
    torch.testing.assert_close(s2, s, **SERIAL_TOL)
    # s0 is read, never written
    assert torch.equal(s0, torch.from_numpy(_inputs(2, 70, 2, 16, seed=3)[5]))


def test_cpu_dispatch_never_counts_a_launch():
    before = wkv6.launches
    args = _torch(_inputs(2, 9, 2, 16, seed=8))
    for got, want in zip(ops.wkv6(*args), ref.ref_wkv6(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.wkv6 is wkv6
    assert wkv6.launches == before == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    r, k, v, lw, u, s0 = _torch(_inputs(2, 9, 2, 16))
    with pytest.raises(TypeError):
        wkv6(r.double(), k.double(), v.double(), lw, u)
    with pytest.raises(TypeError):
        wkv6(r, k.bfloat16(), v, lw, u)
    with pytest.raises(TypeError):
        wkv6(r, k, v, lw.bfloat16(), u)
    with pytest.raises(TypeError):
        wkv6(r, k, v, lw, u.double())
    with pytest.raises(ValueError):
        wkv6(r, k[:, :4], v, lw, u)
    with pytest.raises(ValueError):
        wkv6(r[0], k[0], v[0], lw[0], u)
    with pytest.raises(ValueError):
        wkv6(r, k, v, lw, u[:1])
    with pytest.raises(ValueError):
        wkv6(*(t.to("meta") for t in (r, k, v, lw, u)))
    with pytest.raises(ValueError):
        wkv6(r, k, v, lw, u, s0[:1])
    with pytest.raises(TypeError):
        wkv6(r, k, v, lw, u, s0.bfloat16())
    with pytest.raises(ValueError):
        wkv6(r, k, v, lw, u, s0.to("meta"))


# (B, S, H, d): decode (S = 1), S short of, at and past a 32-step stage,
# ragged, long; head dims 16-128
GPU_SHAPES = [(1, 1, 64, 64), (8, 1, 64, 64), (1, 31, 4, 64),
              (2, 32, 4, 64), (1, 33, 4, 64), (3, 100, 2, 16),
              (2, 77, 3, 32), (1, 50, 2, 128), (1, 1000, 8, 64)]


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    before = wkv6.launches
    n = 0
    for i, (B, S, H, D) in enumerate(GPU_SHAPES):
        for logw in (None, -5.0, 0.0):
            arrays = _inputs(B, S, H, D, seed=20 + i, logw=logw)
            for dt in (torch.float32, torch.bfloat16):
                host = _torch(arrays, dt)
                dev = [t.cuda() for t in host]
                for start in (False, True):
                    s0h, s0d = (host[5], dev[5]) if start else (None, None)
                    want_y, want_s = ref.ref_wkv6(*host[:5], s0h)
                    # strided views of the model's layout: (B, H, S, d)
                    # storage read as (B, S, H, d)
                    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
                             for t in dev[:4]]
                    y, s_last = wkv6(*views, dev[4], s0d)
                    torch.cuda.synchronize()
                    n += 1
                    what = f"{(B, S, H, D)} {dt} logw={logw} s0={start}"
                    np.testing.assert_allclose(
                        y.float().cpu().numpy(), want_y.float().numpy(),
                        **card_tol(want_y.float(), dt), err_msg=what)
                    np.testing.assert_allclose(
                        s_last.cpu().numpy(), want_s.numpy(),
                        **card_tol(want_s, torch.float32), err_msg=what)
    assert wkv6.launches == before + n

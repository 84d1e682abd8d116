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
from repro_torch.kernels.wkv6 import (  # noqa: E402
    CHUNK,
    COLUMNS,
    FACTOR_MAX,
    STEP_COLS,
    TOTAL_MIN,
    plan,
    wkv6,
)

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


def _inputs(B, S, H, D, seed=0, logw=None, scale=1.0):
    """r, k, v, logw (B, S, H, D), u (H, D) and a state s0 (B, H, D, D), as
    float32 numpy arrays; k and v times ``scale``; logw as the model's
    decay_log gives it (in [-5, 0)), or the constant given."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, D), dtype=np.float32)
               * np.float32(1.0 if x == "r" else scale) for x in "rkv")
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


def _tf32(x):
    """x rounded to TF32 as the card's cvt.rna.tf32.f32 rounds it: 10
    mantissa bits, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(a, b, mode):
    """a @ b as the tensor cores would give it: ``"split"`` sums
    hi*hi + hi*lo + lo*hi of the TF32 parts hi = tf32(x), lo = tf32(x -
    hi); ``"tf32"`` one product of the rounded operands; ``"f32"`` exact
    float32 operands."""
    if mode == "f32":
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    if mode == "tf32":
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _chunked_model(r, k, v, lw, u, s0, chunk, mode="split",
                   total_min=TOTAL_MIN, factor_max=FACTOR_MAX,
                   carry_from_k_in=False, stats=None):
    """The prefill kernel's float32 arithmetic (``csrc/wkv6.cu``), head by
    head: per chunk the inclusive sums of logw in step order (the
    exclusive sum of a step is the inclusive sum of the step before, the
    total the last), recentred at theta = total / 2, q_in = r exp(cume -
    theta), k_in = k / exp(cum - theta), k_carry = k_in exp(theta) (=
    k exp(total - cum));
    A = q_in k_in^T strictly below the diagonal, 0 elsewhere (by select);
    y = q_in S' + A v + (r u k) v with S' = exp(theta) S, and S <-
    exp(total) S + k_carry^T v (``carry_from_k_in``: exp(theta) k_in^T v,
    the same sum with factors up to exp(-theta) times larger), each
    product as ``_product`` gives it.  A chunk with a total below
    ``total_min`` or a factor q_in or k_in past ``factor_max`` is
    evaluated step by step; ``stats`` counts the chunks of each path."""
    B, S, H, D = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    y = torch.empty(B, S, H, D)
    s_out = torch.empty(B, H, D, D)
    for b in range(B):
        for h in range(H):
            st = s0[b, h].clone() if s0 is not None else torch.zeros(D, D)
            for t0 in range(0, S, chunk):
                R, K, V, W = (x[b, t0:t0 + chunk, h] for x in (rf, kf, vf,
                                                                lw))
                n = R.shape[0]
                cum = torch.cumsum(W, 0)
                total = cum[-1]
                theta = 0.5 * total
                cume = torch.cat([torch.zeros_like(cum[:1]), cum[:-1]])
                q_in = R * torch.exp(cume - theta)
                k_in = K / torch.exp(cum - theta)
                big = max(float(q_in.abs().max()), float(k_in.abs().max()))
                serial = bool((total < total_min).any()) or not (
                    big <= factor_max)
                if stats is not None:
                    key = "step by step" if serial else "chunked"
                    stats[key] = stats.get(key, 0) + 1
                if serial:
                    for t in range(n):
                        kv = K[t][:, None] * V[t][None, :]
                        y[b, t0 + t, h] = R[t] @ (st + u[h][:, None] * kv)
                        st = torch.exp(W[t])[:, None] * st + kv
                    continue
                e_theta = torch.exp(theta)[:, None]
                i = torch.arange(n)
                a = torch.where(i[:, None] > i[None, :],
                                _product(q_in, k_in.T, mode),
                                torch.zeros(()))
                bonus = (R * u[h] * K).sum(1)[:, None]
                y[b, t0:t0 + n, h] = (_product(q_in, e_theta * st, mode)
                                      + _product(a, V, mode) + bonus * V)
                if carry_from_k_in:
                    carry = e_theta * _product(k_in.T, V, mode)
                else:
                    carry = _product((k_in * torch.exp(theta)).T, V, mode)
                st = torch.exp(total)[:, None] * st + carry
            s_out[b, h] = st
    return y, s_out


def _bf16_valued(arrays):
    """r, k, v rounded to bfloat16 and held in float32 (what the kernel
    reads on the model's path), logw, u and s0 as they are."""
    r, k, v, lw, u, s0 = _torch(arrays, torch.bfloat16)
    return r.float(), k.float(), v.float(), lw, u, s0


def _used(got, want):
    """The largest share of ``CARD_TOL`` (float32) ``got`` uses."""
    atol, rtol = CARD_TOL[torch.float32]
    scale = max(1.0, float(want.abs().max()))
    return float(((got - want).abs() / (atol * scale + rtol * want.abs())
                  ).max())


@pytest.mark.parametrize("S", [31, 32, 33, 64, 1000])
@pytest.mark.parametrize("logw", [None, -5.0, 0.0, -20.0],
                         ids=["model", "-5", "0", "-20"])
def test_chunked_split_tf32_model_matches_plain_version(S, logw):
    """The kernel's arithmetic, split TF32 emulated, from a given s0,
    within ``CARD_TOL`` of the serial recurrence: the model's decays, its
    -5 clamp (totals of -160, on the recentring's edge), no decay (the
    state grows with S) and -20 (every full chunk past ``TOTAL_MIN``,
    evaluated step by step; a short tail chunk not)."""
    args = _bf16_valued(_inputs(1, S, 2, 64, seed=40 + S, logw=logw))
    want_y, want_s = ref.ref_wkv6(*args)
    y, s_last = _chunked_model(*args, chunk=CHUNK[64])
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s_last).all())
    np.testing.assert_allclose(y.numpy(), want_y.numpy(),
                               **card_tol(want_y, torch.float32))
    np.testing.assert_allclose(s_last.numpy(), want_s.numpy(),
                               **card_tol(want_s, torch.float32))


@pytest.mark.parametrize("logw", [None, -5.0], ids=["model", "-5"])
def test_one_tf32_product_fails_the_tolerance_and_the_split_passes(logw):
    """Why the products are split: one TF32 product (10 mantissa bits) is
    many times past ``CARD_TOL``, hi*hi + hi*lo + lo*hi well within it."""
    args = _bf16_valued(_inputs(1, 100, 2, 64, seed=7, logw=logw))
    want_y, _ = ref.ref_wkv6(*args)
    plain, _ = _chunked_model(*args, chunk=32, mode="tf32")
    split, _ = _chunked_model(*args, chunk=32, mode="split")
    assert _used(plain, want_y) > 4.0
    assert _used(split, want_y) < 0.25


def test_a_chunk_past_32_steps_overflows_at_the_clamp():
    """Why chunks stay at 32 steps or below: at logw = -5 a 64-step chunk
    has totals of -320, and the recentred factors exp(160) overflow
    float32 unless such a chunk goes step by step."""
    args = _bf16_valued(_inputs(1, 64, 1, 16, seed=2, logw=-5.0))
    y, _ = _chunked_model(*args, chunk=64, total_min=-1e30,
                          factor_max=float("inf"))
    assert not bool(torch.isfinite(y).all())
    y, _ = _chunked_model(*args, chunk=64)
    assert bool(torch.isfinite(y).all())
    assert 32 * -5.0 >= TOTAL_MIN and max(CHUNK.values()) <= 32


#: (logw, scale of k and v, the path the chunks take): at the clamp and at
#: chunk totals of -164 the recentred factors reach |k| exp(80) and
#: |k| exp(82); past FACTOR_MAX (|k| in the thousands there) a chunk goes
#: step by step
LARGE = [(-5.0, 100.0, "chunked"), (-5.125, 30.0, "chunked"),
         (-5.125, 1000.0, "step by step")]


@pytest.mark.parametrize("logw,scale,path", LARGE,
                         ids=[f"{w}x{s:g}" for w, s, _ in LARGE])
def test_chunked_model_at_large_k_and_v_matches_plain_version(logw, scale,
                                                              path):
    """Large k and v where the recentred factors are largest: every
    product the chunk sums stays as small as the serial form's, so y and
    s_last are finite and within ``CARD_TOL``; factors past
    ``FACTOR_MAX`` send their chunks step by step."""
    args = _bf16_valued(_inputs(1, 100, 2, 64, seed=11, logw=logw,
                                scale=scale))
    want_y, want_s = ref.ref_wkv6(*args)
    stats = {}
    y, s_last = _chunked_model(*args, chunk=CHUNK[64], stats=stats)
    assert stats.get(path, 0) >= 2
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s_last).all())
    np.testing.assert_allclose(y.numpy(), want_y.numpy(),
                               **card_tol(want_y, torch.float32))
    np.testing.assert_allclose(s_last.numpy(), want_s.numpy(),
                               **card_tol(want_s, torch.float32))


def test_state_update_from_k_in_overflows_at_large_k_and_v():
    """Why the state update takes k_carry = k exp(total - cum): the same
    sum as exp(theta) k_in^T v holds products up to exp(-theta) = exp(80)
    times the serial form's at the clamp, and overflows float32 at |k v|
    of a few thousand."""
    args = _bf16_valued(_inputs(1, 64, 1, 64, seed=12, logw=-5.0,
                                scale=100.0))
    _, s_last = _chunked_model(*args, chunk=32, carry_from_k_in=True)
    assert not bool(torch.isfinite(s_last).all())
    _, s_last = _chunked_model(*args, chunk=32)
    assert bool(torch.isfinite(s_last).all())


#: (B, S, H, d): rwkv6-7b's prefills (17, 100, 512, 4096 tokens, the
#: batcher's 512 at batch 1), decode at batch 1 and 8, ragged shapes and
#: the other head dims
PLAN_SHAPES = [(1, 4096, 64, 64), (1, 512, 64, 64), (1, 100, 64, 64),
               (1, 17, 64, 64), (1, 1, 64, 64), (8, 1, 64, 64),
               (8, 40, 64, 64), (2, 33, 3, 16), (1, 77, 5, 32),
               (3, 50, 2, 128), (1, 2, 1, 16)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_launch_plan_covers_every_step_and_column_once(shape):
    """The blocks of a launch (column slice, head, batch) and the chunks
    each walks cover every (b, step, head, value column) of y and every
    (b, head, row, column) of s_last exactly once."""
    B, S, H, D = shape
    chunk, vb = plan(S, D)
    assert D % vb == 0 and vb % 16 == 0
    if S == 1:
        assert (chunk, vb) == (1, STEP_COLS)
    else:
        assert (chunk, vb) == (CHUNK[D], COLUMNS[D]) and chunk % 16 == 0
    y_cover = np.zeros((B, S, H, D), np.int32)
    s_cover = np.zeros((B, H, D, D), np.int32)
    for b in range(B):
        for h in range(H):
            for j0 in range(0, D, vb):
                s_cover[b, h, :, j0:j0 + vb] += 1
                for t0 in range(0, S, chunk):
                    y_cover[b, t0:t0 + chunk, h, j0:j0 + vb] += 1
    assert (y_cover == 1).all() and (s_cover == 1).all()
    if (B, H, D) == (1, 64, 64) and S > 1:
        # batch 1 at rwkv6-7b's width: 128 blocks of 32 columns, one an
        # SM of 132
        assert vb == 32 and B * H * (D // vb) == 128


# (B, S, H, d): decode (S = 1), S short of, at and past a 32-step stage,
# ragged, long; head dims 16-128
GPU_SHAPES = [(1, 1, 64, 64), (8, 1, 64, 64), (1, 31, 4, 64),
              (2, 32, 4, 64), (1, 33, 4, 64), (3, 100, 2, 16),
              (2, 77, 3, 32), (1, 50, 2, 128), (1, 1000, 8, 64),
              (1, 64, 4, 64), (1, 4096, 2, 64), (2, 33, 2, 128),
              (1, 1, 3, 16)]


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    before = wkv6.launches
    n = 0
    for i, (B, S, H, D) in enumerate(GPU_SHAPES):
        for logw in (None, -5.0, 0.0, -20.0):
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
    # large k and v where the recentred factors are largest (``LARGE``)
    for logw, scale, _ in LARGE:
        for dt in (torch.float32, torch.bfloat16):
            host = _torch(_inputs(1, 100, 4, 64, seed=13, logw=logw,
                                  scale=scale), dt)
            dev = [t.cuda() for t in host]
            want_y, want_s = ref.ref_wkv6(*host)
            y, s_last = wkv6(*dev)
            torch.cuda.synchronize()
            n += 1
            what = f"large {dt} logw={logw} k, v x{scale:g}"
            assert bool(torch.isfinite(y).all()), what
            np.testing.assert_allclose(
                y.float().cpu().numpy(), want_y.float().numpy(),
                **card_tol(want_y.float(), dt), err_msg=what)
            np.testing.assert_allclose(
                s_last.cpu().numpy(), want_s.numpy(),
                **card_tol(want_s, torch.float32), err_msg=what)
    assert wkv6.launches == before + n


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 4096, 64, 64), (1, 512, 64, 64),
                                   (1, 1, 64, 64), (8, 1, 64, 64)], ids=str)
def test_cuda_graph_replays_are_bitwise_equal(shape):
    """50 replays of one captured launch give the bits of the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    B, S, H, D = shape
    r, k, v, lw, u, s0 = (t.cuda() for t in _torch(
        _inputs(B, S, H, D, seed=9), torch.bfloat16))
    first = wkv6(r, k, v, lw, u, s0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        wkv6(r, k, v, lw, u, s0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = wkv6(r, k, v, lw, u, s0)
    for _ in range(50):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, f) for o, f in zip(out, first))

"""The recurrences' backward: ``wkv6_bwd`` and ``rglru_scan_bwd`` against
``jax.grad`` of the reference, a model of each kernel's arithmetic, their
launch plans and their counted branch.

On the CPU the wrappers autograd through their plain versions.  Their
gradients must equal ``jax.grad`` of the reference's ``wkv6_serial`` and
``wkv6_chunked`` (``src/repro/models/rwkv6.py``) and of its ``rglru_scan``
(``src/repro/models/rglru.py``) on the same inputs, made by numpy from a
seed, in float32, with a starting state and a cotangent of the last state:
each gradient within ``JAX_TOL`` of its largest entry (1e-5 against the
serial forms; 1e-4 against the chunked WKV form, the tolerance the
reference holds that form to against its serial one).

The kernels' arithmetic is modelled here in torch (the WKV backward's
chunked form in split TF32: the states entering each chunk from a walk
forward, the chunk's products, dlogw summed directly, chunks past the
forward's guards walked step by step; the RG-LRU backward's chunk
summaries folded last chunk first) and held to autograd through the plain
versions within the card's tolerance (``CARD_TOL``: atol relative to each
gradient's largest entry), and the WKV model also to ``jax.grad`` of
``wkv6_serial`` within 1e-5, where the chunked form's own gradient misses
dlogw at logw = -5.  On a card (``-m gpu``) the CUDA kernels must agree
with autograd through the plain versions within ``CARD_TOL`` and give the
same bits over 20 calls; the card's machine has no JAX, so there run
``python -m pytest --noconftest -m gpu tests/test_torch_recurrence_bwd.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.rglru_scan import (  # noqa: E402
    CHANNELS,
    chunk_plan,
    rglru_scan_bwd,
)
from repro_torch.kernels.wkv6 import (  # noqa: E402
    BWD_CHUNK,
    CHUNK,
    FACTOR_MAX,
    HEAD_DIMS,
    TOTAL_MIN,
    bwd_plan,
    bwd_workspace_bytes,
    wkv6_bwd,
)
from repro_torch.roofline import kernel_costs  # noqa: E402

#: the port's gradients against jax.grad of the reference: |err| <= tol x
#: the gradient's largest entry
JAX_TOL = {"serial": 1e-5, "chunked": 1e-4, "rglru": 1e-5}
#: the kernels (and the model of their arithmetic) against autograd
#: through the plain versions: |err| <= atol x max|want| + rtol x |want|,
#: (atol, rtol) by dtype, the forwards' tolerances (chip_smoke.py's
#: WKV_TOL and SCAN_TOL): float32 sums in another order; bf16 gradients
#: are rounded once (at most 2^-7 of them)
CARD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 1e-2)}
WKV_NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


def _wkv_inputs(B, S, H, D, seed=0, logw=None):
    """r, k, v, logw (B, S, H, D), u (H, D), s0 and ds_last (B, H, D, D)
    and dy (B, S, H, D), float32 numpy; logw as the model's decay_log
    makes it (-exp of a normal, clamped at -5), or a constant."""
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    r, k, v = (draw(B, S, H, D, scale=0.5) for _ in range(3))
    if logw is None:
        lw = np.maximum(-np.exp(draw(B, S, H, D, scale=0.7) - 0.5), -5.0)
    else:
        lw = np.full((B, S, H, D), logw, np.float32)
    u = draw(H, D, scale=0.5)
    s0 = draw(B, H, D, D, scale=0.3)
    dy = draw(B, S, H, D)
    ds_last = draw(B, H, D, D, scale=0.3)
    return r, k, v, lw.astype(np.float32), u, s0, dy, ds_last


def _close_to_max(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert np.isfinite(got).all(), what
    assert err <= tol * scale, (what, err, scale)


def _card_close(got, want, dtype, what):
    """``CARD_TOL`` against the gradient's largest entry; returns the
    share of the tolerance used."""
    atol, rtol = CARD_TOL[dtype]
    got, want = got.double(), want.double()
    scale = float(want.abs().max()) or 1.0
    limit = atol * scale + rtol * want.abs()
    used = float(((got - want).abs() / limit).max())
    assert bool(torch.isfinite(got).all()), what
    assert used <= 1.0, (what, used)
    return used


# ---------------------------------------------------------------------------
# against jax.grad of the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 17, 33, 64])
@pytest.mark.parametrize("logw", [None, -5.0], ids=["model", "-5"])
@pytest.mark.parametrize("form", ["serial", "chunked"])
def test_wkv6_gradients_match_jax_grad_of_the_reference(S, logw, form):
    """(dr, dk, dv, dlogw, du, ds0) from a given s0, with y's and
    s_last's cotangents, against jax.grad of the reference's
    ``wkv6_serial`` / ``wkv6_chunked`` of <y, dy> + <s_last, ds_last>."""
    import jax
    import jax.numpy as jnp
    from repro.models.rwkv6 import wkv6_chunked, wkv6_serial

    arrays = _wkv_inputs(2, S, 2, 16, seed=S, logw=logw)
    r, k, v, lw, u, s0, dy, dsl = arrays
    fn = wkv6_serial if form == "serial" else wkv6_chunked

    def loss(r_, k_, v_, lw_, u_, s0_):
        y, s_last = fn(r_, k_, v_, lw_, u_, s0_)
        return jnp.sum(y * dy) + jnp.sum(s_last * dsl)

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, lw, u, s0)))
    t = [torch.from_numpy(a) for a in arrays]
    got = wkv6_bwd(*t[:6], t[6], t[7])
    for name, g, w in zip(WKV_NAMES, got, want):
        _close_to_max(g.numpy(), np.asarray(w), JAX_TOL[form],
                      f"{name} S={S} logw={logw} {form}")


@pytest.mark.parametrize("S", [1, 17, 33, 64])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_rglru_gradients_match_jax_grad_of_the_reference(S, with_h0):
    """(dx, da, dh0) against jax.grad of the reference's ``rglru_scan``
    (an associative scan) of <h, dh>, a in (0, 1) as the model makes
    it."""
    import jax
    import jax.numpy as jnp
    from repro.models.rglru import rglru_scan as jscan

    rng = np.random.default_rng(100 + S)
    B, D = 2, 24
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    a = rng.uniform(0.05, 0.999, (B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    dh = rng.standard_normal((B, S, D)).astype(np.float32)

    def loss(x_, a_, h0_):
        h, _ = jscan(x_, a_, h0_ if with_h0 else None)
        return jnp.sum(h * dh)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(a),
                                            jnp.asarray(h0))
    got = rglru_scan_bwd(torch.from_numpy(x), torch.from_numpy(a),
                         torch.from_numpy(h0) if with_h0 else None,
                         torch.from_numpy(dh))
    for name, g, w in zip(("dx", "da"), got, want):
        _close_to_max(g.numpy(), np.asarray(w), JAX_TOL["rglru"],
                      f"{name} S={S}")
    if with_h0:
        _close_to_max(got[2].numpy(), np.asarray(want[2]), JAX_TOL["rglru"],
                      f"dh0 S={S}")
    else:
        assert got[2] is None


def test_cpu_wrappers_differentiate_through_the_plain_versions():
    """``ops.wkv6`` / ``ops.rglru_scan`` under autograd on the CPU give
    what ``wkv6_bwd`` / ``rglru_scan_bwd`` give, and launch nothing."""
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.kernels import wkv6 as WK
    before = (WK.wkv6_bwd.launches, RS.rglru_scan_bwd.launches)
    arrays = [torch.from_numpy(a) for a in _wkv_inputs(1, 9, 2, 16, seed=3)]
    leaves = [t.clone().requires_grad_() for t in arrays[:6]]
    y, s_last = ops.wkv6(*leaves)
    torch.autograd.backward([y, s_last], [arrays[6], arrays[7]])
    want = wkv6_bwd(*arrays)
    for name, leaf, w in zip(WKV_NAMES, leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0, msg=name)
    x = torch.randn(2, 7, 5, requires_grad=True)
    a = torch.rand(2, 7, 5, requires_grad=True)
    dh = torch.randn(2, 7, 5)
    ops.rglru_scan(x, a).backward(dh)
    dx, da, _ = rglru_scan_bwd(x.detach(), a.detach(), None, dh)
    assert torch.equal(x.grad, dx) and torch.equal(a.grad, da)
    assert (WK.wkv6_bwd.launches, RS.rglru_scan_bwd.launches) == before


# ---------------------------------------------------------------------------
# models of the kernels' arithmetic
# ---------------------------------------------------------------------------


def _tf32(x):
    """x rounded to TF32 as the card's cvt.rna.tf32.f32 rounds it: 10
    mantissa bits, to nearest, ties away from zero (as in
    tests/test_torch_wkv6.py)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(a, b):
    """a @ b as the tensor cores give it in split TF32: hi*hi + hi*lo +
    lo*hi of the parts hi = tf32(x), lo = tf32(x - hi) (a bfloat16 value
    has no lo part, so its products are the same)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _wkv_bwd_model(r, k, v, logw, u, s0, dy, ds_last, chunk=None,
                   stats=None):
    """``csrc/wkv6_bwd.cu``'s arithmetic in torch, float32, batched over
    (B, H), chunks of ``chunk`` steps (``BWD_CHUNK[d]``), steps past S
    padded with r = k = v = dy = 0 and logw = 0 as the copy engine pads
    them.  A walk forward keeps the state entering each chunk, S <-
    exp(tot) S + (k exp(tot - cum))^T v; the walk back, last chunk first,
    per chunk: q_in = r exp(cume - theta), k_in = k / exp(cum - theta),
    k_carry = k_in exp(theta), r_e = q_in exp(theta); A = q_in k_in^T and
    dA = dy v^T strictly below the diagonal (by select); dr, dk, dv from
    dA k_in, dA^T q_in, A^T dy and the inter-chunk products dy S_c^T,
    v dS^T, k_carry dS; dlogw summed directly (exp(tot) rowsum(S_c o dS), the
    suffix sums of r o dr^inter, the prefix sums of k o dk^inter and the
    running sum over a < s < b of q_in[b] k_in[a] dA[b, a]); dS <-
    exp(tot) dS + r_e^T dy.  A (batch, head)'s chunk with a total below
    ``TOTAL_MIN`` or a factor q_in or k_in past ``FACTOR_MAX`` is walked
    back step by step; ``stats`` counts the chunks of each path.  Each
    product is split TF32 (``_product``)."""
    B, S, H, D = r.shape
    C = chunk or BWD_CHUNK[D]
    n = -(-S // C)
    pad = n * C - S

    def chunks(t):  # (n, B, H, C, D)
        t = torch.cat([t.float(), t.new_zeros((B, pad, H, D)).float()], 1)
        return t.reshape(B, n, C, H, D).permute(1, 0, 3, 2, 4)

    R, K, V, W, DY = (chunks(t) for t in (r, k, v, logw, dy))

    def T(x):
        return x.transpose(-1, -2)

    st = s0.clone() if s0 is not None else torch.zeros(B, H, D, D)
    states = [st]
    for c in range(n - 1):
        cum = torch.cumsum(W[c], -2)
        tot = cum[..., -1:, :]
        st = T(torch.exp(tot)) * st + _product(T(K[c] * torch.exp(tot - cum)),
                                               V[c])
        states.append(st)
    ds = ds_last.clone() if ds_last is not None else torch.zeros(B, H, D, D)
    outs = torch.zeros(4, n, B, H, C, D)  # dr, dk, dv, dlogw
    du = torch.zeros(B, H, D)
    idx = torch.arange(C)
    below = idx[:, None] > idx[None, :]
    zero = torch.zeros(())
    for c in reversed(range(n)):
        Rc, Kc, Vc, Wc, DYc, Sc = R[c], K[c], V[c], W[c], DY[c], states[c]
        cum = torch.cumsum(Wc, -2)
        tot = cum[..., -1:, :]
        theta = 0.5 * tot
        cume = torch.cat([torch.zeros_like(cum[..., :1, :]), cum[..., :-1, :]],
                         -2)
        e1, e2 = torch.exp(cume - theta), 1.0 / torch.exp(cum - theta)
        eth, etot = torch.exp(theta), torch.exp(tot)
        q_in, k_in = Rc * e1, Kc * e2
        k_carry, r_e = k_in * eth, q_in * eth
        vdy = (Vc * DYc).sum(-1, keepdim=True)
        ruk = (Rc * u[:, None] * Kc).sum(-1, keepdim=True)
        du += (Rc * Kc * vdy).sum(-2)
        big = torch.maximum(q_in.abs().amax((-1, -2)),
                            k_in.abs().amax((-1, -2)))
        serial = (tot < TOTAL_MIN).any(-1).any(-1) | ~(big <= FACTOR_MAX)
        if stats is not None:
            stats["step by step"] = (stats.get("step by step", 0)
                                     + int(serial.sum()))
            stats["chunked"] = stats.get("chunked", 0) + int((~serial).sum())
        A = torch.where(below, _product(q_in, T(k_in)), zero)
        dA = torch.where(below, _product(DYc, T(Vc)), zero)
        dr_inter = (e1 * eth) * _product(DYc, T(Sc))
        dk_inter = (e2 * eth) * _product(Vc, T(ds))
        grads = [e1 * _product(dA, k_in) + dr_inter + u[:, None] * Kc * vdy,
                 e2 * _product(T(dA), q_in) + dk_inter
                 + u[:, None] * Rc * vdy,
                 _product(T(A), DYc) + _product(k_carry, ds) + ruk * DYc]
        rdr, kdk = Rc * dr_inter, Kc * dk_inter
        dlogw = (etot * (Sc * ds).sum(-1)[..., None, :]).expand(
            -1, -1, C, -1).clone()
        run = torch.zeros_like(rdr[..., 0, :])
        for s in reversed(range(C)):
            dlogw[..., s, :] += run
            run = run + rdr[..., s, :]
        run = torch.zeros_like(kdk[..., 0, :])
        inner = torch.zeros_like(q_in)  # b: sum_{a < s} k_in[a] dA[b, a]
        for s in range(C):
            later = (idx > s)[:, None]
            dlogw[..., s, :] += run + torch.where(later, q_in * inner,
                                                  zero).sum(-2)
            run = run + kdk[..., s, :]
            inner = inner + k_in[..., s:s + 1, :] * dA[..., :, s:s + 1]
        grads.append(dlogw)
        ds_new = T(etot) * ds + _product(T(r_e), DYc)
        if bool(serial.any()):
            hist, sc = [], Sc
            for s in range(C):
                hist.append(sc)
                sc = (torch.exp(Wc[..., s, :])[..., None] * sc
                      + Kc[..., s, :, None] * Vc[..., s, None, :])
            d2 = ds
            step = torch.zeros(4, B, H, C, D)
            for s in reversed(range(C)):
                w = torch.exp(Wc[..., s, :])
                bonus = u * vdy[..., s, :]
                step[0, ..., s, :] = ((hist[s] * DYc[..., s, None, :]).sum(-1)
                                      + bonus * Kc[..., s, :])
                step[1, ..., s, :] = ((d2 * Vc[..., s, None, :]).sum(-1)
                                      + bonus * Rc[..., s, :])
                step[2, ..., s, :] = ((d2 * Kc[..., s, :, None]).sum(-2)
                                      + ruk[..., s, :] * DYc[..., s, :])
                step[3, ..., s, :] = w * (hist[s] * d2).sum(-1)
                d2 = (w[..., None] * d2
                      + Rc[..., s, :, None] * DYc[..., s, None, :])
            pick = serial[..., None, None]
            grads = [torch.where(pick, a, g) for a, g in zip(step, grads)]
            ds_new = torch.where(pick, d2, ds_new)
        for q, g in enumerate(grads):
            outs[q, c] = g
        ds = ds_new

    def back(t):
        return t.permute(1, 0, 3, 2, 4).reshape(B, n * C, H, D)[:, :S]

    return (back(outs[0]), back(outs[1]), back(outs[2]), back(outs[3]),
            du.sum(0), ds if s0 is not None else None)


def _plain_wkv_grads(arrays, with_s0=True, with_ds_last=True):
    """Autograd through ``ref_wkv6``: (dr, dk, dv, dlogw, du, ds0)."""
    t = [torch.from_numpy(a) for a in arrays]
    return wkv6_bwd(*t[:5], t[5] if with_s0 else None, t[6],
                    t[7] if with_ds_last else None)


@pytest.mark.parametrize("S", [1, 17, 33, 64, 100])
@pytest.mark.parametrize("logw", [None, -5.0, 0.0, -20.0],
                         ids=["model", "-5", "0", "-20"])
def test_wkv_bwd_kernel_model_matches_autograd_through_plain(S, logw):
    """The kernel's arithmetic (rwkv6-7b's d = 64, chunks of 32 steps, a
    ragged last chunk) within ``CARD_TOL`` of autograd through the plain
    recurrence: the model's decays, the -5 clamp (totals of -160, on the
    recentring's edge), no decay (the state grows with S) and -20 (every
    chunk of 9 steps or more past ``TOTAL_MIN``, walked back step by step;
    a shorter tail chunk not)."""
    arrays = _wkv_inputs(1, S, 2, 64, seed=50 + S, logw=logw)
    want = _plain_wkv_grads(arrays)
    t = [torch.from_numpy(a) for a in arrays]
    stats = {}
    got = _wkv_bwd_model(*t, stats=stats)
    for name, g, w in zip(WKV_NAMES, got, want):
        _card_close(g, w, torch.float32, f"{name} S={S} logw={logw}")
    # (batch, head) chunks whose total at -20 passes TOTAL_MIN
    past = sum(2 for c in range(0, S, 32) if -20.0 * min(32, S - c)
               < TOTAL_MIN)
    assert stats.get("step by step", 0) == (past if logw == -20.0 else 0)


@pytest.mark.parametrize("logw", [None, -5.0], ids=["model", "-5"])
@pytest.mark.parametrize("D", [16, 32, 128])
def test_wkv_bwd_kernel_model_at_every_head_dim(D, logw):
    """The other head dims (chunks of 32 steps, 16 at d = 128), without
    s0 and without ds_last."""
    arrays = _wkv_inputs(2, 21 if D < 128 else 37, 2, D, seed=D, logw=logw)
    want = _plain_wkv_grads(arrays, with_s0=False, with_ds_last=False)
    t = [torch.from_numpy(a) for a in arrays]
    got = _wkv_bwd_model(*t[:5], None, t[6], None)
    for name, g, w in zip(WKV_NAMES[:5], got, want):
        _card_close(g, w, torch.float32, f"{name} D={D}")
    assert got[5] is None and want[5] is None


def _jax_wkv_grads(fn, arrays):
    """jax.grad of <y, dy> + <s_last, ds_last> through the reference's
    ``fn`` at (r, k, v, logw, u, s0)."""
    import jax
    import jax.numpy as jnp
    r, k, v, lw, u, s0, dy, dsl = arrays

    def loss(r_, k_, v_, lw_, u_, s0_):
        y, s_last = fn(r_, k_, v_, lw_, u_, s0_)
        return jnp.sum(y * dy) + jnp.sum(s_last * dsl)

    return jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, lw, u, s0)))


@pytest.mark.parametrize("S", [1, 17, 33, 64])
@pytest.mark.parametrize("logw", [None, -5.0], ids=["model", "-5"])
def test_wkv_bwd_kernel_model_matches_jax_grad_of_serial(S, logw):
    """The kernel's arithmetic within ``JAX_TOL["serial"]`` of jax.grad
    of the reference's ``wkv6_serial``, every gradient, dlogw at the -5
    clamp included."""
    from repro.models.rwkv6 import wkv6_serial
    arrays = _wkv_inputs(2, S, 2, 64, seed=60 + S, logw=logw)
    want = _jax_wkv_grads(wkv6_serial, arrays)
    got = _wkv_bwd_model(*(torch.from_numpy(a) for a in arrays))
    for name, g, w in zip(WKV_NAMES, got, want):
        _close_to_max(g.numpy(), np.asarray(w), JAX_TOL["serial"],
                      f"{name} S={S} logw={logw}")


@pytest.mark.parametrize("S", [17, 64])
def test_direct_dlogw_holds_where_the_chunked_forms_gradient_misses(S):
    """Why dlogw is summed directly: at logw = -5 the chunked form's own
    gradient (jax.grad of ``wkv6_chunked``, a difference of sums dominated
    by adjacent pairs) is more than 1e-5 of dlogw's largest entry from
    jax.grad of ``wkv6_serial`` (4.2e-05 and 3.4e-05 here), and the
    kernel's direct form within it."""
    from repro.models.rwkv6 import wkv6_chunked, wkv6_serial
    arrays = _wkv_inputs(2, S, 2, 64, seed=1, logw=-5.0)
    serial = np.asarray(_jax_wkv_grads(wkv6_serial, arrays)[3], np.float64)
    chunked = np.asarray(_jax_wkv_grads(wkv6_chunked, arrays)[3], np.float64)
    scale = float(np.abs(serial).max())
    assert float(np.abs(chunked - serial).max()) > JAX_TOL["serial"] * scale
    got = _wkv_bwd_model(*(torch.from_numpy(a) for a in arrays))[3]
    _close_to_max(got.numpy(), serial, JAX_TOL["serial"], f"dlogw S={S}")


def _rglru_bwd_model(dh, a, h, h0, n_chunks, chunk, parts=4):
    """``csrc/rglru_scan_bwd.cu``'s arithmetic in torch: each chunk's
    parts folded backwards from 0 into (prod a, g), the parts into the
    chunk's summary last part first; the gradient entering a chunk from
    its end the fold of the later chunks' summaries, last chunk first,
    from 0, in runs of ``ceil(later / parts)``; then each part rescanned
    backwards.  a_{t+1} is 0 past S."""
    B, S, D = a.shape
    a_next = torch.cat([a[:, 1:], a.new_zeros(B, 1, D)], 1).float()
    dh, h = dh.float(), h.float()
    per = -(-chunk // parts)
    summaries, part_folds = {}, {}
    for c in range(n_chunks):
        t0, n = c * chunk, min(chunk, S - c * chunk)
        folds = []
        for p in range(parts):
            lo, hi = p * per, min(n, p * per + per)
            pp, g = torch.ones(B, D), torch.zeros(B, D)
            for t in range(hi - 1, lo - 1, -1):
                g = a_next[:, t0 + t] * g + dh[:, t0 + t]
                pp = pp * a_next[:, t0 + t]
            folds.append((pp, g))
        part_folds[c] = folds
        pp, g = torch.ones(B, D), torch.zeros(B, D)
        for q in reversed(range(parts)):
            g = folds[q][0] * g + folds[q][1]
            pp = pp * folds[q][0]
        summaries[c] = (pp, g)
    dx, da = torch.zeros(B, S, D), torch.zeros(B, S, D)
    dh0 = None
    for c in range(n_chunks):
        later = [n_chunks - 1 - m for m in range(n_chunks - 1 - c)]
        per_c = -(-len(later) // parts) if later else 0
        g = torch.zeros(B, D)
        for p in range(parts):
            pp, gg = torch.ones(B, D), torch.zeros(B, D)
            for q in later[p * per_c:(p + 1) * per_c]:
                gg = summaries[q][0] * gg + summaries[q][1]
                pp = pp * summaries[q][0]
            g = pp * g + gg
        t0, n = c * chunk, min(chunk, S - c * chunk)
        enter = {}
        for q in reversed(range(parts)):
            enter[q] = g
            g = part_folds[c][q][0] * g + part_folds[c][q][1]
        for p in range(parts):
            g = enter[p]
            lo, hi = p * per, min(n, p * per + per)
            for t in range(hi - 1, lo - 1, -1):
                gt = t0 + t
                g = a_next[:, gt] * g + dh[:, gt]
                dx[:, gt] = g
                hp = h[:, gt - 1] if gt > 0 else (
                    h0 if h0 is not None else torch.zeros(B, D))
                da[:, gt] = g * hp
                if gt == 0 and h0 is not None:
                    dh0 = a[:, 0].float() * g
    return dx, da, dh0


@pytest.mark.parametrize("S,n_chunks,chunk", [(1, 1, 1), (17, 2, 9),
                                              (100, 4, 32), (300, 3, 128),
                                              (64, 64, 1)])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
def test_rglru_bwd_kernel_model_matches_autograd_through_plain(
        S, n_chunks, chunk, with_h0):
    """The reverse chunked scan (ragged last chunk, one-step chunks, a
    part with no steps) within ``CARD_TOL`` of autograd through the plain
    recurrence, its h the float32 carry."""
    g = torch.Generator().manual_seed(S)
    B, D = 2, 6
    x = torch.randn(B, S, D, generator=g)
    a = torch.rand(B, S, D, generator=g) * 0.95 + 0.05
    h0 = torch.randn(B, D, generator=g) if with_h0 else None
    dh = torch.randn(B, S, D, generator=g)
    want = rglru_scan_bwd(x, a, h0, dh)
    h = ref.ref_rglru(x, a, h0)
    got = _rglru_bwd_model(dh, a, h, h0, n_chunks, chunk)
    for name, gg, w in zip(("dx", "da", "dh0"), got, want):
        if w is None:
            assert gg is None
            continue
        _card_close(gg, w, torch.float32, f"{name} S={S}")


# ---------------------------------------------------------------------------
# launch plans
# ---------------------------------------------------------------------------

#: (B, S, H, d): rwkv6-7b's training shape and T5b's, ragged lengths, one
#: step, every head dim
BWD_PLAN_SHAPES = [(4, 1024, 64, 64), (1, 256, 64, 64), (1, 1, 64, 64),
                   (2, 33, 3, 16), (1, 77, 5, 32), (3, 50, 2, 128),
                   (1, 17, 2, 64)]


@pytest.mark.parametrize("shape", BWD_PLAN_SHAPES, ids=str)
def test_wkv_bwd_launch_plan_covers_every_step_and_column_once(shape):
    """One block per (head, batch), a whole head: its walk forward covers
    chunks 0 .. n - 2 (writing the state entering each, and the last one's
    when it turns), its walk back every chunk last first, so every
    (b, step, head, channel) of dr, dk, dv and dlogw and every (b, head,
    row, column) of ds0 is written once; chunks of BWD_CHUNK[d] steps in
    strips of 16; the workspace holds n states a (batch, head) and du's
    partials, 134 MB at rwkv6-7b's training shape."""
    B, S, H, D = shape
    chunk, n_chunks = bwd_plan(S, D)
    assert chunk == BWD_CHUNK[D] and chunk % 16 == 0
    assert n_chunks * chunk >= S > (n_chunks - 1) * chunk
    out_cover = np.zeros((B, S, H, D), np.int32)
    s_cover = np.zeros((B, H, D, D), np.int32)
    for b in range(B):
        for h in range(H):
            forward = list(range(n_chunks - 1))
            back = [2 * (n_chunks - 1) - x
                    for x in range(n_chunks - 1, 2 * n_chunks - 1)]
            assert back == list(reversed(range(n_chunks)))
            written = set(forward) | {n_chunks - 1}
            assert written == set(range(n_chunks))  # every state read back
            for c in back:
                out_cover[b, c * chunk:min(S, (c + 1) * chunk), h, :] += 1
            s_cover[b, h] += 1
    assert (out_cover == 1).all() and (s_cover == 1).all()
    assert bwd_workspace_bytes(B, S, H, D) == 4 * (
        n_chunks * B * H * D * D + B * H * D)
    if shape == (4, 1024, 64, 64):
        assert B * H == 256 and n_chunks == 32
        assert bwd_workspace_bytes(B, S, H, D) == 134_217_728 + 65_536


@pytest.mark.parametrize("shape", [(4, 1024, 2560), (1, 256, 2560),
                                   (1, 1, 2560), (3, 129, 77),
                                   (1, 3000, 2560)], ids=str)
def test_rglru_bwd_tickets_cover_every_chunk_once_last_first(shape):
    """The backward's tickets map onto (chunk, batch, channel block) one
    to one, later chunks on lower tickets (a block waits only on chunks
    that have started), and the chunks cover every step once."""
    B, S, D = shape
    n_chunks, chunk = chunk_plan(B, S, D, 132)
    n_cb = -(-D // CHANNELS)
    seen = {}
    for job in range(n_chunks * B * n_cb):
        c = n_chunks - 1 - job // (B * n_cb)
        rest = job % (B * n_cb)
        seen[(c, rest // n_cb, rest % n_cb)] = job
    assert len(seen) == n_chunks * B * n_cb
    for (c, b, cb), job in seen.items():
        for later in range(c + 1, n_chunks):
            assert seen[(later, b, cb)] < job
    steps = np.zeros(S, np.int32)
    for c in range(n_chunks):
        steps[c * chunk:min(S, (c + 1) * chunk)] += 1
    assert (steps == 1).all()


# ---------------------------------------------------------------------------
# the counted branch (the dry run)
# ---------------------------------------------------------------------------


def test_fake_tensors_record_the_backward_costs():
    """On fake tensors both Functions return fake gradients of the right
    shapes and record the forward and the backward kernels' operations and
    bytes, never launching and never raising."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.kernels import wkv6 as WK
    kernel_costs.reset()
    before = (WK.wkv6.launches, WK.wkv6_bwd.launches,
              RS.rglru_scan.launches, RS.rglru_scan_bwd.launches)
    B, S, H, D = 2, 40, 4, 64
    with FakeTensorMode():
        r, k, v = (torch.zeros(B, S, H, D, dtype=torch.bfloat16,
                               requires_grad=True) for _ in range(3))
        lw = torch.zeros(B, S, H, D, requires_grad=True)
        u = torch.zeros(H, D, requires_grad=True)
        y, _ = ops.wkv6(r, k, v, lw, u)
        y.float().sum().backward()
        assert r.grad.shape == r.shape and r.grad.dtype == torch.bfloat16
        assert lw.grad.dtype == torch.float32 and u.grad.shape == (H, D)
        x = torch.zeros(B, S, 96, requires_grad=True)
        a = torch.zeros(B, S, 96, requires_grad=True)
        h0 = torch.zeros(B, 96, requires_grad=True)
        ops.rglru_scan(x, a, h0).sum().backward()
        assert x.grad.shape == x.shape and h0.grad.shape == h0.shape
    c = kernel_costs.COUNTS
    assert c["wkv6.calls"] == 1 and c["wkv6_bwd.calls"] == 1
    assert c["wkv6_bwd.flops"] == kernel_costs.wkv6_bwd_cost(
        B, S, H, D, 2, False, False, BWD_CHUNK[D])[0]
    assert c["rglru_scan.calls"] == 1 and c["rglru_scan_bwd.calls"] == 1
    assert c["rglru_scan_bwd.bytes"] == kernel_costs.rglru_scan_bwd_cost(
        B * S * 96, 4, B * 96 * 4)[1]
    assert (WK.wkv6.launches, WK.wkv6_bwd.launches, RS.rglru_scan.launches,
            RS.rglru_scan_bwd.launches) == before
    kernel_costs.reset()


def test_backward_costs():
    """The bounds' counts: the WKV backward's products, 3 (10 C d + 10 d^2)
    flops a token and head on the TF32 rate (48.3 GFLOP at rwkv6-7b's
    training shape, 0.098 ms at the card's TF32 rate, below its bytes'
    0.110 ms: bound by bytes); the RG-LRU backward's three flops an
    element, its bytes those it moves."""
    from repro_torch.roofline.analysis import HBM_BW, PEAK_BY_RATE
    flops, nbytes, rate = kernel_costs.wkv6_bwd_cost(
        4, 1024, 64, 64, 2, False, False, BWD_CHUNK[64])
    assert rate == "tf32" and f"{flops / 1e9:.1f}" == "48.3"
    assert flops == 3 * (10 * 32 * 64 + 10 * 64 * 64) * 4 * 1024 * 64
    assert nbytes == 4 * 1024 * 64 * 64 * (7 * 2 + 8) + 8 * 64 * 64
    assert f"{nbytes / HBM_BW * 1e3:.3f}" == "0.110"
    assert f"{flops / PEAK_BY_RATE[rate] * 1e3:.3f}" == "0.098"
    flops, nbytes, rate = kernel_costs.rglru_scan_bwd_cost(10, 4, 8)
    assert (flops, nbytes, rate) == (30, 10 * 20 + 16, "f32")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

#: (B, S, H, d, logw, s0, ds_last, strided)
GPU_WKV_CASES = [
    (1, 1, 64, 64, None, True, True, False),
    (4, 1, 8, 64, None, False, False, True),
    (1, 17, 8, 64, -5.0, True, False, False),
    (4, 32, 8, 64, 0.0, False, True, True),
    (1, 33, 8, 64, -20.0, True, True, False),
    (4, 1024, 8, 64, None, False, False, False),
    (1, 1024, 8, 64, -5.0, True, True, True),
    (1, 4096, 2, 64, None, True, True, True),
    (2, 50, 3, 16, None, True, True, False),
    (1, 77, 4, 32, -5.0, False, True, True),
    (2, 40, 2, 128, None, True, False, False),
]
GPU_RGLRU_CASES = [(1, 1, 2560, True), (4, 17, 2560, False),
                   (1, 32, 77, True), (4, 33, 2560, True),
                   (1, 1024, 2560, False), (4, 1024, 2560, True),
                   (1, 4096, 2560, True), (3, 300, 77, False)]


def _gpu_wkv(case, dtype, seed):
    B, S, H, D, logw, with_s0, with_dsl, strided = case
    t = [torch.from_numpy(a).cuda()
         for a in _wkv_inputs(B, S, H, D, seed=seed, logw=logw)]
    r, k, v, dy = (x.to(dtype) for x in (t[0], t[1], t[2], t[6]))
    if strided:  # (B, S, H, d) views of a wider buffer, as the model's
        r, k, v = (torch.cat([x, x], -2)[..., :H, :] for x in (r, k, v))
    return (r, k, v, t[3], t[4], t[5] if with_s0 else None, dy,
            t[7] if with_dsl else None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GPU_WKV_CASES, ids=str)
def test_cuda_wkv6_backward_matches_autograd_through_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from repro_torch.kernels import wkv6 as WK
    args = _gpu_wkv(case, dtype, seed=7)
    r, k, v, lw, u, s0, dy, dsl = args
    leaves = [x.detach().requires_grad_() for x in (r, k, v, lw, u)]
    leaves.append(s0.detach().requires_grad_() if s0 is not None else None)
    before = WK.wkv6_bwd.launches
    y, s_last = ops.wkv6(*leaves)
    outs, cots = [y], [dy]
    if dsl is not None:
        outs.append(s_last)
        cots.append(dsl)
    got = torch.autograd.grad(outs, [x for x in leaves if x is not None],
                              cots)
    assert WK.wkv6_bwd.launches == before + 1
    want = wkv6_bwd(*(None if x is None else x.cpu()
                      for x in (r, k, v, lw, u, s0, dy, dsl)))
    for name, g, w in zip(WKV_NAMES, got, want):
        assert g.dtype == w.dtype, name
        _card_close(g.cpu().float(), w.float(), dtype, f"{name} {case}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GPU_RGLRU_CASES, ids=str)
def test_cuda_rglru_backward_matches_autograd_through_plain(case, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from repro_torch.kernels import rglru_scan as RS
    B, S, D, with_h0 = case
    g = torch.Generator().manual_seed(S)
    x = torch.randn(B, S, D, generator=g).to(dtype)
    a = (torch.rand(B, S, D, generator=g) * 0.95 + 0.05).to(dtype)
    h0 = torch.randn(B, D, generator=g) if with_h0 else None
    dh = torch.randn(B, S, D, generator=g).to(dtype)
    leaves = [t.cuda().requires_grad_() for t in (x, a)]
    if with_h0:
        leaves.append(h0.cuda().requires_grad_())
    before = RS.rglru_scan_bwd.launches
    got = torch.autograd.grad(
        ops.rglru_scan(*leaves[:2], leaves[2] if with_h0 else None), leaves,
        dh.cuda())
    assert RS.rglru_scan_bwd.launches == before + 1
    want = rglru_scan_bwd(x, a, h0, dh)
    for name, gg, w in zip(("dx", "da", "dh0"), got, want):
        assert gg.dtype == w.dtype, name
        _card_close(gg.cpu().float(), w.float(), dtype, f"{name} {case}")


@pytest.mark.gpu
def test_cuda_backward_replays_are_bitwise_equal():
    """20 calls of each backward at its training shape (rwkv6-7b's
    4 x 1024 tokens of 64 heads of 64, bf16; recurrentgemma-2b's
    4 x 1024 x 2560, float32) give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    args = _gpu_wkv((4, 1024, 64, 64, None, False, False, False),
                    torch.bfloat16, seed=1)
    first = wkv6_bwd(*args)
    for _ in range(20):
        again = wkv6_bwd(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again)
                   if a is not None)
    g = torch.Generator(device="cuda").manual_seed(2)
    x, dh = (torch.randn(4, 1024, 2560, generator=g, device="cuda")
             for _ in range(2))
    a = torch.rand(4, 1024, 2560, generator=g, device="cuda")
    h0 = torch.randn(4, 2560, generator=g, device="cuda")
    first = rglru_scan_bwd(x, a, h0, dh)
    for _ in range(20):
        again = rglru_scan_bwd(x, a, h0, dh)
        assert all(torch.equal(p, q) for p, q in zip(first, again))


def test_backward_head_dims_are_the_forwards():
    """The backward takes the forward's head dims and chunks: 32 steps at
    the -5 clamp stay within the recentring's range (16 at d = 128)."""
    assert set(BWD_CHUNK) == set(HEAD_DIMS) and BWD_CHUNK == CHUNK

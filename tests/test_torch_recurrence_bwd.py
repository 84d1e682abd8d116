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
checkpoints, its recomputed states, its column blocks' partials added in
block order; the RG-LRU backward's chunk summaries folded last chunk
first) and held to autograd through the plain versions within the card's
tolerance (``CARD_TOL``: atol relative to each gradient's largest entry).
On a card (``-m gpu``) the CUDA kernels must agree with autograd through
the plain versions within ``CARD_TOL`` and give the same bits over 20
calls; the card's machine has no JAX, so there run ``python -m pytest
--noconftest -m gpu tests/test_torch_recurrence_bwd.py``.
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
    BWD_COLUMNS,
    HEAD_DIMS,
    bwd_plan,
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


def _wkv_bwd_model(r, k, v, logw, u, s0, dy, ds_last, chunk=BWD_CHUNK,
                   vb=None):
    """``csrc/wkv6_bwd.cu``'s arithmetic in torch, float32, batched over
    (B, H): a walk forward over chunks of ``chunk`` steps keeping the
    state entering each; then back over the chunks, last first, the
    chunk's states recomputed from its checkpoint and its steps walked
    back; dr, dk, dlogw and du summed over each block's ``vb`` value
    columns, the blocks' partials added in block order (du batch by
    batch); dv summed over every row.  Steps past S are padded with
    r = k = v = dy = 0 and logw = 0, as the kernel stages them."""
    B, S, H, D = r.shape
    vb = vb or BWD_COLUMNS[D]
    ncb, n_chunks = D // vb, -(-S // chunk)
    pad = n_chunks * chunk - S

    def padded(t):
        return torch.cat([t.float(), t.new_zeros((B, pad, H, D)).float()], 1)

    r, k, v, dy = (padded(t) for t in (r, k, v, dy))
    w = torch.exp(padded(logw))
    st = s0.clone() if s0 is not None else torch.zeros(B, H, D, D)
    ckpt = []
    for c in range(n_chunks):
        ckpt.append(st.clone())
        for t in range(c * chunk, (c + 1) * chunk):
            st = w[:, t, :, :, None] * st + k[:, t, :, :, None] * v[:, t, :,
                                                                     None]
    ds = ds_last.clone() if ds_last is not None else torch.zeros(B, H, D, D)
    part = torch.zeros(3, ncb, B, n_chunks * chunk, H, D)
    du_part = torch.zeros(ncb, B, H, D)
    dv = torch.zeros(B, n_chunks * chunk, H, D)
    for c in reversed(range(n_chunks)):
        hist, sc = [], ckpt[c]
        for t in range(c * chunk, (c + 1) * chunk):
            hist.append(sc)
            sc = w[:, t, :, :, None] * sc + k[:, t, :, :, None] * v[:, t, :,
                                                                    None]
        for q in reversed(range(chunk)):
            t = c * chunk + q
            st_t, rt, kt, wt = hist[q], r[:, t], k[:, t], w[:, t]
            for jb in range(ncb):
                J = slice(jb * vb, (jb + 1) * vb)
                vdy = (v[:, t, :, J] * dy[:, t, :, J]).sum(-1)[..., None]
                a_r = (st_t[..., J] * dy[:, t, :, None, J]).sum(-1)
                a_k = (ds[..., J] * v[:, t, :, None, J]).sum(-1)
                a_w = (st_t[..., J] * ds[..., J]).sum(-1)
                part[0, jb, :, t] = a_r + u * kt * vdy
                part[1, jb, :, t] = a_k + u * rt * vdy
                part[2, jb, :, t] = wt * a_w
                du_part[jb] += rt * kt * vdy
            ruk = (rt * u * kt).sum(-1)[..., None]
            dv[:, t] = (ds * kt[..., None]).sum(-2) + ruk * dy[:, t]
            ds = wt[..., None] * ds + rt[..., None] * dy[:, t, :, None]
    sums = []
    for kind in range(3):
        acc = torch.zeros(B, n_chunks * chunk, H, D)
        for jb in range(ncb):
            acc = acc + part[kind, jb]
        sums.append(acc[:, :S])
    du = torch.zeros(H, D)
    for b in range(B):
        for jb in range(ncb):
            du = du + du_part[jb, b]
    return (sums[0], sums[1], dv[:, :S], sums[2], du,
            ds if s0 is not None else None)


def _plain_wkv_grads(arrays, with_s0=True, with_ds_last=True):
    """Autograd through ``ref_wkv6``: (dr, dk, dv, dlogw, du, ds0)."""
    t = [torch.from_numpy(a) for a in arrays]
    return wkv6_bwd(*t[:5], t[5] if with_s0 else None, t[6],
                    t[7] if with_ds_last else None)


@pytest.mark.parametrize("S", [1, 17, 33, 64, 100])
@pytest.mark.parametrize("logw", [None, -5.0, 0.0, -20.0],
                         ids=["model", "-5", "0", "-20"])
def test_wkv_bwd_kernel_model_matches_autograd_through_plain(S, logw):
    """The kernel's arithmetic (checkpoints every ``BWD_CHUNK`` steps,
    recomputed states, rwkv6-7b's d = 64 in four 16-column blocks) within
    ``CARD_TOL`` of autograd through the plain recurrence: the model's
    decays, the -5 clamp, no decay (the state grows with S) and -20 (the
    serial form needs no guard where the forward's chunks go step by
    step: it only multiplies by w <= 1)."""
    arrays = _wkv_inputs(1, S, 2, 64, seed=50 + S, logw=logw)
    want = _plain_wkv_grads(arrays)
    t = [torch.from_numpy(a) for a in arrays]
    got = _wkv_bwd_model(*t)
    for name, g, w in zip(WKV_NAMES, got, want):
        _card_close(g, w, torch.float32, f"{name} S={S} logw={logw}")


@pytest.mark.parametrize("D", [16, 32, 128])
def test_wkv_bwd_kernel_model_at_every_head_dim(D):
    """The other head dims' column blocks (one of 16 or 32 columns, or
    sixteen of 8), without s0 and without ds_last."""
    arrays = _wkv_inputs(2, 21, 2, D, seed=D)
    want = _plain_wkv_grads(arrays, with_s0=False, with_ds_last=False)
    t = [torch.from_numpy(a) for a in arrays]
    got = _wkv_bwd_model(*t[:5], None, t[6], None)
    for name, g, w in zip(WKV_NAMES[:5], got, want):
        _card_close(g, w, torch.float32, f"{name} D={D}")
    assert got[5] is None and want[5] is None


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
    """The blocks (column slice, head, batch) and the chunks each walks
    write every (b, step, head, value column) of dv and every (b, head,
    row, column) of ds0 once, and d / VB partials of each (b, step, head,
    row) of dr, dk and dlogw; a block is d x VB <= 1024 threads, whole
    warps, and a row's VB lanes lie in one warp."""
    B, S, H, D = shape
    chunk, vb, n_chunks = bwd_plan(S, D)
    assert chunk == BWD_CHUNK and D % vb == 0 and 32 % vb == 0
    assert D * vb <= 1024 and (D * vb) % 32 == 0
    assert n_chunks * chunk >= S > (n_chunks - 1) * chunk
    dv_cover = np.zeros((B, S, H, D), np.int32)
    part_cover = np.zeros((B, S, H, D), np.int32)
    s_cover = np.zeros((B, H, D, D), np.int32)
    for b in range(B):
        for h in range(H):
            for j0 in range(0, D, vb):
                s_cover[b, h, :, j0:j0 + vb] += 1
                for c in range(n_chunks):
                    ts = slice(c * chunk, min(S, (c + 1) * chunk))
                    dv_cover[b, ts, h, j0:j0 + vb] += 1
                    part_cover[b, ts, h, :] += 1
    assert (dv_cover == 1).all() and (s_cover == 1).all()
    assert (part_cover == D // vb).all()


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
        B, S, H, D, 2, False, False)[0]
    assert c["rglru_scan.calls"] == 1 and c["rglru_scan_bwd.calls"] == 1
    assert c["rglru_scan_bwd.bytes"] == kernel_costs.rglru_scan_bwd_cost(
        B * S * 96, 4, B * 96 * 4)[1]
    assert (WK.wkv6.launches, WK.wkv6_bwd.launches, RS.rglru_scan.launches,
            RS.rglru_scan_bwd.launches) == before
    kernel_costs.reset()


def test_backward_costs():
    """The bounds' counts: the WKV backward's 12 d^2 + 10 d float32 flops
    a token and head (13.1 GFLOP at rwkv6-7b's training shape, 0.19 ms at
    the CUDA cores' peak, above its bytes' time); the RG-LRU backward's
    three flops an element, its bytes those it moves."""
    from repro_torch.roofline.analysis import HBM_BW, PEAK_BY_RATE
    flops, nbytes, rate = kernel_costs.wkv6_bwd_cost(4, 1024, 64, 64, 2,
                                                     False, False)
    assert rate == "f32" and f"{flops / 1e9:.1f}" == "13.1"
    assert flops / PEAK_BY_RATE[rate] > nbytes / HBM_BW
    assert nbytes == 4 * 1024 * 64 * 64 * (7 * 2 + 8) + 8 * 64 * 64
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
    assert set(BWD_COLUMNS) == set(HEAD_DIMS)

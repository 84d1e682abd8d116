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
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    DQ_KEYS,
    DQ_ROWS,
    KV_KEYS,
    WALK_INTS,
    FlashAttention,
    bwd_plan,
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
    recurrentgemma train on the CPU (on the card their backward kernels
    run: see the gpu test below)."""
    x = torch.randn(1, 5, 8, requires_grad=True)
    a = torch.rand(1, 5, 8)
    ops.rglru_scan(x, a).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    r = torch.randn(1, 4, 2, 16, requires_grad=True)
    y, _ = ops.wkv6(r, torch.randn(1, 4, 2, 16), torch.randn(1, 4, 2, 16),
                    -torch.rand(1, 4, 2, 16), torch.randn(2, 16))
    y.sum().backward()
    assert r.grad is not None


# (B, H, H_kv, S_q, S_k, d, causal, window) of the wgmma path's plan:
# causal lengths on and off the tiles, a window, cross-attention (whisper's
# split dq), one query row, d = 128 with qwen3-moe's group of 8; at d =
# 256: recurrentgemma-2b's training shape (T4: its 2048-key window over
# 1024 keys, group 10 over one kv head, the group split), a window, a
# length that is no multiple of 64, one query row, cross-attention
PLAN_CASES = [
    (4, 32, 8, 1024, 1024, 64, True, None),
    (1, 8, 2, 1000, 1000, 64, True, None),
    (1, 4, 1, 300, 300, 64, True, 100),
    (1, 4, 1, 300, 300, 64, False, 100),
    (2, 6, 6, 16, 1500, 64, False, None),
    (2, 8, 2, 1, 1500, 128, False, None),
    (1, 32, 4, 2048, 2048, 128, True, None),
    (2, 6, 6, 16, 16, 64, True, None),
    (1, 6, 6, 448, 1500, 64, False, None),
    (4, 10, 1, 1024, 1024, 256, True, 2048),
    (1, 4, 1, 300, 300, 256, True, 100),
    (1, 10, 1, 1000, 1000, 256, True, None),
    (2, 10, 1, 1, 1, 256, True, None),
    (1, 8, 2, 17, 300, 256, False, None),
]


def _visible(S_q, S_k, causal, window):
    i = np.arange(S_q)[:, None]
    j = np.arange(S_k)[None, :]
    vis = np.ones((S_q, S_k), dtype=bool)
    if causal:
        vis &= j <= i
    if window is not None:
        vis &= i - j < window
    return vis


def _records(plan):
    """``plan.walks`` as the kernel reads it: one (block, consumer 0,
    consumer 1) triple of 4-int records a block."""
    w = np.asarray(plan.walks).reshape(-1, WALK_INTS // 4, 4)
    assert len(w) == plan.c_args()[3]
    return w


def _kind(span, t):
    """The kernel's ``tile_kind``: what a consumer does with tile t."""
    vis_lo, full_lo, full_hi, vis_hi = span
    if not vis_lo <= t < vis_hi:
        return "skip"
    return "masked" if not full_lo <= t < full_hi else "full"


def _account(counts, vis, kind, q0, n_q, k0, n_k):
    """Add a consumer's tile to ``counts`` as the kernel computes it: P is
    nonzero on the tile's visible pairs ("masked"), or on every pair
    ("full"), which must then all be visible; "skip" must see none."""
    S_q, S_k = vis.shape
    rows, cols = slice(q0, min(q0 + n_q, S_q)), slice(k0, min(k0 + n_k, S_k))
    if kind == "skip":
        assert not vis[rows, cols].any(), (q0, k0)
        return
    if kind == "full":
        assert vis[rows, cols].all(), (q0, k0)
    counts[rows, cols] += vis[rows, cols]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[str(c) for c in PLAN_CASES])
def test_bwd_plan_walks_cover_every_visible_pair_once(case):
    """The walk table the CUDA kernel reads (:attr:`BwdPlan.walks`): in
    the dk/dv walk and in the dq walk with its key splits, each visible
    (query, key) pair of a head gets a nonzero P exactly once, an
    invisible pair never; a tile left unmasked holds visible pairs only
    (and, in dq, keys below S_k only)."""
    B, H, H_kv, S_q, S_k, D, causal, window = case
    plan = bwd_plan(B, H, H_kv, S_q, S_k, D, causal, window, n_sms=132)
    recs = _records(plan)
    vis = _visible(S_q, S_k, causal, window)
    counts = np.zeros(vis.shape, dtype=np.int64)
    bq = plan.kv_q_tile
    n_kb = plan.kv_grid[1]
    assert plan.kv_keys == (64 if D == 256 else KV_KEYS)
    # at d = 256 the two consumers take the same keys and split the
    # products: consumer 0's P^T is the tile's one P, consumer 1 walks
    # the same tiles (it reads that P^T)
    consumers = (0,) if D == 256 else (0, 1)
    for kb in range(n_kb):
        walk, spans = recs[kb][0], recs[kb][1:]
        if D == 256:
            assert tuple(spans[0]) == tuple(spans[1])
        for qt in range(walk[1], walk[2]):
            for c in consumers:  # the consumer warpgroups with keys
                kw = kb * plan.kv_keys + 64 * c
                if kw < S_k:
                    _account(counts, vis, _kind(spans[c], qt), qt * bq, bq,
                             kw, 64)
    np.testing.assert_array_equal(counts, vis)
    # each head of a kv head's group in exactly one group share, in order
    heads = [h for share in range(plan.n_gsplit)
             for h in range(*plan.group_heads(share))]
    assert heads == list(range(H // H_kv))
    counts[:] = 0
    n_qt, n_split, dk = plan.dq_grid[1], plan.dq_grid[2], plan.dq_keys
    for qt in range(n_qt):
        tiles = []
        for split in range(n_split):
            walk, spans = recs[n_kb + split * n_qt + qt][0], \
                recs[n_kb + split * n_qt + qt][1:]
            tiles += list(range(walk[1], walk[2]))
            for kt in range(walk[1], walk[2]):
                for c in (0, 1):  # the consumer warpgroups with rows
                    qw, k0 = qt * DQ_ROWS + 64 * c, kt * dk
                    if qw < S_q:
                        kind = _kind(spans[c], kt)
                        assert kind != "full" or k0 + dk <= S_k
                        _account(counts, vis, kind, qw, 64, k0, dk)
        assert tiles == sorted(set(tiles))  # splits in order, disjoint
    np.testing.assert_array_equal(counts, vis)
    assert plan.s_pad % 128 == 0 and plan.s_pad >= S_q
    assert plan.c_args() == (bq, n_split, plan.s_pad, len(recs),
                             plan.n_gsplit)


def test_bwd_plan_key_split_sums_to_dq_in_split_order():
    """Whisper's cross-attention: dq as the kernel forms it, one float32
    partial per key split of the walk table, summed in split order 0, 1,
    ..., equals autograd's dq through the plain version."""
    B, H, S_q, S_k, D = 1, 2, 16, 1500, 64
    plan = bwd_plan(B, H, H, S_q, S_k, D, False, None, n_sms=132)
    assert plan.n_split > 1
    recs = _records(plan)
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape))
                   for shape in ((B, H, S_q, D), (B, H, S_k, D),
                                 (B, H, S_k, D), (B, H, S_q, D)))
    qg = q.clone().requires_grad_()
    want = torch.autograd.grad(ref.ref_attention(qg, k, v, causal=False),
                               qg, do)[0]
    scale = D ** -0.5
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    ds = p * (do @ v.transpose(-1, -2)
              - (do * (p @ v)).sum(-1, keepdim=True))
    parts = []
    for split in range(plan.n_split):
        _, lo, hi, _ = recs[plan.kv_grid[1] + split][0]
        assert hi > lo
        keys = slice(lo * DQ_KEYS, min(hi * DQ_KEYS, S_k))
        parts.append((ds[..., keys] @ k[:, :, keys] * scale).float())
    got = parts[0]
    for part in parts[1:]:
        got = got + part
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)


def test_bwd_plan_fills_the_card_for_few_queries():
    """Whisper's cross-attention (16 queries, 1500 keys) splits dq's keys
    so that its blocks fill the SMs the dk/dv blocks leave idle: the one
    launch is whole waves; granite-3-2b's training shape needs no split;
    the dk/dv query tile follows S_q.  At d = 256 the tiles are smaller
    and a kv head's group is split over dk/dv blocks where they are
    fewer than the SMs."""
    plan = bwd_plan(2, 6, 6, 16, 1500, 64, False, None, n_sms=132)
    kv_blocks = plan.kv_grid[0] * plan.kv_grid[1]
    dq_blocks = plan.dq_grid[0] * plan.dq_grid[1] * plan.dq_grid[2]
    assert plan.n_split > 1 and plan.kv_q_tile == 16
    assert dq_blocks <= -kv_blocks % 132 and plan.n_blocks % 132 == 0
    granite = bwd_plan(4, 32, 8, 1024, 1024, 64, True, None, n_sms=132)
    assert granite.n_split == 1 and granite.kv_q_tile == 128
    assert bwd_plan(1, 1, 1, 1, 1, 64, True, None, 132).kv_q_tile == 16
    assert bwd_plan(1, 1, 1, 17, 17, 64, True, None, 132).kv_q_tile == 32
    assert bwd_plan(1, 1, 1, 2048, 2048, 128, True, None,
                    132).kv_q_tile == 64
    # d = 256: 64-key dk/dv blocks of 64-row query tiles, 32-key dq tiles;
    # at recurrentgemma-2b's training shape (T4) the 64 (b, kv head, key
    # block) blocks would leave half the card idle, so its group of 10
    # heads is split in two: 128 dk/dv blocks of 5 heads each
    t4 = bwd_plan(4, 10, 1, 1024, 1024, 256, True, 2048, 132)
    assert (t4.kv_keys, t4.dq_keys, t4.kv_q_tile) == (64, 32, 64)
    assert t4.n_gsplit == 2 and t4.kv_grid == (8, 16)
    assert 132 // 2 < math.prod(t4.kv_grid) <= 132
    assert [t4.group_heads(s) for s in range(2)] == [(0, 5), (5, 10)]
    assert t4.n_split == 1 and t4.dq_grid == (40, 8, 1)
    assert bwd_plan(1, 1, 1, 1, 1, 256, True, None, 132).kv_q_tile == 16
    # enough blocks without it: no group split (and none below d = 256)
    assert bwd_plan(16, 10, 1, 1024, 1024, 256, True, None,
                    132).n_gsplit == 1
    assert granite.n_gsplit == plan.n_gsplit == 1
    with pytest.raises(ValueError):
        bwd_plan(1, 1, 1, 64, 64, 512, True, None, 132)


@pytest.mark.parametrize("shape", [(1, 10, 1, 300, 300, True, 100),
                                   (2, 6, 2, 70, 70, True, None)],
                         ids=["group10-window", "group3-causal"])
def test_bwd_plan_group_split_sums_dkdv_in_split_order(shape):
    """At d = 256 with few dk/dv blocks, the group split: each share of a
    kv head's group (``BwdPlan.group_heads``) forms float32 partials of dk
    and dv over its own heads, each (head, key) in exactly one share, and
    the partials summed in split order 0, 1, ... equal autograd's dk and
    dv through the plain version."""
    B, H, H_kv, S_q, S_k, causal, window = shape
    D = 256
    plan = bwd_plan(B, H, H_kv, S_q, S_k, D, causal, window, n_sms=132)
    assert plan.n_gsplit > 1
    group = H // H_kv
    seen = np.zeros(group, dtype=np.int64)
    for share in range(plan.n_gsplit):
        lo, hi = plan.group_heads(share)
        seen[lo:hi] += 1
    np.testing.assert_array_equal(seen, 1)
    rng = np.random.default_rng(12)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape_))
                   for shape_ in ((B, H, S_q, D), (B, H_kv, S_k, D),
                                  (B, H_kv, S_k, D), (B, H, S_q, D)))
    kg, vg = k.clone().requires_grad_(), v.clone().requires_grad_()
    want = torch.autograd.grad(ref.ref_attention(q, kg, vg, causal=causal,
                                                 window=window), (kg, vg), do)
    scale = D ** -0.5
    kr, vr = (t.repeat_interleave(group, dim=1) for t in (k, v))
    s = q @ kr.transpose(-1, -2) * scale
    vis = torch.from_numpy(_visible(S_q, S_k, causal, window))
    p = torch.softmax(s.masked_fill(~vis, -1e30), dim=-1) * vis
    ds = p * (do @ vr.transpose(-1, -2)
              - (do * (p @ vr)).sum(-1, keepdim=True))
    dk_h = (ds.transpose(-1, -2) @ q * scale).reshape(B, H_kv, group, S_k, D)
    dv_h = (p.transpose(-1, -2) @ do).reshape(B, H_kv, group, S_k, D)
    got = []
    for per_head in (dk_h, dv_h):
        parts = [per_head[:, :, slice(*plan.group_heads(share))]
                 .sum(dim=2).float() for share in range(plan.n_gsplit)]
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        got.append(total)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_.double(), w, rtol=1e-5, atol=1e-5)


def test_ptxas_report_reads_registers_and_spills_by_kernel():
    """The build report phase T1 prints: each entry function's readable
    name, registers and spill bytes, from ``nvcc -Xptxas -v``."""
    from repro_torch.kernels._build import ptxas_report

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a28"
        "3_22_flash_attention_bwd_cu_04843d3016bwd_wgmma_kernelILi64ELi128E"
        "EEvP13__nv_bfloat16' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN55_GLOBAL",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a28"
        "3_22_flash_attention_bwd_cu_04843d3013bwd_dq_kernelIfLi64EEEvPKT_' "
        "for 'sm_90a'",
        "    64 bytes stack frame, 60 bytes spill stores, 68 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 64 bytes "
        "cumulative stack size",
        "ptxas info    : Compiling entry function '_ZN55_GLOBAL__N__3b49a28"
        "3_22_flash_attention_bwd_cu_04843d3015bwd_dkdv_kernelI13__nv_bfloa"
        "t16Li256EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 128 registers, used 1 barriers",
    ])
    assert ptxas_report(log) == [
        ("bwd_wgmma_kernel<64, 128>", 168, 0, 0),
        ("bwd_dq_kernel<float, 64>", 128, 60, 68),
        ("bwd_dkdv_kernel<bf16, 256>", 128, 0, 0)]


def _gpu_case(case, dtype, seed):
    B, Sq, Sk, H, H_kv, D, causal, window = case
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, Sq, D, generator=g).to("cuda", dtype)
    k = torch.randn(B, H_kv, Sk, D, generator=g).to("cuda", dtype)
    v = torch.randn(B, H_kv, Sk, D, generator=g).to("cuda", dtype)
    do = torch.randn(B, H, Sq, D, generator=g).to("cuda", dtype)
    return q, k, v, do


# (B, S_q, S_k, H, H_kv, d, causal, window) at the kernel's head dims
# (the fifth: d = 256 windowed; the last two: recurrentgemma-2b's
# training shape at B 1, the group split, and d = 256 cross-attention,
# whose dq keys and dk/dv group are both split); from the seventh: whisper's cross-attention shape (its dq split over
# the keys), one query row against 1500 keys at d = 128 with a group, d =
# 128 causal at 2048 with qwen3-moe's 32 / 4 heads, a causal length that
# is no multiple of 128, a window at d = 64
GPU_CASES = [
    (2, 17, 17, 8, 2, 64, True, None), (1, 1, 1500, 6, 6, 64, False, None),
    (1, 448, 1500, 6, 6, 64, False, None), (2, 127, 127, 8, 1, 128, True,
                                            None),
    (1, 300, 300, 4, 1, 256, True, 100), (1, 1500, 1500, 6, 6, 64, False,
                                          None),
    (2, 16, 1500, 6, 6, 64, False, None), (2, 1, 1500, 8, 2, 128, False,
                                           None),
    (1, 2048, 2048, 32, 4, 128, True, None), (1, 1000, 1000, 8, 2, 64, True,
                                              None),
    (1, 300, 300, 4, 1, 64, True, 100),
    (1, 1024, 1024, 10, 1, 256, True, 2048),  # T4's shape at B 1
    (1, 17, 1500, 4, 1, 256, False, None),  # dq key and group splits
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
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_backward_takes_strided_model_views(causal):
    """q, k, v and the cotangent as the model hands them in: (B, H, S, d)
    views of (B, S, H, d) tensors (and k, v of one fused (B, S, 2 H_kv,
    d) projection), bf16 at d = 64 and 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    g = torch.Generator().manual_seed(5)
    for D in (64, 128):
        B, S, H, H_kv = 2, 200, 8, 2
        q = torch.randn(B, S, H, D, generator=g).to("cuda", torch.bfloat16)
        kv = torch.randn(B, S, 2 * H_kv, D, generator=g).to(
            "cuda", torch.bfloat16)
        do = torch.randn(B, S, H, D, generator=g).to("cuda", torch.bfloat16)
        q, do = q.transpose(1, 2), do.transpose(1, 2)
        k, v = kv.transpose(1, 2).split(H_kv, dim=1)
        qq, kk, vv = (t.detach().float().requires_grad_() for t in (q, k, v))
        want = torch.autograd.grad(ref.ref_attention(qq, kk, vv,
                                                     causal=causal),
                                   (qq, kk, vv), do.float())
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        got = torch.autograd.grad(flash_attention(qg, kg, vg, causal=causal),
                                  (qg, kg, vg), do)
        torch.cuda.synchronize()
        assert got[0].stride() == (S * H * D, D, H * D, 1)  # (B, S, H, d)
        for name, g_, w in zip("qkv", got, want):
            scale = float(w.abs().max())
            err = float((g_.float() - w).abs().max())
            assert err <= 2e-2 * scale, (D, name, err, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 1024, 1024, 32, 8, True),
                                   (2, 16, 1500, 6, 6, False)],
                         ids=["granite-train", "whisper-cross"])
def test_cuda_backward_replays_are_bitwise_equal(shape):
    """20 calls of the bf16 backward on the same inputs give the same
    bits: granite-3-2b's training shape, and whisper's cross-attention,
    whose dq is summed over key splits in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from repro_torch.kernels.flash_attention import _launch

    B, Sq, Sk, H, H_kv, causal = shape
    g = torch.Generator(device="cuda").manual_seed(3)
    q, do = (torch.randn(B, H, Sq, 64, generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, H_kv, Sk, 64, generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    out, lse = _launch(q, k, v, causal, None, with_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    for _ in range(20):
        again = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_recurrence_kernels_differentiate_on_the_card():
    """A CUDA input that requires grad runs each recurrence's backward
    kernel (launch counted), and its gradient agrees with autograd through
    the plain version on the CPU (float32, within 1e-5 of the gradient's
    largest entry)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    from repro_torch.kernels import rglru_scan as RS
    from repro_torch.kernels import wkv6 as WK

    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 8, generator=g)
    a = torch.rand(1, 5, 8, generator=g)
    before = RS.rglru_scan_bwd.launches
    xc = x.cuda().requires_grad_()
    ops.rglru_scan(xc, a.cuda()).sum().backward()
    assert RS.rglru_scan_bwd.launches == before + 1
    xr = x.clone().requires_grad_()
    ops.rglru_scan(xr, a).sum().backward()
    err = float((xc.grad.cpu() - xr.grad).abs().max())
    assert err <= 1e-5 * float(xr.grad.abs().max())
    r = torch.randn(1, 4, 2, 16, generator=g)
    lw = -torch.rand(1, 4, 2, 16, generator=g)
    u = torch.randn(2, 16, generator=g)
    grads, before = [], WK.wkv6_bwd.launches
    for dev in ("cuda", "cpu"):
        leaf = r.to(dev).clone().requires_grad_()
        y, _ = ops.wkv6(leaf, r.to(dev), r.to(dev), lw.to(dev), u.to(dev))
        y.sum().backward()
        grads.append(leaf.grad.cpu())
    assert WK.wkv6_bwd.launches == before + 1
    err = float((grads[0] - grads[1]).abs().max())
    assert err <= 1e-5 * float(grads[1].abs().max())


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

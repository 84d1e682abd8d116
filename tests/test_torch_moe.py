"""The port's mixture-of-experts layer against the JAX package's.

Inputs are drawn by numpy from a seed, the parameters by the reference's
``init_moe`` and carried over as numpy; both packages then run the router,
the load-balance loss, the dense (drop-free) layer and the GShard capacity
dispatch on the CPU.  Float32 outputs agree within rtol/atol 1e-5 (the two
frameworks sum in different orders); the routing is exact: top-k indices,
the kept mask and each pair's place in its expert's queue are equal,
including where gates tie (a zero router) and where the token count is no
multiple of the group size (the gcd fallbacks, T = 24 at groups of 16 and
T = 513).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import moe  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
#: bfloat16: both sides round the output to bf16 (one ulp is at most 2^-7
#: of a value) after products rounded at different places
BF16_TOL = dict(rtol=1e-2, atol=4e-3)
D = 64
#: the smoke configs' routing (8 experts, top-2) with one shared expert,
#: and a wider one: 16 experts, top-4, no shared expert
SMOKE = moe.MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=1,
                      group_size=16)
WIDE = moe.MoEConfig(n_experts=16, top_k=4, d_expert=24, n_shared=0,
                     group_size=16)


def _params(cfg, kind="swiglu", seed=0, dtype=jnp.float32):
    """The reference's parameters, and the same values as torch tensors."""
    jp = jmoe.init_moe(jax.random.key(seed), D, cfg, kind, dtype)

    def carry(tree):
        if isinstance(tree, dict):
            return {k: carry(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree, dtype=np.float32)).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)

    return jp, carry(jp)


def _x(T, seed=1, batch=1):
    x = np.random.default_rng(seed).standard_normal(
        (batch, T // batch, D), dtype=np.float32)
    return x


def _ref_positions(top_i, cfg, T):
    """The reference's own expressions (``models/moe.py:122-147``) for the
    group size, the capacity, each pair's queue position and the kept
    mask, on its top-k indices."""
    g = min(cfg.group_size, T)
    if T % g:
        g = math.gcd(T, g)
        if g == 1:
            g = T
    G, C = T // g, jmoe._capacity(cfg, g)
    onehot = jax.nn.one_hot(top_i.reshape(G, g, cfg.top_k), cfg.n_experts,
                            dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(G, cfg.top_k * g,
                                                cfg.n_experts)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = pos.reshape(G, cfg.top_k, g, cfg.n_experts).transpose(0, 2, 1, 3)
    pos = np.asarray(jnp.sum(pos * onehot, axis=-1)).reshape(T, cfg.top_k)
    return g, C, pos.astype(np.int64), pos < C


def _plain_positions(top_i, g):
    """Each pair's queue place by a loop: per group, all first choices in
    token order, then all second choices, ..."""
    T, k = top_i.shape
    pos = np.zeros((T, k), np.int64)
    for start in range(0, T, g):
        seen = {}
        for j in range(k):
            for t in range(start, start + g):
                e = int(top_i[t, j])
                pos[t, j] = seen.get(e, 0)
                seen[e] = pos[t, j] + 1
    return pos


@pytest.mark.parametrize("cfg", [SMOKE, WIDE], ids=["e8k2", "e16k4"])
@pytest.mark.parametrize("T", [1, 17, 96])
def test_router_probs_match_reference(cfg, T):
    jp, p = _params(cfg)
    x = _x(T)[0]
    jg, jw, ji = jmoe.router_probs(jp, jnp.asarray(x), cfg)
    g, w, i = moe.router_probs(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i.dtype == torch.int64 and w.dtype == g.dtype == torch.float32


@pytest.mark.parametrize("cfg", [SMOKE, WIDE], ids=["e8k2", "e16k4"])
def test_load_balance_loss_matches_reference(cfg):
    jp, p = _params(cfg)
    x = _x(48)[0]
    jg, _, ji = jmoe.router_probs(jp, jnp.asarray(x), cfg)
    g, _, i = moe.router_probs(p, torch.from_numpy(x), cfg)
    want = jmoe.load_balance_loss(jg, ji, cfg.n_experts)
    got = moe.load_balance_loss(g, i, cfg.n_experts)
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("shared", [1, 0])
def test_dense_matches_reference(kind, shared):
    cfg = dataclasses.replace(SMOKE, n_shared=shared)
    jp, p = _params(cfg, kind)
    x = _x(24, batch=2)
    jout, jaux = jmoe.apply_moe_dense(jp, jnp.asarray(x), cfg, kind)
    out, aux = moe.apply_moe_dense(p, torch.from_numpy(x), cfg, kind)
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


#: (T, group size): T = 24 at 16 and T = 513 take the gcd fallbacks
#: (groups of 8; one group of 513), 17 at 16 one group of 17
GSHARD_CASES = [(T, gs) for T in (1, 2, 8, 17, 24, 513) for gs in (16, 512)]


@pytest.mark.parametrize("T,gs", GSHARD_CASES)
@pytest.mark.parametrize("kind,shared", [("swiglu", 1), ("gelu", 0)])
def test_gshard_matches_reference(T, gs, kind, shared):
    cfg = dataclasses.replace(SMOKE, group_size=gs, n_shared=shared)
    jp, p = _params(cfg, kind)
    x = _x(T)
    jout, jaux = jmoe.apply_moe_gshard(jp, jnp.asarray(x), cfg, kind)
    out, aux = moe.apply_moe_gshard(p, torch.from_numpy(x), cfg, kind)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("T,gs", GSHARD_CASES)
@pytest.mark.parametrize("cfg", [SMOKE, WIDE], ids=["e8k2", "e16k4"])
def test_gshard_routing_is_exact(cfg, T, gs):
    """top_i, the group size and capacity, the queue positions and the kept
    mask equal the reference's, and a loop's."""
    cfg = dataclasses.replace(cfg, group_size=gs)
    jp, p = _params(cfg)
    x = _x(T)[0]
    _, _, ji = jmoe.router_probs(jp, jnp.asarray(x), cfg)
    _, _, i = moe.router_probs(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    g, C, want_pos, want_keep = _ref_positions(ji, cfg, T)
    assert moe.group_size(cfg, T) == g
    assert moe._capacity(cfg, g) == C
    pos = moe.dispatch_positions(i, T // g, cfg.n_experts)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal((pos < C).numpy(), want_keep)
    np.testing.assert_array_equal(pos.numpy(), _plain_positions(i.numpy(), g))


def test_gcd_cases_drop_choices():
    """The cases above are not all drop-free: at T = 24 and groups of 8 the
    capacity is 3, and some choices of this input are dropped."""
    cfg = SMOKE
    jp, p = _params(cfg)
    _, _, i = moe.router_probs(p, torch.from_numpy(_x(24)[0]), cfg)
    assert (moe.group_size(cfg, 24), moe._capacity(cfg, 8)) == (8, 3)
    pos = moe.dispatch_positions(i, 3, cfg.n_experts)
    assert int((pos >= 3).sum()) > 0


@pytest.mark.parametrize("T", [24, 40])
def test_zero_router_ties_to_lower_experts_and_drops_slot_major(T):
    """Every gate ties at 1/E: the reference picks experts 0..k-1 for every
    token, and each of them takes the group's first C tokens of its slot;
    the port does the same and computes the same output."""
    cfg = SMOKE
    jp, p = _params(cfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = _x(T)
    _, _, i = moe.router_probs(p, torch.from_numpy(x[0]), cfg)
    np.testing.assert_array_equal(
        i.numpy(), np.broadcast_to(np.arange(cfg.top_k), (T, cfg.top_k)))
    g = moe.group_size(cfg, T)
    C = moe._capacity(cfg, g)
    pos = moe.dispatch_positions(i, T // g, cfg.n_experts).numpy()
    in_group = np.arange(T) % g
    np.testing.assert_array_equal(pos, np.repeat(in_group[:, None],
                                                 cfg.top_k, 1))
    assert C < g  # this input drops every token past C in each slot
    jout, jaux = jmoe.apply_moe_gshard(jp, jnp.asarray(x), cfg, "swiglu")
    out, aux = moe.apply_moe_gshard(p, torch.from_numpy(x), cfg, "swiglu")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    # a token past C in its group has only the shared expert's output
    shared = moe.apply_mlp(p["shared"], torch.from_numpy(x), "swiglu")
    dropped = in_group >= C
    np.testing.assert_allclose(out[0, dropped].numpy(),
                               shared[0, dropped].numpy(), **TOL)


@pytest.mark.parametrize("T,gs", [(24, 16), (513, 512)])
@pytest.mark.parametrize("kind", ["relu", "squared_relu"])
def test_gshard_bf16_within_one_output_ulp(T, gs, kind):
    """bfloat16 weights and input: the combine weights rounded to bf16 as
    the reference rounds them.  Kinds whose activation rounds once in both
    frameworks (JAX evaluates silu and the tanh gelu op by op in bf16,
    PyTorch in float32 with one rounding, which moves an output by a few
    ulps before any MoE arithmetic)."""
    cfg = dataclasses.replace(SMOKE, group_size=gs)
    jp, p = _params(cfg, kind, dtype=jnp.bfloat16)
    x = _x(T)
    jout, _ = jmoe.apply_moe_gshard(jp, jnp.asarray(x, jnp.bfloat16), cfg,
                                    kind)
    out, _ = moe.apply_moe_gshard(
        p, torch.from_numpy(x).to(torch.bfloat16), cfg, kind)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), **BF16_TOL)


@pytest.mark.parametrize("T,gs", [(24, 16), (96, 32), (513, 512)])
def test_gshard_equals_dense_on_tokens_with_no_dropped_choice(T, gs):
    cfg = dataclasses.replace(SMOKE, group_size=gs)
    _, p = _params(cfg)
    x = torch.from_numpy(_x(T))
    dense, _ = moe.apply_moe_dense(p, x, cfg, "swiglu")
    gshard, _ = moe.apply_moe_gshard(p, x, cfg, "swiglu")
    _, _, i = moe.router_probs(p, x[0], cfg)
    g = moe.group_size(cfg, T)
    pos = moe.dispatch_positions(i, T // g, cfg.n_experts)
    whole = (pos < moe._capacity(cfg, g)).all(-1)
    assert int(whole.sum()) > 0
    np.testing.assert_allclose(gshard[0, whole].numpy(),
                               dense[0, whole].numpy(), **TOL)


@pytest.mark.parametrize("impl", ["dense", "gshard"])
def test_apply_moe_dispatches_like_the_reference(impl):
    jp, p = _params(SMOKE)
    x = _x(24, batch=2)
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), SMOKE, "swiglu", impl)
    out, aux = moe.apply_moe(p, torch.from_numpy(x), SMOKE, "swiglu", impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    _, none = moe.apply_moe(p, torch.from_numpy(x), SMOKE, "swiglu", impl,
                            need_aux=False)
    assert none is None


def test_apply_moe_rejects_other_impls():
    _, p = _params(SMOKE)
    x = torch.from_numpy(_x(8))
    # the distributed runtime's all-to-all layer needs the current mesh
    with pytest.raises(RuntimeError, match="needs a mesh"):
        moe.apply_moe(p, x, SMOKE, "swiglu", impl="a2a")
    with pytest.raises(ValueError):
        moe.apply_moe(p, x, SMOKE, "swiglu", impl="sparse")


@pytest.mark.parametrize("arch,T,want", [
    ("deepseek-moe-16b", 17, (17, 6)), ("deepseek-moe-16b", 512, (512, 60)),
    ("deepseek-moe-16b", 2048, (512, 60)), ("deepseek-moe-16b", 1000, (8, 6)),
    ("deepseek-moe-16b", 513, (513, 61)), ("deepseek-moe-16b", 1, (1, 6)),
    ("deepseek-moe-16b", 8, (8, 6)), ("qwen3-moe-30b-a3b", 512, (512, 40)),
    ("qwen3-moe-30b-a3b", 8, (8, 8)), ("qwen3-moe-30b-a3b", 2048, (512, 40))])
def test_full_width_groups_and_capacities(arch, T, want):
    """The group size and capacity the full configs dispatch with, at the
    token counts the card's serving phases give them."""
    cfg = configs.get_config(arch).moe
    g = moe.group_size(cfg, T)
    assert (g, moe._capacity(cfg, g)) == want
    assert moe._capacity(cfg, g) == jmoe._capacity(cfg, g)


def test_module_holds_the_reference_tree_and_draws_its_distributions():
    cfg = configs.get_config("deepseek-moe-16b").smoke()
    m = moe.MoE(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    jp = jmoe.init_moe(jax.random.key(0), cfg.d_model, cfg.moe, cfg.mlp_kind,
                       jnp.float32)
    assert sorted(jp) == ["experts", "router", "shared"]
    for name in ("w_gate", "w_up", "w_down"):
        assert m["experts"][name].shape == jp["experts"][name].shape
        assert m["shared"][name].shape == jp["shared"][name].shape
    assert m["router"].shape == jp["router"].shape
    w = moe.MoE(dataclasses.replace(cfg, d_model=256),
                torch.Generator().manual_seed(1), torch.float32, "cpu")
    for e in range(cfg.moe.n_experts):  # N(0, 1/in_dim) per expert
        assert abs(float(w["experts"]["w_up"][e].std()) - 256 ** -0.5) \
            < 0.1 * 256 ** -0.5
        assert abs(float(w["experts"]["w_down"][e].std()) - 32 ** -0.5) \
            < 0.1 * 32 ** -0.5

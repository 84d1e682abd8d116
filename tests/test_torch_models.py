"""The port's models against the JAX package on the same weights.

The reference's ``init_params`` tree is carried into the port through
numpy (``models/convert.py``); both packages then run ``forward``,
``prefill`` and four teacher-forced ``decode_step``s on the same tokens.
Float32 smoke configs on the CPU: logits and caches agree within 1e-4
(the two frameworks sum in different orders; the observed gap is ~2e-6),
and greedy tokens are equal.  The dense decoders, and recurrentgemma-2b
(RG-LRU and local-attention layers): its smoke window of 8 is shorter than
S = 12, so ``forward`` runs the window mask, and the decode steps past
PROMPT = 8 wrap the ring-buffer caches.  Its 8-layer variant,
``(rglru, rglru, local_attn) x 2 + (rglru, rglru)``, splits into two
segments as the full 26-layer model does.  rwkv6-7b (time mix and channel
mix, whose nested {"tm", "cm"} states are the caches) and a 4-layer
variant: the reference's prefill evaluates the WKV in its chunked form
and its decode step serially, the port both through ``ops.wkv6``; besides
the shared tests, a 40-token prefill (two 32-step chunks, the second
ragged) and 8 decode steps are held to the reference at every step.
deepseek-moe-16b (a dense layer 0, then MoE layers with a shared expert)
and qwen3-moe-30b-a3b, with the smoke configs' drop-free dense experts
and with GShard capacity dispatch ("/gshard"): the forward's 24 tokens
dispatch in gcd groups of 8 at capacity 3, so choices are dropped, and
the summed auxiliary loss is held to the reference's too.  whisper-tiny
(the encoder-decoder: two encoder layers of full self-attention over 16
precomputed frames, decoder layers of causal self-attention, ``ln_x`` and
cross-attention, sinusoidal positions in both, and the {"self",
"cross_k", "cross_v"} caches), with frames drawn from the same seed.
``check_supported`` raises for no config; the MoE's ``moe_impl="a2a"``
(the distributed runtime's) raises without a mesh, as the reference's
does, and under ``use_mesh`` on a one-rank mesh gives the reference's
logits (the 2x2 mesh is ``tests/test_torch_distributed_moe.py``'s).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.attention import chunked_attention as j_chunked  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import (  # noqa: E402
    cache_specs,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.models.model import check_supported  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    caches_from_jax,
    caches_to_numpy,
    params_from_jax,
)

DENSE = ["granite-3-2b", "phi3-medium-14b", "qwen1.5-32b", "nemotron-4-15b",
         "qwen2-vl-72b"]
#: "<arch>/<n> layers" is the arch's smoke config cut or grown to n layers
RWKV = ["rwkv6-7b", "rwkv6-7b/4 layers"]
#: "<arch>/gshard" is the arch's smoke config with capacity dispatch
MOE = ["deepseek-moe-16b", "deepseek-moe-16b/gshard", "qwen3-moe-30b-a3b",
       "qwen3-moe-30b-a3b/gshard"]
COMPARED = (DENSE + ["recurrentgemma-2b", "recurrentgemma-2b/8 layers"]
            + RWKV + MOE + ["whisper-tiny"])
#: "<arch>/a2a": the arch's smoke config with the distributed runtime's
#: all-to-all MoE dispatch, which needs a mesh
A2A = ["deepseek-moe-16b/a2a", "qwen3-moe-30b-a3b/a2a"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, PROMPT = 2, 12, 8


class _Pair:
    """One arch's smoke config in both packages, on the same weights."""

    def __init__(self, name):
        arch, _, variant = name.partition("/")
        self.jcfg = jconfigs.get_config(arch).smoke()
        self.cfg = configs.get_config(arch).smoke()
        if variant:
            change = (dict(moe_impl=variant) if variant in ("gshard", "a2a")
                      else dict(n_layers=int(variant.split()[0])))
            self.jcfg = dataclasses.replace(self.jcfg, **change)
            self.cfg = dataclasses.replace(self.cfg, **change)
        self.jparams = jmodels.init_params(self.jcfg, jax.random.key(0))
        self.params = params_from_jax(
            self.cfg, jax.tree.map(np.asarray, self.jparams), device="cpu")
        rng = np.random.default_rng(1)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (B, S)
                                   ).astype(np.int32)
        self.frames = (rng.standard_normal(
            (B, self.cfg.encoder_seq_len, self.cfg.d_model)
        ).astype(np.float32) if self.cfg.is_encoder_decoder else None)

    def jframes(self):
        return None if self.frames is None else jnp.asarray(self.frames)

    def frames_t(self):
        return None if self.frames is None else torch.from_numpy(self.frames)


_PAIRS = {}


@pytest.fixture(params=COMPARED)
def pair(request):
    if request.param not in _PAIRS:
        _PAIRS[request.param] = _Pair(request.param)
    return _PAIRS[request.param]


def test_every_config_carries_the_reference_data():
    mine, ref = configs.all_configs(), jconfigs.all_configs()
    assert sorted(mine) == sorted(ref)
    for name, cfg in mine.items():
        for c, r in ((cfg, ref[name]), (cfg.smoke(), ref[name].smoke())):
            assert dataclasses.asdict(c) == dataclasses.asdict(r), name
            assert c.n_params() == r.n_params()
            assert c.n_active_params() == r.n_active_params()
            assert str(c.dtype()) == f"torch.{r.dtype()}"
            assert str(c.cdtype()) == f"torch.{r.cdtype()}"
            assert str(c.kv_dtype()) == f"torch.{r.kv_dtype()}"
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})


def test_forward_logits_match_reference(pair):
    jl, jaux = jmodels.forward(pair.jcfg, pair.jparams,
                               jnp.asarray(pair.tokens), pair.jframes())
    logits, aux = forward(pair.cfg, pair.params,
                          torch.from_numpy(pair.tokens),
                          frames=pair.frames_t())
    assert logits.dtype == torch.float32
    assert logits.shape == (B, S, pair.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    if pair.cfg.moe is None:
        assert float(aux) == float(jaux) == 0.0
    else:  # the MoE layers' load-balance losses, summed
        np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_prefill_logits_and_caches_match_reference(pair):
    toks = pair.tokens[:, :PROMPT]
    jl, jc = jmodels.prefill(pair.jcfg, pair.jparams, jnp.asarray(toks),
                             pair.jframes(), cache_len=S)
    logits, caches = prefill(pair.cfg, pair.params, torch.from_numpy(toks),
                             frames=pair.frames_t(), cache_len=S)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    mine = caches_to_numpy(pair.cfg, caches)
    assert (jax.tree.structure(jax.tree.map(np.asarray, jc))
            == jax.tree.structure(mine))
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(mine)):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, np.asarray(a), **TOL)


def test_decode_steps_match_reference(pair):
    """Four teacher-forced steps from the prefill caches, and from the
    reference's own caches carried over."""
    toks = pair.tokens
    jl, jc = jmodels.prefill(pair.jcfg, pair.jparams,
                             jnp.asarray(toks[:, :PROMPT]), pair.jframes(),
                             cache_len=S)
    _, caches = prefill(pair.cfg, pair.params,
                        torch.from_numpy(toks[:, :PROMPT]),
                        frames=pair.frames_t(), cache_len=S)
    carried = caches_from_jax(pair.cfg, jax.tree.map(np.asarray, jc),
                              device="cpu")
    for i in range(PROMPT, S):
        step = toks[:, i:i + 1]
        jl, jc = jmodels.decode_step(pair.jcfg, pair.jparams, jc,
                                     jnp.asarray(step))
        logits, caches = decode_step(pair.cfg, pair.params, caches,
                                     torch.from_numpy(step))
        logits2, carried = decode_step(pair.cfg, pair.params, carried,
                                       torch.from_numpy(step))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(logits2.numpy(), np.asarray(jl), **TOL)
    for a, b in zip(jax.tree.leaves(jc),
                    jax.tree.leaves(caches_to_numpy(pair.cfg, caches))):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)


def test_greedy_tokens_match_reference(pair):
    prompt = pair.tokens[:1, :PROMPT]
    frames = None if pair.frames is None else pair.frames[:1]
    _, jc = jmodels.prefill(pair.jcfg, pair.jparams, jnp.asarray(prompt),
                            None if frames is None else jnp.asarray(frames),
                            cache_len=PROMPT + 6)
    _, caches = prefill(pair.cfg, pair.params, torch.from_numpy(prompt),
                        frames=None if frames is None
                        else torch.from_numpy(frames),
                        cache_len=PROMPT + 6)
    jtok = jnp.asarray(prompt[:, -1:])
    tok = torch.from_numpy(prompt[:, -1:])
    want, got = [], []
    for _ in range(6):
        jl, jc = jmodels.decode_step(pair.jcfg, pair.jparams, jc, jtok)
        jtok = jnp.argmax(jl, -1).astype(jnp.int32)[:, None]
        want.append(int(jtok[0, 0]))
        logits, caches = decode_step(pair.cfg, pair.params, caches, tok)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        got.append(int(tok[0, 0]))
    assert got == want


def test_init_cache_matches_reference_layout(pair):
    jc = jmodels.init_cache(pair.jcfg, B, 10)
    mine = caches_to_numpy(pair.cfg, init_cache(pair.cfg, B, 10,
                                                device="cpu"))
    assert jax.tree.structure(jc) == jax.tree.structure(mine)
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(mine)):
        np.testing.assert_array_equal(b, np.asarray(a))


def test_init_cache_fill_pos_and_cache_specs_match_reference(pair):
    """``init_cache(fill_pos=)`` writes every attention cache's ``pos``;
    ``cache_specs`` gives the same tree as meta tensors (nothing
    allocated), each with the reference's per-layer shape and dtype."""
    jc = jmodels.init_cache(pair.jcfg, B, 10, fill_pos=7)
    mine = caches_to_numpy(pair.cfg, init_cache(pair.cfg, B, 10,
                                                device="cpu", fill_pos=7))
    for a, b in zip(jax.tree.leaves(jc), jax.tree.leaves(mine)):
        np.testing.assert_array_equal(b, np.asarray(a))
    specs = cache_specs(pair.cfg, B, 10)
    leaves = jax.tree.leaves(specs)
    assert all(t.device.type == "meta" for t in leaves)
    assert len(leaves) == len(jax.tree.leaves(init_cache(
        pair.cfg, B, 10, device="cpu")))
    # the reference's specs stack each segment's layers on a leading axis
    want = {(tuple(a.shape[1:]), str(a.dtype))
            for a in jax.tree.leaves(jmodel.cache_specs(pair.jcfg, B, 10))}
    got = {(tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for t in leaves}
    assert got == want


@pytest.mark.parametrize("name", RWKV)
def test_rwkv6_long_prefill_and_decode_match_reference(name):
    """A 40-token prefill (not a multiple of the reference's 32-step chunk)
    and 8 decode steps: logits and the ``tm.shift``, ``tm.wkv`` and
    ``cm.shift`` states at every step."""
    if name not in _PAIRS:
        _PAIRS[name] = _Pair(name)
    pair = _PAIRS[name]
    prompt, n_steps = 40, 8
    toks = np.random.default_rng(4).integers(
        0, pair.cfg.vocab_size, (B, prompt + n_steps)).astype(np.int32)
    jl, jc = jmodels.prefill(pair.jcfg, pair.jparams,
                             jnp.asarray(toks[:, :prompt]))
    logits, caches = prefill(pair.cfg, pair.params,
                             torch.from_numpy(toks[:, :prompt]))

    def same(logits, caches, jl, jc):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        mine = caches_to_numpy(pair.cfg, caches)
        for seg, jseg in zip(mine, jc):
            for entry, jentry in zip(seg, jseg):
                assert sorted(entry) == ["cm", "tm"]
                for part, names in (("tm", ("shift", "wkv")),
                                    ("cm", ("shift",))):
                    assert sorted(entry[part]) == sorted(names)
                    for n in names:
                        np.testing.assert_allclose(
                            entry[part][n], np.asarray(jentry[part][n]),
                            **TOL)

    same(logits, caches, jl, jc)
    for i in range(prompt, prompt + n_steps):
        step = toks[:, i:i + 1]
        jl, jc = jmodels.decode_step(pair.jcfg, pair.jparams, jc,
                                     jnp.asarray(step))
        logits, caches = decode_step(pair.cfg, pair.params, caches,
                                     torch.from_numpy(step))
        same(logits, caches, jl, jc)


@pytest.mark.parametrize("name", A2A)
def test_other_mixers_and_channels_raise_not_implemented(name, tmp_path):
    """The a2a MoE channel: without a mesh both packages raise; on a
    one-rank (data, model) mesh the port's forward (one gloo rank in this
    process) gives the reference's logits and aux loss."""
    import torch.distributed as dist
    from jax.sharding import Mesh
    from repro.runtime.mesh_context import use_mesh as j_use_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime.mesh_context import use_mesh

    pair = _Pair(name)
    tokens = torch.from_numpy(pair.tokens)
    with pytest.raises(RuntimeError, match="needs a mesh"):
        forward(pair.cfg, pair.params, tokens)
    with pytest.raises(RuntimeError, match="needs a mesh"):
        jmodels.forward(pair.jcfg, pair.jparams, jnp.asarray(pair.tokens))
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with j_use_mesh(jmesh):
        jl, jaux = jmodels.forward(pair.jcfg, pair.jparams,
                                   jnp.asarray(pair.tokens))
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        with use_mesh(make_test_mesh(1, 1)):
            logits, aux = forward(pair.cfg, pair.params, tokens)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("name", sorted(configs.all_configs()))
def test_check_supported_raises_for_no_config(name):
    cfg = configs.get_config(name)
    for c in (cfg, cfg.smoke()):
        check_supported(c)
    assert len(init_cache(cfg.smoke(), 1, 8, device="cpu")) \
        == cfg.smoke().n_layers


def test_chunked_attention_matches_reference_scan():
    """The reference's model-path attention (a scan over query blocks) and
    the port's (one flash call) on the same (B, S, H, d) inputs."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 96, 4, 32), dtype=np.float32)
    k = rng.standard_normal((2, 96, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, 96, 2, 32), dtype=np.float32)
    want = np.asarray(j_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, q_block=32))
    got = chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_init_params_draws_the_reference_distributions():
    cfg = dataclasses.replace(configs.get_config("granite-3-2b").smoke(),
                              d_model=256, d_ff=512, vocab_size=512)
    p = init_params(cfg, 3, device="cpu")
    again = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    w = p.layers[0].attn["w_q"]
    assert w.shape == (256, cfg.n_heads * cfg.head_dim)
    assert abs(float(w.std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert abs(float(p.embed["tokens"].std()) - 0.02) < 0.002
    assert torch.equal(p.layers[0].ln1["scale"], torch.ones(256))
    assert "unembed" not in p.embed  # granite ties its embeddings
    for a, b in zip(p.parameters(), again.parameters()):
        assert torch.equal(a, b)
    assert not any(t.requires_grad for t in p.parameters())
    n = sum(t.numel() for t in p.parameters())
    assert n == cfg.n_params() + (2 * cfg.n_layers + 1) * cfg.d_model

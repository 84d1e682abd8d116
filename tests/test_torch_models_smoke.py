"""Twin of ``tests/test_models_smoke.py`` for the port, on the CPU.

Every config, at its reduced smoke size (whisper-tiny with random frame
embeddings for its encoder): ``loss_fn`` (loss, cross-entropy and the MoE
auxiliary loss) equals the reference's on the same weights (carried over
by ``models/convert.py``) and the same batch within rtol 1e-4, the MoE
configs with their dense and their capacity-dispatched (gshard) layers;
a prefill plus one decode step gives the forward pass's last logits;
greedy decoding stays finite; one train step (autograd through the
model, then SGD) gives a finite loss that does not blow up; the segment
structure and the parameter counts of the full configs hold (counted on
the meta device, so nothing is allocated).
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro_torch.configs import all_configs, get_config  # noqa: E402
from repro_torch.models import (  # noqa: E402
    Transformer,
    build_segments,
    decode_step,
    forward,
    init_params,
    loss_fn,
    prefill,
)
from repro_torch.models.convert import params_from_jax  # noqa: E402

ARCHS = sorted(all_configs())
MOE = sorted(n for n, c in all_configs().items() if c.moe is not None)
B, S = 2, 32
TOL = dict(rtol=1e-4, atol=1e-4)


def make_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def smoke_setups():
    return {name: (get_config(name).smoke(),
                   init_params(get_config(name).smoke(), 0, device="cpu"))
            for name in ARCHS}


@pytest.mark.parametrize("arch", ARCHS + [f"{a}/gshard" for a in MOE])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_fn_matches_reference(arch, masked):
    name, _, impl = arch.partition("/")
    jcfg, cfg = jconfigs.get_config(name).smoke(), get_config(name).smoke()
    if impl:
        jcfg = dataclasses.replace(jcfg, moe_impl=impl)
        cfg = dataclasses.replace(cfg, moe_impl=impl)
    jparams = jmodels.init_params(jcfg, jax.random.key(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    batch = make_batch(cfg, 2)
    if masked:
        batch["loss_mask"] = (np.random.default_rng(5).uniform(size=(B, S))
                              < 0.6).astype(np.float32)
    jloss, jm = jmodels.loss_fn(jcfg, jparams,
                                {k: jnp.asarray(v) for k, v in batch.items()})
    loss, m = loss_fn(cfg, params, _torch(batch))
    assert sorted(m) == ["aux", "ce", "loss"] and m["loss"] is loss
    for key in ("loss", "ce", "aux"):
        assert m[key].dtype == torch.float32 and m[key].shape == ()
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    if cfg.moe is None:
        assert float(m["aux"]) == 0.0
    else:
        assert float(m["aux"]) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_shapes_and_finite(smoke_setups, arch):
    cfg, params = smoke_setups[arch]
    batch = _torch(make_batch(cfg, 1))
    logits, aux = forward(cfg, params, batch["tokens"],
                          frames=batch.get("frames"))
    assert logits.shape == (B, S, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_decreases_loss_and_is_finite(smoke_setups, arch):
    cfg, frozen = smoke_setups[arch]
    params = copy.deepcopy(frozen).requires_grad_(True)
    batch = _torch(make_batch(cfg, 2))

    def step():
        for p in params.parameters():
            p.grad = None
        loss, metrics = loss_fn(cfg, params, batch)
        loss.backward()
        with torch.no_grad():
            for p in params.parameters():
                assert p.grad is not None and bool(torch.isfinite(p.grad)
                                                   .all()), arch
                p -= 0.05 * p.grad.to(p.dtype)
        return loss.detach(), metrics

    loss0, metrics = step()
    assert bool(torch.isfinite(loss0)), f"{arch}: non-finite loss"
    loss1, _ = step()
    assert bool(torch.isfinite(loss1))
    assert float(loss1) < float(loss0) + 0.5  # no blow-up; usually decreases


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(smoke_setups, arch):
    """Prefill on S-1 tokens + 1 decode step == forward logits at the last
    position (the cache path is numerically consistent)."""
    cfg, params = smoke_setups[arch]
    batch = _torch(make_batch(cfg, 3))
    tokens, frames = batch["tokens"], batch.get("frames")
    full, _ = forward(cfg, params, tokens, frames=frames)
    _, caches = prefill(cfg, params, tokens[:, :-1], frames=frames)
    step, _ = decode_step(cfg, params, caches, tokens[:, -1:])
    np.testing.assert_allclose(step.numpy(), full[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_multi_step_decode_finite(smoke_setups, arch):
    cfg, params = smoke_setups[arch]
    batch = _torch(make_batch(cfg, 4))
    tokens = batch["tokens"]
    _, caches = prefill(cfg, params, tokens, frames=batch.get("frames"))
    tok = tokens[:, -1:]
    for _ in range(4):
        logits, caches = decode_step(cfg, params, caches, tok)
        assert bool(torch.isfinite(logits).all())
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def test_segments_cover_all_layers():
    for name, cfg in all_configs().items():
        segs = build_segments(cfg)
        assert sum(len(s.pattern) * s.repeats for s in segs) == cfg.n_layers


def test_recurrentgemma_segments_structure():
    segs = build_segments(get_config("recurrentgemma-2b"))
    # 26 layers = (rglru, rglru, local_attn) x 8 + (rglru, rglru)
    assert segs[0].repeats == 8 and len(segs[0].pattern) == 3
    assert segs[1].repeats == 2 and segs[1].pattern[0][0] == "rglru"


def test_deepseek_segments_structure():
    segs = build_segments(get_config("deepseek-moe-16b"))
    assert [(s.pattern, s.repeats) for s in segs] == [
        ((("attn", "mlp"),), 1), ((("attn", "moe"),), 27)]


@pytest.mark.parametrize("name,lo,hi", [
    ("qwen2-vl-72b", 60e9, 85e9), ("granite-3-2b", 1.8e9, 3.2e9),
    ("nemotron-4-15b", 12e9, 18e9), ("phi3-medium-14b", 12e9, 16e9),
    ("qwen1.5-32b", 28e9, 36e9), ("qwen3-moe-30b-a3b", 25e9, 34e9),
    ("deepseek-moe-16b", 14e9, 20e9), ("recurrentgemma-2b", 2e9, 3.5e9),
    ("rwkv6-7b", 6e9, 9e9), ("whisper-tiny", 25e6, 80e6)])
def test_param_counts_in_expected_range(name, lo, hi):
    """The full model's parameters, counted on the meta device, land near
    the advertised size; the MoE and dense decoders' without biases equal
    the config's formula plus the norms' scales."""
    cfg = get_config(name)
    model = Transformer(cfg, None, torch.device("meta"))
    n = sum(t.numel() for t in model.parameters())
    assert lo <= n <= hi, f"{name}: {n / 1e9:.2f}B params"
    assert cfg.n_params() == jconfigs.get_config(name).n_params()
    if cfg.norm == "rmsnorm" and not cfg.qkv_bias \
            and cfg.family in ("dense", "moe"):
        assert n == cfg.n_params() + (2 * cfg.n_layers + 1) * cfg.d_model


def test_moe_active_params_much_smaller():
    cfg = get_config("qwen3-moe-30b-a3b")
    assert cfg.n_active_params() < 0.25 * cfg.n_params()
    model = Transformer(cfg, None, torch.device("meta"))
    experts = sum(t.numel() for layer in model.layers
                  for t in layer.moe.experts.parameters())
    m = cfg.moe
    assert experts == cfg.n_layers * m.n_experts * 3 * cfg.d_model \
        * m.d_expert
    assert cfg.n_active_params() == cfg.n_params() - experts \
        * (m.n_experts - m.top_k) // m.n_experts

"""Twin of ``tests/test_train_loop.py`` for the port's trainer, on the CPU:
loss goes down, checkpoints commit through the RSM, crash recovery
restores the committed checkpoint bit for bit, stragglers get skipped,
elastic rescale works, two trainers are deterministic.

Besides, the port's ``Trainer`` started from the reference's initial
weights (carried across by ``models/convert.py``) on the float32 smoke
configs of granite-3-2b, rwkv6-7b and recurrentgemma-2b (the recurrences
differentiated through their plain versions here, their backward kernels
on the card): the loss, ``grad_norm`` and ``lr`` of 3 steps within 1e-4 of the
reference ``Trainer``'s, and each parameter's ``.grad`` of the first step
within 1e-4 of its largest entry of the reference's gradient, put through
the same conversion.
"""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, init_opt_state  # noqa: E402
from repro_torch.runtime.train_loop import TrainState, Trainer  # noqa: E402


@pytest.fixture()
def trainer(tmp_path):
    cfg = get_config("granite-3-2b").smoke()
    return Trainer(
        cfg, str(tmp_path / "ckpt"),
        opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=100,
                            weight_decay=0.01),
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                            global_batch=4, seed=0),
        n_virtual_workers=3, ckpt_every=4, device="cpu")


def test_loss_decreases(trainer):
    metrics = trainer.run(12)
    first = np.mean([m["ce"] for m in metrics[:3]])
    last = np.mean([m["ce"] for m in metrics[-3:]])
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first, (first, last)


def test_steps_commit_through_rsm(trainer):
    trainer.run(3)
    assert trainer.coord.view.committed_step == 2


def test_crash_recovery_restores_exact_state(trainer):
    trainer.run(4)  # checkpoint at step 4 (ckpt_every=4)
    assert trainer.coord.view.committed_ckpt == 4
    saved = {n: p.detach().clone()
             for n, p in trainer.state.params.named_parameters()}
    saved_m = {n: t.clone() for n, t in trainer.state.opt_state["m"].items()}
    trainer.run(2)  # move past the checkpoint
    restored_step = trainer.crash_and_recover()
    assert restored_step == 4
    for n, p in trainer.state.params.named_parameters():
        assert torch.equal(p, saved[n]), n
    for n, t in trainer.state.opt_state["m"].items():
        assert torch.equal(t, saved_m[n]), n
    assert int(trainer.state.opt_state["step"]) == 4
    m = trainer.run_step()
    assert m["step"] == 4  # training resumes from the committed step
    assert np.isfinite(m["ce"])


def test_straggler_step_commits_with_noops(trainer):
    trainer.run(2)
    m = trainer.run_step(straggler=2)
    assert trainer.coord.view.committed_step >= m["step"] - 1
    assert any(trainer.coord.view.step_noops.values())


def test_elastic_scale_up_and_down(trainer):
    trainer.run(2)
    g0 = trainer.coord.view.generation
    trainer.scale_workers(5)
    assert len(trainer.coord.view.workers) == 5
    assert trainer.coord.view.generation > g0
    trainer.run(2)
    trainer.scale_workers(2)
    assert len(trainer.coord.view.workers) == 2
    trainer.run(2)
    assert trainer.coord.view.committed_step == 5


def test_determinism_across_trainers(tmp_path):
    cfg = get_config("granite-3-2b").smoke()
    kw = dict(
        opt_cfg=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=100),
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                            global_batch=4, seed=7),
        n_virtual_workers=2, ckpt_every=100, device="cpu")
    t1 = Trainer(cfg, str(tmp_path / "a"), **kw)
    t2 = Trainer(cfg, str(tmp_path / "b"), **kw)
    assert [m["ce"] for m in t1.run(3)] == [m["ce"] for m in t2.run(3)]


@pytest.mark.parametrize("name", ["granite-3-2b", "rwkv6-7b",
                                  "recurrentgemma-2b"])
def test_trainer_matches_reference_from_the_same_weights(tmp_path, name):
    import jax
    from repro.configs import get_config as jget
    from repro.data.pipeline import DataConfig as JData
    from repro.optim.adamw import AdamWConfig as JAdam
    from repro.runtime.train_loop import Trainer as JTrainer
    from repro.models import loss_fn as jloss
    from repro_torch.models.convert import params_from_jax

    jcfg, cfg = jget(name).smoke(), get_config(name).smoke()
    okw = dict(lr=3e-3, warmup_steps=2, total_steps=100, weight_decay=0.01)
    dkw = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=0)
    ref = JTrainer(jcfg, tempfile.mkdtemp(dir=tmp_path), opt_cfg=JAdam(**okw),
                   data_cfg=JData(**dkw), n_virtual_workers=2,
                   ckpt_every=100)
    mine = Trainer(cfg, str(tmp_path / "port"), opt_cfg=AdamWConfig(**okw),
                   data_cfg=DataConfig(**dkw), n_virtual_workers=2,
                   ckpt_every=100, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref.state.params),
                             device="cpu").requires_grad_(True)
    mine.state = TrainState(params=params, opt_state=init_opt_state(params))

    # the first step's gradients, each against the reference's
    batch = {k: jax.numpy.asarray(v)
             for k, v in ref.data.global_batch(0).items()}
    jgrads = jax.grad(lambda p: jloss(jcfg, p, batch)[0])(ref.state.params)
    want = dict(params_from_jax(cfg, jax.tree.map(np.asarray, jgrads),
                                device="cpu").named_parameters())
    for step in range(3):
        jm, m = ref.run_step(), mine.run_step()
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(m[key], jm[key], rtol=1e-4,
                                       err_msg=f"{key} at step {step}")
        if step == 0:
            for n, p in mine.state.params.named_parameters():
                w = want[n].detach()
                err = float((p.grad - w).abs().max())
                assert err <= 1e-4 * float(w.abs().max()), (n, err)
    assert mine.coord.view.committed_step == ref.coord.view.committed_step


def test_adamw_decays_what_the_reference_decays():
    """From the reference's smoke weights, zero gradients and a nonzero
    weight decay: after one AdamW step through the train step's mask every
    parameter equals the reference's within 1e-6.  The reference decays a
    layer's norm scales (stacked there to 2-D over the segment's repeats),
    so ``layers.*.ln*.scale`` moves by lr * wd * 1 = 9.997e-04."""
    import jax
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit
    from repro.optim.adamw import AdamWConfig as JAdam
    from repro.optim.adamw import adamw_update as jupdate
    from repro.optim.adamw import init_opt_state as jopt
    from repro_torch.models.convert import decay_mask, params_from_jax
    from repro_torch.optim.adamw import adamw_update

    name = "granite-3-2b"
    jcfg, cfg = jget(name).smoke(), get_config(name).smoke()
    okw = dict(lr=1e-2, warmup_steps=0, weight_decay=0.1)
    jparams = jinit(jcfg, jax.random.key(0))
    jgrads = jax.tree.map(jax.numpy.zeros_like, jparams)
    jnew, _, _ = jupdate(JAdam(**okw), jgrads, jopt(jparams), jparams)
    want = dict(params_from_jax(cfg, jax.tree.map(np.asarray, jnew),
                                device="cpu").named_parameters())

    model = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    named = dict(model.named_parameters())
    grads = {n: torch.zeros_like(p) for n, p in named.items()}
    adamw_update(AdamWConfig(**okw), grads, init_opt_state(model), named,
                 decay_mask(model))
    moved = 0
    for n, p in model.named_parameters():
        assert float((p - want[n]).abs().max()) <= 1e-6, n
        if ".ln" in n and n.endswith(".scale"):
            shift = float((before[n] - p).abs().max())
            assert shift == pytest.approx(9.997e-04, rel=1e-3), (n, shift)
            moved += 1
    assert moved == 2 * cfg.n_layers
    assert torch.equal(model.final_norm["scale"], before["final_norm.scale"])

"""Twin of ``tests/test_runtime_substrate.py`` for the port: optimizer,
compression, data pipeline, grid checkpoints and the coordinator (the RSM
control plane), on the CPU over torch tensors.

Beyond the 21 twins, the port is held to the reference on the same
inputs: int8 codes and scales of ``compress_tree`` (with error feedback
over steps) exactly, ``SyntheticLM`` batches and shards exactly,
``lr_schedule`` exactly and ``adamw_update`` (moments, parameters,
``grad_norm``) for the same gradients within float32 rounding, and the
coordinator's committed view exactly after the same command sequence.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint.store import GridCheckpointStore  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig,
    Prefetcher,
    SyntheticLM,
    pack_documents,
)
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    adamw_update,
    init_opt_state,
    lr_schedule,
)
from repro_torch.optim.compression import (  # noqa: E402
    compress_tree,
    compression_ratio,
    decompress_tree,
    quantize_int8,
)
from repro_torch.runtime.coordinator import TrainingCoordinator  # noqa: E402


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_adamw_reduces_quadratic_loss():
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, total_steps=100,
                      weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = init_opt_state(params)
    for _ in range(50):
        w = params["w"].detach().requires_grad_()
        torch.sum(w ** 2).backward()
        params, opt, m = adamw_update(cfg, {"w": w.grad}, opt, params)
    assert float(torch.sum(params["w"] ** 2)) < 0.05
    assert int(opt["step"]) == 50


def test_lr_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    assert float(lr_schedule(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(lr_schedule(cfg, torch.tensor(10))) == pytest.approx(
        1.0, abs=0.01)
    assert float(lr_schedule(cfg, torch.tensor(100))) == pytest.approx(
        0.1, abs=0.01)


def test_grad_clipping_bounds_update():
    cfg = AdamWConfig(clip_norm=1.0, warmup_steps=0, total_steps=10)
    params = {"w": torch.zeros(3)}
    opt = init_opt_state(params)
    huge = {"w": torch.tensor([1e6, -1e6, 1e6])}
    _, _, metrics = adamw_update(cfg, huge, opt, params)
    assert float(metrics["grad_norm"]) > 1e5  # pre-clip norm reported


def test_lr_schedule_equals_reference_exactly():
    import jax.numpy as jnp
    from repro.optim.adamw import AdamWConfig as JCfg
    from repro.optim.adamw import lr_schedule as jsched
    for kw in (dict(lr=3e-3, warmup_steps=2, total_steps=100),
               dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_ratio=0.1),
               dict(lr=1e-3, warmup_steps=5, total_steps=200)):
        for step in (0, 1, 2, 3, 5, 10, 57, 99, 100, 150):
            want = np.float32(jsched(JCfg(**kw), jnp.asarray(step)))
            got = lr_schedule(AdamWConfig(**kw), torch.tensor(step))
            assert got.dtype == torch.float32
            assert np.float32(got) == want, (kw, step)


@pytest.mark.parametrize("clip_norm", [1e9, 1.0])
def test_adamw_update_matches_reference_for_the_same_gradients(clip_norm):
    """Three steps from the same float32 and bfloat16 parameters with the
    same gradients: the first step, unclipped, equals the reference to the
    bit; later and clipped steps within float32 rounding of the global
    norm's sum order."""
    import jax
    import jax.numpy as jnp
    from repro.optim.adamw import AdamWConfig as JCfg
    from repro.optim.adamw import adamw_update as jupdate
    from repro.optim.adamw import init_opt_state as jinit
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=100, weight_decay=0.1,
              clip_norm=clip_norm)
    rng = np.random.default_rng(0)
    p0 = {"a_w": rng.standard_normal((8, 6)).astype(np.float32),
          "b_bias": rng.standard_normal(6).astype(np.float32),
          "c_bf16": rng.standard_normal((4, 5)).astype(np.float32)}
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "c_bf16" else jnp.float32)
          for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16 if k == "c_bf16"
                                    else torch.float32)
          for k, v in p0.items()}
    jopt, topt = jinit(jp), init_opt_state(tp)
    for step in range(3):
        g = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
             for k, v in p0.items()}
        jg = {k: jnp.asarray(v).astype(jp[k].dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(tp[k].dtype) for k, v in g.items()}
        jp, jopt, jm = jupdate(JCfg(**kw), jg, jopt, jp)
        tp, topt, tm = adamw_update(AdamWConfig(**kw), tg, topt, tp)
        exact = step == 0 and clip_norm > 1e6
        tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert np.float32(tm["lr"]) == np.float32(jm["lr"])
        assert int(topt["step"]) == int(jopt["step"]) == step + 1
        for k in p0:
            for mine, ref in ((tp[k], jp[k]), (topt["m"][k], jopt["m"][k]),
                              (topt["v"][k], jopt["v"][k])):
                np.testing.assert_allclose(
                    mine.float().numpy(),
                    np.asarray(jax.device_get(ref), np.float32), **tol,
                    err_msg=f"{k} step {step}")
        assert tp["c_bf16"].dtype == torch.bfloat16


def test_clip_by_global_norm_matches_reference():
    import jax.numpy as jnp
    from repro.optim.adamw import clip_by_global_norm as jclip
    from repro_torch.optim.adamw import clip_by_global_norm
    rng = np.random.default_rng(9)
    g = {"a": rng.standard_normal((5, 3)).astype(np.float32) * 4,
         "b": rng.standard_normal(7).astype(np.float32)}
    for max_norm in (1.0, 1e3):
        jc, jn = jclip({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        tc, tn = clip_by_global_norm({k: torch.from_numpy(v)
                                      for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=1e-7)
        if max_norm > 100:
            for k in g:
                np.testing.assert_array_equal(tc[k].numpy(), g[k])


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_int8_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(256)
                         .astype(np.float32))
    q, s = quantize_int8(x)
    err = torch.abs(q.float() * s - x)
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_accumulates_residual():
    grads = {"w": torch.from_numpy(np.random.default_rng(1)
                                   .standard_normal(64).astype(np.float32))}
    qtree, res = compress_tree(grads)
    deq = decompress_tree(qtree)
    np.testing.assert_allclose((deq["w"] + res["w"]).numpy(),
                               grads["w"].numpy(), rtol=1e-5, atol=1e-6)


def test_error_feedback_unbiased_over_steps():
    """With a constant gradient, mean of dequantized updates -> true grad."""
    g = {"w": torch.tensor([0.001, 0.5, -0.3, 1e-5])}
    res = None
    acc = torch.zeros(4)
    n = 200
    for _ in range(n):
        qtree, res = compress_tree(g, res)
        acc = acc + decompress_tree(qtree)["w"]
    np.testing.assert_allclose((acc / n).numpy(), g["w"].numpy(),
                               rtol=0.02, atol=3e-5)


def test_compression_ratio_about_one_quarter_fp32():
    grads = {"a": torch.zeros((1024,), dtype=torch.float32)}
    assert compression_ratio(grads) == pytest.approx(0.251, abs=0.01)


def test_compress_tree_codes_and_scales_equal_reference():
    """Codes, scales and residuals over 5 steps of error feedback on a
    nested tree (float32 and bfloat16 leaves, a zero leaf, ties at .5)."""
    import jax.numpy as jnp
    from repro.optim.compression import compress_tree as jcompress
    from repro.optim.compression import compression_ratio as jratio
    rng = np.random.default_rng(3)
    ties = (np.arange(-8, 9) * 0.5).astype(np.float32)  # x / scale = k/2
    base = {"a": rng.standard_normal((16, 8)).astype(np.float32),
            "nested": {"b": rng.standard_normal(33).astype(np.float32) * 1e-3,
                       "ties": ties, "zero": np.zeros(5, np.float32)},
            "c": rng.standard_normal((3, 7)).astype(np.float32)}
    jres = tres = None
    for step in range(5):
        g = {"a": base["a"] * (step + 1),
             "nested": {k: v + step for k, v in base["nested"].items()},
             "c": base["c"]}
        jg = {"a": jnp.asarray(g["a"]),
              "nested": {k: jnp.asarray(v) for k, v in g["nested"].items()},
              "c": jnp.asarray(g["c"], jnp.bfloat16)}
        tg = {"a": torch.from_numpy(g["a"]),
              "nested": {k: torch.from_numpy(v)
                         for k, v in g["nested"].items()},
              "c": torch.from_numpy(g["c"]).to(torch.bfloat16)}
        jq, jres = jcompress(jg, jres)
        tq, tres = compress_tree(tg, tres)
        for path in (("a",), ("nested", "b"), ("nested", "ties"),
                     ("nested", "zero"), ("c",)):
            jl, tl, jr, tr = jq, tq, jres, tres
            for key in path:
                jl, tl, jr, tr = jl[key], tl[key], jr[key], tr[key]
            assert tl[0].dtype == torch.int8
            np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl[0]))
            assert np.float32(tl[1]) == np.float32(jl[1]), path
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert compression_ratio(tg) == pytest.approx(jratio(jg), rel=1e-12)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_data_deterministic_and_rank_consistent():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=8, seed=3)
    src = SyntheticLM(cfg)
    g = src.global_batch(step=7)
    parts = [src.shard_batch(7, r, 4)["tokens"] for r in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), g["tokens"])
    parts2 = [src.shard_batch(7, r, 2)["tokens"] for r in range(2)]
    np.testing.assert_array_equal(np.concatenate(parts2), g["tokens"])


def test_labels_are_shifted_tokens():
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2, seed=0)
    b = SyntheticLM(cfg).global_batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_markov_stream_is_learnable():
    cfg = DataConfig(vocab_size=64, seq_len=512, global_batch=1, seed=1)
    toks = SyntheticLM(cfg).global_batch(0)["tokens"][0]
    from collections import Counter, defaultdict
    nxt = defaultdict(Counter)
    for a, b in zip(toks[:-1], toks[1:]):
        nxt[int(a)][int(b)] += 1
    top_frac = np.mean([c.most_common(1)[0][1] / sum(c.values())
                        for c in nxt.values() if sum(c.values()) >= 5])
    assert top_frac > 3.0 / 64


def test_pack_documents():
    docs = [np.arange(1, 4), np.arange(1, 6), np.arange(1, 3), np.arange(1, 8)]
    toks, mask, segs = pack_documents(docs, seq_len=8)
    assert toks.shape[1] == 8
    assert mask.max() == 1.0
    assert int(mask.sum()) == sum(len(d) for d in docs)
    assert len(set(segs[0][mask[0] > 0])) >= 1


def test_prefetcher_yields_increasing_steps():
    cfg = DataConfig(vocab_size=32, seq_len=8, global_batch=4, seed=0)
    pf = Prefetcher(SyntheticLM(cfg), rank=0, num_ranks=2, depth=2)
    try:
        b0 = pf.next()
        b1 = pf.next()
        assert b1["step"] == b0["step"] + 1
        assert b0["tokens"].shape == (2, 8)
    finally:
        pf.close()


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (128, 16, 8, 3), (49155, 1024, 4, 0), (64, 33, 6, 11)])
def test_synthetic_batches_equal_reference_exactly(vocab, seq, batch, seed):
    from repro.data.pipeline import DataConfig as JData
    from repro.data.pipeline import SyntheticLM as JLM
    from repro.data.pipeline import pack_documents as jpack
    mine = SyntheticLM(DataConfig(vocab, seq, batch, seed))
    ref = JLM(JData(vocab, seq, batch, seed))
    for step in (0, 1, 7):
        a, b = mine.global_batch(step), ref.global_batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        for r in range(2):
            np.testing.assert_array_equal(
                mine.shard_batch(step, r, 2)["tokens"],
                ref.shard_batch(step, r, 2)["tokens"])
    docs = [np.arange(1, n) for n in (4, 9, 3, 12, 2)]
    for x, y in zip(pack_documents(docs, 8), jpack(docs, 8)):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# grid checkpoint store
# ---------------------------------------------------------------------------


def make_tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((5,), dtype=torch.bfloat16),
                   "c": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    return [tree["a"], tree["nested"]["b"], tree["nested"]["c"]]


def test_checkpoint_roundtrip(tmp_path):
    store = GridCheckpointStore(tmp_path, rows=2, cols=2)
    tree = make_tree()
    store.save(3, tree)
    out = store.restore(3, tree)
    for a, b in zip(_leaves(tree), _leaves(out)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_survives_node_failures(tmp_path):
    store = GridCheckpointStore(tmp_path, rows=2, cols=3)
    tree = make_tree()
    store.save(1, tree)
    store.fail_node(0, 0)
    store.fail_node(0, 2)
    store.fail_node(1, 1)
    out = store.restore(1, tree)
    assert torch.equal(out["a"], tree["a"])


def test_checkpoint_detects_corruption_and_falls_back(tmp_path):
    store = GridCheckpointStore(tmp_path, rows=2, cols=2)
    tree = make_tree()
    store.save(2, tree)
    for f in (store._node_dir(0, 0).glob("step2_*")):
        f.write_bytes(b"garbage")
    for f in (store._node_dir(0, 1).glob("step2_*")):
        f.write_bytes(b"garbage")
    out = store.restore(2, tree)  # row 1 replicas still intact
    assert torch.equal(out["a"], tree["a"])


def test_checkpoint_write_load_spread(tmp_path):
    store = GridCheckpointStore(tmp_path, rows=2, cols=2)
    tree = {f"leaf{i}": torch.ones((64,), dtype=torch.float32)
            for i in range(8)}
    store.save(0, tree)
    for v in store.write_load_fractions().values():
        assert v == pytest.approx(0.25, abs=0.05)


def test_async_checkpoint(tmp_path):
    """The host copy is taken before ``save_async`` returns: writing the
    tensors in place afterwards (as the trainer's AdamW does) does not
    reach the checkpoint."""
    store = GridCheckpointStore(tmp_path, rows=2, cols=2)
    tree = make_tree()
    saved = tree["a"].clone()
    store.save_async(5, tree)
    tree["a"].add_(100.0)
    store.wait()
    assert store.latest_step() == 5
    out = store.restore(5, tree)
    assert torch.equal(out["a"], saved)


def test_checkpoint_files_equal_the_reference_store(tmp_path):
    """The same tree saved by both stores: the same manifest leaves (bf16
    as a uint16 view) and the same bytes and crc32 per shard."""
    import jax.numpy as jnp
    from repro.checkpoint.store import GridCheckpointStore as JStore
    jtree = {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
             "nested": {"b": jnp.ones((5,), jnp.bfloat16) * 1.5,
                        "c": jnp.asarray(7, jnp.int32)}}
    tree = make_tree()
    tree["nested"]["b"] = tree["nested"]["b"] * 1.5
    jm = JStore(tmp_path / "ref", 2, 2).save(4, jtree)
    m = GridCheckpointStore(tmp_path / "port", 2, 2).save(4, tree)
    assert sorted(m.leaves) == sorted(jm.leaves)
    for name, meta in m.leaves.items():
        ref = jm.leaves[name]
        for key in ("index", "column", "shape", "dtype", "crc32", "bytes",
                    "file"):
            assert meta[key] == ref[key], (name, key)


def test_checkpoint_leaf_order_follows_sorted_keys_as_the_reference(tmp_path):
    """A tree whose keys are not in sorted order (as the trainer's own
    {"params", "opt", "step"}): both stores give each leaf the same index,
    column and file, and write the same bytes to it."""
    import jax.numpy as jnp
    from repro.checkpoint.store import GridCheckpointStore as JStore
    jtree = {"b": jnp.ones((5,), jnp.float32),
             "a": jnp.arange(3, dtype=jnp.float32)}
    tree = {"b": torch.ones((5,), dtype=torch.float32),
            "a": torch.arange(3, dtype=torch.float32)}
    jm = JStore(tmp_path / "ref", 2, 2).save(0, jtree)
    m = GridCheckpointStore(tmp_path / "port", 2, 2).save(0, tree)
    assert sorted(m.leaves) == sorted(jm.leaves)
    assert m.leaves["['a']"]["index"] == 0
    for name, meta in m.leaves.items():
        ref = jm.leaves[name]
        for key in ("index", "column", "file", "bytes", "crc32"):
            assert meta[key] == ref[key], (name, key)
        path = f"node_r0_c{meta['column']}/{meta['file']}"
        assert ((tmp_path / "port" / path).read_bytes()
                == (tmp_path / "ref" / path).read_bytes()), name
    out = GridCheckpointStore(tmp_path / "port", 2, 2).restore(0, tree)
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"],
                                                            tree["b"])


# ---------------------------------------------------------------------------
# coordinator (RSM control plane)
# ---------------------------------------------------------------------------


def test_coordinator_commits_steps():
    coord = TrainingCoordinator(n_workers=3)
    for s in range(3):
        for w in range(3):
            coord.report_step(w, s)
    assert coord.view.committed_step == 2
    assert len(coord.view.workers) == 3


def test_coordinator_straggler_noop_fill():
    coord = TrainingCoordinator(n_workers=3, skip_after=1)
    for s in range(4):
        for w in (0, 1):
            coord.report_step(w, s)
    assert coord.view.committed_step == -1
    skipped = coord.mitigate_stragglers(
        3, {"worker/0": 3, "worker/1": 3, "worker/2": -1})
    assert skipped == ["worker/2"]
    assert coord.view.committed_step == 3


def test_coordinator_membership_and_generation():
    coord = TrainingCoordinator(n_workers=2)
    g0 = coord.view.generation
    coord.join("worker/9")
    assert coord.view.generation == g0 + 1
    coord.leave("worker/9")
    assert coord.view.generation == g0 + 2
    assert "worker/9" not in coord.view.workers


def test_coordinator_survives_leader_failover():
    coord = TrainingCoordinator(n_workers=2)
    for w in range(2):
        coord.report_step(w, 0)
    coord.fail_over()
    for w in range(2):
        coord.report_step(w, 1)
    assert coord.view.committed_step == 1
    coord.commit_checkpoint(1)
    assert coord.view.committed_ckpt == 1


def test_coordinator_commits_equal_reference():
    """The same command sequence (reports, a straggler's noop fill, a
    fail-over, joins and leaves, a checkpoint commit) through both
    packages' RSMs: the same results and the same replayed view."""
    import dataclasses
    from repro.runtime.coordinator import TrainingCoordinator as JCoord
    mine, ref = TrainingCoordinator(3, skip_after=1, seed=4), \
        JCoord(3, skip_after=1, seed=4)
    for coord in (mine, ref):
        out = []
        for s in range(3):
            for w in (0, 1):
                out.append(coord.report_step(w, s))
        out.append(coord.mitigate_stragglers(
            2, {"worker/0": 2, "worker/1": 2, "worker/2": -1}))
        coord.fail_over()
        out.append(coord.join("worker/7"))
        for w in (0, 1, 2):
            out.append(coord.report_step(w, 3))
        out.append(coord.report_step(7, 3))
        out.append(coord.leave("worker/2"))
        out.append(coord.commit_checkpoint(3))
        coord.out = out
    assert mine.out == ref.out
    assert dataclasses.asdict(mine.view) == dataclasses.asdict(ref.view)
    assert mine.view.committed_step == 3

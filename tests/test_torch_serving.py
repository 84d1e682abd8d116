"""The port's serving plane: twins of ``tests/test_serving.py`` on the CPU,
and both packages' fleets serving the same prompts on the same weights.

Weight updates are writes through the log, inference is a leaderless read,
consistency modes hold, continuous batching drains; every port entry
point is given ``device="cpu"`` (its default is the card).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatcher,
    Request,
)
from repro_torch.serving.server import ServingDeployment  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def smoke_model():
    cfg = get_config("granite-3-2b").smoke()
    params = init_params(cfg, 0, device=CPU)
    return cfg, params


@pytest.fixture()
def fleet(smoke_model):
    cfg, params = smoke_model
    dep = ServingDeployment(cfg, n_replicas=3, n_clients=2, device=CPU)
    dep.push_weights(params)
    return dep


def _direct(cfg, params, prompt, max_new, cache_len):
    tokens = torch.tensor([prompt], dtype=torch.int32)
    _, caches = prefill(cfg, params, tokens, cache_len=cache_len)
    tok = tokens[:, -1:]
    out = []
    for _ in range(max_new):
        logits, caches = decode_step(cfg, params, caches, tok)
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out.append(int(tok[0, 0]))
    return out


def test_inference_is_a_read_not_a_log_write(fleet):
    slots_before = fleet.rsm.leader.next_slot
    fleet.infer([1, 2, 3], max_new=2)
    assert fleet.rsm.leader.next_slot == slots_before, \
        "inference must bypass the leader (leaderless read path)"


def test_inference_returns_tokens(fleet, smoke_model):
    cfg, _ = smoke_model
    version, toks = fleet.infer([1, 2, 3], max_new=3)
    assert version == "v1"
    assert len(toks) == 3
    assert all(isinstance(t, int) and 0 <= t < cfg.vocab_size for t in toks)


def test_inference_matches_direct_decode(fleet, smoke_model):
    """The serving fleet must produce exactly the single-model answer."""
    cfg, params = smoke_model
    prompt = [5, 6, 7, 8]
    _, served = fleet.infer(prompt, max_new=4)
    assert list(served) == _direct(cfg, params, prompt, 4, len(prompt) + 4)


def test_weight_update_visible_to_subsequent_reads(fleet, smoke_model):
    cfg, _ = smoke_model
    v1, _ = fleet.infer([1, 2, 3], max_new=2)
    fleet.push_weights(init_params(cfg, 42, device=CPU))
    v2, _ = fleet.infer([1, 2, 3], max_new=2)
    assert v1 == "v1" and v2 == "v2", \
        "linearizable read must observe the committed weight update"


def test_reads_spread_across_replicas(fleet):
    fleet.submit_many([[1, 2]] * 12, max_new=1)
    loads = fleet.replica_loads()
    assert sum(loads) >= 12
    assert max(loads) < sum(loads), "reads must not funnel to one replica"


def test_eventual_consistency_skips_acceptors(smoke_model):
    cfg, params = smoke_model
    dep = ServingDeployment(cfg, n_replicas=2, n_clients=1,
                            consistency="eventual", device=CPU)
    dep.push_weights(params)
    before = sum(a.msgs_received for a in dep.rsm.acceptors)
    dep.infer([1, 2], max_new=1)
    after = sum(a.msgs_received for a in dep.rsm.acceptors)
    assert after == before, \
        "eventual reads must not touch the acceptors (paper section 3.6)"


def test_linearizable_read_prereads_a_quorum(smoke_model):
    cfg, params = smoke_model
    dep = ServingDeployment(cfg, n_replicas=2, n_clients=1,
                            consistency="linearizable", device=CPU)
    dep.push_weights(params)
    before = sum(a.msgs_received for a in dep.rsm.acceptors)
    dep.infer([1, 2], max_new=1)
    after = sum(a.msgs_received for a in dep.rsm.acceptors)
    assert after > before, "linearizable reads preread the acceptor grid"


def test_continuous_batcher_drains_all_requests(smoke_model):
    cfg, params = smoke_model
    cb = ContinuousBatcher(cfg, params, n_slots=3, max_len=32, device=CPU)
    reqs = [Request(rid=i, prompt=[1, 2, 3, 4], max_new=3) for i in range(7)]
    for r in reqs:
        cb.submit(r)
    cb.run_until_drained()
    assert all(r.done for r in reqs)
    assert all(len(r.out) == 3 for r in reqs)
    assert cb.mean_occupancy > 1.5


def test_continuous_batcher_matches_sequential_decode(smoke_model):
    cfg, params = smoke_model
    prompt = [2, 3, 4]
    cb = ContinuousBatcher(cfg, params, n_slots=2, max_len=16, device=CPU)
    r = Request(rid=0, prompt=prompt, max_new=3)
    cb.submit(r)
    cb.run_until_drained()
    assert r.out == _direct(cfg, params, prompt, 3, 16)


def test_push_weights_rejects_weights_on_another_device(smoke_model):
    cfg, _ = smoke_model
    dep = ServingDeployment(cfg, n_replicas=2, n_clients=1, device=CPU)
    with pytest.raises(ValueError):
        dep.push_weights(init_params(cfg, 0, device=CPU).to("meta"))


# ---------------------------------------------------------------------------
# both packages, the same weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-2b",
                                  "rwkv6-7b", "deepseek-moe-16b/gshard"])
def test_both_packages_serve_the_same_tokens(arch, monkeypatch):
    """Fleet and batcher of both packages on carried weights.  The longest
    prompts and their decode steps pass recurrentgemma's smoke window of 8:
    the prefill rolls its ring buffer, and decode wraps it.
    deepseek-moe-16b with capacity dispatch: the batcher's 6 slots decode
    as one group of 6 tokens at capacity 2 (8 experts, top-2), so choices
    are dropped, and the slots that fall idle once the queue is empty
    still decode and take capacity, as in the reference."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as jget
    from repro.models import init_params as jinit
    from repro.serving.scheduler import ContinuousBatcher as JBatcher
    from repro.serving.scheduler import Request as JRequest
    from repro.serving.server import ServingDeployment as JDeployment
    from repro_torch.models import moe
    from repro_torch.models.convert import params_from_jax

    name, _, impl = arch.partition("/")
    jcfg, cfg = jget(name).smoke(), get_config(name).smoke()
    if impl:
        jcfg = dataclasses.replace(jcfg, moe_impl=impl)
        cfg = dataclasses.replace(cfg, moe_impl=impl)
    v1, v2 = jinit(jcfg, jax.random.key(0)), jinit(jcfg, jax.random.key(1))
    p1, p2 = (params_from_jax(cfg, jax.tree.map(np.asarray, p), device=CPU)
              for p in (v1, v2))
    jdep = JDeployment(jcfg, n_replicas=3, n_clients=2)
    dep = ServingDeployment(cfg, n_replicas=3, n_clients=2, device=CPU)
    prompts = [[5, 6, 7, 8], [1, 2, 3], [9, 10, 11, 12, 13], [4, 4],
               list(range(20, 30))]
    want, got = [], []
    for weights, d in ((v1, jdep), (p1, dep)):
        d.push_weights(weights)
    for i, p in enumerate(prompts):
        if i == 2:
            jdep.push_weights(v2)
            dep.push_weights(p2)
        want.append(jdep.infer(p, max_new=4, client=i % 2))
        got.append(dep.infer(p, max_new=4, client=i % 2))
    assert got == want
    assert [v for v, _ in got] == ["v1", "v1", "v2", "v2", "v2"]
    assert dep.replica_loads() == jdep.replica_loads()

    # continuous batching over equal-length prompts, slots reused; the MoE
    # decode steps' dropped choices are counted
    n_slots, n_requests = (6, 9) if cfg.moe else (2, 5)
    dropped = []
    positions = moe.dispatch_positions

    def counted(top_i, n_groups, n_experts):
        pos = positions(top_i, n_groups, n_experts)
        if top_i.shape[0] == n_slots:
            c = moe._capacity(cfg.moe, n_slots // n_groups)
            dropped.append(int((pos >= c).sum()))
        return pos

    monkeypatch.setattr(moe, "dispatch_positions", counted)
    jcb = JBatcher(jcfg, v1, n_slots=n_slots, max_len=16)
    cb = ContinuousBatcher(cfg, p1, n_slots=n_slots, max_len=16, device=CPU)
    rng = np.random.default_rng(3)
    for rid in range(n_requests):
        prompt = rng.integers(0, cfg.vocab_size, 7).tolist()
        jcb.submit(JRequest(rid=rid, prompt=prompt, max_new=4))
        cb.submit(Request(rid=rid, prompt=prompt, max_new=4))
    jreqs, reqs = list(jcb.queue), list(cb.queue)
    jcb.run_until_drained()
    cb.run_until_drained()
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert cb.steps_executed == jcb.steps_executed
    if cfg.moe:
        assert len(dropped) == cb.steps_executed * cfg.n_layers - \
            cb.steps_executed * cfg.moe_layer_start
        assert sum(dropped) > 0, "no decode step dropped a choice"
        assert cb.mean_occupancy < n_slots  # idle slots decoded too


@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-2b",
                                  "rwkv6-7b", "deepseek-moe-16b",
                                  "qwen3-moe-30b-a3b"])
def test_serve_launcher_runs_on_the_host(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--device", "cpu", "--requests", "4",
                "--max-new", "2", "--push-update-midway"])
    out = capsys.readouterr().out
    assert "weights v1 installed" in out and "v2 committed" in out
    assert out.count("served at weights") == 4

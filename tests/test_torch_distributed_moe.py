"""Twin of ``tests/test_distributed_moe.py``: the port's all-to-all
expert-parallel MoE (``runtime/moe_a2a.py``) on a 2x2 (data, model) mesh
of gloo ranks on the CPU, the reference's on four forced host devices.

With generous capacity the layer is drop-free and matches the port's
``apply_moe_dense`` and the reference's within 2e-5; it makes exactly two
``all_to_all_single`` calls per layer call and gathers no token before
the dispatch (counted by ``runtime.collectives.CALLS``, the port has no
HLO); with tight capacity it drops choices and stays finite.  Against the
reference's ``make_moe_a2a`` on the same weights and tokens, every rank's
``slot`` and ``kept`` equal the reference's ``_local_dispatch`` on the
same shard exactly, and the output within 1e-5; the model's MoE channel
with ``moe_impl="a2a"`` under ``use_mesh`` gives the reference's logits
within 1e-4.  The sharded train step with ``moe_impl="a2a"`` over the
model axis matches the reference's 2x2 step, and the sharded prefill and
serve steps the unsharded port's.
"""
import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import run_ranks, run_reference  # noqa: E402

D_MODEL = 16
#: x (4, 8, 16): one batch row per rank of the 2x2 mesh
X_SHAPE = (4, 8, D_MODEL)

LAYER_BODY = """
from repro_torch.models import moe
from repro_torch.runtime.collectives import CALLS, reset_counts
from repro_torch.runtime.moe_a2a import _local_dispatch, make_moe_a2a
from repro_torch.runtime.sharding import local_chunk
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = moe.MoEConfig(**{cfg})
tree = pickle.load(open({params!r}, "rb"))


def tensors(t):
    if isinstance(t, dict):
        return {{k: tensors(v) for k, v in t.items()}}
    return torch.from_numpy(np.asarray(t))


params = tensors(tree)
x = torch.from_numpy(np.load({ref!r} + "/x.npy"))
mine = local_chunk(x, ("data", None, None), mesh)
fn = make_moe_a2a(mesh, cfg, "swiglu", {d_model})
reset_counts()
out, aux = fn(params, mine)
calls = dict(CALLS)
# the dispatch of this rank's tokens (its row along the model axis)
xt = mine[mesh.get_local_rank("model")].reshape(-1, {d_model})
_, top_w, top_i = moe.router_probs(params, xt, cfg)
_, slot, kept = _local_dispatch(xt, top_w, top_i, cfg.n_experts,
                                moe._capacity(cfg, xt.shape[0]))
dense, aux_d = moe.apply_moe_dense(params, x, cfg, "swiglu")
pickle.dump(dict(out=out.numpy(), aux=float(aux), slot=slot.numpy(),
                 kept=kept.numpy(), calls=calls,
                 dense=local_chunk(dense, ("data", None, None),
                                   mesh).numpy(), aux_dense=float(aux_d)),
            open(f"{{OUT}}/rank{{RANK}}.pkl", "wb"))
"""


def _moe_cfg(capacity_factor, n_shared=0):
    return dict(n_experts=8, top_k=2, d_expert=32, n_shared=n_shared,
                capacity_factor=capacity_factor)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's layer at three capacities on the same weights and
    tokens, its per-shard dispatch, and its model forward with
    ``moe_impl="a2a"``, all on a 2x2 mesh."""
    out = tmp_path_factory.mktemp("reference")
    rng = np.random.default_rng(1)
    np.save(out / "x.npy", rng.standard_normal(X_SHAPE).astype(np.float32))
    np.save(out / "tokens.npy", rng.integers(0, 128, (4, 8), np.int32))
    run_reference(f"""
    import dataclasses, math
    from repro.models.moe import MoEConfig, init_moe, router_probs
    from repro.runtime.moe_a2a import _local_dispatch, make_moe_a2a
    OUT = {str(out)!r}
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    x = np.load(OUT + "/x.npy")
    for cf, shared in ((8.0, 1), (2.0, 0), (0.5, 0)):
        cfg = MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=shared,
                        capacity_factor=cf)
        params = init_moe(jax.random.key(0), {D_MODEL}, cfg, "swiglu",
                          jnp.float32)
        o, aux = jax.jit(make_moe_a2a(mesh, cfg, "swiglu", {D_MODEL}))(
            params, x)
        shards = []
        for row in range(4):   # shard (data d, model m) holds row 2 d + m
            xt = jnp.asarray(x[row]).reshape(-1, {D_MODEL})
            _, top_w, top_i = router_probs(params, xt, cfg)
            cap = max(int(math.ceil(cfg.top_k * xt.shape[0]
                                    * cfg.capacity_factor / cfg.n_experts)),
                      cfg.top_k)
            _, slot, kept = _local_dispatch(xt, top_w, top_i, cfg.n_experts,
                                            cap)
            shards.append((np.asarray(slot), np.asarray(kept)))
        pickle.dump(dict(params=jax.tree.map(np.asarray, params),
                         out=np.asarray(o), aux=float(aux), shards=shards),
                    open(OUT + f"/layer_{{cf}}.pkl", "wb"))

    from repro.configs import get_config
    from repro.models import forward, init_params
    from repro.runtime.mesh_context import use_mesh
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").smoke(),
                              moe_impl="a2a")
    params = init_params(cfg, jax.random.key(0))
    with use_mesh(mesh):
        logits, aux = jax.jit(lambda p, t: forward(cfg, p, t))(
            params, np.load(OUT + "/tokens.npy"))
    pickle.dump(dict(params=jax.tree.map(np.asarray, params),
                     logits=np.asarray(logits), aux=float(aux)),
                open(OUT + "/model.pkl", "wb"))
    """)
    return out


def _run_layer(ref, tmp_path, capacity_factor, n_shared=0):
    """The port's layer on every rank from the reference's weights at
    ``capacity_factor``; returns (each rank's results, the reference's)."""
    want = pickle.load(open(ref / f"layer_{capacity_factor}.pkl", "rb"))
    pickle.dump(want["params"], open(tmp_path / "moe_params.pkl", "wb"))
    run_ranks(LAYER_BODY.format(cfg=_moe_cfg(capacity_factor, n_shared),
                                ref=str(ref), d_model=D_MODEL,
                                params=str(tmp_path / "moe_params.pkl")),
              tmp_path)
    return ([pickle.load(open(tmp_path / f"rank{r}.pkl", "rb"))
             for r in range(4)], want)


def _whole(ranks, key):
    """The data ranks' row blocks of an output whole along the model axis
    (rank = 2 data + model), after checking the model axis agrees."""
    for r in (1, 3):
        np.testing.assert_array_equal(ranks[r][key], ranks[r - 1][key])
    return np.concatenate([ranks[0][key], ranks[2][key]])


def test_a2a_moe_matches_dense_oracle(ref, tmp_path):
    ranks, want = _run_layer(ref, tmp_path, 8.0, n_shared=1)
    assert all(r["kept"].all() for r in ranks)   # generous: drop-free
    out = _whole(ranks, "out")
    np.testing.assert_allclose(out, _whole(ranks, "dense"), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(out, want["out"], rtol=2e-5, atol=2e-5)
    # aux is the mean of per-shard load-balance losses (the distributed
    # estimator) vs the oracle's global one: close, not equal
    for r in ranks:
        np.testing.assert_allclose(r["aux"], r["aux_dense"], rtol=0.25)
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=1e-5)


def test_a2a_moe_emits_all_to_all_not_gather(ref, tmp_path):
    """Two all-to-alls per layer call, and the only gather is of the
    layer's output rows along the model axis, after the combine."""
    ranks, _ = _run_layer(ref, tmp_path, 2.0)
    for r in ranks:
        assert r["calls"].get("all_to_all_single") == 2, r["calls"]
        assert r["calls"].get("all_gather_into_tensor") == 1, r["calls"]
        assert r["calls"].get("reduce_scatter_tensor") is None, r["calls"]


def test_a2a_moe_capacity_drops_are_bounded(ref, tmp_path):
    """With tight capacity some (token, expert) pairs drop; outputs stay
    finite."""
    ranks, _ = _run_layer(ref, tmp_path, 0.5)
    assert not all(r["kept"].all() for r in ranks)
    assert np.all(np.isfinite(_whole(ranks, "out")))


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_a2a_moe_dispatch_and_output_equal_reference(ref, tmp_path,
                                                     capacity_factor):
    """Each rank's ``slot`` and ``kept`` equal the reference's
    ``_local_dispatch`` on the same shard (row 2 d + m of the batch)
    exactly, and the layer's output the reference's ``make_moe_a2a``."""
    ranks, want = _run_layer(ref, tmp_path, capacity_factor)
    for rank, r in enumerate(ranks):
        slot, kept = want["shards"][rank]
        np.testing.assert_array_equal(r["slot"], slot)
        np.testing.assert_array_equal(r["kept"], kept)
    np.testing.assert_allclose(_whole(ranks, "out"), want["out"], rtol=1e-5,
                               atol=1e-5)


def test_model_moe_channel_runs_a2a_under_use_mesh(ref, tmp_path):
    """deepseek-moe-16b's smoke config with ``moe_impl="a2a"``: the port's
    forward under ``use_mesh`` on every rank's rows, against the
    reference's forward on the same mesh."""
    run_ranks(f"""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import forward
    from repro_torch.models.convert import params_from_jax
    from repro_torch.runtime.collectives import CALLS
    from repro_torch.runtime.mesh_context import use_mesh
    from repro_torch.runtime.sharding import local_chunk
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").smoke(),
                              moe_impl="a2a")
    want = pickle.load(open({str(ref)!r} + "/model.pkl", "rb"))
    model = params_from_jax(cfg, want["params"], device="cpu")
    tokens = torch.from_numpy(np.load({str(ref)!r} + "/tokens.npy"))
    with torch.no_grad(), use_mesh(mesh):
        logits, aux = forward(cfg, model,
                              local_chunk(tokens, ("data", None), mesh))
    n_moe = sum(cfg.channel_kind(i) == "moe" for i in range(cfg.n_layers))
    assert CALLS["all_to_all_single"] == 2 * n_moe, CALLS
    np.testing.assert_allclose(
        logits.numpy(), local_chunk(torch.from_numpy(want["logits"]),
                                    ("data", None, None), mesh).numpy(),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), want["aux"], rtol=1e-4)
    """, tmp_path)


#: the a2a train step's config: deepseek-moe-16b's smoke config (a dense
#: layer, then a MoE layer of 8 experts, top-2, one shared) on the
#: all-to-all layer
A2A_CFG = ("dataclasses.replace(get_config('deepseek-moe-16b').smoke(), "
           "moe_impl='a2a')")


@pytest.fixture(scope="module")
def ref_step(tmp_path_factory):
    """The reference's train step of ``A2A_CFG`` on a 2x2 (data, model)
    mesh of four host devices, as ``test_torch_distributed.py`` runs its
    step: the weights before it, the parameters and metrics after it."""
    out = tmp_path_factory.mktemp("reference_step")
    rng = np.random.default_rng(4)
    np.save(out / "tokens.npy", rng.integers(0, 128, (4, 8), np.int32))
    np.save(out / "labels.npy", rng.integers(0, 128, (4, 8), np.int32))
    run_reference(f"""
    import dataclasses
    from pathlib import Path
    from repro.configs import get_config
    from repro.configs.shapes import ShapeSpec
    from repro.models import init_params
    from repro.optim.adamw import init_opt_state
    from repro.runtime.mesh_context import use_mesh
    from repro.runtime.sharding import ShardingPolicy
    from repro.runtime.steps import input_specs, make_train_step
    OUT = Path({str(out)!r})
    # automatic axes: XLA's partitioner places the unembedding's gradient
    # behind the a2a layer's (data, model)-split rows (explicit axes
    # refuse its sharded contraction)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = {A2A_CFG}
    policy = ShardingPolicy(cfg, mesh)
    specs = input_specs(cfg, ShapeSpec("tiny", seq_len=8, global_batch=4,
                                       kind="train"))
    step = jax.jit(make_train_step(cfg),
                   in_shardings=(policy.params_shardings(specs["params"]),
                                 policy.opt_state_shardings(specs["params"]),
                                 policy.batch_shardings(specs["batch"])))
    params = init_params(cfg, jax.random.key(0))
    pickle.dump(jax.tree.map(np.asarray, params),
                open(OUT / "params0.pkl", "wb"))
    batch = {{"tokens": np.load(OUT / "tokens.npy"),
              "labels": np.load(OUT / "labels.npy")}}
    with use_mesh(mesh):
        p2, _, metrics = step(params, init_opt_state(params), batch)
    pickle.dump({{"params": jax.tree.map(np.asarray, p2),
                  "metrics": {{k: float(v) for k, v in metrics.items()}}}},
                open(OUT / "step.pkl", "wb"))
    """)
    return out


def test_sharded_a2a_train_step_matches_reference(ref_step, tmp_path):
    """The sharded train step with ``moe_impl="a2a"`` over a model axis of
    two ranks (the MoE layer's parameters' gradients summed over "model":
    a reduce-scatter into the experts' shards, an all-reduce for the
    router and the shared expert) from the reference's weights: every
    parameter within 1e-6 of the reference's 2x2 step (the tolerance of
    ``test_torch_distributed.py``'s sharded step: float32 sums in another
    order), the loss, its load-balance term and the gradient norm within
    1e-4; every rank holding the same parameters."""
    run_ranks(f"""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.runtime.collectives import CALLS
    from repro_torch.runtime.sharding import (ShardingPolicy,
                                              distribute_model,
                                              sharded_opt_state)
    from repro_torch.runtime.steps import make_train_step
    REF = {str(ref_step)!r}
    cfg = {A2A_CFG}
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    tree = pickle.load(open(os.path.join(REF, "params0.pkl"), "rb"))
    batch = {{n: torch.from_numpy(np.load(os.path.join(REF, n + ".npy")))
              for n in ("tokens", "labels")}}
    policy = ShardingPolicy(cfg, mesh)
    model = distribute_model(params_from_jax(cfg, tree, device="cpu"),
                             policy)
    opt = sharded_opt_state(policy, model)
    _, _, metrics = make_train_step(cfg, policy=policy)(model, opt, batch)
    # forward and backward: two exchanges each way a MoE layer call
    assert CALLS["all_to_all_single"] == 4, CALLS
    full = {{n: p.full_tensor().numpy() for n, p in
             model.named_parameters()}}
    pickle.dump({{"params": full,
                  "metrics": {{k: float(v) for k, v in metrics.items()}}}},
                open(os.path.join(OUT, f"step{{RANK}}.pkl"), "wb"))
    """, tmp_path)
    import pickle

    import jax
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax

    cfg = dataclasses.replace(get_config("deepseek-moe-16b").smoke(),
                              moe_impl="a2a")
    jstep = pickle.load(open(ref_step / "step.pkl", "rb"))
    want = dict(params_from_jax(cfg, jax.tree.map(np.asarray,
                                                  jstep["params"]),
                                device="cpu").named_parameters())
    ranks = [pickle.load(open(tmp_path / f"step{r}.pkl", "rb"))
             for r in range(4)]
    for key in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(ranks[0]["metrics"][key],
                                   jstep["metrics"][key], rtol=1e-4,
                                   err_msg=key)
    for n, w in want.items():
        for r in ranks:
            np.testing.assert_array_equal(r["params"][n],
                                          ranks[0]["params"][n], err_msg=n)
        np.testing.assert_allclose(ranks[0]["params"][n],
                                   w.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=n)


SERVE_BODY = """
import copy
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.runtime.sharding import (ShardingPolicy, distribute_model,
                                          local_chunk)
from repro_torch.runtime.steps import (_tree_map, make_prefill_step,
                                       make_serve_step)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = get_config({arch!r}).smoke()
gen = np.random.default_rng(5)
batch = {{"tokens": torch.from_numpy(gen.integers(0, 128, (4, 16),
                                                  np.int32))}}
if cfg.is_encoder_decoder:
    batch["frames"] = torch.from_numpy(gen.standard_normal(
        (4, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))
token = torch.from_numpy(gen.integers(0, 128, (4, 1), np.int32))
plain = init_params(cfg, 3, device="cpu")
policy = ShardingPolicy(cfg, mesh)
model = distribute_model(copy.deepcopy(plain), policy)
split = []


def same(path, got, want):
    if any(p.is_shard() and p.dim > 0 for p in got.placements):
        split.append(path)
    np.testing.assert_allclose(got.full_tensor().numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5, err_msg=path)


def rows(t):
    return local_chunk(t, ("data", None), mesh).numpy()


want_logits, want_caches = make_prefill_step(cfg)(plain, batch)
logits, caches = make_prefill_step(cfg, policy)(model, batch)
np.testing.assert_allclose(logits.numpy(), rows(want_logits), rtol=1e-5,
                           atol=1e-5)
_tree_map(same, caches, want_caches)
assert split, "no cache split over the model axis"
want_next, want_l, want_new = make_serve_step(cfg)(plain, want_caches,
                                                   token)
nxt, l, new = make_serve_step(cfg, policy)(model, caches, token)
np.testing.assert_allclose(l.numpy(), rows(want_l), rtol=1e-5, atol=1e-5)
np.testing.assert_array_equal(nxt.numpy(), rows(want_next))
_tree_map(same, new, want_new)
"""


@pytest.mark.parametrize("arch", ["granite-3-2b", "recurrentgemma-2b",
                                  "rwkv6-7b", "whisper-tiny",
                                  "deepseek-moe-16b"])
def test_sharded_prefill_and_serve_steps_equal_unsharded(tmp_path, arch):
    """The sharded prefill and serve steps on a 2x2 (data, model) mesh
    (parameters gathered at use, each rank its rows of the batch) against
    the unsharded port's on the whole batch, from the same weights: the
    rank's rows of the logits and the next token, and every cache after
    the prefill and after one decode step, within 1e-5 (float32 sums in
    another order; the split-KV combine merges the model ranks' softmax
    partials), with the K/V caches split along their sequence and the
    recurrent states along their channels or heads over "model"."""
    run_ranks(SERVE_BODY.format(arch=arch), tmp_path)

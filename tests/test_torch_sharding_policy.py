"""Twin of ``tests/test_sharding_policy.py``: the port's sharding rules
(``runtime/sharding.py``) on the port's parameter names, evaluated on mesh
shapes (``launch/mesh.py:MeshShape``: no process group needed).

The eight cases of the reference's file, and one more: for all 10
configs at full width (the reference's shapes through ``jax.eval_shape``,
the port's on the meta device), on the (16, 16) and (2, 16, 16)
production meshes and on (2, 2), every port spec - of the parameters, of
the ZeRO-1 moments and of the decode caches - equals the reference's
with the stacked repeats axis dropped.  The reference's side runs once,
in a subprocess with 512 forced host devices.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import all_configs, get_config  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_production_mesh  # noqa: E402
from repro_torch.runtime.sharding import ShardingPolicy  # noqa: E402

from test_torch_distributed import run_reference  # noqa: E402

MESH = MeshShape(("data", "model"), (1, 16))
#: the meshes of the full comparison, by name: shape and axes
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
#: the decode caches compared: batch and length
CACHE = (32, 4096)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_gqa_kv_replicated_when_heads_dont_divide():
    pol = ShardingPolicy(get_config("granite-3-2b"), MESH)  # 32 q, 8 kv
    assert pol.param_spec("layers.0.attn.w_q", (2048, 2048)) == (None, "model")
    # kv heads (8) don't divide 16 -> replicate K/V projections
    assert pol.param_spec("layers.0.attn.w_k", (2048, 512)) == (None, None)
    assert pol.param_spec("layers.0.attn.w_o", (2048, 2048)) == ("model", None)


def test_non_dividing_q_heads_replicate_attention():
    cfg = get_config("qwen1.5-32b")  # 40 heads
    pol = ShardingPolicy(cfg, MESH)
    assert pol.param_spec("layers.0.attn.w_q", (5120, 5120)) == (None, None)
    flat = ShardingPolicy(cfg, MESH, shard_qkv_by_flat_dim=True)
    assert flat.param_spec("layers.0.attn.w_q", (5120, 5120)) \
        == (None, "model")


def test_expert_parallelism():
    cfg = get_config("qwen3-moe-30b-a3b")
    pol = ShardingPolicy(cfg, MESH)
    spec = pol.param_spec("layers.0.moe.experts.w_up", (128, 2048, 768))
    assert spec == ("model", None, None), spec
    # EP survives the dp_only layout (experts cannot be replicated)
    dp = ShardingPolicy(cfg, MESH, dp_only=True)
    assert dp.param_spec("layers.0.moe.experts.w_up",
                         (128, 2048, 768)) == ("model", None, None)
    assert dp.param_spec("layers.0.attn.w_q", (2048, 2048)) == (None, None)


def test_fsdp_shards_first_divisible_dim():
    pol = ShardingPolicy(get_config("qwen1.5-32b"), MESH, fsdp=True)
    assert pol.param_spec("layers.0.attn.w_q", (5120, 5120)) == ("model", None)
    assert pol.param_spec("embed.tokens", (152064, 5120)) == ("model", None)
    # non-divisible everywhere -> replicated
    assert pol.param_spec("layers.0.ln1.scale", (5121,)) == (None,)


def test_dp_for_subset_search():
    mesh3 = MeshShape(("pod", "data", "model"), (2, 4, 2))
    pol = ShardingPolicy(get_config("granite-3-2b"), mesh3, dp_only=True)
    # 8 % (2*4*2 = 16) fails -> falls to some size-8 subset
    combo = pol.dp_for(8)
    size = 1
    for a in combo:
        size *= mesh3.shape[a]
    assert size == 8, combo
    assert pol.dp_for(16) == ("pod", "data", "model")
    assert pol.dp_for(7) is None


def test_zero1_respects_divisibility():
    mesh44 = MeshShape(("data", "model"), (4, 4))
    pol = ShardingPolicy(get_config("granite-3-2b"), mesh44, zero1=True)
    o_sh = pol.opt_state_shardings({"embed.tokens": _meta(49155, 2048)})
    spec = o_sh["m"]["embed.tokens"]
    # 49155 % 4 != 0 on dim0 -> ZeRO lands on dim1 (2048 divisible)
    assert spec[0] is None and spec[1] == "data", spec


def test_rwkv_and_rglru_rules():
    pol = ShardingPolicy(get_config("rwkv6-7b"), MESH)
    assert pol.param_spec("layers.0.tm.w_r", (4096, 4096)) == (None, "model")
    assert pol.param_spec("layers.0.tm.w_o", (4096, 4096)) == ("model", None)
    pol2 = ShardingPolicy(get_config("recurrentgemma-2b"), MESH)
    assert pol2.param_spec("layers.0.rec.w_in_rnn", (2560, 2560)) \
        == (None, "model")
    assert pol2.param_spec("layers.0.rec.lambda", (2560,)) == ("model",)
    assert pol2.param_spec("layers.0.rec.w_out", (2560, 2560)) \
        == ("model", None)


def test_cache_sharding_seq_over_model():
    pol = ShardingPolicy(get_config("granite-3-2b"), MESH)
    sh = pol.cache_shardings([{"k": _meta(128, 32768, 8, 64),
                               "pos": _meta()}])
    spec = sh[0]["k"]
    assert "data" in str(spec[0]), spec
    assert spec[1] == "model" and spec[2] is None, spec  # seq over model
    assert sh[0]["pos"] == ()


# ---------------------------------------------------------------------------
# every spec against the reference's, all configs at full width
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_specs(tmp_path_factory):
    """{mesh: {config: {"params" | "zero1" | "cache": {path: spec}}}} from
    the reference's policy (paths as its ``_path_str``; specs as lists)."""
    out = tmp_path_factory.mktemp("reference") / "specs.json"
    run_reference(f"""
    import json
    from jax.sharding import Mesh
    from repro.configs import all_configs, get_config
    from repro.runtime.sharding import ShardingPolicy, _path_str
    from repro.runtime.steps import cache_specs, params_specs

    def specs(tree):
        return {{_path_str(path): [list(e) if isinstance(e, tuple) else e
                                   for e in s.spec]
                 for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]}}

    result = {{}}
    for name, (shape, axes) in {MESHES!r}.items():
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
        result[name] = {{}}
        for arch in sorted(all_configs()):
            cfg = get_config(arch)
            p = params_specs(cfg)
            pol = ShardingPolicy(cfg, mesh)
            result[name][arch] = dict(
                params=specs(pol.params_shardings(p)),
                zero1=specs(ShardingPolicy(cfg, mesh, zero1=True)
                            .opt_state_shardings(p)["m"]),
                cache=specs(pol.cache_shardings(cache_specs(cfg, *{CACHE!r}))))
    json.dump(result, open({str(out)!r}, "w"))
    """, n_devices=512)
    return json.loads(out.read_text())


def _as_spec(entries):
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_every_spec_equals_the_reference_without_the_stacked_axis(
        reference_specs, mesh_name):
    from repro_torch.models.convert import _layer_slots
    from repro_torch.runtime.steps import cache_specs, params_specs

    shape, axes = MESHES[mesh_name]
    mesh = MeshShape(axes, shape)
    if mesh_name != "2x2":  # the production layouts
        assert mesh == make_production_mesh(multi_pod=len(shape) == 3)
    n_zero1_moved = 0
    for arch in sorted(all_configs()):
        cfg = get_config(arch)
        want = reference_specs[mesh_name][arch]
        slots = {"layers": _layer_slots(cfg),
                 "encoder": _layer_slots(cfg, encoder=True)}
        model = params_specs(cfg)
        pol = ShardingPolicy(cfg, mesh)
        mine = pol.params_shardings(model)
        zero1 = ShardingPolicy(cfg, mesh, zero1=True).opt_state_shardings(
            model)["m"]
        seen = set()
        for name, spec in mine.items():
            stack, _, rest = name.partition(".")
            if stack in slots:
                i, _, leaf = rest.partition(".")
                si, _, p = slots[stack][int(i)]
                seg = "segments" if stack == "layers" else "enc_segments"
                path = f"{seg}/{si}/{p}/" + leaf.replace(".", "/")
                seen.add(path)
                ref, ref_z = (_as_spec(want[k][path]) for k in
                              ("params", "zero1"))
                assert ref[0] is None, (arch, path, ref)
                assert spec == ref[1:], (mesh_name, arch, name, spec, ref)
                if ref_z[0] is None:
                    assert zero1[name] == ref_z[1:], (arch, name)
                else:   # the reference put ZeRO-1 on its repeats axis
                    n_zero1_moved += 1
            else:
                path = name.replace(".", "/")
                seen.add(path)
                assert spec == _as_spec(want["params"][path]), (arch, name)
                assert zero1[name] == _as_spec(want["zero1"][path]), name
        assert seen == set(want["params"]), (arch, seen ^ set(want["params"]))
        caches = pol.cache_shardings(cache_specs(cfg, *CACHE))
        seen = set()

        def walk(tree, path):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, f"{path}/{k}")
                return
            seen.add(path)
            ref = _as_spec(want["cache"][path])
            assert ref[0] is None and tree == ref[1:], (arch, path, tree)

        for i, (si, _, p) in enumerate(slots["layers"]):
            walk(caches[i], f"{si}/{p}")
        assert seen == set(want["cache"]), arch
    if mesh_name == "2x2":  # 2 divides many segments' repeats
        assert n_zero1_moved > 0

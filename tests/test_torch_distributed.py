"""Twin of ``tests/test_distributed.py`` for the port's distributed runtime
(``runtime/collectives.py``, ``runtime/sharding.py``, the sharded
``runtime/steps.py:make_train_step``), on the CPU.

Each port case spawns its ranks as processes over gloo (a ``FileStore``
under the test's ``tmp_path``, so files running side by side never share
a port or a store) and builds its ``DeviceMesh`` there; the reference's
side runs once for the file in a subprocess with four forced host
devices, as its own tests do.  Both packages take the same numpy inputs:

* the hierarchical mean over a (pod=2, data=2) mesh against a plain mean
  within 1e-6, on equal and on rank-dependent inputs, tree and padding
  included;
* the int8-compressed mean equal to the reference's;
* the distributed split-KV decode against the reference's within 1e-5;
* a 2x2 sharded train step from the reference's smoke weights: the
  embedding sharded over "model", the loss within 1e-4 of the
  single-process step's and of the reference's 2x2 step's, the parameters
  after it within 1e-6 of both;
* ZeRO-1: the moments sharded over "data", and the ZeRO-1 step equal to
  the step without it.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _env():
    return {"PYTHONPATH": str(SRC), "PATH": os.environ.get("PATH", "/usr/bin"),
            "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}


def run_reference(body: str, n_devices: int = 4, timeout: int = 480) -> str:
    """``body`` under the JAX package with ``n_devices`` forced host
    devices, in a subprocess."""
    code = (f"import os\nos.environ['XLA_FLAGS'] = "
            f"'--xla_force_host_platform_device_count={n_devices}'\n"
            "import pickle\nimport jax, jax.numpy as jnp, numpy as np\n"
            + textwrap.dedent(body))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=_env(), cwd=ROOT)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    return proc.stdout


RANK_PREAMBLE = """
import os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
RANK, WORLD, OUT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", rank=RANK, world_size=WORLD,
                        store=dist.FileStore(os.path.join(OUT, "store"),
                                             WORLD))
from torch.distributed.device_mesh import init_device_mesh
"""


def run_ranks(body: str, out: Path, world: int = 4,
              timeout: int = 300) -> None:
    """``body`` on ``world`` ranks of one gloo group, one process each;
    ``RANK``, ``WORLD`` and ``OUT`` (``out``, where ranks leave their
    results) are defined in it."""
    code = (RANK_PREAMBLE + "try:\n" + textwrap.indent(textwrap.dedent(body),
                                                       "    ")
            + "finally:\n    dist.destroy_process_group()\n")
    out.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT) for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\nSTDOUT:\n{so}\nSTDERR:\n{se}"


#: the 2x2 train step's config (the reference test's): granite's smoke
#: config with 2 KV heads and a 128-token vocabulary
STEP_CFG = ("dataclasses.replace(get_config('granite-3-2b').smoke(), "
            "n_kv_heads=2, vocab_size=128)")
DECODE = dict(B=4, H=8, H_kv=2, S=64, D=16, cache_len=[64, 17, 33, 5])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's outputs on the file's inputs (in one subprocess):
    the compressed mean, the distributed decode, the 2x2 train step."""
    out = tmp_path_factory.mktemp("reference")
    rng = np.random.default_rng(0)
    np.save(out / "x_c.npy", rng.standard_normal((8, 16)).astype(np.float32))
    d = DECODE
    for name, shape in (("q", (d["B"], d["H"], d["D"])),
                        ("k", (d["B"], d["S"], d["H_kv"], d["D"])),
                        ("v", (d["B"], d["S"], d["H_kv"], d["D"]))):
        np.save(out / f"{name}.npy",
                rng.standard_normal(shape).astype(np.float32))
    np.save(out / "tokens.npy", rng.integers(0, 128, (4, 16), np.int32))
    np.save(out / "labels.npy", rng.integers(0, 128, (4, 16), np.int32))
    run_reference(f"""
    import dataclasses
    from pathlib import Path
    from jax.sharding import PartitionSpec as P
    from repro.runtime.compat import shard_map
    from repro.runtime.collectives import (hierarchical_allreduce,
                                           make_distributed_flash_decode)
    OUT = Path({str(out)!r})

    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    def mean_c(v):
        r = jax.lax.axis_index("pod") * 2 + jax.lax.axis_index("data")
        v = v * (1.0 + r.astype(jnp.float32) / 8.0)
        return hierarchical_allreduce(v, in_pod_axis="data",
                                      cross_pod_axis="pod",
                                      compress_cross_pod=True)
    f = jax.jit(shard_map(mean_c, mesh=mesh, in_specs=P(), out_specs=P(),
                          check_vma=False))
    np.save(OUT / "mean_c.npy", np.asarray(f(np.load(OUT / "x_c.npy"))))

    mesh = jax.make_mesh((2, 2), ("data", "model"))
    fn = jax.jit(make_distributed_flash_decode(mesh, seq_axis="model",
                                               batch_axes=("data",)))
    out = fn(*(np.load(OUT / f"{{n}}.npy") for n in "qkv"),
             jnp.asarray({DECODE['cache_len']}, jnp.int32))
    np.save(OUT / "decode.npy", np.asarray(out))

    from repro.configs import get_config
    from repro.runtime.sharding import ShardingPolicy
    from repro.runtime.steps import input_specs, make_train_step
    from repro.configs.shapes import ShapeSpec
    from repro.models import init_params
    from repro.optim.adamw import init_opt_state
    cfg = {STEP_CFG}
    policy = ShardingPolicy(cfg, mesh)
    shape = ShapeSpec("tiny", seq_len=16, global_batch=4, kind="train")
    specs = input_specs(cfg, shape)
    step = jax.jit(make_train_step(cfg),
                   in_shardings=(policy.params_shardings(specs["params"]),
                                 policy.opt_state_shardings(specs["params"]),
                                 policy.batch_shardings(specs["batch"])))
    params = init_params(cfg, jax.random.key(0))
    pickle.dump(jax.tree.map(np.asarray, params),
                open(OUT / "params0.pkl", "wb"))
    batch = {{"tokens": np.load(OUT / "tokens.npy"),
              "labels": np.load(OUT / "labels.npy")}}
    p2, _, metrics = step(params, init_opt_state(params), batch)
    pickle.dump({{"params": jax.tree.map(np.asarray, p2),
                  "metrics": {{k: float(v) for k, v in metrics.items()}}}},
                open(OUT / "step.pkl", "wb"))
    """)
    return out


def test_hierarchical_allreduce_matches_psum(tmp_path):
    run_ranks("""
    from repro_torch.runtime.collectives import (
        CALLS, hierarchical_allreduce, make_hierarchical_grad_mean)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    x = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    out = hierarchical_allreduce(x, mesh, in_pod_axis="data",
                                 cross_pod_axis="pod")
    np.testing.assert_allclose(out.numpy(), x.numpy(), rtol=1e-6)
    # rank-dependent inputs against their plain mean; a tree whose leaves
    # need padding to a multiple of |data|
    gen = np.random.default_rng(3)
    xs = [gen.standard_normal((6, 5)).astype(np.float32) for _ in range(4)]
    ys = [gen.standard_normal((7,)).astype(np.float32) for _ in range(4)]
    mine = {"a": torch.from_numpy(xs[RANK]), "b": [torch.from_numpy(ys[RANK])]}
    got = make_hierarchical_grad_mean(mesh)(mine)
    np.testing.assert_allclose(got["a"].numpy(), np.mean(xs, axis=0),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["b"][0].numpy(), np.mean(ys, axis=0),
                               rtol=1e-6, atol=1e-6)
    assert CALLS["reduce_scatter_tensor"] == 3, CALLS
    assert CALLS["all_gather_into_tensor"] == 3, CALLS
    """, tmp_path)


def test_hierarchical_allreduce_compressed_close(tmp_path, ref):
    """Equal inputs: within int8's step of the mean.  Rank-dependent ones
    (x (1 + rank / 8)): equal to the reference's output."""
    run_ranks(f"""
    from repro_torch.runtime.collectives import hierarchical_allreduce
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    x = torch.from_numpy(np.load({str(ref / "x_c.npy")!r}))
    for name, mine in (("same", x), ("ranked", x * (1.0 + RANK / 8.0))):
        out = hierarchical_allreduce(mine, mesh, in_pod_axis="data",
                                     cross_pod_axis="pod",
                                     compress_cross_pod=True)
        np.save(os.path.join(OUT, f"{{name}}{{RANK}}.npy"), out.numpy())
    """, tmp_path)
    x = np.load(ref / "x_c.npy")
    scale = np.abs(x).max() / 127.0
    for r in range(4):
        err = np.abs(np.load(tmp_path / f"same{r}.npy") - x).max()
        assert err <= scale + 1e-6, (err, scale)
        np.testing.assert_array_equal(np.load(tmp_path / f"ranked{r}.npy"),
                                      np.load(ref / "mean_c.npy"))


def test_distributed_flash_decode_matches_ref(tmp_path, ref):
    run_ranks(f"""
    from repro_torch.runtime.collectives import make_distributed_flash_decode
    from repro_torch.runtime.sharding import local_chunk
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    q, k, v = (torch.from_numpy(np.load(os.path.join({str(ref)!r}, n + ".npy")))
               for n in "qkv")
    cl = torch.tensor({DECODE['cache_len']}, dtype=torch.int32)
    fn = make_distributed_flash_decode(mesh, seq_axis="model",
                                       batch_axes=("data",))
    out = fn(local_chunk(q, ("data", None, None), mesh),
             local_chunk(k, ("data", "model", None, None), mesh),
             local_chunk(v, ("data", "model", None, None), mesh),
             local_chunk(cl, ("data",), mesh))
    np.save(os.path.join(OUT, f"out{{RANK}}.npy"), out.numpy())
    """, tmp_path)
    from repro_torch.kernels.ref import ref_decode
    q, k, v = (torch.from_numpy(np.load(ref / f"{n}.npy")) for n in "qkv")
    cl = torch.tensor(DECODE["cache_len"], dtype=torch.int32)
    plain = ref_decode(q, k.transpose(1, 2), v.transpose(1, 2), cl).numpy()
    # rank = 2 * data + model: data rank d holds rows [2d, 2d + 2)
    got = np.concatenate([np.load(tmp_path / f"out{r}.npy") for r in (0, 2)])
    for r in (1, 3):
        np.testing.assert_array_equal(np.load(tmp_path / f"out{r}.npy"),
                                      np.load(tmp_path / f"out{r - 1}.npy"))
    np.testing.assert_allclose(got, np.load(ref / "decode.npy"), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)


STEP_BODY = """
import dataclasses
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime.sharding import (ShardingPolicy, distribute_model,
                                          placements, sharded_opt_state)
from repro_torch.runtime.steps import make_train_step
REF = {ref!r}
cfg = {cfg}
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
tree = pickle.load(open(os.path.join(REF, "params0.pkl"), "rb"))
batch = {{n: torch.from_numpy(np.load(os.path.join(REF, n + ".npy")))
          for n in ("tokens", "labels")}}


def sharded_step(**levers):
    policy = ShardingPolicy(cfg, mesh, **levers)
    model = distribute_model(params_from_jax(cfg, tree, device="cpu"),
                             policy)
    opt = sharded_opt_state(policy, model)
    _, opt, metrics = make_train_step(cfg, policy=policy)(model, opt, batch)
    return model, opt, {{k: float(v) for k, v in metrics.items()}}
"""


#: a rank's body after ``STEP_BODY``: the sharded step with ``LEVERS``,
#: rank 0 leaving the whole parameters after it and the metrics
SAVE_STEP = """
model, _, metrics = sharded_step(**LEVERS)
full = {n: p.full_tensor().numpy() for n, p in model.named_parameters()}
if RANK == 0:
    pickle.dump({"params": full, "metrics": metrics},
                open(os.path.join(OUT, "step.pkl"), "wb"))
"""


def _check_against_single_process(tmp_path, ref):
    """The sharded step rank 0 left in ``tmp_path`` against the
    single-process step and the reference's 2x2 step."""
    import dataclasses
    import pickle

    import jax
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime.steps import make_train_step

    cfg = dataclasses.replace(get_config("granite-3-2b").smoke(),
                              n_kv_heads=2, vocab_size=128)
    sharded = pickle.load(open(tmp_path / "step.pkl", "rb"))
    jstep = pickle.load(open(ref / "step.pkl", "rb"))
    model = params_from_jax(cfg, pickle.load(open(ref / "params0.pkl", "rb")),
                            device="cpu").requires_grad_(True)
    batch = {n: torch.from_numpy(np.load(ref / f"{n}.npy"))
             for n in ("tokens", "labels")}
    _, _, metrics = make_train_step(cfg)(model, init_opt_state(model), batch)
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(sharded["metrics"][key], float(metrics[key]),
                                   rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(sharded["metrics"][key],
                                   jstep["metrics"][key], rtol=1e-4,
                                   err_msg=key)
    want = dict(params_from_jax(cfg, jax.tree.map(np.asarray,
                                                  jstep["params"]),
                                device="cpu").named_parameters())
    for n, p in model.named_parameters():
        np.testing.assert_allclose(sharded["params"][n], p.detach().numpy(),
                                   rtol=0, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(sharded["params"][n],
                                   want[n].detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)


def test_sharding_policy_on_small_mesh(tmp_path, ref):
    """The 2x2 sharded step against the single-process step and the
    reference's 2x2 step, from the same weights and batch; the embedding
    sharded over "model"."""
    run_ranks(STEP_BODY.format(ref=str(ref), cfg=STEP_CFG) + textwrap.dedent("""
    emb_spec = ShardingPolicy(cfg, mesh).param_spec(
        "embed.tokens", (cfg.vocab_size, cfg.d_model))
    assert emb_spec == ("model", None), emb_spec
    LEVERS = {}
    """) + SAVE_STEP + textwrap.dedent("""
    emb = model.embed["tokens"]
    assert list(emb.placements) == placements(("model", None), mesh), \
        emb.placements
    assert emb.to_local().shape[0] == cfg.vocab_size // 2
    """), tmp_path)
    _check_against_single_process(tmp_path, ref)


@pytest.mark.parametrize("lever", ["dp_only", "fsdp"])
def test_sharded_step_levers_equal_the_single_process_step(tmp_path, ref,
                                                           lever):
    """The levers that split the batch over the model axis too (one row a
    rank) and, for ``fsdp``, shard every parameter on its first divisible
    dim: the same step as the single-process one."""
    run_ranks(STEP_BODY.format(ref=str(ref), cfg=STEP_CFG) + textwrap.dedent(f"""
    LEVERS = {{{lever!r}: True}}
    policy = ShardingPolicy(cfg, mesh, **LEVERS)
    assert policy.batch_shardings(batch)["tokens"][0] == ("data", "model")
    """) + SAVE_STEP, tmp_path)
    _check_against_single_process(tmp_path, ref)


#: the configs the 2x2 step is held on beside granite's ``STEP_CFG``:
#: (the config, whether the batch carries a ``loss_mask``).  The masked
#: granite batch keeps 8 tokens on data rank 0 and 32 on rank 1, and the
#: MoE configs' load-balance loss is a product of means over every token:
#: neither is a plain mean over rows of equal weight, so a step that
#: averaged the ranks' losses would miss the whole batch's.
WHOLE_BATCH_CASES = {
    "granite-3-2b-loss-mask": ("get_config('granite-3-2b').smoke()", True),
    "deepseek-moe-16b-gshard": (
        "dataclasses.replace(get_config('deepseek-moe-16b').smoke(), "
        "moe_impl='gshard')", False),
    "deepseek-moe-16b-dense": (
        "dataclasses.replace(get_config('deepseek-moe-16b').smoke(), "
        "moe_impl='dense')", False),
    "qwen3-moe-30b-a3b": ("get_config('qwen3-moe-30b-a3b').smoke()", False),
    "rwkv6-7b": ("get_config('rwkv6-7b').smoke()", False),
    "recurrentgemma-2b": ("get_config('recurrentgemma-2b').smoke()", False),
    "qwen2-vl-72b": ("get_config('qwen2-vl-72b').smoke()", False),
}


def _reference_whole_batch_step(out: Path, cfg_expr: str, mask: bool):
    """The reference's 2x2 step (data 2, model 2) on ``cfg_expr`` from
    ``init_params(cfg, key(0))``; tokens then labels drawn from
    ``default_rng(0)``, and with ``mask`` a ``loss_mask`` of ones with rows
    0-1 zeroed from column 4.  Leaves the inputs, the weights and the
    step's parameters and metrics in ``out``."""
    run_reference(f"""
    import dataclasses
    from pathlib import Path
    from repro.configs import get_config
    from repro.configs.shapes import ShapeSpec
    from repro.models import init_params
    from repro.optim.adamw import init_opt_state
    from repro.runtime.sharding import ShardingPolicy
    from repro.runtime.steps import input_specs, make_train_step
    OUT = Path({str(out)!r})
    cfg = {cfg_expr}
    rng = np.random.default_rng(0)
    batch = {{"tokens": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32),
              "labels": rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)}}
    if {mask}:
        m = np.ones((4, 16), np.float32)
        m[:2, 4:] = 0.0
        batch["loss_mask"] = m
    for k, v in batch.items():
        np.save(OUT / f"{{k}}.npy", v)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    policy = ShardingPolicy(cfg, mesh)
    specs = input_specs(cfg, ShapeSpec("tiny", seq_len=16, global_batch=4,
                                       kind="train"))
    specs["batch"].update({{k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                            for k, v in batch.items()}})
    step = jax.jit(make_train_step(cfg),
                   in_shardings=(policy.params_shardings(specs["params"]),
                                 policy.opt_state_shardings(specs["params"]),
                                 policy.batch_shardings(specs["batch"])))
    params = init_params(cfg, jax.random.key(0))
    pickle.dump(jax.tree.map(np.asarray, params),
                open(OUT / "params0.pkl", "wb"))
    p2, _, metrics = step(params, init_opt_state(params), batch)
    pickle.dump({{"params": jax.tree.map(np.asarray, p2),
                  "metrics": {{k: float(v) for k, v in metrics.items()}}}},
                open(OUT / "step.pkl", "wb"))
    """)


@pytest.mark.parametrize("case", list(WHOLE_BATCH_CASES))
def test_sharded_step_takes_the_whole_batch_loss(tmp_path, case):
    """The port's 2x2 step against the reference's 2x2 step, from the same
    weights and batch: metrics ("loss", "ce", "aux", "grad_norm") within
    1e-4, every parameter after the step within 1e-6; and against the
    port's single-process step on the whole batch, to the same limits.  A
    masked cross-entropy's sum and count and the load-balance loss's
    f_e and P_e are taken over the batch's ranks (``mesh_context.
    whole_batch_sum``), not each rank's own averaged."""
    import dataclasses
    import pickle

    import jax
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.runtime.steps import make_train_step

    cfg_expr, mask = WHOLE_BATCH_CASES[case]
    ref = tmp_path / "reference"
    ref.mkdir()
    _reference_whole_batch_step(ref, cfg_expr, mask)
    keys = ("tokens", "labels") + (("loss_mask",) if mask else ())
    run_ranks(STEP_BODY.format(ref=str(ref), cfg=cfg_expr) + textwrap.dedent(f"""
    batch = {{n: torch.from_numpy(np.load(os.path.join(REF, n + ".npy")))
              for n in {keys!r}}}
    LEVERS = {{}}
    """) + SAVE_STEP, tmp_path / "ranks")
    sharded = pickle.load(open(tmp_path / "ranks" / "step.pkl", "rb"))
    jstep = pickle.load(open(ref / "step.pkl", "rb"))
    cfg = eval(cfg_expr, {"dataclasses": dataclasses,
                          "get_config": get_config})
    model = params_from_jax(cfg, pickle.load(open(ref / "params0.pkl", "rb")),
                            device="cpu").requires_grad_(True)
    batch = {n: torch.from_numpy(np.load(ref / f"{n}.npy")) for n in keys}
    _, _, metrics = make_train_step(cfg)(model, init_opt_state(model), batch)
    for key in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(sharded["metrics"][key],
                                   jstep["metrics"][key], rtol=1e-4,
                                   atol=1e-7, err_msg=key)
        np.testing.assert_allclose(sharded["metrics"][key],
                                   float(metrics[key]), rtol=1e-4, atol=1e-7,
                                   err_msg=key)
    want = dict(params_from_jax(cfg, jax.tree.map(np.asarray,
                                                  jstep["params"]),
                                device="cpu").named_parameters())
    for n, p in model.named_parameters():
        np.testing.assert_allclose(sharded["params"][n],
                                   want[n].detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(sharded["params"][n], p.detach().numpy(),
                                   rtol=0, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("remat", [False, True])
def test_sharded_step_gathers_one_layer_at_a_time(tmp_path, remat):
    """The sharded step gathers each layer's parameters at use: while a
    layer runs (its forward and, with remat, its recompute in the
    backward) its parameters are whole and every other layer's are still
    ``DTensor`` shards; after the step every parameter is a ``DTensor``
    again, with no gradient left on it."""
    run_ranks(f"""
    import dataclasses
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.runtime.sharding import (ShardingPolicy,
                                              distribute_model,
                                              sharded_opt_state)
    from repro_torch.runtime.steps import make_train_step
    cfg = dataclasses.replace({STEP_CFG}, n_layers=3, remat={remat})
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    model = distribute_model(init_params(cfg, 0, device="cpu"),
                             ShardingPolicy(cfg, mesh, zero1=True))
    opt = sharded_opt_state(ShardingPolicy(cfg, mesh, zero1=True), model)
    seen = []
    def probe(i):
        def hook(module, args):
            whole = [j for j, layer in enumerate(model.layers)
                     if not any(isinstance(p, DTensor)
                                for p in layer.parameters())]
            seen.append((i, whole))
        return hook
    for i, layer in enumerate(model.layers):
        layer.ln1.register_forward_pre_hook(probe(i))
    gen = np.random.default_rng(1)
    batch = {{k: torch.from_numpy(gen.integers(0, 128, (4, 16), np.int32))
              for k in ("tokens", "labels")}}
    make_train_step(cfg, policy=ShardingPolicy(cfg, mesh, zero1=True))(
        model, opt, batch)
    order = [0, 1, 2] + ([2, 1, 0] if {remat} else [])
    assert seen == [(i, [i]) for i in order], seen
    for n, p in model.named_parameters():
        assert isinstance(p, DTensor) and p.grad is None, n
    """, tmp_path)


def test_zero1_shards_optimizer_state(tmp_path, ref):
    """Most moments sharded over "data" (each rank allocating its block),
    and the ZeRO-1 step's parameters and moments equal the plain sharded
    step's."""
    run_ranks(STEP_BODY.format(ref=str(ref), cfg=STEP_CFG) + textwrap.dedent("""
    plain, plain_opt, m0 = sharded_step(zero1=False)
    zero, zero_opt, m1 = sharded_step(zero1=True)
    assert m0 == m1, (m0, m1)
    moments = list(zero_opt["m"].values())
    # placements by mesh dim: (data, model)
    on_data = [m for m in moments if m.placements[0].is_shard()]
    assert len(on_data) > 0.8 * len(moments), (len(on_data), len(moments))
    for m in on_data:
        assert m.to_local().numel() * 2 <= m.numel()
    for (n, a), b in zip(plain.named_parameters(), zero.parameters()):
        assert torch.equal(a.full_tensor(), b.full_tensor()), n
    for part in ("m", "v"):
        for n, a in plain_opt[part].items():
            assert torch.equal(a.full_tensor(),
                               zero_opt[part][n].full_tensor()), (part, n)
    """), tmp_path)


def test_the_four_card_script_passes_on_gloo_ranks():
    """``scripts/distributed_nccl.py`` (the four-card run) on four gloo
    ranks of the CPU with the smoke configs: every check passes."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "distributed_nccl.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "every check passed on 4 ranks" in proc.stdout, proc.stdout

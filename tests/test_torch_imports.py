"""The PyTorch port stands alone: no JAX, no JAX package, no silent CPU.

``src/repro_torch/`` runs on a machine that has no JAX, so importing it
must pull in neither ``jax`` nor anything of ``repro``; its entry points
default to ``cuda`` and raise without a card unless given ``device="cpu"``.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.latency_hist\n"
        "import repro_torch.kernels.exec_lanes\n"
        "import repro_torch.kernels.transient_lanes\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.decode_attention\n"
        "import repro_torch.kernels.rglru_scan, repro_torch.models.rglru\n"
        "import repro_torch.kernels.wkv6, repro_torch.models.rwkv6\n"
        "import repro_torch.core.autotune, repro_torch.core.autoscale\n"
        "import repro_torch.configs, repro_torch.models\n"
        "import repro_torch.models.moe\n"
        "import repro_torch.models.convert\n"
        "import repro_torch.serving.scheduler, repro_torch.serving.server\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "import repro_torch.optim.adamw, repro_torch.optim.compression\n"
        "import repro_torch.data.pipeline, repro_torch.checkpoint.store\n"
        "import repro_torch.runtime.coordinator, repro_torch.runtime.steps\n"
        "import repro_torch.runtime.train_loop\n"
        "import repro_torch.launch.mesh, repro_torch.runtime.mesh_context\n"
        "import repro_torch.runtime.sharding\n"
        "import repro_torch.runtime.collectives\n"
        "import repro_torch.runtime.moe_a2a\n"
        "import repro_torch.roofline.hlo, repro_torch.roofline.analysis\n"
        "import repro_torch.roofline.report, repro_torch.roofline.compare\n"
        "import repro_torch.roofline.kernel_costs\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.moe_a2a_probe\n"
        "repro_torch.configs.get_config('granite-3-2b')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(len(repro_torch.core.executable_variants()))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "10"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_source_imports_jax_or_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_entry_points_default_to_cuda_and_raise_without_a_card(monkeypatch):
    from repro_torch.core import (
        SweepSpec,
        calibrate_alpha,
        compile_sweep,
        execute_configs,
        mva_curves_from_demands,
        run_variant_batched,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        execute_configs([{"variant": "multipaxos"}], n_commands=8, seeds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_variant_batched("multipaxos", n_commands=8, seeds=1)
    sweep = compile_sweep(SweepSpec())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.mva(calibrate_alpha(), n_clients_max=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mva_curves_from_demands([[1.0, 2.0]], 4, device="cuda")
    # the explicit host run still works
    _, x, _ = sweep.mva(calibrate_alpha(), n_clients_max=4, device="cpu")
    assert x.shape == (1, 4)


def test_serving_entry_points_default_to_cuda_and_raise_without_a_card(
        monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.convert import caches_from_jax, params_from_jax
    from repro_torch.serving.scheduler import ContinuousBatcher
    from repro_torch.serving.server import ServingDeployment

    from repro_torch.runtime.train_loop import Trainer

    cfg = get_config("granite-3-2b").smoke()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_params(cfg, 0),
                 lambda: Trainer(cfg, "unused"),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: ServingDeployment(cfg),
                 lambda: ContinuousBatcher(cfg, None),
                 lambda: params_from_jax(cfg, {}),
                 lambda: caches_from_jax(cfg, [])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the explicit host run still works
    params = init_params(cfg, 0, device="cpu")
    assert params.device.type == "cpu"
    ServingDeployment(cfg, device="cpu").push_weights(params)
    ContinuousBatcher(cfg, params, device="cpu")


def test_no_attention_library_call_in_the_port():
    """The port's attention goes through its own kernels: no PyTorch
    attention operator, no torch.compile."""
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        for banned in ("scaled_dot_product_attention", "torch.compile",
                       "flash_attn", "xformers"):
            assert banned not in text, (path, banned)


def test_port_core_exports_every_name_of_the_reference():
    """``repro_torch.core`` does all that ``repro.core`` does: every public
    name of the reference has its counterpart under the same name."""
    import repro.core
    import repro_torch.core

    missing = set(repro.core.__all__) - set(repro_torch.core.__all__)
    assert not missing, sorted(missing)
    for name in repro_torch.core.__all__:
        assert hasattr(repro_torch.core, name), name

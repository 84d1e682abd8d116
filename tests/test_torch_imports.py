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

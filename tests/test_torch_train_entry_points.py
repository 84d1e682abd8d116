"""The port's training entry points run as a user runs them, on the CPU:
``python -m repro_torch.launch.train --smoke --device cpu`` (with a
crash and recovery) and ``examples/torch_elastic_train.py --device cpu``
(the twin of ``examples/elastic_train.py``, shortened).  Without
``--device`` both run on cuda, and raise without a card.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(args, tmp_path, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, *args], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=timeout)


def test_launch_train_smoke_on_the_cpu(tmp_path):
    out = _run(["-m", "repro_torch.launch.train", "--smoke", "--device",
                "cpu", "--steps", "3"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "device=cpu" in out.stdout
    assert "done: 3 steps" in out.stdout


def test_launch_train_recovers_from_a_crash(tmp_path):
    out = _run(["-m", "repro_torch.launch.train", "--smoke", "--device",
                "cpu", "--steps", "6", "--ckpt-every", "2", "--fail-at", "5",
                "--ckpt-dir", str(tmp_path / "ckpt")], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "resumed from committed checkpoint step 4" in out.stdout
    assert (tmp_path / "ckpt" / "manifest_step4.json").exists()


def test_launch_train_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    out = _run(["-m", "repro_torch.launch.train", "--smoke", "--steps", "1"],
               tmp_path)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


def test_elastic_train_example_on_the_cpu(tmp_path):
    out = _run([str(ROOT / "examples" / "torch_elastic_train.py"),
                "--device", "cpu", "--steps", "62"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "straggler worker/3 noop-filled" in out.stdout
    assert "recovered from committed checkpoint at step 60" in out.stdout
    assert "loss decreased" in out.stdout

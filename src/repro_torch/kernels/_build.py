"""Build a CUDA source of ``csrc/`` into a ``ctypes``-loaded shared library.

Each kernel module calls :func:`build_library` on first use: ``nvcc``
compiles the source for ``sm_90a`` with a plain C interface (no PyTorch
headers, so a build takes seconds) into ``build/`` beside this file, keyed
by a hash of the source, the ``csrc/*.cuh`` headers and the flags, and
the library is loaded with ``ctypes``.  Nothing is built when a module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built (set CUDA_HOME or put nvcc on PATH)")


def build_library(source: str) -> Tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<source>`` (once per source and flags) and load it.
    Returns the library and ``nvcc``'s ``-Xptxas -v`` report (registers,
    shared memory, spills) of the build that produced it."""
    path = CSRC / source
    # the source and the headers it may include
    src = path.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join((ARCH,) + FLAGS).encode()
                         ).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"{path.stem}_{tag}.so"
    log = so.with_suffix(".log")
    if not so.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), ARCH, *FLAGS, "-o", tmp, str(path)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):"
                               f"\n{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)  # atomic: a concurrent build sees a whole file
    return ctypes.CDLL(str(so)), (log.read_text() if log.exists() else "")

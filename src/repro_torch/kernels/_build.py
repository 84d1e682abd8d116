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
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

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


def load_library(source: str, symbols: Dict[str, Sequence]
                 ) -> Tuple[ctypes.CDLL, str]:
    """:func:`build_library` of ``csrc/<source>``, each C entry point in
    ``symbols`` (name -> its ``ctypes`` argument types) typed, its result
    the launch's CUDA error as a C ``int``.  Returns the library and the
    build's ``-Xptxas -v`` report."""
    lib, log = build_library(source)
    for name, argtypes in symbols.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib, log


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The streaming multiprocessors of card ``device`` (a
    ``torch.device`` or an index; ``cuda`` alone is the current card),
    read once a card."""
    import torch
    index = device.index if isinstance(device, torch.device) else device
    return _sm_count(torch.cuda.current_device() if index is None
                     else index)


class ZeroedCounters:
    """Zeroed int32 counters a kernel uses and leaves zeroed, kept per
    device: ``counters(device, n)`` returns at least ``n`` of them (at
    least ``minimum``).  A grown buffer keeps the old ones alive, since a
    captured CUDA graph may still point at them."""

    def __init__(self, minimum: int):
        self.minimum = minimum
        self._bufs: Dict[object, list] = {}

    def __call__(self, device, n: int):
        import torch
        bufs = self._bufs.setdefault(device, [])
        if not bufs or bufs[-1].numel() < n:
            bufs.append(torch.zeros(max(n, self.minimum), dtype=torch.int32,
                                    device=device))
        return bufs[-1]


def _kernel_name(mangled: str) -> str:
    """``bwd_wgmma_kernel<64, 128>`` from a mangled kernel name: the
    length-prefixed identifier that ends in ``_kernel``, and its template
    arguments."""
    for m in re.finditer(r"\d+", mangled):
        run = m.group(0)
        for k in range(len(run)):  # the length is a suffix of the digits
            n = int(run[k:])
            name = mangled[m.end():m.end() + n]
            if n and name.endswith("_kernel") and name.isidentifier():
                rest = mangled[m.end() + n:]
                if not rest.startswith("I") or "EE" not in rest:
                    return name
                args = rest[1:rest.index("EE")]
                args = args.replace("13__nv_bfloat16", "bf16,")
                args = re.sub(r"Li(\d+)E?", r"\1,", args)
                args = re.sub(r"^f", "float,", args)
                return f"{name}<{', '.join(a for a in args.split(',') if a)}>"
    return mangled


def ptxas_report(log: str) -> List[Tuple[str, int, int, int]]:
    """(kernel, registers a thread, spill store bytes, spill load bytes)
    for each entry function of an ``nvcc -Xptxas -v`` report, in its
    order."""
    rows, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = _kernel_name(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((name, int(m.group(1)), *spills))
            name = None
    return rows

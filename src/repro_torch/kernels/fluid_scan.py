"""The fluid pipeline's step loop: the hand-written CUDA kernel and its
wrapper.

:mod:`repro_torch.core.simulator` steps a slot-stepped fluid model of the
closed queueing network of every row of a [M, K] demand matrix: work
flows client -> station 0 -> ... -> station K-1 -> client, each station
draining at its service rate.  The reference runs it as one jitted
``lax.scan`` (``src/repro/core/simulator.py:115`` ``_fluid_scan_impl``,
vmapped over the rows by ``_fluid_scan_batch``, ``:149``); it replaces no
Pallas kernel.  The CUDA source is ``csrc/fluid_scan.cu``: one warp a row,
the step loop inside the kernel, so a call is one launch instead of some 9
eager ops a step.  Its time is the step's serial chain, not bytes; see the
source's note.  It equals :func:`repro_torch.kernels.ref.ref_fluid_scan`
bit for bit, and so the card's ``CompiledSweep.fluid`` equals the CPU's.

The library is compiled on first use with ``nvcc`` for ``sm_90a`` into
``build/`` beside this file and loaded with ``ctypes``.  CUDA tensors go to
the kernel (or the call raises); CPU tensors go to the plain version.
``fluid_scan.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ..roofline import kernel_costs
from ._build import load_library
from .mva_scan import REGISTER_COLUMNS
from .ref import ref_fluid_scan

_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def build() -> str:
    """Compile ``csrc/fluid_scan.cu`` (once per source and flags) and load
    it.  Returns ``nvcc``'s ``-Xptxas -v`` report (registers, shared
    memory, spills) of the build that produced the library."""
    global _lib, _build_log
    if _lib is None:
        _lib, _build_log = load_library("fluid_scan.cu", {
            "fluid_scan_launch": [ctypes.c_void_p] + [ctypes.c_float] * 2
                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4,
        })
    return _build_log


def _check(demands: torch.Tensor, n_steps: int) -> None:
    if demands.dim() != 2 or demands.shape[1] < 1:
        raise ValueError(f"demands (M, K >= 1) expected: "
                         f"{tuple(demands.shape)}")
    if demands.dtype != torch.float32:
        raise TypeError(f"demands must be float32: {demands.dtype}")
    if not demands.is_contiguous():
        raise ValueError("fluid_scan takes a contiguous demand matrix")
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0: {n_steps}")
    m, k = demands.shape
    if m >= 2 ** 33 or k >= 2 ** 30 or n_steps >= 2 ** 31:
        raise ValueError(f"{m} rows x {k} columns x {n_steps} steps exceed "
                         f"the kernel's grid")


def _launch(demands: torch.Tensor, n_clients: float, dt: float,
            n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch on the current stream (none for zero rows or steps)."""
    m, k = demands.shape
    flows = torch.empty((m, n_steps), dtype=torch.float32,
                        device=demands.device)
    if m == 0 or n_steps == 0:
        return torch.zeros((m,), dtype=torch.float32,
                           device=demands.device), flows
    done = torch.empty((m,), dtype=torch.float32, device=demands.device)
    build()
    scratch = torch.empty((m, 2 * k) if k > REGISTER_COLUMNS else (0,),
                          dtype=torch.float32, device=demands.device)
    with torch.cuda.device(demands.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.fluid_scan_launch(
            demands.data_ptr(), n_clients, dt, m, k, n_steps,
            done.data_ptr(), flows.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fluid_scan kernel launch failed: CUDA error "
                           f"{err}")
    fluid_scan.launches += 1
    return done, flows


def fluid_scan(demands: torch.Tensor, n_clients: float, dt: float,
               n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(done (M,), flows (M, n_steps)) float32: ``n_steps`` steps of ``dt``
    of the fluid pipeline over every row of the contiguous (M, K >= 1)
    float32 ``demands``, ``n_clients`` clients queued at station 0 at the
    start; :func:`repro_torch.kernels.ref.ref_fluid_scan`'s arguments and
    result.

    CUDA tensors run the hand-written kernel (one launch); CPU tensors run
    the plain version.  Any other device raises.  Fake tensors (the dry
    run) add the kernel's operations and bytes to
    ``roofline.kernel_costs.COUNTS`` and return fake outputs."""
    _check(demands, n_steps)
    if is_fake(demands):
        m, k = demands.shape
        kernel_costs.record("fluid_scan",
                            kernel_costs.fluid_scan_cost(m, n_steps, k))
        return (torch.empty((m,), dtype=torch.float32, device=demands.device),
                torch.empty((m, n_steps), dtype=torch.float32,
                            device=demands.device))
    if demands.device.type == "cpu":
        return ref_fluid_scan(demands, n_clients, dt, n_steps)
    if demands.device.type != "cuda":
        raise ValueError(f"fluid_scan runs on cuda or cpu, not "
                         f"{demands.device}")
    return _launch(demands, float(n_clients), float(dt), n_steps)


fluid_scan.launches = 0

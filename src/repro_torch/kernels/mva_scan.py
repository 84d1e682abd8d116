"""Exact single-class MVA: the hand-written CUDA kernel and its wrapper.

:mod:`repro_torch.core.simulator` solves the closed queueing network of
every row of a [M, K] demand matrix for N = 1..n_max clients.  The
reference runs the recursion as one jitted ``lax.scan``
(``src/repro/core/simulator.py:38`` ``_mva_scan_impl``, vmapped over the
rows by ``_mva_scan_batch``, ``:61``); it replaces no Pallas kernel.  The
CUDA source is ``csrc/mva_scan.cu``: the N loop inside the kernel, so a
call is one launch instead of some 12 eager ops a step; a row on one
thread up to 8 columns, on as many lanes as hold 8 columns each up to
256 (the Fig. 29 grid's 15 columns on 2 lanes), a warp a row up to 512,
the global-memory walk past that.  Its time is the step's serial chain, not bytes; see the
source's note.  The order of a row's sum is a function of K alone,
:func:`plan`, which the kernel is launched with and
:func:`repro_torch.kernels.ref.ref_mva_scan` repeats, so the two are equal
bit for bit and the card's ``CompiledSweep.mva`` equals the CPU's.

The library is compiled on first use with ``nvcc`` for ``sm_90a`` into
``build/`` beside this file and loaded with ``ctypes``.  CUDA tensors go to
the kernel (or the call raises); CPU tensors go to the plain version.
``mva_scan.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ..roofline import kernel_costs
from ._build import load_library
from .ref import ref_mva_scan

#: columns a lane keeps in registers up to 256 columns a row: a row of K
#: is split over the power of two at or above K / LANE_COLUMNS lanes (so
#: a step's instructions a lane stay few; one warp issues them in order)
LANE_COLUMNS = 8
#: columns a row the kernel keeps in registers (a warp of 16 a lane); past
#: it each lane walks its columns through a global-memory scratch row
REGISTER_COLUMNS = 512


class Plan(NamedTuple):
    """How the kernel holds a row of K columns.  Up to 512 columns (route
    "thread" or "lanes"): ``lanes`` lanes a row, lane s holding the
    ``width`` columns s, s + lanes, s + 2 lanes, ... of the row padded with
    zeros to ``width * lanes``, the power of two at or above K; the row sum
    is then the strided pairwise tree over those columns, whatever the
    split.  Past 512 (route "global", ``width`` 0): 32 lanes a row, lane l
    summing columns l, l + 32, ... in column order from +0, then an xor
    butterfly over the 32 lanes."""
    route: str   # "thread", "lanes" or "global"
    width: int
    lanes: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def plan(k: int) -> Plan:
    """The kernel's hold on K columns, a function of K alone, with N the
    power of two at or above K (at least 1): one thread a row up to
    ``LANE_COLUMNS`` columns; past that ``LANE_COLUMNS`` columns a lane on
    N / ``LANE_COLUMNS`` lanes, up to a whole warp; past that a warp a row,
    N / 32 columns a lane, up to 512 columns; past that the global-memory
    walk."""
    n = _pow2_at_least(k)
    if n <= LANE_COLUMNS:
        return Plan("thread", n, 1)
    if n <= 32 * LANE_COLUMNS:
        return Plan("lanes", LANE_COLUMNS, n // LANE_COLUMNS)
    if n <= REGISTER_COLUMNS:
        return Plan("lanes", n // 32, 32)
    return Plan("global", 0, 32)


_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def build() -> str:
    """Compile ``csrc/mva_scan.cu`` (once per source and flags) and load
    it.  Returns ``nvcc``'s ``-Xptxas -v`` report (registers, shared
    memory, spills) of the build that produced the library."""
    global _lib, _build_log
    if _lib is None:
        _lib, _build_log = load_library("mva_scan.cu", {
            "mva_scan_launch": [ctypes.c_void_p, ctypes.c_float]
                + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4,
        })
    return _build_log


def _check(demands: torch.Tensor, n_max: int) -> None:
    if demands.dim() != 2:
        raise ValueError(f"demands (M, K) expected: {tuple(demands.shape)}")
    if demands.dtype != torch.float32:
        raise TypeError(f"demands must be float32: {demands.dtype}")
    if not demands.is_contiguous():
        raise ValueError("mva_scan takes a contiguous demand matrix")
    if n_max < 0:
        raise ValueError(f"n_max must be >= 0: {n_max}")
    m, k = demands.shape
    if m >= 2 ** 31 or k >= 2 ** 31 or n_max >= 2 ** 24:
        raise ValueError(f"{m} rows x {k} columns x {n_max} steps exceed "
                         f"the kernel's grid (N must stay exact in "
                         f"float32)")


def _launch(demands: torch.Tensor, think: float, n_max: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch on the current stream."""
    m, k = demands.shape
    xs = torch.empty((m, n_max), dtype=torch.float32, device=demands.device)
    rs = torch.empty_like(xs)
    if m == 0 or n_max == 0:
        return xs, rs
    build()
    p = plan(k)
    scratch = torch.empty((m, k) if p.route == "global" else (0,),
                          dtype=torch.float32, device=demands.device)
    with torch.cuda.device(demands.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.mva_scan_launch(demands.data_ptr(), think, m, k, n_max,
                                   p.width, p.lanes, xs.data_ptr(),
                                   rs.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mva_scan kernel launch failed: CUDA error {err}")
    mva_scan.launches += 1
    return xs, rs


def mva_scan(demands: torch.Tensor, think: float, n_max: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X, R), each (M, n_max) float32: the MVA recursion over every row of
    the contiguous (M, K) float32 ``demands`` for N = 1..n_max clients with
    think time ``think``; :func:`repro_torch.kernels.ref.ref_mva_scan`'s
    arguments and result.

    CUDA tensors run the hand-written kernel (one launch); CPU tensors run
    the plain version.  Any other device raises.  Fake tensors (the dry
    run) add the kernel's operations and bytes to
    ``roofline.kernel_costs.COUNTS`` and return fake outputs."""
    _check(demands, n_max)
    if is_fake(demands):
        m, k = demands.shape
        kernel_costs.record("mva_scan",
                            kernel_costs.mva_scan_cost(m, n_max, k))
        xs = torch.empty((m, n_max), dtype=torch.float32,
                         device=demands.device)
        return xs, torch.empty_like(xs)
    if demands.device.type == "cpu":
        return ref_mva_scan(demands, think, n_max)
    if demands.device.type != "cuda":
        raise ValueError(f"mva_scan runs on cuda or cpu, not "
                         f"{demands.device}")
    return _launch(demands, float(think), n_max)


mva_scan.launches = 0

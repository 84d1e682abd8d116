"""The batched execution engine's step loop: the hand-written CUDA kernel
and its wrapper.

:mod:`repro_torch.core.batched_execution` runs every (config x seed) lane
of closed-loop clients through a step loop: stations drain their head's
work, finished clients move on, completions emit latency samples.  The
reference runs it as one jitted ``lax.scan`` (``src/repro/core/
batched_execution.py:137`` ``_one_exec_lane``, vmapped over the lanes);
it replaces no Pallas kernel.  The CUDA source is ``csrc/exec_lanes.cu``:
one block a lane, one thread a client, the step loop inside the kernel, so
a run of ``n_steps`` steps is ``ceil(n_steps / block)`` launches instead of
some 40 eager ops a step.  Its time is the step's serial chain (two
barriers a step), not bytes; see the source's note.  It equals
:func:`repro_torch.kernels.ref.ref_exec_lanes` bit for bit.

The library is compiled on first use with ``nvcc`` for ``sm_90a`` into
``build/`` beside this file and loaded with ``ctypes``.  CUDA tensors go to
the kernel (or the call raises); CPU tensors go to the plain version.
``exec_lanes.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ..roofline import kernel_costs
from ._build import load_library
from .ref import ref_exec_lanes

#: K + 1 station columns the kernel's shared tables hold
MAX_COLUMNS = 64
#: clients a lane the kernel keeps in registers: up to 1024 threads a
#: block, each walking 1, 2 or 4 clients; past it each thread walks its
#: clients through global memory
REGISTER_CLIENTS = 4096

_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def build() -> str:
    """Compile ``csrc/exec_lanes.cu`` (once per source and flags) and load
    it.  Returns ``nvcc``'s ``-Xptxas -v`` report (registers, shared
    memory, spills) of the build that produced the library."""
    global _lib, _build_log
    if _lib is None:
        _lib, _build_log = load_library("exec_lanes.cu", {
            "exec_lanes_launch": [ctypes.c_void_p] * 8
                + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 8
                + [ctypes.c_int] * 4 + [ctypes.c_longlong]
                + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        })
    return _build_log


def launch_plan(n_clients: int, n_columns: int) -> Tuple[int, int]:
    """(threads a block, clients a thread) for a lane of ``n_clients``
    clients and ``n_columns`` station columns: the fewest clients a thread
    (a power of two) that fit 1024 threads, rounded up to whole warps, and
    at least one thread a station column.  Past 4 clients a thread the
    kernel walks them through global memory."""
    cpt = 1
    while cpt * 1024 < n_clients:
        cpt *= 2
    per_thread = -(-n_clients // cpt)
    threads = max(-(-per_thread // 32), -(-n_columns // 32)) * 32
    return threads, cpt


def _check(rate_w, rate_r, finishes_at, arrive_at, cls, budget, t_ends,
           draws, stage, rank, enter_t, op_i, q, work, fin_all, lat_all,
           i0: int, i1: int) -> None:
    if q.dim() != 2 or stage.dim() != 2:
        raise ValueError(f"q (L, K+1) and stage (L, N) expected: "
                         f"{tuple(q.shape)}, {tuple(stage.shape)}")
    n_lanes, k1 = q.shape
    n_clients = stage.shape[1]
    if fin_all.dim() != 3:
        raise ValueError(f"fin_all (L, n_steps, N) expected: "
                         f"{tuple(fin_all.shape)}")
    n_steps = fin_all.shape[1]
    if cls.dim() != 3 or cls.shape[:2] != (n_lanes, n_clients) \
            or cls.shape[2] < 1:
        raise ValueError(f"cls must be ({n_lanes}, {n_clients}, n_ops + 1): "
                         f"{tuple(cls.shape)}")
    shapes = {
        "rate_w": (rate_w, (n_lanes, k1)), "rate_r": (rate_r, (n_lanes, k1)),
        "finishes_at": (finishes_at, (n_lanes, k1)),
        "arrive_at": (arrive_at, (n_lanes, k1)),
        "work": (work, (n_lanes, k1)),
        "budget": (budget, (n_lanes, n_clients)),
        "rank": (rank, (n_lanes, n_clients)),
        "enter_t": (enter_t, (n_lanes, n_clients)),
        "op_i": (op_i, (n_lanes, n_clients)),
        "t_ends": (t_ends, (n_steps, n_lanes)),
        "lat_all": (lat_all, (n_lanes, n_steps, n_clients))}
    if draws is not None:
        shapes["draws"] = (draws, (n_lanes, i1 - i0, k1 - 1))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}: {tuple(t.shape)}")
    dtypes = {torch.float32: ("rate_w", "rate_r", "t_ends", "enter_t",
                              "work", "lat_all", "draws"),
              torch.int64: ("arrive_at", "cls", "budget", "stage", "rank",
                            "op_i", "q"),
              torch.bool: ("finishes_at", "fin_all")}
    given = dict(rate_w=rate_w, rate_r=rate_r, finishes_at=finishes_at,
                 arrive_at=arrive_at, cls=cls, budget=budget, t_ends=t_ends,
                 draws=draws, stage=stage, rank=rank, enter_t=enter_t,
                 op_i=op_i, q=q, work=work, fin_all=fin_all, lat_all=lat_all)
    for dtype, names in dtypes.items():
        for name in names:
            t = given[name]
            if t is not None and t.dtype != dtype:
                raise TypeError(f"{name} must be {dtype}: {t.dtype}")
    devices = {t.device for t in given.values() if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: "
                         f"{sorted(map(str, devices))}")
    if not 0 <= i0 <= i1 <= n_steps:
        raise ValueError(f"steps [{i0}, {i1}) outside [0, {n_steps})")


def _launch(rate_w, rate_r, finishes_at, arrive_at, cls, budget, t_ends,
            draws, stage, rank, enter_t, op_i, q, work, fin_all, lat_all,
            i0: int, i1: int) -> None:
    """Steps [i0, i1) in one launch on the current stream.  Every tensor
    but ``draws`` must be contiguous; ``draws`` may be a view with unit
    stride along its station axis."""
    n_lanes, k1 = q.shape
    n_clients = stage.shape[1]
    if k1 > MAX_COLUMNS:
        raise ValueError(f"{k1} station columns exceed the kernel's "
                         f"{MAX_COLUMNS}")
    if n_lanes >= 2 ** 31 or n_clients >= 2 ** 30:
        raise ValueError(f"{n_lanes} lanes of {n_clients} clients exceed "
                         f"the kernel's grid")
    tensors = (rate_w, rate_r, finishes_at, arrive_at, cls, budget, t_ends,
               stage, rank, enter_t, op_i, q, work, fin_all, lat_all)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("exec_lanes takes contiguous tables, state and "
                         "outputs")
    if draws is not None and draws.shape[1] > 0 and draws.stride(2) != 1:
        raise ValueError("draws must have unit stride along its stations")
    if n_lanes == 0 or n_clients == 0 or i0 == i1:
        return
    build()
    threads, cpt = launch_plan(n_clients, k1)
    draw_ptr, draw_lane, draw_step = 0, 0, 0
    if draws is not None:
        draw_ptr = draws.data_ptr()
        draw_lane, draw_step = draws.stride(0), draws.stride(1)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.exec_lanes_launch(
            rate_w.data_ptr(), rate_r.data_ptr(), finishes_at.data_ptr(),
            arrive_at.data_ptr(), cls.data_ptr(), budget.data_ptr(),
            t_ends.data_ptr(), draw_ptr, draw_lane, draw_step,
            stage.data_ptr(), rank.data_ptr(), enter_t.data_ptr(),
            op_i.data_ptr(), q.data_ptr(), work.data_ptr(),
            fin_all.data_ptr(), lat_all.data_ptr(), n_lanes, n_clients,
            k1 - 1, cls.shape[2], fin_all.shape[1], i0, i1, threads, cpt,
            stream)
    if err != 0:
        raise RuntimeError(f"exec_lanes kernel launch failed: CUDA error "
                           f"{err}")
    exec_lanes.launches += 1


def exec_lanes(rate_w: torch.Tensor, rate_r: torch.Tensor,
               finishes_at: torch.Tensor, arrive_at: torch.Tensor,
               cls: torch.Tensor, budget: torch.Tensor,
               t_ends: torch.Tensor, draws: Optional[torch.Tensor],
               stage: torch.Tensor, rank: torch.Tensor,
               enter_t: torch.Tensor, op_i: torch.Tensor, q: torch.Tensor,
               work: torch.Tensor, fin_all: torch.Tensor,
               lat_all: torch.Tensor, i0: int, i1: int) -> None:
    """Steps ``[i0, i1)`` of every execution lane, the state updated and
    the outputs written in place; the arguments are
    :func:`repro_torch.kernels.ref.ref_exec_lanes`'s.

    CUDA tensors run the hand-written kernel (one launch); CPU tensors run
    the plain version.  Any other device raises.  Fake tensors (the dry
    run) add the kernel's operations and bytes to
    ``roofline.kernel_costs.COUNTS`` and change nothing."""
    args = (rate_w, rate_r, finishes_at, arrive_at, cls, budget, t_ends,
            draws, stage, rank, enter_t, op_i, q, work, fin_all, lat_all,
            i0, i1)
    _check(*args)
    if is_fake(q):
        lanes, k1 = q.shape
        kernel_costs.record("exec_lanes", kernel_costs.exec_lanes_cost(
            lanes, i1 - i0, stage.shape[1], k1, cls.shape[2] - 1,
            draws is not None))
        return
    if q.device.type == "cpu":
        ref_exec_lanes(*args)
        return
    if q.device.type != "cuda":
        raise ValueError(f"exec_lanes runs on cuda or cpu, not {q.device}")
    _launch(*args)


exec_lanes.launches = 0

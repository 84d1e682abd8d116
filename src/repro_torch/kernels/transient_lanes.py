"""The transient engine's step loop: the hand-written CUDA kernel and its
wrapper.

:mod:`repro_torch.core.transient` runs every (deployment x seed) lane of a
closed token ring through a step loop: stations drain their head's work in
piecewise-constant demand windows, finished heads move on, a command that
leaves the last station is a latency sample.  The reference runs it as one
jitted ``lax.scan`` (``src/repro/core/transient.py:482`` ``_one_lane``,
vmapped over the lanes by ``_transient_batch``, ``:565``); it replaces no
Pallas kernel.  The CUDA source is ``csrc/transient_lanes.cu``: one block a
lane, one thread a client, the step loop inside the kernel, so a run of
``n_steps`` steps is ``ceil(n_steps / block)`` launches instead of some 31
eager ops a step.  Its time is the step's serial chain (two barriers a
step), not bytes; see the source's note.  It equals
:func:`repro_torch.kernels.ref.ref_transient_lanes` bit for bit.

The library is compiled on first use with ``nvcc`` for ``sm_90a`` into
``build/`` beside this file and loaded with ``ctypes``.  CUDA tensors go to
the kernel (or the call raises); CPU tensors go to the plain version.
``transient_lanes.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from ..roofline import kernel_costs
from ._build import load_library
from .exec_lanes import launch_plan
from .ref import ref_transient_lanes

#: station columns a lane the kernel takes: one thread a station, at most
#: 1024 threads a block
MAX_STATIONS = 1024

_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def build() -> str:
    """Compile ``csrc/transient_lanes.cu`` (once per source and flags) and
    load it.  Returns ``nvcc``'s ``-Xptxas -v`` report (registers, shared
    memory, spills) of the build that produced the library."""
    global _lib, _build_log
    if _lib is None:
        _lib, _build_log = load_library("transient_lanes.cu", {
            "transient_lanes_launch": [ctypes.c_void_p] * 6
                + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p],
        })
    return _build_log


def _check(rates, window_of, dt, finishes_at, arrive_at, draws, stage, rank,
           enter_t, q, work, qsum, flows, lat1, i0: int, i1: int) -> None:
    if q.dim() != 2 or stage.dim() != 2 or rates.dim() != 3:
        raise ValueError(f"q (L, K), stage (L, N) and rates (W, L, K) "
                         f"expected: {tuple(q.shape)}, {tuple(stage.shape)}, "
                         f"{tuple(rates.shape)}")
    n_lanes, k = q.shape
    n_windows = rates.shape[0]
    n_clients = stage.shape[1]
    if window_of.dim() != 1:
        raise ValueError(f"window_of (n_steps,) expected: "
                         f"{tuple(window_of.shape)}")
    n_steps = window_of.shape[0]
    shapes = {
        "rates": (rates, (n_windows, n_lanes, k)), "dt": (dt, (n_lanes,)),
        "finishes_at": (finishes_at, (n_lanes, k)),
        "arrive_at": (arrive_at, (n_lanes, k)), "work": (work, (n_lanes, k)),
        "rank": (rank, (n_lanes, n_clients)),
        "enter_t": (enter_t, (n_lanes, n_clients)),
        "qsum": (qsum, (n_lanes, n_windows, k)),
        "flows": (flows, (n_lanes, n_steps)),
        "lat1": (lat1, (n_lanes, n_steps))}
    if draws is not None:
        if draws.dim() != 3 or draws.shape[0] < 1 \
                or n_lanes % draws.shape[0] != 0:
            raise ValueError(f"draws must be (S, n_steps + 1, K) with S "
                             f"dividing {n_lanes} lanes: "
                             f"{tuple(draws.shape)}")
        shapes["draws"] = (draws, (draws.shape[0], n_steps + 1, k))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}: {tuple(t.shape)}")
    dtypes = {torch.float32: ("rates", "dt", "draws", "enter_t", "work",
                              "qsum", "lat1"),
              torch.int64: ("arrive_at", "stage", "rank", "q"),
              torch.int32: ("window_of", "flows"),
              torch.bool: ("finishes_at",)}
    given = dict(rates=rates, window_of=window_of, dt=dt,
                 finishes_at=finishes_at, arrive_at=arrive_at, draws=draws,
                 stage=stage, rank=rank, enter_t=enter_t, q=q, work=work,
                 qsum=qsum, flows=flows, lat1=lat1)
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


def _launch(rates, window_of, dt, finishes_at, arrive_at, draws, stage, rank,
            enter_t, q, work, qsum, flows, lat1, i0: int, i1: int) -> None:
    """Steps [i0, i1) in one launch on the current stream.  Every tensor
    but ``draws`` must be contiguous; ``draws`` may be a view with unit
    stride along its station axis."""
    n_lanes, k = q.shape
    n_clients = stage.shape[1]
    if k > MAX_STATIONS:
        raise ValueError(f"{k} station columns exceed the kernel's "
                         f"{MAX_STATIONS}")
    if n_lanes >= 2 ** 31 or n_clients >= 2 ** 30:
        raise ValueError(f"{n_lanes} lanes of {n_clients} clients exceed "
                         f"the kernel's grid")
    tensors = (rates, window_of, dt, finishes_at, arrive_at, stage, rank,
               enter_t, q, work, qsum, flows, lat1)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("transient_lanes takes contiguous tables, state "
                         "and outputs")
    if draws is not None and draws.stride(2) != 1:
        raise ValueError("draws must have unit stride along its stations")
    if n_lanes == 0 or i0 == i1:
        return
    build()
    threads, cpt = launch_plan(max(n_clients, 1), k)
    draw_ptr, draw_seed, draw_step, n_seeds = 0, 0, 0, 1
    if draws is not None:
        draw_ptr = draws.data_ptr()
        draw_seed, draw_step = draws.stride(0), draws.stride(1)
        n_seeds = draws.shape[0]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.transient_lanes_launch(
            rates.data_ptr(), window_of.data_ptr(), dt.data_ptr(),
            finishes_at.data_ptr(), arrive_at.data_ptr(), draw_ptr,
            draw_seed, draw_step, n_seeds, stage.data_ptr(),
            rank.data_ptr(), enter_t.data_ptr(), q.data_ptr(),
            work.data_ptr(), qsum.data_ptr(), flows.data_ptr(),
            lat1.data_ptr(), n_lanes, n_clients, k, rates.shape[0],
            flows.shape[1], i0, i1, threads, cpt, stream)
    if err != 0:
        raise RuntimeError(f"transient_lanes kernel launch failed: CUDA "
                           f"error {err}")
    transient_lanes.launches += 1


def transient_lanes(rates: torch.Tensor, window_of: torch.Tensor,
                    dt: torch.Tensor, finishes_at: torch.Tensor,
                    arrive_at: torch.Tensor, draws: Optional[torch.Tensor],
                    stage: torch.Tensor, rank: torch.Tensor,
                    enter_t: torch.Tensor, q: torch.Tensor,
                    work: torch.Tensor, qsum: torch.Tensor,
                    flows: torch.Tensor, lat1: torch.Tensor, i0: int,
                    i1: int) -> None:
    """Steps ``[i0, i1)`` of every transient lane, the state updated and
    the outputs written in place; the arguments are
    :func:`repro_torch.kernels.ref.ref_transient_lanes`'s.

    CUDA tensors run the hand-written kernel (one launch); CPU tensors run
    the plain version.  Any other device raises.  Fake tensors (the dry
    run) add the kernel's operations and bytes to
    ``roofline.kernel_costs.COUNTS`` and change nothing."""
    args = (rates, window_of, dt, finishes_at, arrive_at, draws, stage, rank,
            enter_t, q, work, qsum, flows, lat1, i0, i1)
    _check(*args)
    if is_fake(q):
        lanes, k = q.shape
        kernel_costs.record("transient_lanes",
                            kernel_costs.transient_lanes_cost(
                                lanes, i1 - i0, stage.shape[1], k,
                                rates.shape[0],
                                0 if draws is None else draws.shape[0]))
        return
    if q.device.type == "cpu":
        ref_transient_lanes(*args)
        return
    if q.device.type != "cuda":
        raise ValueError(f"transient_lanes runs on cuda or cpu, not "
                         f"{q.device}")
    _launch(*args)


transient_lanes.launches = 0

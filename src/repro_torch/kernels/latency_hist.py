"""Masked latency histogramming: the hand-written CUDA kernel and its wrapper.

The batched execution plane (:mod:`repro_torch.core.batched_execution`)
emits one (latency, valid) sample per protocol step per client per lane;
turning those streams into p50/p99 surfaces means binning every valid
sample against its lane's log-spaced edge vector with the transient
plane's ``searchsorted(edges) - 1`` convention, clipped to the end bins.

This replaces the Pallas kernel ``src/repro/kernels/latency_hist.py:
_hist_kernel``.  The CUDA source is ``csrc/latency_hist.cu``; it is bound
by memory bytes - ``L*N*5`` with every sample valid, and on the execution
plane's sparse masks the ``L*N`` mask bytes plus 4 bytes per valid sample,
since a sample is loaded only where its mask is set.  Its design (see the
source's note): a call is one launch that stores every bin once (``out``
is not zeroed first, and no atomic adds into it); :func:`plan` picks one
block a lane where the lane fits one block's pass, else a grid of lanes x
chunks whose blocks read the mask 16 bytes a load, two loads in flight
a thread, add their nonzero bins into the lane's row of int32 sums kept
zero between calls, and the last block of each lane to arrive (a ticket
from the lane's arrival counter) stores the row into the lane's bins and
zeroes it; the lane's edges and a shared int32 histogram in shared
memory, a lower-bound search per valid sample, and in the one-block
route a warp's samples of one bin added by one shared atomic - so the
result is exact and equal bit for bit to
:func:`repro_torch.kernels.ref.ref_latency_hist`.
A refused launch raises; nothing falls back.

The library is compiled on first use with ``nvcc`` for ``sm_90a`` into
``build/`` beside this file and loaded with ``ctypes``.  A CUDA tensor goes
to the kernel (or the call raises); a CPU tensor goes to the plain version.
``latency_hist.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from ..roofline import kernel_costs
from ._build import ZeroedCounters, load_library, sm_count
from .ref import ref_latency_hist

_MAX_BINS = 4096  # (2B + 1) * 4 bytes of shared memory stays under 48 KB
#: one block a lane: its threads, and the mask entries a thread takes a
#: pass (``LANE_U`` in the source); a lane of at most ``LANE_N`` entries
#: is one pass
LANE_THREADS = 1024
LANE_N = LANE_THREADS * 4
#: lanes x chunks: a block's threads, and the most mask entries a chunk
#: (8 16-byte vectors a thread: the execution calls' blocks end sooner
#: than at 16, so the grid's last blocks leave less of the card idle)
CHUNK_THREADS = 256
CHUNK = CHUNK_THREADS * 8 * 16

_lib: Optional[ctypes.CDLL] = None
_build_log = ""
#: the lanes x chunks route's int32 arrival counters (one a lane) and bin
#: sums (a row a lane), per device; the kernel leaves them zero
_arrival_counters = ZeroedCounters(1024)
_lane_sums = ZeroedCounters(64 * 1024)


class Plan(NamedTuple):
    """How a call is launched: ``route`` "lane" (one block of ``threads``
    a lane, ``n_chunks`` 0) or "chunks" (``n_chunks`` blocks of
    ``threads`` a lane, ``chunk`` entries each)."""
    route: str
    threads: int
    chunk: int
    n_chunks: int


def plan(n_lanes: int, n: int, sms: int) -> Plan:
    """One block a lane where a lane's ``n`` entries fit one pass of it;
    past that chunks of at most ``CHUNK`` entries (whole 16-entry
    vectors), split further until a card of ``sms`` multiprocessors holds
    8 blocks on each in every wave, as long as each thread of a block
    keeps a whole 16-entry vector."""
    if n <= LANE_N:
        return Plan("lane", LANE_THREADS, 0, 0)
    n_chunks = max(-(-n // CHUNK),
                   min(-(-8 * sms // n_lanes), -(-n // (16 * CHUNK_THREADS))))
    per_chunk = -(-n // n_chunks)
    chunk = -(-per_chunk // 16) * 16    # whole 16-entry vectors
    return Plan("chunks", CHUNK_THREADS, chunk, -(-n // chunk))


def launch_plan(samples: torch.Tensor) -> Plan:
    """The plan a call on these CUDA samples launches with."""
    return plan(samples.shape[0], samples.shape[1], sm_count(samples.device))


def build() -> str:
    """Compile ``csrc/latency_hist.cu`` (once per source and flags) and
    load it.  Returns ``nvcc``'s ``-Xptxas -v`` report (registers, shared
    memory, spills) of the build that produced the library."""
    global _lib, _build_log
    if _lib is None:
        _lib, _build_log = load_library("latency_hist.cu", {
            "latency_hist_launch": [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                + [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p],
        })
    return _build_log


def _check(samples: torch.Tensor, valid: torch.Tensor,
           edges: torch.Tensor) -> None:
    if samples.dim() != 2 or edges.dim() != 2:
        raise ValueError(f"samples (L, N) and edges (L, B+1) expected: "
                         f"{tuple(samples.shape)}, {tuple(edges.shape)}")
    if valid.shape != samples.shape or edges.shape[0] != samples.shape[0]:
        raise ValueError(f"shape mismatch: samples {tuple(samples.shape)}, "
                         f"valid {tuple(valid.shape)}, "
                         f"edges {tuple(edges.shape)}")
    if edges.shape[1] < 2:
        raise ValueError("edges need at least two entries (one bin)")
    if samples.dtype != torch.float32 or edges.dtype != torch.float32:
        raise TypeError(f"samples and edges must be float32: "
                        f"{samples.dtype}, {edges.dtype}")
    if valid.dtype not in (torch.bool, torch.float32):
        raise TypeError(f"valid must be bool or float32: {valid.dtype}")
    if not (samples.device == valid.device == edges.device):
        raise ValueError(f"tensors on different devices: {samples.device}, "
                         f"{valid.device}, {edges.device}")


def _launch(samples: torch.Tensor, valid: torch.Tensor,
            edges: torch.Tensor) -> torch.Tensor:
    """One kernel launch on the current stream.  Inputs must be contiguous
    CUDA tensors with nondecreasing edges per lane."""
    build()
    n_lanes, n = samples.shape
    n_bins = edges.shape[1] - 1
    if n_bins > _MAX_BINS:
        raise ValueError(f"{n_bins} bins exceed the kernel's {_MAX_BINS}")
    out = torch.empty((n_lanes, n_bins), dtype=torch.int32,
                      device=samples.device)
    if n_lanes == 0:
        return out
    p = launch_plan(samples)
    if n_lanes * max(p.n_chunks, 1, n_bins) >= 2 ** 31:
        raise ValueError(f"{n_lanes} lanes exceed the kernel's grid")
    sums = arrivals = out  # the one-block route reads neither
    if p.n_chunks:
        sums = _lane_sums(samples.device, n_lanes * n_bins)
        arrivals = _arrival_counters(samples.device, n_lanes)
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.latency_hist_launch(
            samples.data_ptr(), valid.data_ptr(),
            int(valid.dtype == torch.float32), edges.data_ptr(),
            out.data_ptr(), sums.data_ptr(), arrivals.data_ptr(),
            n_lanes, n, n_bins, p.chunk, p.n_chunks, p.threads, stream)
    if err != 0:
        raise RuntimeError(f"latency_hist kernel launch failed ({p}): CUDA "
                           f"error {err}")
    latency_hist.launches += 1
    return out


def latency_hist(samples: torch.Tensor, valid: torch.Tensor,
                 edges: torch.Tensor) -> torch.Tensor:
    """samples: (L, N) float32; valid: (L, N) bool or float32 (a sample
    counts where valid is true / > 0); edges: (L, B+1) float32,
    nondecreasing per lane (the kernel's lower-bound search relies on it;
    it is not checked, since that would wait on the device).  Returns
    (L, B) int32 counts of valid samples per bin, with out-of-range
    samples clamped to the end bins.

    CUDA tensors run the hand-written kernel; CPU tensors run the plain
    version.  Any other device raises.  Fake tensors (the dry run) return
    fake counts and add the kernel's operations and bytes to
    ``roofline.kernel_costs.COUNTS``, every sample counted as valid (the
    mask is not known there)."""
    _check(samples, valid, edges)
    if is_fake(samples):
        lanes, n = samples.shape
        bins = edges.shape[1] - 1
        kernel_costs.record("latency_hist", kernel_costs.latency_hist_cost(
            lanes, n, bins, lanes * n, valid.element_size()))
        return torch.empty((lanes, bins), dtype=torch.int32,
                           device=samples.device)
    if samples.device.type == "cpu":
        return ref_latency_hist(samples, valid, edges)
    if samples.device.type != "cuda":
        raise ValueError(f"latency_hist runs on cuda or cpu, not "
                         f"{samples.device}")
    return _launch(samples.contiguous(), valid.contiguous(),
                   edges.contiguous())


latency_hist.launches = 0

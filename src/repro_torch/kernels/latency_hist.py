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
source's note): one block per (lane, chunk of N), the lane's edges and a
shared int32 histogram in shared memory, the mask read 16 bytes per thread
at a time, a lower-bound search per valid sample, shared then global
integer atomics - so the result is exact and equal bit for bit to
:func:`repro_torch.kernels.ref.ref_latency_hist`.

The library is compiled on first use with ``nvcc`` for ``sm_90a`` into
``build/`` beside this file and loaded with ``ctypes``.  A CUDA tensor goes
to the kernel (or the call raises); a CPU tensor goes to the plain version.
``latency_hist.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from ..roofline import kernel_costs
from ._build import load_library, sm_count
from .ref import ref_latency_hist

_THREADS = 256
_CHUNK = _THREADS * 16 * 16  # mask entries per block at most
_MAX_BINS = 4096  # (2B + 1) * 4 bytes of shared memory stays under 48 KB

_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def build() -> str:
    """Compile ``csrc/latency_hist.cu`` (once per source and flags) and
    load it.  Returns ``nvcc``'s ``-Xptxas -v`` report (registers, shared
    memory, spills) of the build that produced the library."""
    global _lib, _build_log
    if _lib is None:
        _lib, _build_log = load_library("latency_hist.cu", {
            "latency_hist_launch": [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
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
    out = torch.zeros((n_lanes, n_bins), dtype=torch.int32,
                      device=samples.device)
    if n_lanes == 0 or n == 0:
        return out
    # chunks of ~16 16-byte mask vectors per thread (a multiple of 16
    # entries), split further until there are enough blocks to fill the
    # card (8 resident per SM)
    sms = sm_count(samples.device)
    n_chunks = max(-(-n // _CHUNK),
                   min(-(-8 * sms // n_lanes), -(-n // (16 * _THREADS))))
    per_chunk = -(-n // n_chunks)
    chunk = -(-per_chunk // 16) * 16    # whole 16-entry vectors
    n_chunks = -(-n // chunk)
    if n_lanes * n_chunks >= 2 ** 31:
        raise ValueError(f"{n_lanes} lanes exceed the kernel's grid")
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.latency_hist_launch(
            samples.data_ptr(), valid.data_ptr(),
            int(valid.dtype == torch.float32), edges.data_ptr(),
            out.data_ptr(), n_lanes, n, n_bins, chunk, n_chunks, _THREADS,
            stream)
    if err != 0:
        raise RuntimeError(f"latency_hist kernel launch failed: CUDA error "
                           f"{err}")
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

"""RG-LRU linear recurrence: the hand-written CUDA kernel and its wrapper.

Replaces the Pallas kernel ``src/repro/kernels/rglru_scan.py:
_rglru_kernel``.  The CUDA source is ``csrc/rglru_scan.cu``: the sequence
is cut into chunks that run in parallel (a per-chunk summary pass, a carry
pass over the chunk boundaries, then the scan itself), one thread per
channel with coalesced loads.  It is bound by the bytes of x, a and h (see
the source's note).

The wrapper takes x and a (B, S, D), float32 or bfloat16 alike, as strided
views whose last dimension is contiguous, and an optional float32 starting
state h0 (B, D), and returns a dense (B, S, D) tensor in x's dtype with
``h_t = a_t h_{t-1} + x_t`` (``h_{-1} = h0``, or 0; float32 carry).  A
decode step (S = 1) is one launch computing ``a h0 + x``.  A CUDA tensor launches the kernel (or the call raises); a
CPU tensor runs the plain version :func:`repro_torch.kernels.ref.ref_rglru`.
``rglru_scan.launches`` counts launches (one per call: the three passes
together), and only those.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ._build import build_library
from .ref import ref_rglru

DTYPES = (torch.float32, torch.bfloat16)
THREADS = 128       # channels per block in the kernel
MIN_CHUNK = 32      # steps per chunk at the least
BLOCKS_PER_SM = 8   # chunks are cut to fill the card about this many times

_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def build() -> str:
    """Compile ``csrc/rglru_scan.cu`` (once per source and flags) and load
    it.  Returns ``nvcc``'s ``-Xptxas -v`` report."""
    global _lib, _build_log
    if _lib is not None:
        return _build_log
    lib, _build_log = build_library("rglru_scan.cu")
    fn = lib.rglru_scan_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return _build_log


def chunk_plan(batch: int, seq: int, width: int, n_sms: int
               ) -> Tuple[int, int]:
    """(n_chunks, chunk): as many chunks of at least ``MIN_CHUNK`` steps as
    it takes for ``batch x channel blocks x n_chunks`` to reach about
    ``BLOCKS_PER_SM`` blocks per SM; one chunk when S is short."""
    channel_blocks = -(-width // THREADS)
    want = -(-BLOCKS_PER_SM * n_sms // max(1, batch * channel_blocks))
    n_chunks = max(1, min(want, seq // MIN_CHUNK))
    chunk = -(-seq // n_chunks)
    return -(-seq // chunk), chunk


@functools.lru_cache(maxsize=None)
def _n_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x: torch.Tensor, a: torch.Tensor,
           h0: Optional[torch.Tensor]) -> None:
    if x.dim() != 3 or x.shape != a.shape:
        raise ValueError(f"x and a must both be (B, S, D): {tuple(x.shape)}, "
                         f"{tuple(a.shape)}")
    if x.dtype != a.dtype or x.dtype not in DTYPES:
        raise TypeError(f"x and a must share float32 or bfloat16: "
                        f"{x.dtype}, {a.dtype}")
    if x.device != a.device:
        raise ValueError(f"tensors on different devices: {x.device}, "
                         f"{a.device}")
    if h0 is None:
        return
    if h0.shape != (x.shape[0], x.shape[2]):
        raise ValueError(f"h0 must be (B, D) = {(x.shape[0], x.shape[2])}: "
                         f"{tuple(h0.shape)}")
    if h0.dtype != torch.float32:
        raise TypeError(f"h0 must be float32: {h0.dtype}")
    if h0.device != x.device:
        raise ValueError(f"tensors on different devices: {x.device}, "
                         f"{h0.device}")


def _launch(x: torch.Tensor, a: torch.Tensor,
            h0: Optional[torch.Tensor]) -> torch.Tensor:
    B, S, D = x.shape
    x, a = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, a))
    if h0 is not None and h0.stride(-1) != 1:
        h0 = h0.contiguous()
    out = torch.empty((B, S, D), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    build()
    n_chunks, chunk = chunk_plan(B, S, D, _n_sms(x.device))
    ws = (torch.empty(3 * B * n_chunks * D, dtype=torch.float32,
                      device=x.device) if n_chunks > 1 else None)
    strides = (ctypes.c_longlong * 5)(*x.stride()[:2], *a.stride()[:2],
                                      h0.stride(0) if h0 is not None else 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.rglru_scan_launch(
            int(x.dtype == torch.bfloat16), x.data_ptr(), a.data_ptr(),
            h0.data_ptr() if h0 is not None else None, out.data_ptr(), ws.data_ptr() if ws is not None else None, B, S,
            D, n_chunks, chunk, strides, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    rglru_scan.launches += 1
    return out


def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x, a: (B, S, D), float32 or bfloat16 alike; h0: (B, D) float32 or
    None.  Returns h (B, S, D) in x's dtype, ``h_t = a_t h_{t-1} + x_t``
    from ``h = h0`` (or 0) with a float32 carry.

    CUDA tensors run the hand-written kernel; CPU tensors run the plain
    version.  Any other device raises."""
    _check(x, a, h0)
    if x.device.type == "cpu":
        return ref_rglru(x, a, h0)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu, not {x.device}")
    return _launch(x, a, h0)


rglru_scan.launches = 0

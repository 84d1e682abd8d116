"""RG-LRU linear recurrence: the hand-written CUDA kernel and its wrapper.

Replaces the Pallas kernel ``src/repro/kernels/rglru_scan.py:
_rglru_kernel``.  The CUDA source is ``csrc/rglru_scan.cu``: one launch
in which the sequence is cut into chunks that run in parallel, each block
(taking its chunk in order from an atomic ticket) staging its chunk of x
and a once by the copy engine, publishing the chunk's summary and folding
the earlier chunks' summaries in chunk order into the state entering its
chunk.  :func:`chunk_plan` sizes the chunks.  It is bound by the bytes of
x, a and h (see the source's note).

The wrapper takes x and a (B, S, D), float32 or bfloat16 alike, as strided
views whose last dimension is contiguous, and an optional float32 starting
state h0 (B, D), and returns a dense (B, S, D) tensor in x's dtype with
``h_t = a_t h_{t-1} + x_t`` (``h_{-1} = h0``, or 0; float32 carry).  A
decode step (S = 1) is one launch computing ``a h0 + x``.  The wrapper
owns the kernel's ticket, counter and flags, one zeroed int32 buffer per
device that every launch leaves zeroed.  A CUDA tensor launches the kernel
(or the call raises); a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.ref_rglru`.  ``rglru_scan.launches`` counts
launches (one per call), and only those.

The backward is ``csrc/rglru_scan_bwd.cu`` (:func:`rglru_scan_bwd`,
through the autograd Function :class:`RGLRUScan` where an input requires
grad): the same chunked scan run backwards in one launch, chunks taken in
reverse order and the later chunks' summaries folded last first, on the
same plan and the same counters.  ``rglru_scan_bwd.launches`` counts its
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ..roofline import kernel_costs
from ._build import build_library
from .ref import ref_rglru

DTYPES = (torch.float32, torch.bfloat16)
CHANNELS = 32       # channels a block of the kernel
CHUNKS = (128, 32)  # steps a chunk, the longest that fills the card
MAX_CHUNK = 256     # steps a chunk at most (a copy-engine box)
MAX_CHUNKS = 64     # chunks of a sequence, until that takes MAX_CHUNK
BLOCKS_PER_SM = 2   # the grid covers the card about this many times

_lib: Optional[ctypes.CDLL] = None
_build_log = ""
_bwd_lib: Optional[ctypes.CDLL] = None
_bwd_build_log = ""
#: device -> the kernel's zeroed int32 ticket, counter and flags; a grown
#: buffer keeps the old ones alive, since a captured CUDA graph may still
#: point at them
_counters: Dict[torch.device, List[torch.Tensor]] = {}


def build() -> str:
    """Compile ``csrc/rglru_scan.cu`` (once per source and flags) and load
    it.  Returns ``nvcc``'s ``-Xptxas -v`` report."""
    global _lib, _build_log
    if _lib is not None:
        return _build_log
    lib, _build_log = build_library("rglru_scan.cu")
    fn = lib.rglru_scan_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    _lib = lib
    return _build_log


def build_bwd() -> str:
    """Compile ``csrc/rglru_scan_bwd.cu`` (once per source and flags) and
    load it.  Returns ``nvcc``'s ``-Xptxas -v`` report."""
    global _bwd_lib, _bwd_build_log
    if _bwd_lib is not None:
        return _bwd_build_log
    lib, _bwd_build_log = build_library("rglru_scan_bwd.cu")
    fn = lib.rglru_scan_bwd_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    _bwd_lib = lib
    return _bwd_build_log


def chunk_plan(batch: int, seq: int, width: int, n_sms: int
               ) -> Tuple[int, int]:
    """(n_chunks, chunk) of one launch over ``batch`` sequences of ``seq``
    steps and ``width`` channels: the longest chunk of ``CHUNKS`` whose
    ``batch x channel blocks x n_chunks`` blocks cover the ``n_sms`` SMs
    ``BLOCKS_PER_SM`` times, else the shortest; past ``MAX_CHUNKS`` chunks
    of the longest, chunks grow (in steps of 32) up to ``MAX_CHUNK``.  A
    decode step (S = 1) is one chunk of one step."""
    if seq <= 1:
        return 1, 1
    channel_blocks = -(-width // CHANNELS)
    chunk = CHUNKS[-1]
    for cand in CHUNKS:
        if batch * channel_blocks * -(-seq // cand) >= BLOCKS_PER_SM * n_sms:
            chunk = cand
            break
    if -(-seq // chunk) > MAX_CHUNKS:
        chunk = min(MAX_CHUNK, 32 * -(-seq // (32 * MAX_CHUNKS)))
    return -(-seq // chunk), chunk


def _counter_buffer(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters on ``device`` (the kernel
    leaves them zeroed)."""
    bufs = _counters.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 4096), dtype=torch.int32,
                                device=device))
    return bufs[-1]


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
    """One counted launch."""
    B, S, D = x.shape
    x, a = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, a))
    if h0 is not None and h0.stride(-1) != 1:
        h0 = h0.contiguous()
    out = torch.empty((B, S, D), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    build()
    n_chunks, chunk = chunk_plan(B, S, D, _n_sms(x.device))
    ws = counters = None
    if S > 1:
        ws = torch.empty(2 * B * n_chunks * D, dtype=torch.float32,
                         device=x.device)
        counters = _counter_buffer(
            x.device, 2 + B * -(-D // CHANNELS) * n_chunks)
    step = 16 // x.element_size()
    vec = int(D % step == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % step == 0 for n, st in
                                       zip(t.shape[:2], t.stride()[:2])
                                       if n > 1)
        for t in (x, a)) and (
            S > 1 or h0 is None or (h0.data_ptr() % 16 == 0
                                    and (B == 1 or h0.stride(0) % 4 == 0))))
    strides = (ctypes.c_longlong * 5)(*x.stride()[:2], *a.stride()[:2],
                                      h0.stride(0) if h0 is not None else 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.rglru_scan_launch(
            int(x.dtype == torch.bfloat16), x.data_ptr(), a.data_ptr(),
            h0.data_ptr() if h0 is not None else None, out.data_ptr(),
            ws.data_ptr() if ws is not None else None,
            counters.data_ptr() if counters is not None else None, vec, B,
            S, D, n_chunks, chunk, strides, stream)
    if err == -2:
        raise RuntimeError("rglru_scan: the driver refused the tensor maps "
                           "of x and a (cuTensorMapEncodeTiled)")
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    rglru_scan.launches += 1
    return out


def _launch_bwd(dh: torch.Tensor, a: torch.Tensor, h: torch.Tensor,
                h0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           Optional[torch.Tensor]]:
    """One counted launch of the backward."""
    B, S, D = a.shape
    dh, a = (t if t.stride(-1) == 1 else t.contiguous() for t in (dh, a))
    h = h.contiguous()
    if h0 is not None and h0.stride(-1) != 1:
        h0 = h0.contiguous()
    dx, da = (torch.empty((B, S, D), dtype=a.dtype, device=a.device)
              for _ in range(2))
    dh0 = (torch.empty((B, D), dtype=torch.float32, device=a.device)
           if h0 is not None else None)
    if dx.numel() == 0:
        return dx, da, dh0
    build_bwd()
    n_chunks, chunk = chunk_plan(B, S, D, _n_sms(a.device))
    ws = torch.empty(2 * B * n_chunks * D, dtype=torch.float32,
                     device=a.device)
    counters = _counter_buffer(a.device, 2 + B * -(-D // CHANNELS) * n_chunks)
    strides = (ctypes.c_longlong * 5)(*dh.stride()[:2], *a.stride()[:2],
                                      h0.stride(0) if h0 is not None else 0)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib.rglru_scan_bwd_launch(
            int(a.dtype == torch.bfloat16), dh.data_ptr(), a.data_ptr(),
            h.data_ptr(), h0.data_ptr() if h0 is not None else None,
            dx.data_ptr(), da.data_ptr(),
            dh0.data_ptr() if dh0 is not None else None, ws.data_ptr(),
            counters.data_ptr(), B, S, D, n_chunks, chunk, strides, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd kernel launch failed: CUDA error "
                           f"{err}")
    rglru_scan_bwd.launches += 1
    return dx, da, dh0


def rglru_scan_bwd(x: torch.Tensor, a: torch.Tensor,
                   h0: Optional[torch.Tensor], dh: torch.Tensor,
                   h: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor]]:
    """The gradients ``(dx, da, dh0)`` of :func:`rglru_scan` at (x, a, h0)
    given h's cotangent ``dh`` (x's shape and dtype): dx and da in x's
    dtype, dh0 float32 (None where h0 is None).  ``h`` is the forward's
    float32 carry (B, S, D), the kernel's float32 output; CUDA tensors
    without it get it from one forward launch in float32.  CUDA tensors
    run the hand-written kernel; CPU tensors autograd through the plain
    version; fake tensors return fake gradients and add the kernel's
    operations and bytes to ``roofline.kernel_costs.COUNTS``.  Any other
    device raises."""
    _check(x, a, h0)
    if dh.shape != x.shape or dh.dtype != x.dtype:
        raise ValueError(f"dh must be x's shape and dtype: {tuple(dh.shape)}"
                         f" {dh.dtype}")
    fake = is_fake(x)
    if x.device.type == "cpu" and not fake:
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, a)]
            if h0 is not None:
                leaves.append(h0.detach().requires_grad_())
            grads = torch.autograd.grad(ref_rglru(*leaves), leaves, dh)
        return grads[0], grads[1], grads[2] if h0 is not None else None
    if x.device.type != "cuda" and not fake:
        raise ValueError(f"rglru_scan_bwd runs on cuda or cpu, not "
                         f"{x.device}")
    if h is None and not fake:
        h = _launch(x.float(), a.float(), h0)
    return _backward(dh, a, h, h0)


def _backward(dh, a, h, h0):
    """The backward kernel's launch, or on fake tensors its count and
    fake gradients."""
    if is_fake(a):  # counted, not launched (the dry run)
        kernel_costs.record("rglru_scan_bwd", kernel_costs.rglru_scan_bwd_cost(
            a.numel(), a.element_size(),
            0 if h0 is None else h0.numel() * h0.element_size()))
        return (torch.empty(a.shape, dtype=a.dtype, device=a.device),
                torch.empty(a.shape, dtype=a.dtype, device=a.device),
                None if h0 is None else torch.empty(
                    h0.shape, dtype=torch.float32, device=a.device))
    return _launch_bwd(dh, a, h, h0)


rglru_scan_bwd.launches = 0


class RGLRUScan(torch.autograd.Function):
    """:func:`rglru_scan` on CUDA (or fake) tensors with its gradient: the
    forward is the kernel (in float32 for a bfloat16 input, its output
    rounded, so that the backward has the float32 carry) and saves a, that
    carry and h0; the backward is :func:`rglru_scan_bwd`."""

    @staticmethod
    def forward(ctx, x, a, h0):
        if is_fake(x) or x.dtype == torch.float32:
            out = h = _forward(x, a, h0)
        else:
            h = _launch(x.float(), a.float(), h0)
            out = h.to(x.dtype)
        ctx.save_for_backward(a, h0, h)
        return out

    @staticmethod
    def backward(ctx, dh):
        a, h0, h = ctx.saved_tensors
        return _backward(dh, a, h, h0)


def _forward(x, a, h0):
    """The kernel's launch, or on fake tensors its count and a fake
    output."""
    if is_fake(x):  # counted, not launched (the dry run)
        kernel_costs.record("rglru_scan", kernel_costs.rglru_scan_cost(
            x.numel(), x.element_size(),
            0 if h0 is None else h0.numel() * h0.element_size()))
        return torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return _launch(x, a, h0)


def rglru_scan(x: torch.Tensor, a: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x, a: (B, S, D), float32 or bfloat16 alike; h0: (B, D) float32 or
    None.  Returns h (B, S, D) in x's dtype, ``h_t = a_t h_{t-1} + x_t``
    from ``h = h0`` (or 0) with a float32 carry.

    CUDA tensors run the hand-written kernel, differentiable through
    :class:`RGLRUScan` (the backward kernel) where an input requires grad;
    CPU tensors run the plain version, which autograd differentiates.  Any
    other device raises.  Fake tensors (the dry run) stand for CUDA ones:
    they return a fake output and add the kernel's operations and bytes
    to ``roofline.kernel_costs.COUNTS``, and the backward's through
    :class:`RGLRUScan`."""
    _check(x, a, h0)
    fake = is_fake(x)
    if x.device.type == "cpu" and not fake:
        return ref_rglru(x, a, h0)
    if x.device.type != "cuda" and not fake:
        raise ValueError(f"rglru_scan runs on cuda or cpu, not {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, a, h0)):
        return RGLRUScan.apply(x, a, h0)
    return _forward(x, a, h0)


rglru_scan.launches = 0

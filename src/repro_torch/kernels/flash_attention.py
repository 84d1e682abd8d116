"""Flash attention forward (prefill): the hand-written CUDA kernel and its
wrapper.

Replaces the Pallas kernel ``src/repro/kernels/flash_attention.py:
_flash_kernel``.  The CUDA source is ``csrc/flash_attention.cu``: one
block per (batch, head, query tile) walks the K/V tiles from the first its
rows can see (0, or the window's start) up to the diagonal with an online
softmax in float32 registers - bfloat16 inputs on the tensor cores
(``mma.sync`` fed by ``ldmatrix`` from a two-stage ``cp.async`` ring,
float32 accumulation), float32 inputs in float32 FMAs on the CUDA cores.
At the serving path's shapes it is bound by operations (see the source's
note).

The wrapper takes the JAX kernel's layout, q (B, H, S, d) and k/v
(B, H_kv, S, d), as any strided views whose last dimension is contiguous,
and returns (B, H, S, d) laid out as a (B, S, H, d) tensor, so the model's
``out.transpose(1, 2).reshape(B, S, H * d)`` costs no copy.  A view whose
rows a 16-byte copy cannot read is copied first (:func:`aligned_rows`).  A
CUDA tensor launches the kernel (or the call raises); a CPU tensor runs
the plain version :func:`repro_torch.kernels.ref.ref_attention`.
``flash_attention.launches`` counts kernel launches, and only those.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import build_library
from .ref import ref_attention

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def build() -> str:
    """Compile ``csrc/flash_attention.cu`` (once per source and flags) and
    load it.  Returns ``nvcc``'s ``-Xptxas -v`` report."""
    global _lib, _build_log
    if _lib is not None:
        return _build_log
    lib, _build_log = build_library("flash_attention.cu")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return _build_log


#: head dim -> (query rows per block, keys per tile) of the bfloat16
#: kernel (``MmaTile`` in the source)
MMA_TILES = {16: (64, 64), 32: (64, 64), 64: (128, 64), 128: (64, 64),
             256: (64, 32)}


def key_tile(head_dim: int) -> int:
    """Keys per tile of the bfloat16 kernel at ``head_dim``."""
    return MMA_TILES[head_dim][1]


def aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels' 16-byte copies can read its rows: a
    contiguous last dimension, a 16-byte aligned start, and every other
    stride (of a dimension longer than 1) a multiple of 16 bytes.  Else a
    dense copy of it."""
    step = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % step == 0 for n, st in zip(t.shape[:-1],
                                                    t.stride()[:-1])
                    if n > 1)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q (B, H, S, d) and k/v (B, H_kv, S, d) expected: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[1] == 0 or H % k.shape[1] != 0:
        raise ValueError(f"{H} query heads do not group over {k.shape[1]} "
                         f"kv heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"q, k, v must share float32 or bfloat16: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or at least 1: {window}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int]) -> torch.Tensor:
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    q, k, v = (aligned_rows(t) for t in (q, k, v))
    out = torch.empty((B, S, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    build()
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.flash_attention_launch(
            int(q.dtype == torch.bfloat16), D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, H, k.shape[1], S, int(causal),
            window or 0, 1.0 / math.sqrt(D), strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, d); k/v: (B, H_kv, S, d), H % H_kv == 0, float32 or
    bfloat16.  Returns (B, H, S, d) in q's dtype.  With a ``window``, query
    i sees key j only where ``i - j < window`` (local attention).

    CUDA tensors run the hand-written kernel (head dims 16, 32, 64, 128,
    256); CPU tensors run the plain version.  Any other device raises."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return ref_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, causal, window)


flash_attention.launches = 0

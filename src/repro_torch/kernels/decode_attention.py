"""Split-KV flash decode: the hand-written CUDA kernel and its wrapper.

Replaces the Pallas kernel ``src/repro/kernels/decode_attention.py:
_decode_kernel``.  The CUDA source is ``csrc/decode_attention.cu``: a grid
of (split, kv head, batch) blocks computes each split's (max, sum,
weighted values) for all query heads of its kv head, and the splits are
merged by log-sum-exp in fixed order - for bfloat16 in the same launch,
by the block of each (b, kv head) that arrives last, on the tensor cores
(``mma.sync`` over the group's query heads as M rows); for float32 by a
second kernel.  It is bound by the bytes of the cache it reads (see the
source's note).

The wrapper takes the JAX kernel's layout, q (B, H, d), caches
(B, H_kv, S_max, d) and cache_len (B,) int32, as strided views whose last
dimension is contiguous, so the model passes ``cache.transpose(1, 2)`` of
its (B, S_max, H_kv, d) caches without a copy; a view whose rows a 16-byte
copy cannot read is copied first (``flash_attention.aligned_rows``).
``cache_len`` stays on the device: nothing here waits on it.  The
wrapper owns the bfloat16 kernel's arrival counters, one zeroed int32
buffer per device that every launch leaves zeroed.  A CUDA tensor
launches the kernel (or the call raises); a CPU tensor runs the plain
version :func:`repro_torch.kernels.ref.ref_decode`.
``flash_decode.launches`` counts launches (one per call), and only those.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ..roofline import kernel_costs
from ._build import ZeroedCounters, load_library, sm_count
from .flash_attention import aligned_rows
from .ref import ref_decode

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
TILE = 64          # keys per tile in the kernel; a split is whole tiles
MIN_TILES = 2      # tiles per split at least, where the cache has two
MAX_SPLITS = 64    # splits the bfloat16 kernel's last block merges
MAX_OUT = 2560     # group * d the float32 kernel's registers hold
MAX_GROUP = 16     # query heads per kv head: the bfloat16 kernel's M rows

_lib: Optional[ctypes.CDLL] = None
_build_log = ""
#: the bfloat16 kernel's zeroed int32 arrival counters, one per (b, kv
#: head), per device
_arrival_counters = ZeroedCounters(1024)


def build() -> str:
    """Compile ``csrc/decode_attention.cu`` (once per source and flags) and
    load it.  Returns ``nvcc``'s ``-Xptxas -v`` report."""
    global _lib, _build_log
    if _lib is None:
        _lib, _build_log = load_library("decode_attention.cu", {
            "flash_decode_launch": [ctypes.c_int, ctypes.c_int]
                + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p],
        })
    return _build_log


def split_plan(batch: int, n_kv_heads: int, s_max: int,
               n_sms: int) -> Tuple[int, int]:
    """(n_splits, split_len): whole 64-key tiles per split, at least
    ``MIN_TILES`` of them (where the cache has that many), few enough that
    ``batch * n_kv_heads * n_splits`` covers the ``n_sms`` SMs about once,
    and at most ``MAX_SPLITS`` splits."""
    n_tiles = max(1, -(-s_max // TILE))
    want = max(1, -(-n_sms // max(1, batch * n_kv_heads)))
    per_split = min(n_tiles, max(MIN_TILES, -(-n_tiles // want),
                                 -(-n_tiles // MAX_SPLITS)))
    split_len = per_split * TILE
    return -(-s_max // split_len), split_len


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           cache_len: torch.Tensor) -> None:
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(f"q (B, H, d) and caches (B, H_kv, S_max, d) "
                         f"expected: {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, D = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if k_cache.shape[1] == 0 or H % k_cache.shape[1] != 0:
        raise ValueError(f"{H} query heads do not group over "
                         f"{k_cache.shape[1]} kv heads")
    if cache_len.shape != (B,):
        raise ValueError(f"cache_len must be ({B},): "
                         f"{tuple(cache_len.shape)}")
    if cache_len.dtype != torch.int32:
        raise TypeError(f"cache_len must be int32: {cache_len.dtype}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"q and caches must share float32 or bfloat16: "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device == cache_len.device):
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k_cache.device}, {v_cache.device}, "
                         f"{cache_len.device}")


def _launch(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
            cache_len: torch.Tensor) -> torch.Tensor:
    B, H, D = q.shape
    H_kv, S_max = k_cache.shape[1], k_cache.shape[2]
    group = H // H_kv
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and group > MAX_GROUP:
        raise ValueError(f"group {group} exceeds the bfloat16 kernel's "
                         f"{MAX_GROUP} query heads per kv head")
    if q.dtype == torch.float32 and group * D > MAX_OUT:
        raise ValueError(f"group {group} x head dim {D} exceeds the "
                         f"kernel's {MAX_OUT} outputs per block")
    q, k_cache, v_cache = (aligned_rows(t) for t in (q, k_cache, v_cache))
    lens = cache_len.contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    build()
    n_splits, split_len = split_plan(B, H_kv, S_max, sm_count(q.device))
    row = -(-(group * D + 2 * group) // 4) * 4  # a split's floats
    ws = torch.empty(B * H_kv * n_splits * row, dtype=torch.float32,
                     device=q.device)
    arrivals = _arrival_counters(q.device, B * H_kv)
    strides = (ctypes.c_longlong * 10)(
        *q.stride()[:2], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *out.stride()[:2])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.flash_decode_launch(
            int(q.dtype == torch.bfloat16), D, q.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
            ws.data_ptr(), arrivals.data_ptr(), out.data_ptr(), B, H, H_kv,
            S_max, n_splits,
            split_len, 1.0 / math.sqrt(D), strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    flash_decode.launches += 1
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor
                 ) -> torch.Tensor:
    """q: (B, H, d), one token per sequence; caches: (B, H_kv, S_max, d);
    cache_len: (B,) int32 with 1 <= cache_len <= S_max (not checked: that
    would wait on the device; the kernel clamps it to S_max).  Returns
    (B, H, d) in q's dtype.

    CUDA tensors run the hand-written kernel (head dims 16, 32, 64, 128,
    256; a group of at most 16 query heads in bfloat16, group x head dim
    at most 2560 in float32); CPU tensors run the plain version.  Any
    other device raises.  Fake tensors (the dry run) return a fake output
    and add the kernel's operations and bytes to
    ``roofline.kernel_costs.COUNTS``, counting every cached row (the
    lengths are not known there)."""
    _check(q, k_cache, v_cache, cache_len)
    if is_fake(q):
        B, H, D = q.shape
        kernel_costs.record("flash_decode", kernel_costs.flash_decode_cost(
            B, H, k_cache.shape[1], D, B * k_cache.shape[2],
            q.element_size()))
        return torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        return ref_decode(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, not {q.device}")
    return _launch(q, k_cache, v_cache, cache_len)


flash_decode.launches = 0

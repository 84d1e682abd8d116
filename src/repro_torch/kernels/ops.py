"""Kernel dispatch for the port.

Each op runs its hand-written Hopper kernel on CUDA tensors and its plain
PyTorch version (:mod:`repro_torch.kernels.ref`) on CPU tensors; the
dispatch is by the device of the tensors the caller passes, never a
fallback.  Core and model code call these entry points.  The JAX
package's pad-to-128 of the head dim (a TPU lane-width matter) is not
carried: the CUDA kernels take head dims 16, 32, 64, 128 and 256 as they
are, the RG-LRU kernel any width and length, and the WKV kernel head dims
16, 32, 64 and 128 at any length.
"""
from __future__ import annotations

from .decode_attention import flash_decode
from .exec_lanes import exec_lanes
from .flash_attention import flash_attention
from .fluid_scan import fluid_scan
from .latency_hist import latency_hist
from .mva_scan import mva_scan
from .rglru_scan import rglru_scan
from .transient_lanes import transient_lanes
from .wkv6 import wkv6

__all__ = ["exec_lanes", "flash_attention", "flash_decode", "fluid_scan",
           "latency_hist", "mva_scan", "rglru_scan", "transient_lanes",
           "wkv6"]

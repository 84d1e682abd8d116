"""Kernel dispatch for the port.

Each op runs its hand-written Hopper kernel on CUDA tensors and its plain
PyTorch version (:mod:`repro_torch.kernels.ref`) on CPU tensors; the
dispatch is by the device of the tensors the caller passes, never a
fallback.  Core and model code call these entry points.  The JAX
package's pad-to-128 of the head dim (a TPU lane-width matter) is not
carried: the CUDA kernels take head dims 16, 32, 64 and 128 as they are.
"""
from __future__ import annotations

from .decode_attention import flash_decode
from .flash_attention import flash_attention
from .latency_hist import latency_hist

__all__ = ["flash_attention", "flash_decode", "latency_hist"]

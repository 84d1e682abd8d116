"""Kernel dispatch for the port.

Each op runs its hand-written Hopper kernel on CUDA tensors and its plain
PyTorch version (:mod:`repro_torch.kernels.ref`) on CPU tensors; the
dispatch is by the device of the tensors the caller passes, never a
fallback.  Core code calls these entry points.
"""
from __future__ import annotations

from .latency_hist import latency_hist

__all__ = ["latency_hist"]

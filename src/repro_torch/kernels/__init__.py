"""Hand-written Hopper kernels of the port, with their plain versions.

  latency_hist - masked per-lane latency histogramming for the batched
                 execution plane's p50/p99 surfaces (CUDA C++,
                 ``csrc/latency_hist.cu``)

Each ships with a wrapper that launches the kernel on CUDA tensors and
runs the plain version (``ref.py``) on CPU tensors; ``ops.py`` is the
dispatch core code calls.  Sources are compiled on first use, on the
machine with the card: importing this package builds nothing.
"""
from . import ops, ref

__all__ = ["ops", "ref"]

"""PyTorch + CUDA port of the compartmentalized state machine replication
package (:mod:`repro`), for one NVIDIA Hopper card.

Same layout and module names as the JAX package, which stays the reference
the tests hold this package to.  This package imports neither JAX nor the
JAX package.  ``core`` carries the registry, demand tables, sweeps, the
steady-state solves and the batched execution plane; ``kernels`` holds the
hand-written CUDA kernels with their plain PyTorch versions.
"""
from . import core, kernels

__all__ = ["core", "kernels"]

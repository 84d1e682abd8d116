"""The current mesh, for the one layer of the model that needs it (port of
``runtime/mesh_context.py``).

The model is mesh-agnostic; the one exception is the explicit all-to-all
MoE layer (``moe_impl="a2a"``), whose collectives need the
``DeviceMesh``.  The caller sets it around the model's call.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

_CURRENT: Optional[Any] = None


def current_mesh():
    if _CURRENT is None:
        raise RuntimeError(
            "moe_impl='a2a' needs a mesh: wrap lowering in "
            "repro_torch.runtime.mesh_context.use_mesh(mesh)")
    return _CURRENT


@contextlib.contextmanager
def use_mesh(mesh):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = mesh
    try:
        yield mesh
    finally:
        _CURRENT = prev

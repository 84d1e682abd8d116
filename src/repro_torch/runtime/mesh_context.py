"""The current mesh, for the parts of the model that need it (port of
``runtime/mesh_context.py``).

The model is mesh-agnostic, with two exceptions.  The explicit
all-to-all MoE layer (``moe_impl="a2a"``) needs the ``DeviceMesh`` for
its collectives.  And the losses need to know where the sharded train
step splits the batch over ranks: the reference's step is one SPMD
program, so its loss is the whole batch's, and a loss that is not a plain
mean over rows of equal weight (the masked cross-entropy, the MoE
load-balance loss) has to take its sums over the batch's ranks before it
divides or multiplies (:func:`whole_batch_sum`).  The caller sets both
around the model's call.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence, Tuple

import torch

_CURRENT: Optional[Any] = None
#: the mesh axes the current batch is split over (the sharded train step
#: sets them; empty outside it, or where they hold one rank in all)
_BATCH_AXES: Tuple[str, ...] = ()


def current_mesh():
    if _CURRENT is None:
        raise RuntimeError(
            "moe_impl='a2a' needs a mesh: wrap lowering in "
            "repro_torch.runtime.mesh_context.use_mesh(mesh)")
    return _CURRENT


def batch_axes() -> Tuple[str, ...]:
    """The axes of the current mesh the batch is split over: () outside
    the sharded train step."""
    return _BATCH_AXES


@contextlib.contextmanager
def use_mesh(mesh, batch_axes: Sequence[str] = ()):
    """``mesh`` is the current mesh inside the block; ``batch_axes``: the
    axes of it the batch is split over, given only where they hold more
    than one rank (the losses then sum over them)."""
    global _CURRENT, _BATCH_AXES
    prev = _CURRENT, _BATCH_AXES
    _CURRENT, _BATCH_AXES = mesh, tuple(batch_axes)
    try:
        yield mesh
    finally:
        _CURRENT, _BATCH_AXES = prev


class _WholeSum(torch.autograd.Function):
    """Forward: each input (float32) summed over the ranks of ``axes``
    (one all-reduce an axis for all of them).  Backward: the identity.  Each
    rank's gradient is then its own share of the whole sum's, and the
    sharded step sums the ranks' gradients (their ``Partial`` placement
    over the batch's axes), which gives the whole sum's gradient once."""

    @staticmethod
    def forward(ctx, mesh, axes, *ts):
        from .collectives import _sum
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        for a in axes:
            _sum(flat, mesh.get_group(a))
        return tuple(part.reshape(t.shape) for part, t in
                     zip(flat.split([t.numel() for t in ts]), ts))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + grads


def whole_batch_sum(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``ts`` (sums over this rank's rows) summed over the ranks the
    current batch is split over, with the gradient of each rank's own
    (:class:`_WholeSum`); ``ts`` as they are outside the sharded step."""
    if not _BATCH_AXES:
        return ts
    return _WholeSum.apply(_CURRENT, _BATCH_AXES, *ts)

"""Gradient compression: int8 quantization with error feedback (port of
``optim/compression.py``).

The S-Paxos lesson (paper section 7) applied to training: keep the control
path (step ordering, tiny) separate from the data path (gradient payloads,
huge) and compress the expensive hop.  Gradients crossing the scarce link
are quantized to int8 with per-tensor scales; the quantization residual
is fed back into the next step (error feedback keeps SGD convergence).

Trees are nested dicts (or lists and tuples) of tensors; a quantized
leaf is a ``(q int8, scale float32)`` tuple.  ``torch.round`` rounds half
to even as ``jnp.round`` does, so codes and scales equal the reference's
exactly.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` over the leaves of nested dicts, lists and tuples (and the
    matching leaves of ``rest``), keeping the structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    out = []
    tree_map(out.append, tree, is_leaf=is_leaf)
    return out


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q int8, scale float32 0-d)."""
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / 127.0
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads, residuals: Optional[Any] = None):
    """Quantize a gradient tree with error feedback.  Returns (the tree of
    (q, scale), the new residuals); ``residuals`` from the previous step
    are added before quantizing."""
    if residuals is None:
        residuals = tree_map(lambda g: torch.zeros_like(g,
                                                        dtype=torch.float32),
                             grads)

    def one(g, r):
        corrected = g.float() + r
        q, scale = quantize_int8(corrected)
        return (q, scale), corrected - dequantize_int8(q, scale)

    both = tree_map(one, grads, residuals)
    is_pair = lambda t: (isinstance(t, tuple) and len(t) == 2  # noqa: E731
                         and isinstance(t[0], tuple))
    return (tree_map(lambda t: t[0], both, is_leaf=is_pair),
            tree_map(lambda t: t[1], both, is_leaf=is_pair))


def decompress_tree(qtree):
    return tree_map(lambda leaf: dequantize_int8(*leaf), qtree,
                    is_leaf=lambda t: isinstance(t, tuple))


def compression_ratio(grads) -> float:
    """Bytes(int8 + scale) / bytes(original)."""
    leaves = tree_leaves(grads)
    orig = sum(t.numel() * t.element_size() for t in leaves)
    comp = sum(t.numel() * 1 + 4 for t in leaves)
    return comp / orig

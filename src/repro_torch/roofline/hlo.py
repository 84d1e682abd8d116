"""Collective-bytes accounting: from HLO text, and from the port's own
program.

The reference reads ``compiled.as_text()``, the post-partitioning
per-device HLO, so every shape is a per-shard shape and the sums below are
**per-device** collective bytes.  :func:`collective_stats`,
:func:`total_collective_bytes` and :func:`count_op` are kept as they are
there, over HLO text.

The port has no compiler and no HLO: :class:`CollectiveCounter` records
every collective the program issues as it runs (on a real or a fake
process group), under the reference's HLO names, with the same measure -
the **per-device result bytes** of each: an all-gather counts its gathered
output, a reduce-scatter its shard, an all-reduce and an all-to-all their
output.  It sees the ``c10d`` ops behind ``torch.distributed``'s calls
(``runtime/collectives.collective``) and the ``_c10d_functional`` ops
behind ``DTensor`` redistributions and ``full_tensor()``.
(``runtime/collectives.BYTES`` counts each call's *input* bytes; it is not
this number.)  The roofline's collective term is

    collective_bytes_per_device / link_bw

with the card's per-device link rate (``analysis.LINK_BW``).
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

# e.g.  "bf16[2048,512]{1,0}"  or  "f32[]"
_ARRAY_RE = re.compile(r"(\w+)\[([\d,]*)\]")
# result of an HLO instruction: "  %name = <TYPE> op-name(...".  Async
# collectives appear as op-start/op-done; we count the -start (the -done
# carries the same payload and would double count).
_INSTR_RE = re.compile(
    r"=\s*(\(?[^)=]*?\)?)\s+(" + "|".join(COLLECTIVE_OPS)
    + r")(-start)?[\s(.]")


def _type_bytes(type_str: str) -> int:
    total = 0
    for m in _ARRAY_RE.finditer(type_str):
        dtype, dims = m.group(1), m.group(2)
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_stats(hlo_text: str) -> Dict[str, Dict[str, float]]:
    """Per collective-op-kind: {count, bytes} (per-device result bytes)."""
    stats: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "bytes": 0})
    for line in hlo_text.splitlines():
        m = _INSTR_RE.search(line)
        if not m:
            continue
        type_str, op = m.group(1), m.group(2)
        if f"{op}-done" in line:
            continue
        stats[op]["count"] += 1
        stats[op]["bytes"] += _type_bytes(type_str)
    return dict(stats)


def total_collective_bytes(hlo_text: str) -> float:
    return sum(v["bytes"] for v in collective_stats(hlo_text).values())


def count_op(hlo_text: str, opname: str) -> int:
    return len(re.findall(rf"\b{re.escape(opname)}\(", hlo_text))


#: the torch collectives, by the operator's overload packet, under their
#: HLO names.  The ``c10d`` ops are in place: their first argument is the
#: output (a tensor, or a list of them); the ``_c10d_functional`` ops
#: return theirs.
TORCH_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
}


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) tuple or list; a ``DTensor``
    counts its local block."""
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(t) for t in tree)
    if isinstance(tree, torch.Tensor):
        local = getattr(tree, "_local_tensor", tree)
        return local.numel() * local.element_size()
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Inside the block, every collective the program dispatches is
    recorded: :attr:`stats` maps its HLO name to {"count", "bytes"}
    (per-device result bytes), as :func:`collective_stats` reads them from
    HLO.  Enter it inside a ``FakeTensorMode`` to count a program on fake
    tensors."""

    def __init__(self) -> None:
        super().__init__()
        self.stats: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {"count": 0, "bytes": 0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = TORCH_COLLECTIVES.get(str(func.overloadpacket))
        if op is not None:
            result = args[0] if str(func.namespace) == "c10d" else out
            self.stats[op]["count"] += 1
            self.stats[op]["bytes"] += tensor_bytes(result)
        return out

    def total_bytes(self) -> float:
        return sum(v["bytes"] for v in self.stats.values())

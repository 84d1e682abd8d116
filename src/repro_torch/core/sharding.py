"""The shard axis: lowering sharded systems onto the existing planes.

A sharded system is N independent replicated groups, each owning a hash
partition of the key space (:class:`~repro.core.api.ShardingSpec`).  This
module holds the plane-agnostic machinery:

* **demand lowering** - a sharded deployment's demand tensor is the
  per-command table scaled by each shard's traffic fraction:
  ``d[m, s, k] = w_s * d[m, k]`` (a random command visits shard *s*'s
  stations with probability ``w_s`` - standard probabilistic-routing
  visit ratios).  Flattening the ``[M, S, K]`` tensor to ``[M, S*K]``
  lets the *unchanged* jitted MVA / fluid / transient paths evaluate
  per-shard station loads in the same single device call; the row max
  recovers the min-law ``T = min_s alpha / (w_s * max_k d[k])``.
* **routing helpers** - largest-remainder integer splits of command /
  client budgets by shard weight, and the flattened column index of a
  (shard, station) pair for transient event targeting.
* **history partitioning** - linearizability is *local*: a KV history is
  linearizable iff every per-key sub-history is (Herlihy & Wing's
  locality theorem; keys are independent objects).  The same holds for
  any coarser grouping of keys, so per-shard checks are both sound and
  complete.  :func:`partition_history` builds the sub-histories and
  :func:`check_linearizable_partitioned` runs the decomposed check.

Import discipline: numpy + stdlib only (NO JAX) - ``execution.py``
imports this module and is itself stitched into the jax-free synthetic
package used by ``scripts/check_docs_links.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .api import ShardingSpec, Workload
from .history import History, Operation
from .linearizability import check_linearizable

__all__ = [
    "shard_weights",
    "split_counts",
    "shard_demands",
    "flatten_shards",
    "shard_column",
    "split_weights",
    "op_key",
    "partition_ops",
    "partition_history",
    "check_linearizable_partitioned",
]


# ---------------------------------------------------------------------------
# weights + demand lowering
# ---------------------------------------------------------------------------


def shard_weights(sharding: ShardingSpec,
                  workload: Optional[Workload] = None) -> np.ndarray:
    """Per-shard traffic fractions as a float vector summing to 1."""
    return np.asarray(sharding.resolved_weights(workload), dtype=np.float64)


def split_counts(total: int, weights: Sequence[float]) -> np.ndarray:
    """Split ``total`` items into integer per-shard counts proportional to
    ``weights`` (largest-remainder method, so the counts sum exactly to
    ``total`` and no positive weight is starved below its floor)."""
    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 1 or w.size == 0:
        raise ValueError(f"weights must be a non-empty vector: {w!r}")
    w = w / w.sum()
    exact = w * int(total)
    base = np.floor(exact).astype(np.int64)
    rem = int(total) - int(base.sum())
    if rem > 0:
        order = np.argsort(-(exact - base), kind="stable")
        base[order[:rem]] += 1
    return base


def shard_demands(demands: np.ndarray, sharding: ShardingSpec,
                  workload: Optional[Workload] = None,
                  weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """Expand a per-command demand table ``[..., K]`` to the sharded
    tensor ``[..., S, K]`` with ``out[..., s, k] = w_s * demands[..., k]``.

    Each shard is an independent copy of the deployment that sees only
    its traffic fraction, so per *global* command its stations do ``w_s``
    times the per-command work - visit-ratio scaling, which is exactly
    what the MVA and transient engines expect of a demand column."""
    d = np.asarray(demands, dtype=np.float64)
    w = (np.asarray(weights, dtype=np.float64) if weights is not None
         else shard_weights(sharding, workload))
    w = w / w.sum()
    return d[..., None, :] * w[:, None]


def flatten_shards(demands: np.ndarray) -> np.ndarray:
    """Collapse the shard axis of ``[..., S, K]`` into ``[..., S*K]`` so
    the tensor flows through the existing jitted single-deployment paths
    (shard *s*'s station *k* lands in column ``s*K + k``)."""
    d = np.asarray(demands, dtype=np.float64)
    if d.ndim < 2:
        raise ValueError(f"expected [..., S, K], got shape {d.shape}")
    return d.reshape(*d.shape[:-2], d.shape[-2] * d.shape[-1])


def shard_column(shard: int, station: int, n_stations: int) -> int:
    """Flattened column index of station ``station`` (an int slot index)
    on shard ``shard`` - the address space transient ``Event``s target
    after :func:`flatten_shards`."""
    if not 0 <= station < n_stations:
        raise ValueError(
            f"station index {station} outside [0, {n_stations})")
    return shard * n_stations + station


def split_weights(sharding: ShardingSpec,
                  workload: Optional[Workload] = None,
                  ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Weights before/after a hot-shard split, for resharding schedules.

    Returns ``(pre, post, hot)`` over ``S + 1`` lanes: the original
    ``S`` shards plus one destination shard that carries no traffic
    before the split.  After the split the hot shard's traffic is halved,
    the freed half landing on the destination - the canonical "split the
    hot shard in two" rebalancing event."""
    w = shard_weights(sharding, workload)
    hot = int(np.argmax(w))
    pre = np.concatenate([w, [0.0]])
    post = pre.copy()
    post[hot] = w[hot] / 2.0
    post[-1] = w[hot] / 2.0
    return pre, post, hot


# ---------------------------------------------------------------------------
# op routing + history partitioning
# ---------------------------------------------------------------------------


def op_key(op: Tuple) -> Any:
    """The state-machine key an operation addresses (``("put", k, v)`` /
    ``("get", k)`` -> ``k``); None for key-less ops (register r/w)."""
    return op[1] if len(op) > 1 and op[0] in ("put", "get") else None


def partition_ops(ops: Sequence[Tuple], sharding: ShardingSpec,
                  ) -> Dict[int, List[Tuple]]:
    """Route a flat op list to shards by key hash.  Key-less ops all land
    on shard 0 (a register has a single implicit key)."""
    parts: Dict[int, List[Tuple]] = {s: [] for s in range(sharding.n_shards)}
    for op in ops:
        key = op_key(op)
        shard = sharding.shard_of(key) if key is not None else 0
        parts[shard].append(op)
    return parts


def _sub_history(ops: Sequence[Operation]) -> History:
    """A History over an op subset, preserving ids and timestamps.

    ``History.respond`` indexes ``ops[op_id]``, so sub-histories must be
    assembled by assigning ``.ops`` directly - replaying invoke/respond
    would renumber the ops."""
    h = History()
    h.ops = list(ops)
    h._next = (max(o.op_id for o in ops) + 1) if ops else 0
    return h


def partition_history(history: History,
                      part_of: Callable[[Any], Any]) -> Dict[Any, History]:
    """Partition a history by ``part_of(key)`` (e.g. ``sharding.shard_of``
    for per-shard groups, ``lambda k: k`` for per-key groups).  Key-less
    ops go to partition ``None``."""
    groups: Dict[Any, List[Operation]] = {}
    for o in history.ops:
        key = op_key(o.op)
        part = part_of(key) if key is not None else None
        groups.setdefault(part, []).append(o)
    return {part: _sub_history(ops) for part, ops in groups.items()}


def check_linearizable_partitioned(history: History,
                                   part_of: Optional[Callable] = None,
                                   sm_kind: str = "kv",
                                   max_nodes: int = 2_000_000) -> bool:
    """Decomposed linearizability: check each key partition separately.

    By locality this accepts exactly the histories the whole-history
    checker accepts (each key is an independent object; a grouping of
    keys composes per-key linearizations), but the exhaustive search is
    exponential in the *partition* size, not the history size.  Default
    partition is per-key; pass ``part_of=sharding.shard_of`` for
    per-shard groups."""
    part = part_of if part_of is not None else (lambda key: key)
    return all(
        check_linearizable(sub, sm_kind=sm_kind, max_nodes=max_nodes)
        for sub in partition_history(history, part).values())

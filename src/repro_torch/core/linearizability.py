"""Linearizability checking (paper section 3.5, Herlihy & Wing).

Two checkers:

* ``check_linearizable``: exhaustive Wing-Gong search (with memoisation) for
  small histories - the ground truth used by the hypothesis property tests.
  Handles pending invocations per the definition: the history may be
  *extended* with responses for pending ops (they may be linearized with any
  result) or pending ops may be dropped.

* ``check_slot_order`` / ``check_register_semantics``: the paper's own proof
  structure specialised to our protocol, which stamps every response with the
  log index it wrote to / read from.  If ``x <_H y`` then ``slot(x) <=
  slot(y)`` (strictly for write/write).  Cheap enough for large histories.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

from .history import History, Operation
from .statemachine import StateMachine, make_state_machine


def _hashable(x: Any) -> Any:
    if isinstance(x, dict):
        return frozenset((k, _hashable(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(_hashable(v) for v in x)
    return x


def check_linearizable(history: History, sm_kind: str = "kv",
                       max_nodes: int = 2_000_000) -> bool:
    """Exhaustive search for a linearization of ``history``.

    Completed operations must all be linearized with matching results;
    pending operations may be linearized (any result) or dropped.
    """
    ops: List[Operation] = list(history.ops)
    n = len(ops)
    if n == 0:
        return True
    completed = [o for o in ops if not o.pending]

    # precompute happens-before predecessor sets (indices into ops)
    preds: List[List[int]] = [[] for _ in ops]
    for i, a in enumerate(ops):
        for j, b in enumerate(ops):
            if i != j and history.happens_before(a, b):
                preds[j].append(i)

    completed_ids = frozenset(o.op_id for o in completed)
    id_to_idx = {o.op_id: i for i, o in enumerate(ops)}

    seen = set()
    nodes = [0]

    def dfs(linearized: frozenset, sm: StateMachine) -> bool:
        nodes[0] += 1
        if nodes[0] > max_nodes:
            raise RuntimeError("linearizability search budget exceeded")
        if completed_ids <= linearized:
            return True
        key = (linearized, _hashable(sm.snapshot()))
        if key in seen:
            return False
        seen.add(key)
        for i, op in enumerate(ops):
            if op.op_id in linearized:
                continue
            # all real-time predecessors must already be linearized
            if any(ops[p].op_id not in linearized for p in preds[i]):
                continue
            snap = sm.snapshot()
            result = sm.apply(op.op)
            ok = op.pending or result == op.result
            if ok and dfs(linearized | {op.op_id}, sm):
                return True
            sm.restore(snap)
            # also try *dropping* a pending op: handled implicitly - a pending
            # op that is never chosen simply stays out of `linearized`.
        return False

    return dfs(frozenset(), make_state_machine(sm_kind))


# ---------------------------------------------------------------------------
# Slot-stamped checks (scale to large histories)
# ---------------------------------------------------------------------------


def check_slot_order(history: History) -> List[str]:
    """If x <_H y then slot(x) <= slot(y); strict for write-write pairs.

    This is exactly the case analysis in the paper's section 3.5 proof.
    Returns a list of violation descriptions (empty = pass).
    """
    violations: List[str] = []
    done = [o for o in history.complete() if isinstance(o.result, object)]
    stamped = [o for o in done if _slot_of(o) is not None]
    for a in stamped:
        for b in stamped:
            if a is b or not history.happens_before(a, b):
                continue
            sa, sb = _slot_of(a), _slot_of(b)
            if sa > sb:
                violations.append(
                    f"{a.op} (slot {sa}) happens-before {b.op} (slot {sb})")
            elif sa == sb and not a.is_read and not b.is_read:
                violations.append(
                    f"write-write same slot {sa}: {a.op} <_H {b.op}")
    return violations


def _slot_of(op: Operation) -> Optional[int]:
    return op.slot


def check_register_reads(history: History) -> List[str]:
    """Register semantics with slot stamps: a read served at log position j
    must return the value of the latest write with slot <= j (unbatched
    histories only - batched writes share slots)."""
    violations: List[str] = []
    writes = sorted(
        ((op, _slot_of(op)) for op in history.complete()
         if not op.is_read and _slot_of(op) is not None),
        key=lambda t: t[1],
    )
    slots = [s for _, s in writes]
    if len(set(slots)) != len(slots):
        return ["duplicate write slots - use the exhaustive checker"]
    for op in history.complete():
        if not op.is_read or _slot_of(op) is None:
            continue
        j = _slot_of(op)
        latest = None
        for w, s in writes:
            if s <= j:
                latest = w
        expect = None if latest is None else latest.op[1]
        if op.result != expect:
            violations.append(
                f"read at slot {j} returned {op.result!r}, expected {expect!r}")
    return violations

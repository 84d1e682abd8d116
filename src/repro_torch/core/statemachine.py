"""Deterministic state machines replicated by the protocols.

Commands are tuples ``(opcode, *args)``:

KVStore:   ("put", k, v) -> "ok"     | ("get", k) -> value | None
           ("cas", k, expect, v) -> bool
Register:  ("w", v) -> "ok"          | ("r",) -> value
AppendLog: ("append", v) -> index    | ("read",) -> tuple(log)

Reads (``("get", ...)``, ``("r",)``, ``("read",)``) never modify state, which
is what makes the leaderless read path of compartmentalization 4 safe.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Tuple

from .messages import NOOP


class StateMachine:
    def apply(self, op: Tuple) -> Any:
        raise NotImplementedError

    def is_read(self, op: Tuple) -> bool:
        raise NotImplementedError

    def snapshot(self) -> Any:
        raise NotImplementedError

    def restore(self, snap: Any) -> None:
        raise NotImplementedError

    def apply_checked(self, op: Tuple) -> Any:
        if op and op[0] == NOOP:
            return None
        return self.apply(op)


class KVStore(StateMachine):
    """The paper's evaluation state machine: integer keys, small values."""

    def __init__(self) -> None:
        self.data: Dict[Any, Any] = {}

    def apply(self, op: Tuple) -> Any:
        code = op[0]
        if code == "put":
            _, k, v = op
            self.data[k] = v
            return "ok"
        if code == "get":
            return self.data.get(op[1])
        if code == "cas":
            _, k, expect, v = op
            if self.data.get(k) == expect:
                self.data[k] = v
                return True
            return False
        raise ValueError(f"unknown op {op!r}")

    def is_read(self, op: Tuple) -> bool:
        return op[0] == "get"

    def snapshot(self) -> Any:
        return copy.deepcopy(self.data)

    def restore(self, snap: Any) -> None:
        self.data = copy.deepcopy(snap)


class Register(StateMachine):
    """Single register - the object used in the linearizability proofs."""

    def __init__(self, initial: Any = None) -> None:
        self.value = initial

    def apply(self, op: Tuple) -> Any:
        if op[0] == "w":
            self.value = op[1]
            return "ok"
        if op[0] == "r":
            return self.value
        raise ValueError(f"unknown op {op!r}")

    def is_read(self, op: Tuple) -> bool:
        return op[0] == "r"

    def snapshot(self) -> Any:
        return self.value

    def restore(self, snap: Any) -> None:
        self.value = snap


class AppendLog(StateMachine):
    """An append-only log; handy for checking total-order properties."""

    def __init__(self) -> None:
        self.log: List[Any] = []

    def apply(self, op: Tuple) -> Any:
        if op[0] == "append":
            self.log.append(op[1])
            return len(self.log) - 1
        if op[0] == "read":
            return tuple(self.log)
        raise ValueError(f"unknown op {op!r}")

    def is_read(self, op: Tuple) -> bool:
        return op[0] == "read"

    def snapshot(self) -> Any:
        return list(self.log)

    def restore(self, snap: Any) -> None:
        self.log = list(snap)


def make_state_machine(kind: str) -> StateMachine:
    if kind == "kv":
        return KVStore()
    if kind == "register":
        return Register()
    if kind == "appendlog":
        return AppendLog()
    raise ValueError(f"unknown state machine {kind!r}")

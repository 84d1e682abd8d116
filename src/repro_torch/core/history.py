"""Operation histories (Herlihy & Wing) recorded during protocol runs.

A history is a sequence of invocation and response events.  The recorder
assigns each operation a unique id; pending operations (no response) stay in
the history, which matters for linearizability checking (the checker may
*extend* the history with responses for pending writes - paper section 3.5).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class Operation:
    op_id: int
    client_id: int
    op: Tuple
    invoke_time: float
    response_time: Optional[float] = None
    result: Any = None
    slot: Optional[int] = None  # log index written to / read from

    @property
    def pending(self) -> bool:
        return self.response_time is None

    @property
    def is_read(self) -> bool:
        return self.op[0] in ("get", "r", "read")


class History:
    def __init__(self) -> None:
        self.ops: List[Operation] = []
        self._next = 0

    def invoke(self, client_id: int, op: Tuple, now: float) -> int:
        op_id = self._next
        self._next += 1
        self.ops.append(Operation(op_id=op_id, client_id=client_id, op=op,
                                  invoke_time=now))
        return op_id

    def respond(self, op_id: int, result: Any, now: float,
                slot: Optional[int] = None) -> None:
        o = self.ops[op_id]
        o.response_time = now
        o.result = result
        o.slot = slot

    # -- views ----------------------------------------------------------------
    def complete(self) -> List[Operation]:
        return [o for o in self.ops if not o.pending]

    def pending(self) -> List[Operation]:
        return [o for o in self.ops if o.pending]

    def client_subhistory(self, client_id: int) -> List[Operation]:
        return [o for o in self.ops if o.client_id == client_id]

    def happens_before(self, a: Operation, b: Operation) -> bool:
        """a <_H b iff a's response precedes b's invocation (real time)."""
        return (a.response_time is not None
                and a.response_time < b.invoke_time)

    def __len__(self) -> int:
        return len(self.ops)

    def __iter__(self):
        return iter(self.ops)

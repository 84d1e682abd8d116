"""Quorum systems: majority quorums and r x w acceptor grids.

Compartmentalization 2 (paper section 3.2) decouples *read* quorums from
*write* quorums using flexible quorums [Howard et al., OPODIS 2016]: the only
requirement for safety is that every read quorum intersects every write
quorum.  Arranging the ``r * w`` acceptors in an ``r x w`` grid and taking
rows as read quorums and columns as write quorums satisfies this: every row
crosses every column.

- each acceptor handles ``1/w`` of writes  (scale writes: add columns)
- each acceptor handles ``1/r`` of reads   (scale reads:  add rows)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, List, Sequence, Tuple


class QuorumSystem:
    """Abstract quorum system over acceptor ids ``0..n-1``."""

    n: int

    def read_quorums(self) -> List[FrozenSet[int]]:
        raise NotImplementedError

    def write_quorums(self) -> List[FrozenSet[int]]:
        raise NotImplementedError

    def is_read_quorum(self, acks: Sequence[int]) -> bool:
        s = set(acks)
        return any(q <= s for q in self.read_quorums())

    def is_write_quorum(self, acks: Sequence[int]) -> bool:
        s = set(acks)
        return any(q <= s for q in self.write_quorums())

    def validate(self) -> None:
        """Safety: every read quorum intersects every write quorum."""
        for rq in self.read_quorums():
            for wq in self.write_quorums():
                if not (rq & wq):
                    raise AssertionError(
                        f"read quorum {sorted(rq)} does not intersect "
                        f"write quorum {sorted(wq)}"
                    )

    # -- load accounting used by the analytical model ----------------------
    def write_load(self) -> float:
        """Fraction of writes the busiest acceptor must process (one thrifty
        write quorum chosen uniformly at random per write)."""
        wqs = self.write_quorums()
        per = [0.0] * self.n
        for q in wqs:
            for a in q:
                per[a] += 1.0 / len(wqs)
        return max(per)

    def read_load(self) -> float:
        rqs = self.read_quorums()
        per = [0.0] * self.n
        for q in rqs:
            for a in q:
                per[a] += 1.0 / len(rqs)
        return max(per)


@dataclass(frozen=True)
class MajorityQuorums(QuorumSystem):
    """Classic 2f+1 majority quorums (reads == writes == any majority)."""

    f: int

    @property
    def n(self) -> int:  # type: ignore[override]
        return 2 * self.f + 1

    def _majorities(self) -> List[FrozenSet[int]]:
        from itertools import combinations

        k = self.f + 1
        return [frozenset(c) for c in combinations(range(self.n), k)]

    def read_quorums(self) -> List[FrozenSet[int]]:
        return self._majorities()

    def write_quorums(self) -> List[FrozenSet[int]]:
        return self._majorities()


@dataclass(frozen=True)
class GridQuorums(QuorumSystem):
    """``rows x cols`` acceptor grid; rows read, columns write.

    Acceptor ids are row-major: acceptor (i, j) has id ``i * cols + j``.
    Requires rows >= f+1 and cols >= f+1 so that an entire row (column) of
    failures can be tolerated on the opposite axis.
    """

    rows: int
    cols: int

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.rows * self.cols

    def acceptor_id(self, row: int, col: int) -> int:
        return row * self.cols + col

    def row_members(self, row: int) -> FrozenSet[int]:
        return frozenset(self.acceptor_id(row, j) for j in range(self.cols))

    def col_members(self, col: int) -> FrozenSet[int]:
        return frozenset(self.acceptor_id(i, col) for i in range(self.rows))

    def read_quorums(self) -> List[FrozenSet[int]]:
        return [self.row_members(i) for i in range(self.rows)]

    def write_quorums(self) -> List[FrozenSet[int]]:
        return [self.col_members(j) for j in range(self.cols)]

    def tolerates(self, f: int) -> bool:
        """With any f acceptors down there must remain one live read quorum
        *or* recovery path; the paper requires rows, cols >= f+1 so that f
        failures cannot kill every row nor every column."""
        return self.rows >= f + 1 and self.cols >= f + 1


def pick_write_quorum(
    system: QuorumSystem, rng_value: int, dead: FrozenSet[int] = frozenset()
) -> Tuple[int, FrozenSet[int]]:
    """Thrifty write-quorum selection: deterministic in ``rng_value``.

    Skips quorums containing known-dead acceptors; raises if none is live.
    Returns (index, members).
    """
    wqs = system.write_quorums()
    k = len(wqs)
    for off in range(k):
        idx = (rng_value + off) % k
        if not (wqs[idx] & dead):
            return idx, wqs[idx]
    raise RuntimeError("no live write quorum")


def pick_read_quorum(
    system: QuorumSystem, rng_value: int, dead: FrozenSet[int] = frozenset()
) -> Tuple[int, FrozenSet[int]]:
    rqs = system.read_quorums()
    k = len(rqs)
    for off in range(k):
        idx = (rng_value + off) % k
        if not (rqs[idx] & dead):
            return idx, rqs[idx]
    raise RuntimeError("no live read quorum")

"""Protocol messages for compartmentalized state machine replication.

Every message is a frozen dataclass.  Messages are exchanged between *roles*
(leader, proxy leader, acceptor, replica, batcher, unbatcher, disseminator,
stabilizer, chain node, client) through the deterministic in-process network
in :mod:`repro.core.cluster`.

Naming follows the paper (Whittaker et al., "Scaling Replicated State
Machines with Compartmentalization"): Phase1a/Phase1b/Phase2a/Phase2b,
Preread/PrereadAck, Read, Chosen, etc.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

# ---------------------------------------------------------------------------
# Commands
# ---------------------------------------------------------------------------

NOOP = "__noop__"


@dataclass(frozen=True)
class Command:
    """A state machine command proposed by a client.

    ``op`` is interpreted by the state machine (see ``statemachine.py``).
    ``client_id``/``client_seq`` make the command globally unique and let
    replicas route replies.  ``is_read`` marks commands that do not modify
    state (used by the leaderless read path - reads never enter the log).
    """

    client_id: int
    client_seq: int
    op: Any
    is_read: bool = False

    @property
    def uid(self) -> Tuple[int, int]:
        return (self.client_id, self.client_seq)


def noop_command() -> Command:
    return Command(client_id=-1, client_seq=-1, op=(NOOP,))


def is_noop(cmd: Command) -> bool:
    return isinstance(cmd.op, tuple) and len(cmd.op) > 0 and cmd.op[0] == NOOP


@dataclass(frozen=True)
class Batch:
    """A batch of commands formed by a batcher (compartmentalization 5)."""

    batcher_id: int
    batch_seq: int
    commands: Tuple[Command, ...]

    @property
    def uid(self) -> Tuple[int, int]:
        return (self.batcher_id, self.batch_seq)


# ---------------------------------------------------------------------------
# Client <-> protocol
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClientRequest:
    command: Command


@dataclass(frozen=True)
class ClientReply:
    command_uid: Tuple[int, int]
    result: Any
    slot: Optional[int] = None  # log index the op wrote to / read from


@dataclass(frozen=True)
class ReadRequest:
    """A linearizable read issued directly to the acceptors + a replica."""

    command: Command


# ---------------------------------------------------------------------------
# Paxos phases
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Phase1a:
    ballot: int
    # First slot the (new) leader needs information about.
    from_slot: int = 0


@dataclass(frozen=True)
class PhaseVote:
    """A single (slot, ballot, value) vote held by an acceptor."""

    slot: int
    ballot: int
    value: Any  # Command | Batch


@dataclass(frozen=True)
class Phase1b:
    ballot: int
    acceptor_id: int
    votes: Tuple[PhaseVote, ...]


@dataclass(frozen=True)
class Phase2a:
    slot: int
    ballot: int
    value: Any  # Command | Batch
    # Mencius: leaders stamp their id so acceptors can track per-leader
    # progress; -1 for plain MultiPaxos.
    leader_id: int = -1


@dataclass(frozen=True)
class Phase2b:
    slot: int
    ballot: int
    acceptor_id: int


@dataclass(frozen=True)
class Phase2aRange:
    """Mencius skip: choose noops in every ``owner``-owned slot in
    [start, stop).  Stands in for Coordinated Paxos (paper section 6.1)."""

    ballot: int
    owner: int
    start: int
    stop: int
    n_leaders: int


@dataclass(frozen=True)
class Phase2bRange:
    ballot: int
    owner: int
    start: int
    stop: int
    acceptor_id: int


@dataclass(frozen=True)
class Chosen:
    slot: int
    value: Any  # Command | Batch


@dataclass(frozen=True)
class ChosenRange:
    """Noops chosen in every owner-owned slot in [start, stop)."""

    owner: int
    start: int
    stop: int
    n_leaders: int


# ---------------------------------------------------------------------------
# Leaderless reads (compartmentalization 4, PQR-style)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Preread:
    client_id: int
    read_seq: int


@dataclass(frozen=True)
class PrereadAck:
    client_id: int
    read_seq: int
    acceptor_id: int
    vote_watermark: int  # largest slot this acceptor has voted in (-1 if none)


@dataclass(frozen=True)
class ReplicaRead:
    """Execute read ``command`` after the replica has executed slot
    ``watermark`` (paper: Read<x, i>).  ``consistency`` in
    {"linearizable", "sequential", "eventual"}."""

    command: Command
    watermark: int
    consistency: str = "linearizable"


@dataclass(frozen=True)
class ReadReply:
    command_uid: Tuple[int, int]
    result: Any
    executed_slot: int  # slot the read was served at (client watermark update)


@dataclass(frozen=True)
class ReadBatch:
    """A batch of reads with a single Preread watermark (section 4.1)."""

    commands: Tuple[Command, ...]
    watermark: int


# ---------------------------------------------------------------------------
# Batching (compartmentalizations 5 + 6)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResultBatch:
    """Batch of results sent replica -> unbatcher (compartmentalization 6)."""

    replies: Tuple[ClientReply, ...]


# ---------------------------------------------------------------------------
# Mencius coordination
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NextSlotAnnounce:
    """Leaders periodically broadcast their next unused slot so lagging
    leaders can fill their vacant slots with noops."""

    leader_id: int
    next_slot: int


# ---------------------------------------------------------------------------
# S-Paxos dissemination
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Disseminate:
    cmd_id: Tuple[int, int]  # (disseminator_id, seq)
    command: Command


@dataclass(frozen=True)
class StabilizeAck:
    cmd_id: Tuple[int, int]
    stabilizer_id: int


@dataclass(frozen=True)
class ProposeId:
    """Disseminator -> leader: order this (stable) command id."""

    cmd_id: Tuple[int, int]


@dataclass(frozen=True)
class IdChosen:
    """Leader/proxy-leader -> stabilizer: cmd_id chosen in slot."""

    slot: int
    cmd_id: Tuple[int, int]


@dataclass(frozen=True)
class FetchCommand:
    cmd_id: Tuple[int, int]
    requester: str


@dataclass(frozen=True)
class FetchReply:
    cmd_id: Tuple[int, int]
    command: Optional[Command]


# ---------------------------------------------------------------------------
# Chain replication / CRAQ
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChainWrite:
    command: Command
    version: int = -1  # assigned by the head


@dataclass(frozen=True)
class ChainAck:
    key: Any
    version: int


@dataclass(frozen=True)
class ChainRead:
    command: Command


@dataclass(frozen=True)
class VersionQuery:
    """CRAQ: a node with a dirty key forwards the read to the tail."""

    command: Command
    origin: str


# ---------------------------------------------------------------------------
# Timers / control
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Timer:
    name: str
    payload: Any = None


@dataclass(frozen=True)
class Heartbeat:
    sender: str
    seq: int


def clone(msg, **changes):
    return dataclasses.replace(msg, **changes)

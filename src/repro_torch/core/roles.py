"""Compartmentalized MultiPaxos roles (paper sections 2-4).

The six compartmentalizations are realised as distinct role classes wired
together by :class:`repro.core.protocols.CompartmentalizedMultiPaxos`:

  1. proxy leaders      - ``ProxyLeader``       (decouple seq. / broadcast)
  2. acceptor grids     - ``Acceptor`` + ``GridQuorums``
  3. more replicas      - ``Replica`` (round-robin reply ownership)
  4. leaderless reads   - ``Client`` Preread path + ``Replica`` watermarks
  5. batchers           - ``Batcher``
  6. unbatchers         - ``Unbatcher``

Vanilla MultiPaxos is the same code with ``self_broadcast=True`` (the leader
does its own proxy work), majority quorums, and f+1 replicas.
"""
from __future__ import annotations

import random
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .cluster import Node
from .messages import (
    Batch,
    Chosen,
    ChosenRange,
    ClientReply,
    ClientRequest,
    Command,
    Heartbeat,
    NextSlotAnnounce,
    Phase1a,
    Phase1b,
    Phase2a,
    Phase2aRange,
    Phase2b,
    Phase2bRange,
    PhaseVote,
    Preread,
    PrereadAck,
    ReadBatch,
    ReadReply,
    ReplicaRead,
    ResultBatch,
    Timer,
    is_noop,
    noop_command,
)
from .quorums import QuorumSystem, pick_read_quorum, pick_write_quorum
from .statemachine import StateMachine

MAX_LEADERS = 64  # ballot = round * MAX_LEADERS + leader_index


# ---------------------------------------------------------------------------
# Leader
# ---------------------------------------------------------------------------


class Leader(Node):
    """Sequences commands into the log (compartmentalization 1: the leader's
    *only* job in the compartmentalized protocol).

    ``self_broadcast=True`` recovers vanilla MultiPaxos: the leader plays the
    proxy-leader role itself (Phase 2 broadcast + quorum counting).
    """

    HEARTBEAT_PERIOD = 25.0
    HEARTBEAT_MISSES = 4  # promote after this many silent periods

    def __init__(
        self,
        addr: str,
        leader_index: int,
        acceptors: Sequence[str],
        quorums: QuorumSystem,
        proxies: Sequence[str],
        replicas: Sequence[str],
        self_broadcast: bool = False,
        seed: int = 0,
        peers: Sequence[str] = (),
        auto_failover: bool = False,
        heartbeat_budget: int = 10_000,
    ) -> None:
        super().__init__(addr)
        self.leader_index = leader_index
        self.acceptors = list(acceptors)
        self.quorums = quorums
        self.proxies = list(proxies)
        self.replicas = list(replicas)
        self.self_broadcast = self_broadcast
        self.rng = random.Random(seed * 7919 + leader_index)
        # automatic failover (deterministic heartbeat timers).  NOTE: an
        # auto_failover deployment never quiesces (the tick timer
        # self-reschedules); drive it with net.run(until=T) windows.  The
        # budget is a backstop so a runaway test cannot loop forever.
        self.peers = [p for p in peers if p != addr]
        self.auto_failover = auto_failover
        self.heartbeat_budget = heartbeat_budget
        self.last_heartbeat: float = 0.0
        self._hb_seq = 0

        self.active = False
        self.round = 0
        self.ballot = leader_index
        self.next_slot = 0
        # client request buffering before phase-1 completes
        self.buffer: List[Tuple[str, ClientRequest]] = []
        # dedup: command uid -> slot
        self.assigned: Dict[Tuple[int, int], int] = {}
        self.proposals: Dict[int, Any] = {}  # slot -> value (for re-send)
        # phase 1 state
        self.p1_acks: Dict[int, Phase1b] = {}
        self.p1_quorum: FrozenSet[int] = frozenset()
        self._proxy_rr = 0
        # self-broadcast (vanilla) phase-2 state: slot -> (ballot, value, acks)
        self.pending2: Dict[int, Tuple[int, Any, Set[int]]] = {}

    # -- heartbeats / failure detection ---------------------------------------
    def start_failure_detector(self) -> None:
        """Arm heartbeat emission (active leader) / monitoring (followers)."""
        if not self.auto_failover:
            return
        self.last_heartbeat = self.now
        self.set_timer("hb_tick", self.HEARTBEAT_PERIOD)

    def _on_hb_tick(self) -> None:
        if self.heartbeat_budget <= 0:
            return
        self.heartbeat_budget -= 1
        if self.active:
            self._hb_seq += 1
            for p in self.peers:
                self.send(p, Heartbeat(sender=self.addr, seq=self._hb_seq))
        else:
            silent = self.now - self.last_heartbeat
            if silent > self.HEARTBEAT_PERIOD * self.HEARTBEAT_MISSES:
                # deterministic stagger: lower index promotes first
                delay = self.leader_index * self.HEARTBEAT_PERIOD
                self.set_timer("hb_promote", delay)
        self.set_timer("hb_tick", self.HEARTBEAT_PERIOD)

    # -- leadership ----------------------------------------------------------
    def become_leader(self) -> None:
        """Run Phase 1 over a read quorum and take over the log."""
        self.round += 1
        self.ballot = self.round * MAX_LEADERS + self.leader_index
        self.active = False
        self.p1_acks = {}
        idx, members = pick_read_quorum(self.quorums, self.rng.randrange(1 << 30))
        self.p1_quorum = members
        for a in members:
            self.send(self.acceptors[a], Phase1a(ballot=self.ballot, from_slot=0))
        self.set_timer("phase1_retry", 50.0, self.ballot)

    def _finish_phase1(self) -> None:
        # Merge votes: per slot, adopt the highest-ballot vote.
        best: Dict[int, Tuple[int, Any]] = {}
        for ack in self.p1_acks.values():
            for v in ack.votes:
                cur = best.get(v.slot)
                if cur is None or v.ballot > cur[0]:
                    best[v.slot] = (v.ballot, v.value)
        max_slot = max(best.keys(), default=-1)
        # Re-propose adopted values; fill holes with noops.
        for slot in range(0, max_slot + 1):
            value = best[slot][1] if slot in best else noop_command()
            self._propose(slot, value)
        self.next_slot = max_slot + 1
        self.active = True
        buffered, self.buffer = self.buffer, []
        for src, req in buffered:
            self.on_message(src, req)

    # -- sequencing ------------------------------------------------------------
    def _propose(self, slot: int, value: Any) -> None:
        self.proposals[slot] = value
        msg = Phase2a(slot=slot, ballot=self.ballot, value=value,
                      leader_id=self.leader_index)
        if self.self_broadcast:
            self._broadcast_phase2a(msg)
        else:
            proxy = self.proxies[self._proxy_rr % len(self.proxies)]
            self._proxy_rr += 1
            self.send(proxy, msg)

    def _broadcast_phase2a(self, msg: Phase2a) -> None:
        _, members = pick_write_quorum(self.quorums, self.rng.randrange(1 << 30))
        self.pending2[msg.slot] = (msg.ballot, msg.value, set())
        for a in members:
            self.send(self.acceptors[a], msg)

    # -- message handling ---------------------------------------------------------
    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ClientRequest):
            if not self.active:
                self.buffer.append((src, msg))
                return
            uid = msg.command.uid
            if uid in self.assigned:  # client retry: re-propose same slot
                slot = self.assigned[uid]
                self._propose(slot, self.proposals[slot])
                return
            slot = self.next_slot
            self.next_slot += 1
            self.assigned[uid] = slot
            self._propose(slot, msg.command)
        elif isinstance(msg, Batch):
            if not self.active:
                self.buffer.append((src, ClientRequest(msg)))  # type: ignore
                return
            slot = self.next_slot
            self.next_slot += 1
            self._propose(slot, msg)
        elif isinstance(msg, Phase1b):
            if msg.ballot != self.ballot or self.active:
                return
            self.p1_acks[msg.acceptor_id] = msg
            if self.p1_quorum <= set(self.p1_acks.keys()):
                self._finish_phase1()
        elif isinstance(msg, Phase2b):
            # only in self_broadcast mode
            entry = self.pending2.get(msg.slot)
            if entry is None or entry[0] != msg.ballot:
                return
            ballot, value, acks = entry
            acks.add(msg.acceptor_id)
            if self.quorums.is_write_quorum(acks):
                del self.pending2[msg.slot]
                for r in self.replicas:
                    self.send(r, Chosen(slot=msg.slot, value=value))
        elif isinstance(msg, Heartbeat):
            self.last_heartbeat = self.now
        elif isinstance(msg, Timer):
            if msg.name == "phase1_retry" and msg.payload == self.ballot and not self.active:
                self.become_leader()
            elif msg.name == "hb_tick":
                self._on_hb_tick()
            elif msg.name == "hb_promote":
                # promote only if still silent (another leader may have won)
                if (not self.active and self.now - self.last_heartbeat
                        > self.HEARTBEAT_PERIOD * self.HEARTBEAT_MISSES):
                    self.become_leader()

    def on_crash(self) -> None:
        self.active = False


# ---------------------------------------------------------------------------
# Proxy leader (compartmentalization 1)
# ---------------------------------------------------------------------------


class ProxyLeader(Node):
    """Broadcasts Phase2a messages, counts Phase2b votes, notifies replicas.

    Embarrassingly parallel: any number of proxy leaders can run side by
    side; the leader load-balances across them round-robin.
    """

    RETRY = 40.0

    def __init__(
        self,
        addr: str,
        acceptors: Sequence[str],
        quorums: QuorumSystem,
        replicas: Sequence[str],
        seed: int = 0,
        notify_extra: Sequence[str] = (),
    ) -> None:
        super().__init__(addr)
        self.acceptors = list(acceptors)
        self.quorums = quorums
        self.replicas = list(replicas)
        self.rng = random.Random(seed * 104729 + hash(addr) % 65536)
        # slot -> (ballot, value, acks, done)
        self.pending: Dict[int, Tuple[int, Any, Set[int]]] = {}
        self.done: Set[int] = set()
        self.notify_extra = list(notify_extra)  # e.g. S-Paxos stabilizers
        # Mencius skip ranges: (owner, start, stop) -> (ballot, n_leaders, acks)
        self.pending_ranges: Dict[Tuple[int, int, int], Tuple[int, int, Set[int]]] = {}

    def _notify_chosen(self, msg: Chosen | ChosenRange) -> None:
        for r in self.replicas:
            self.send(r, msg)
        for extra in self.notify_extra:
            self.send(extra, msg)

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, Phase2a):
            if msg.slot in self.done:
                return
            _, members = pick_write_quorum(self.quorums, self.rng.randrange(1 << 30))
            self.pending[msg.slot] = (msg.ballot, msg.value, set())
            for a in members:
                self.send(self.acceptors[a], msg)
            self.set_timer("p2_retry", self.RETRY, msg)
        elif isinstance(msg, Phase2b):
            entry = self.pending.get(msg.slot)
            if entry is None or entry[0] != msg.ballot:
                return
            ballot, value, acks = entry
            acks.add(msg.acceptor_id)
            if self.quorums.is_write_quorum(acks):
                del self.pending[msg.slot]
                self.done.add(msg.slot)
                self._notify_chosen(Chosen(slot=msg.slot, value=value))
        elif isinstance(msg, Phase2aRange):
            key = (msg.owner, msg.start, msg.stop)
            _, members = pick_write_quorum(self.quorums, self.rng.randrange(1 << 30))
            self.pending_ranges[key] = (msg.ballot, msg.n_leaders, set())
            for a in members:
                self.send(self.acceptors[a], msg)
        elif isinstance(msg, Phase2bRange):
            key = (msg.owner, msg.start, msg.stop)
            entry = self.pending_ranges.get(key)
            if entry is None or entry[0] != msg.ballot:
                return
            ballot, n_leaders, acks = entry
            acks.add(msg.acceptor_id)
            if self.quorums.is_write_quorum(acks):
                del self.pending_ranges[key]
                self._notify_chosen(ChosenRange(owner=msg.owner, start=msg.start,
                                                stop=msg.stop, n_leaders=n_leaders))
        elif isinstance(msg, Timer) and msg.name == "p2_retry":
            p2a = msg.payload
            entry = self.pending.get(p2a.slot)
            if entry is None or entry[0] != p2a.ballot:
                return
            # Retry non-thriftily: broadcast to *all* acceptors so any live
            # write quorum can form (tolerates acceptor failures).
            for a_addr in self.acceptors:
                self.send(a_addr, p2a)
            self.set_timer("p2_retry", self.RETRY, p2a)


# ---------------------------------------------------------------------------
# Acceptor (compartmentalization 2: arranged in grids)
# ---------------------------------------------------------------------------


class Acceptor(Node):
    """Paxos acceptor.

    Promises are tracked per *lane* (Mencius: each leader owns an independent
    ballot space for its slots) plus one global promise raised by Phase1a
    (MultiPaxos leader failover).  A Phase2a in lane ``l`` succeeds iff its
    ballot >= max(global promise, lane-l promise); plain MultiPaxos uses a
    single lane so this degenerates to the textbook acceptor.
    """

    def __init__(self, addr: str, acceptor_id: int) -> None:
        super().__init__(addr)
        self.acceptor_id = acceptor_id
        self.promised = -1  # global promise (Phase 1)
        self.lane_promised: Dict[int, int] = {}  # leader lane -> promise
        self.votes: Dict[int, Tuple[int, Any]] = {}  # slot -> (ballot, value)
        self.vote_watermark = -1  # largest slot voted in (paper: w_i)

    def _lane_floor(self, lane: int) -> int:
        return max(self.promised, self.lane_promised.get(lane, -1))

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, Phase1a):
            if msg.ballot > self.promised:
                self.promised = msg.ballot
            votes = tuple(
                PhaseVote(slot=s, ballot=b, value=v)
                for s, (b, v) in sorted(self.votes.items())
                if s >= msg.from_slot
            )
            self.send(src, Phase1b(ballot=self.promised, acceptor_id=self.acceptor_id,
                                   votes=votes))
        elif isinstance(msg, Phase2a):
            if msg.ballot >= self._lane_floor(msg.leader_id):
                self.lane_promised[msg.leader_id] = msg.ballot
                self.votes[msg.slot] = (msg.ballot, msg.value)
                if msg.slot > self.vote_watermark:
                    self.vote_watermark = msg.slot
                self.send(src, Phase2b(slot=msg.slot, ballot=msg.ballot,
                                       acceptor_id=self.acceptor_id))
        elif isinstance(msg, Phase2aRange):
            if msg.ballot >= self._lane_floor(msg.owner):
                self.lane_promised[msg.owner] = msg.ballot
                noop = noop_command()
                for slot in range(msg.start, msg.stop):
                    if slot % msg.n_leaders == msg.owner and slot not in self.votes:
                        self.votes[slot] = (msg.ballot, noop)
                        if slot > self.vote_watermark:
                            self.vote_watermark = slot
                self.send(src, Phase2bRange(ballot=msg.ballot, owner=msg.owner,
                                            start=msg.start, stop=msg.stop,
                                            acceptor_id=self.acceptor_id))
        elif isinstance(msg, Preread):
            self.send(src, PrereadAck(client_id=msg.client_id, read_seq=msg.read_seq,
                                      acceptor_id=self.acceptor_id,
                                      vote_watermark=self.vote_watermark))


# ---------------------------------------------------------------------------
# Replica (compartmentalizations 3, 4, 6)
# ---------------------------------------------------------------------------


class Replica(Node):
    """Executes the log in prefix order.

    * Replies only for slots it owns (slot % n == index) - comp. 3.
    * Serves watermarked reads without touching the leader - comp. 4.
    * Ships result batches to unbatchers - comp. 6.
    """

    def __init__(
        self,
        addr: str,
        replica_index: int,
        n_replicas: int,
        state_machine: StateMachine,
        client_addr_fn=lambda cid: f"client/{cid}",
        unbatchers: Sequence[str] = (),
        seed: int = 0,
    ) -> None:
        super().__init__(addr)
        self.replica_index = replica_index
        self.n_replicas = n_replicas
        self.sm = state_machine
        self.client_addr_fn = client_addr_fn
        self.unbatchers = list(unbatchers)
        self.rng = random.Random(seed * 6151 + replica_index)

        self.log: Dict[int, Any] = {}
        self.executed_upto = -1  # highest contiguously executed slot
        # exactly-once execution: client_id -> (last_seq, last_result)
        self.client_table: Dict[int, Tuple[int, Any]] = {}
        # reads waiting for the log to reach their watermark
        self.pending_reads: List[Tuple[int, str, Any]] = []
        self.executed_count = 0

    # -- execution ---------------------------------------------------------
    def _apply_command(self, cmd: Command) -> Optional[ClientReply]:
        if is_noop(cmd):
            return None
        last = self.client_table.get(cmd.client_id)
        if last is not None and cmd.client_seq <= last[0]:
            result = last[1] if cmd.client_seq == last[0] else None
        else:
            result = self.sm.apply_checked(cmd.op)
            self.client_table[cmd.client_id] = (cmd.client_seq, result)
        self.executed_count += 1
        return ClientReply(command_uid=cmd.uid, result=result, slot=self.executed_upto)

    def _execute_ready(self) -> None:
        while (self.executed_upto + 1) in self.log:
            slot = self.executed_upto + 1
            value = self.log[slot]
            self.executed_upto = slot
            owner = slot % self.n_replicas == self.replica_index
            if isinstance(value, Batch):
                replies = []
                for cmd in value.commands:
                    r = self._apply_command(cmd)
                    if r is not None:
                        replies.append(r)
                if owner and replies:
                    self._send_results(tuple(replies))
            else:
                r = self._apply_command(value)
                if owner and r is not None:
                    self.send(self.client_addr_fn(value.client_id), r)
        self._serve_pending_reads()

    def _send_results(self, replies: Tuple[ClientReply, ...]) -> None:
        if self.unbatchers:
            ub = self.unbatchers[self.rng.randrange(len(self.unbatchers))]
            self.send(ub, ResultBatch(replies=replies))
        else:
            for r in replies:
                self.send(self.client_addr_fn(r.command_uid[0]), r)

    # -- reads ---------------------------------------------------------------
    def _serve_read(self, src: str, msg: Any) -> None:
        if isinstance(msg, ReadBatch):
            replies = []
            for cmd in msg.commands:
                result = self.sm.apply_checked(cmd.op)
                replies.append(ClientReply(command_uid=cmd.uid, result=result,
                                           slot=self.executed_upto))
            self._send_results(tuple(replies))
        else:
            result = self.sm.apply_checked(msg.command.op)
            self.send(src, ReadReply(command_uid=msg.command.uid, result=result,
                                     executed_slot=self.executed_upto))

    def _serve_pending_reads(self) -> None:
        still = []
        for watermark, src, msg in self.pending_reads:
            if self.executed_upto >= watermark:
                self._serve_read(src, msg)
            else:
                still.append((watermark, src, msg))
        self.pending_reads = still

    # -- messages ---------------------------------------------------------------
    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, Chosen):
            if msg.slot not in self.log:
                self.log[msg.slot] = msg.value
                self._execute_ready()
        elif isinstance(msg, ChosenRange):
            noop = noop_command()
            for slot in range(msg.start, msg.stop):
                if slot % msg.n_leaders == msg.owner and slot not in self.log:
                    self.log[slot] = noop
            self._execute_ready()
        elif isinstance(msg, (ReplicaRead, ReadBatch)):
            consistency = getattr(msg, "consistency", "linearizable")
            if consistency == "eventual" or self.executed_upto >= msg.watermark:
                self._serve_read(src, msg)
            else:
                self.pending_reads.append((msg.watermark, src, msg))


# ---------------------------------------------------------------------------
# Batcher / Unbatcher (compartmentalizations 5 + 6)
# ---------------------------------------------------------------------------


class Batcher(Node):
    """Forms command batches; forwards them to the leader.  Read batches get
    a single Preread watermark and go straight to a replica (section 4.1)."""

    FLUSH_AFTER = 5.0

    def __init__(
        self,
        addr: str,
        batcher_id: int,
        leader: str,
        batch_size: int,
        acceptors: Sequence[str] = (),
        quorums: Optional[QuorumSystem] = None,
        replicas: Sequence[str] = (),
        seed: int = 0,
    ) -> None:
        super().__init__(addr)
        self.batcher_id = batcher_id
        self.leader = leader
        self.batch_size = batch_size
        self.acceptors = list(acceptors)
        self.quorums = quorums
        self.replicas = list(replicas)
        self.rng = random.Random(seed * 31 + batcher_id)

        self.writes: List[Command] = []
        self.reads: List[Command] = []
        self.batch_seq = 0
        self._timer_set = False
        # read-batch preread state: seq -> (commands, acks {aid: wm}, quorum)
        self.preread_seq = 0
        self.prereads: Dict[int, Tuple[Tuple[Command, ...], Dict[int, int], FrozenSet[int]]] = {}

    def _flush_writes(self) -> None:
        if not self.writes:
            return
        cmds, self.writes = tuple(self.writes), []
        self.send(self.leader, Batch(batcher_id=self.batcher_id,
                                     batch_seq=self.batch_seq, commands=cmds))
        self.batch_seq += 1

    def _flush_reads(self) -> None:
        if not self.reads or self.quorums is None:
            return
        cmds, self.reads = tuple(self.reads), []
        seq = self.preread_seq
        self.preread_seq += 1
        _, members = pick_read_quorum(self.quorums, self.rng.randrange(1 << 30))
        self.prereads[seq] = (cmds, {}, members)
        for a in members:
            self.send(self.acceptors[a], Preread(client_id=-(self.batcher_id + 1),
                                                 read_seq=seq))

    def _maybe_flush(self) -> None:
        if len(self.writes) >= self.batch_size:
            self._flush_writes()
        if len(self.reads) >= self.batch_size:
            self._flush_reads()
        if (self.writes or self.reads) and not self._timer_set:
            self._timer_set = True
            self.set_timer("flush", self.FLUSH_AFTER)

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ClientRequest):
            cmd = msg.command
            (self.reads if cmd.is_read else self.writes).append(cmd)
            self._maybe_flush()
        elif isinstance(msg, PrereadAck):
            entry = self.prereads.get(msg.read_seq)
            if entry is None:
                return
            cmds, acks, members = entry
            acks[msg.acceptor_id] = msg.vote_watermark
            if members <= set(acks.keys()):
                del self.prereads[msg.read_seq]
                watermark = max(acks.values(), default=-1)
                replica = self.replicas[self.rng.randrange(len(self.replicas))]
                self.send(replica, ReadBatch(commands=cmds, watermark=watermark))
        elif isinstance(msg, Timer) and msg.name == "flush":
            self._timer_set = False
            self._flush_writes()
            self._flush_reads()


class Unbatcher(Node):
    """Fans a replica's result batch back out to the clients."""

    def __init__(self, addr: str, client_addr_fn=lambda cid: f"client/{cid}") -> None:
        super().__init__(addr)
        self.client_addr_fn = client_addr_fn

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ResultBatch):
            for reply in msg.replies:
                self.send(self.client_addr_fn(reply.command_uid[0]), reply)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class Client(Node):
    """Closed-loop client driving a scripted workload and recording a history
    for the linearizability checker.

    Writes go to the leader (or a random batcher).  Reads follow the paper's
    three consistency modes:

      linearizable : Preread to a read quorum -> max vote watermark ->
                     Read<x, i> at one replica  (section 3.4)
      sequential   : Read<x, w_client> at one replica (section 3.6)
      eventual     : Read<x> at one replica, executed immediately
    """

    RETRY = 400.0

    def __init__(
        self,
        addr: str,
        client_id: int,
        leader: str,
        acceptors: Sequence[str],
        quorums: QuorumSystem,
        replicas: Sequence[str],
        batchers: Sequence[str] = (),
        consistency: str = "linearizable",
        history=None,
        seed: int = 0,
        retries: bool = False,
    ) -> None:
        super().__init__(addr)
        self.client_id = client_id
        self.leader = leader
        self.acceptors = list(acceptors)
        self.quorums = quorums
        self.replicas = list(replicas)
        self.batchers = list(batchers)
        self.consistency = consistency
        self.history = history
        self.rng = random.Random(seed * 2654435761 + client_id)
        self.retries = retries

        self.seq = 0
        self.read_seq = 0
        self.watermark = -1  # sequential-consistency client watermark (w_i)
        self.ops: List[Tuple] = []
        self.op_index = 0
        self.outstanding: Optional[Tuple] = None  # (kind, op, hist_id)
        self.results: List[Any] = []
        # preread state
        self._preread_acks: Dict[int, int] = {}
        self._preread_quorum: FrozenSet[int] = frozenset()
        self._pending_read: Optional[Command] = None

    # -- workload -----------------------------------------------------------
    def run_ops(self, ops: Sequence[Tuple]) -> None:
        """Queue ops; issuing starts on the next network step."""
        self.ops.extend(ops)
        if self.outstanding is None:
            self.set_timer("kick", 0.0)

    def _issue_next(self) -> None:
        if self.op_index >= len(self.ops):
            self.outstanding = None
            return
        op = self.ops[self.op_index]
        self.op_index += 1
        is_read = self._op_is_read(op)
        hist_id = None
        if self.history is not None:
            hist_id = self.history.invoke(self.client_id, op, self.now)
        if is_read and self.consistency in ("sequential", "eventual") and self.replicas:
            cmd = Command(self.client_id, self.seq, op, is_read=True)
            self.seq += 1
            self.outstanding = ("read", cmd, hist_id)
            wm = self.watermark if self.consistency == "sequential" else -1
            replica = self.replicas[self.rng.randrange(len(self.replicas))]
            self.send(replica, ReplicaRead(command=cmd, watermark=wm,
                                           consistency=self.consistency))
        elif is_read and not self.batchers and self.acceptors:
            cmd = Command(self.client_id, self.seq, op, is_read=True)
            self.seq += 1
            self.outstanding = ("preread", cmd, hist_id)
            self._start_preread(cmd)
        else:
            cmd = Command(self.client_id, self.seq, op, is_read=is_read)
            self.seq += 1
            self.outstanding = ("write", cmd, hist_id)
            dst = (self.batchers[self.rng.randrange(len(self.batchers))]
                   if self.batchers else self.leader)
            self.send(dst, ClientRequest(command=cmd))
        if self.retries:
            self.set_timer("retry", self.RETRY, self.seq - 1)

    @staticmethod
    def _op_is_read(op: Tuple) -> bool:
        # "infer" is the serving plane's read op (model inference does not
        # modify replica state - paper section 3.4 applies verbatim)
        return op[0] in ("get", "r", "read", "infer", "read_view")

    # -- linearizable read path ------------------------------------------------
    def _start_preread(self, cmd: Command) -> None:
        self.read_seq += 1
        self._preread_acks = {}
        self._pending_read = cmd
        _, members = pick_read_quorum(self.quorums, self.rng.randrange(1 << 30))
        self._preread_quorum = members
        for a in members:
            self.send(self.acceptors[a], Preread(client_id=self.client_id,
                                                 read_seq=self.read_seq))

    # -- messages ---------------------------------------------------------------
    def _complete(self, result: Any, slot: Optional[int]) -> None:
        if self.outstanding is None:
            return
        _, _, hist_id = self.outstanding
        if self.history is not None and hist_id is not None:
            self.history.respond(hist_id, result, self.now, slot=slot)
        if slot is not None and slot > self.watermark:
            self.watermark = slot
        self.results.append(result)
        self.outstanding = None
        self._issue_next()

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ClientReply):
            if (self.outstanding and self.outstanding[0] in ("write", "read")
                    and msg.command_uid == self.outstanding[1].uid):
                self._complete(msg.result, msg.slot)
        elif isinstance(msg, ReadReply):
            if (self.outstanding and self.outstanding[1].uid == msg.command_uid):
                self._complete(msg.result, msg.executed_slot)
        elif isinstance(msg, PrereadAck):
            if (self.outstanding is None or self.outstanding[0] != "preread"
                    or msg.read_seq != self.read_seq):
                return
            self._preread_acks[msg.acceptor_id] = msg.vote_watermark
            if self._preread_quorum <= set(self._preread_acks.keys()):
                watermark = max(self._preread_acks.values(), default=-1)
                cmd = self._pending_read
                assert cmd is not None
                replica = self.replicas[self.rng.randrange(len(self.replicas))]
                self.send(replica, ReplicaRead(command=cmd, watermark=watermark,
                                               consistency="linearizable"))
        elif isinstance(msg, Timer):
            if msg.name == "kick" and self.outstanding is None:
                self._issue_next()
            elif (msg.name == "retry" and self.retries and self.outstanding
                  and msg.payload == self.seq - 1):
                kind, cmd, _ = self.outstanding
                if kind == "write":
                    dst = (self.batchers[self.rng.randrange(len(self.batchers))]
                           if self.batchers else self.leader)
                    self.send(dst, ClientRequest(command=cmd))
                elif kind == "preread":
                    self._start_preread(cmd)
                elif kind == "read":
                    wm = self.watermark if self.consistency == "sequential" else -1
                    replica = self.replicas[self.rng.randrange(len(self.replicas))]
                    self.send(replica, ReplicaRead(command=cmd, watermark=wm,
                                                   consistency=self.consistency))
                self.set_timer("retry", self.RETRY, msg.payload)

    @property
    def done(self) -> bool:
        return self.op_index >= len(self.ops) and self.outstanding is None

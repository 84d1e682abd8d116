"""Compartmentalized S-Paxos (paper section 7).

S-Paxos separates *data flow* from *control flow*: client commands are
persisted on a majority of stabilizers by disseminators, and the MultiPaxos
leader orders only small command *ids*.  The compartmentalized deployment
(paper Fig. 27) adds proxy leaders, acceptor grids and scaled replicas.

Flow (write):
  client --cmd--> disseminator --cmd--> stabilizers (majority ack)
         disseminator --id--> leader --Phase2a(id)--> proxy --grid--> chosen
         proxy --Chosen(id)--> stabilizer --Chosen(cmd)--> replicas -> client

The leader never touches command payloads - only ids (the paper's point:
the leader stops being a bottleneck on the data path).
"""
from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from .cluster import Network, Node
from .history import History
from .messages import (
    Chosen,
    ClientRequest,
    Command,
    Disseminate,
    FetchCommand,
    FetchReply,
    IdChosen,
    Phase2a,
    Phase2b,
    ProposeId,
    StabilizeAck,
    Timer,
)
from .protocols import BaseDeployment
from .quorums import GridQuorums, MajorityQuorums, QuorumSystem, pick_write_quorum
from .roles import Acceptor, Client, Leader, ProxyLeader, Replica
from .statemachine import make_state_machine


class Disseminator(Node):
    """Assigns ids, persists payloads on a majority of stabilizers, then
    hands the id to the leader for ordering."""

    def __init__(self, addr: str, dis_id: int, stabilizers: Sequence[str],
                 leader: str, seed: int = 0) -> None:
        super().__init__(addr)
        self.dis_id = dis_id
        self.stabilizers = list(stabilizers)
        self.majority = len(self.stabilizers) // 2 + 1
        self.leader = leader
        self.seq = 0
        # cmd_id -> (command, acks)
        self.pending: Dict[Tuple[int, int], Tuple[Command, Set[int]]] = {}
        self.rng = random.Random(seed * 193 + dis_id)

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ClientRequest):
            cmd_id = (self.dis_id, self.seq)
            self.seq += 1
            self.pending[cmd_id] = (msg.command, set())
            for s in self.stabilizers:
                self.send(s, Disseminate(cmd_id=cmd_id, command=msg.command))
        elif isinstance(msg, StabilizeAck):
            entry = self.pending.get(msg.cmd_id)
            if entry is None:
                return
            command, acks = entry
            acks.add(msg.stabilizer_id)
            if len(acks) == self.majority:  # fire exactly once
                self.send(self.leader, ProposeId(cmd_id=msg.cmd_id))


class Stabilizer(Node):
    """Persists command payloads; resolves chosen ids back to payloads and
    notifies the replicas (the data path's final hop)."""

    def __init__(self, addr: str, stab_id: int, peers: Sequence[str],
                 replicas: Sequence[str]) -> None:
        super().__init__(addr)
        self.stab_id = stab_id
        self.peers = [p for p in peers if p != addr]
        self.replicas = list(replicas)
        self.store: Dict[Tuple[int, int], Command] = {}
        # chosen ids whose payload we're still fetching: id -> slot
        self.waiting: Dict[Tuple[int, int], int] = {}

    def _deliver(self, slot: int, command: Command) -> None:
        for r in self.replicas:
            self.send(r, Chosen(slot=slot, value=command))

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, Disseminate):
            self.store[msg.cmd_id] = msg.command
            self.send(src, StabilizeAck(cmd_id=msg.cmd_id, stabilizer_id=self.stab_id))
            # late fetch satisfied locally
            if msg.cmd_id in self.waiting:
                self._deliver(self.waiting.pop(msg.cmd_id), msg.command)
        elif isinstance(msg, Chosen):
            # value is ("id", cmd_id): resolve payload -> replicas
            _, cmd_id = msg.value
            cmd = self.store.get(cmd_id)
            if cmd is not None:
                self._deliver(msg.slot, cmd)
            else:
                self.waiting[cmd_id] = msg.slot
                for p in self.peers:
                    self.send(p, FetchCommand(cmd_id=cmd_id, requester=self.addr))
        elif isinstance(msg, FetchCommand):
            self.send(msg.requester, FetchReply(cmd_id=msg.cmd_id,
                                                command=self.store.get(msg.cmd_id)))
        elif isinstance(msg, FetchReply):
            if msg.command is not None and msg.cmd_id in self.waiting:
                self.store[msg.cmd_id] = msg.command
                self._deliver(self.waiting.pop(msg.cmd_id), msg.command)


class SPaxosProxyLeader(ProxyLeader):
    """Proxy leader that routes Chosen(id) to one stabilizer (round-robin)
    instead of to the replicas - the replicas need payloads, not ids."""

    def __init__(self, addr: str, acceptors: Sequence[str], quorums: QuorumSystem,
                 stabilizers: Sequence[str], seed: int = 0) -> None:
        super().__init__(addr, acceptors, quorums, replicas=[], seed=seed)
        self.stabilizers = list(stabilizers)
        self._stab_rr = 0

    def _notify_chosen(self, msg) -> None:  # type: ignore[override]
        stab = self.stabilizers[self._stab_rr % len(self.stabilizers)]
        self._stab_rr += 1
        self.send(stab, msg)


class SPaxosDeployment(BaseDeployment):
    """Compartmentalized S-Paxos (paper Fig. 27)."""

    def __init__(
        self,
        f: int = 1,
        n_disseminators: int = 2,
        n_stabilizers: int = 3,  # 2f+1
        n_proxy_leaders: int = 3,
        grid: Optional[Tuple[int, int]] = (2, 2),
        n_replicas: int = 3,
        n_clients: int = 2,
        state_machine: str = "kv",
        consistency: str = "linearizable",
        seed: int = 0,
        latency_fn: Optional[Callable[[str, str], float]] = None,
    ) -> None:
        self.net = Network(seed=seed, latency_fn=latency_fn)
        self.history = History()

        if grid is not None:
            self.quorums: QuorumSystem = GridQuorums(rows=grid[0], cols=grid[1])
        else:
            self.quorums = MajorityQuorums(f=f)
        self.quorums.validate()

        self.acceptor_addrs = [f"acceptor/{i}" for i in range(self.quorums.n)]
        self.replica_addrs = [f"replica/{i}" for i in range(n_replicas)]
        self.proxy_addrs = [f"proxy/{i}" for i in range(n_proxy_leaders)]
        self.stab_addrs = [f"stabilizer/{i}" for i in range(n_stabilizers)]
        self.dis_addrs = [f"disseminator/{i}" for i in range(n_disseminators)]
        self.leader_addr = "leader/0"

        self.acceptors = [Acceptor(a, i) for i, a in enumerate(self.acceptor_addrs)]
        self.replicas = [
            Replica(addr, i, n_replicas, make_state_machine(state_machine), seed=seed)
            for i, addr in enumerate(self.replica_addrs)
        ]
        self.stabilizers = [
            Stabilizer(addr, i, self.stab_addrs, self.replica_addrs)
            for i, addr in enumerate(self.stab_addrs)
        ]
        self.proxies = [
            SPaxosProxyLeader(addr, self.acceptor_addrs, self.quorums,
                              self.stab_addrs, seed=seed)
            for addr in self.proxy_addrs
        ]
        self.disseminators = [
            Disseminator(addr, i, self.stab_addrs, self.leader_addr, seed=seed)
            for i, addr in enumerate(self.dis_addrs)
        ]
        self.leader = SPaxosLeader(self.leader_addr, 0, self.acceptor_addrs,
                                   self.quorums, self.proxy_addrs, seed=seed)
        self.clients = [
            Client(f"client/{i}", i, self.dis_addrs[i % n_disseminators],
                   self.acceptor_addrs, self.quorums, self.replica_addrs,
                   consistency=consistency, history=self.history, seed=seed)
            for i in range(n_clients)
        ]
        for group in (self.acceptors, self.replicas, self.stabilizers, self.proxies,
                      self.disseminators, [self.leader], self.clients):
            self.net.add_nodes(group)


class SPaxosLeader(Node):
    """Orders command *ids* only (never payloads)."""

    def __init__(self, addr: str, leader_id: int, acceptors: Sequence[str],
                 quorums: QuorumSystem, proxies: Sequence[str], seed: int = 0) -> None:
        super().__init__(addr)
        self.leader_id = leader_id
        self.quorums = quorums
        self.proxies = list(proxies)
        self.next_slot = 0
        self.ballot = 0
        self._proxy_rr = 0

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ProposeId):
            slot = self.next_slot
            self.next_slot += 1
            proxy = self.proxies[self._proxy_rr % len(self.proxies)]
            self._proxy_rr += 1
            self.send(proxy, Phase2a(slot=slot, ballot=self.ballot,
                                     value=("id", msg.cmd_id),
                                     leader_id=self.leader_id))


# ---------------------------------------------------------------------------
# Vanilla (fused-server) S-Paxos - paper Fig. 26 baseline
# ---------------------------------------------------------------------------


class VanillaSPaxosServer(Replica):
    """One fused vanilla-S-Paxos server: disseminator + stabilizer +
    acceptor + replica in a single process, with the MultiPaxos leader role
    colocated on server 0 - matching the fused accounting of
    ``vanilla_spaxos_model`` (one ``leader`` machine + ``n - 1`` followers
    sharing the dissemination/stabilization/acceptor/reply work uniformly).

    Wire behaviour mirrors the table term by term: ``Disseminate`` and
    ``Chosen`` broadcasts include the sender itself (the model counts
    self-sends - the in-process network accounts them on both sides), the
    leader self-broadcasts Phase 2 to a thrifty majority drawn from *all*
    ``n`` servers, and each server resolves a chosen id from its local
    store and hands the payload to its *local* replica component without a
    message - the one internal hop the table omits.  Total wire messages
    per command equal the table's total exactly; only the quorum draw moves
    acceptor messages between machines.
    """

    def __init__(self, addr: str, server_id: int, n_servers: int, f: int,
                 servers: Sequence[str], state_machine, seed: int = 0) -> None:
        super().__init__(addr, server_id, n_servers, state_machine, seed=seed)
        self.server_id = server_id
        self.n_servers = n_servers
        self.servers = list(servers)  # all n, self included
        self.leader_addr = servers[0]
        self.majority = n_servers // 2 + 1  # = f + 1
        self.role_rng = random.Random(seed * 193 + server_id)
        # disseminator component
        self.seq = 0
        self.dis_pending: Dict[Tuple[int, int], Set[int]] = {}
        # stabilizer component
        self.store: Dict[Tuple[int, int], Command] = {}
        self.waiting: Dict[Tuple[int, int], int] = {}  # cmd_id -> chosen slot
        # leader component (server 0 only)
        self.next_slot = 0
        self.ballot = 0
        self.pending2: Dict[int, Tuple[Tuple[int, int], Set[int]]] = {}

    def _deliver_local(self, slot: int, command: Command) -> None:
        """Payload resolved: hand to the local replica component (free)."""
        if slot not in self.log:
            self.log[slot] = command
            self._execute_ready()

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ClientRequest):  # disseminator: persist payload
            cmd_id = (self.server_id, self.seq)
            self.seq += 1
            self.dis_pending[cmd_id] = set()
            for s in self.servers:  # self included: the model counts it
                self.send(s, Disseminate(cmd_id=cmd_id, command=msg.command))
        elif isinstance(msg, Disseminate):  # stabilizer: store + ack
            self.store[msg.cmd_id] = msg.command
            self.send(src, StabilizeAck(cmd_id=msg.cmd_id,
                                        stabilizer_id=self.server_id))
            if msg.cmd_id in self.waiting:
                self._deliver_local(self.waiting.pop(msg.cmd_id), msg.command)
        elif isinstance(msg, StabilizeAck):
            acks = self.dis_pending.get(msg.cmd_id)
            if acks is None:
                return
            acks.add(msg.stabilizer_id)
            if len(acks) == self.majority:  # fire exactly once
                self.send(self.leader_addr, ProposeId(cmd_id=msg.cmd_id))
        elif isinstance(msg, ProposeId):  # leader: order the id
            slot = self.next_slot
            self.next_slot += 1
            members = self.role_rng.sample(range(self.n_servers),
                                           self.majority)
            self.pending2[slot] = (msg.cmd_id, set())
            for a in members:
                self.send(self.servers[a],
                          Phase2a(slot=slot, ballot=self.ballot,
                                  value=("id", msg.cmd_id),
                                  leader_id=0))
        elif isinstance(msg, Phase2a):  # acceptor: vote
            self.send(src, Phase2b(slot=msg.slot, ballot=msg.ballot,
                                   acceptor_id=self.server_id))
        elif isinstance(msg, Phase2b):  # leader: count the quorum
            entry = self.pending2.get(msg.slot)
            if entry is None:
                return
            cmd_id, acks = entry
            acks.add(msg.acceptor_id)
            if len(acks) == self.majority:
                del self.pending2[msg.slot]
                for s in self.servers:  # self included: the model counts it
                    self.send(s, Chosen(slot=msg.slot, value=("id", cmd_id)))
        elif isinstance(msg, Chosen):  # stabilizer: resolve id -> payload
            _, cmd_id = msg.value
            cmd = self.store.get(cmd_id)
            if cmd is not None:
                self._deliver_local(msg.slot, cmd)
            else:  # Chosen raced ahead of our Disseminate copy
                self.waiting[cmd_id] = msg.slot
        else:  # replica-component reads etc.
            super().on_message(src, msg)


class VanillaSPaxosDeployment(BaseDeployment):
    """n = 2f+1 fused S-Paxos servers; server 0 carries the leader role."""

    def __init__(
        self,
        f: int = 1,
        n_clients: int = 3,
        state_machine: str = "kv",
        consistency: str = "linearizable",
        seed: int = 0,
        latency_fn: Optional[Callable[[str, str], float]] = None,
    ) -> None:
        self.net = Network(seed=seed, latency_fn=latency_fn)
        self.history = History()
        n = 2 * f + 1
        self.n_servers = n
        self.server_addrs = [f"server/{i}" for i in range(n)]
        self.servers = [
            VanillaSPaxosServer(addr, i, n, f, self.server_addrs,
                                make_state_machine(state_machine), seed=seed)
            for i, addr in enumerate(self.server_addrs)
        ]
        quorums = MajorityQuorums(f=f)
        # client i disseminates through server i % n; n_clients should be a
        # multiple of n so the model's uniform dissemination share holds
        self.clients = [
            Client(f"client/{i}", i, self.server_addrs[i % n], [], quorums,
                   [], consistency=consistency, history=self.history,
                   seed=seed)
            for i in range(n_clients)
        ]
        self.net.add_nodes(self.servers)
        self.net.add_nodes(self.clients)

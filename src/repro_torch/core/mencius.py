"""Compartmentalized Mencius (paper section 6).

Mencius round-robin partitions the log across ``m`` leaders: leader ``i``
owns slots ``{k : k % m == i}``.  A leader that lags fills its vacant slots
with noops ("skip") so replicas can keep executing in prefix order.  The
compartmentalized deployment (paper Fig. 24) reuses the MultiPaxos roles:
proxy leaders, acceptor grids, scaled replicas, and the leaderless read path.

Skips are implemented with ``Phase2aRange`` - a single message that votes for
noops in every owner-owned slot of ``[start, stop)`` - standing in for the
Coordinated Paxos sub-protocol the paper references.
"""
from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .cluster import Network, Node
from .history import History
from .messages import (
    Batch,
    Chosen,
    ChosenRange,
    ClientRequest,
    NextSlotAnnounce,
    Phase2a,
    Phase2aRange,
    Phase2b,
    Phase2bRange,
    noop_command,
)
from .protocols import BaseDeployment, DeploymentConfig
from .quorums import GridQuorums, MajorityQuorums, QuorumSystem
from .roles import Acceptor, Client, ProxyLeader, Replica
from .statemachine import make_state_machine


class MenciusLeader(Node):
    """One of ``m`` Mencius leaders; sequences only its owned slots."""

    def __init__(
        self,
        addr: str,
        leader_id: int,
        n_leaders: int,
        peers: Sequence[str],
        proxies: Sequence[str],
        seed: int = 0,
    ) -> None:
        super().__init__(addr)
        self.leader_id = leader_id
        self.n_leaders = n_leaders
        self.peers = [p for p in peers if p != addr]
        self.proxies = list(proxies)
        self.rng = random.Random(seed * 48271 + leader_id)
        # next owned slot = next_round * m + leader_id
        self.next_round = 0
        self._proxy_rr = 0
        self.ballot = 0  # every lane starts at ballot 0 (lane = leader_id)
        self.skips_issued = 0

    @property
    def next_slot(self) -> int:
        return self.next_round * self.n_leaders + self.leader_id

    def _send_to_proxy(self, msg: Any) -> None:
        proxy = self.proxies[self._proxy_rr % len(self.proxies)]
        self._proxy_rr += 1
        self.send(proxy, msg)

    def _announce(self) -> None:
        for p in self.peers:
            self.send(p, NextSlotAnnounce(leader_id=self.leader_id,
                                          next_slot=self.next_slot))

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, (ClientRequest, Batch)):
            value = msg.command if isinstance(msg, ClientRequest) else msg
            slot = self.next_slot
            self.next_round += 1
            self._send_to_proxy(Phase2a(slot=slot, ballot=self.ballot, value=value,
                                        leader_id=self.leader_id))
            self._announce()
        elif isinstance(msg, NextSlotAnnounce):
            # Lagging? fill every owned vacant slot below the peer's frontier
            # with noops so replicas are not stalled by our holes.
            if msg.next_slot > self.next_slot:
                start = self.next_slot
                stop = msg.next_slot
                self._send_to_proxy(Phase2aRange(ballot=self.ballot,
                                                 owner=self.leader_id,
                                                 start=start, stop=stop,
                                                 n_leaders=self.n_leaders))
                self.skips_issued += 1
                # advance frontier past the filled range
                while self.next_slot < stop:
                    self.next_round += 1


class MenciusDeployment(BaseDeployment):
    """Compartmentalized Mencius: m leaders + proxies + grid + replicas."""

    def __init__(
        self,
        n_leaders: int = 3,
        f: int = 1,
        n_proxy_leaders: int = 4,
        grid: Optional[Tuple[int, int]] = (2, 2),
        n_replicas: int = 3,
        n_clients: int = 3,
        state_machine: str = "kv",
        consistency: str = "linearizable",
        seed: int = 0,
        latency_fn: Optional[Callable[[str, str], float]] = None,
    ) -> None:
        self.net = Network(seed=seed, latency_fn=latency_fn)
        self.history = History()
        self.n_leaders = n_leaders

        if grid is not None:
            self.quorums: QuorumSystem = GridQuorums(rows=grid[0], cols=grid[1])
        else:
            self.quorums = MajorityQuorums(f=f)
        self.quorums.validate()

        self.acceptor_addrs = [f"acceptor/{i}" for i in range(self.quorums.n)]
        self.replica_addrs = [f"replica/{i}" for i in range(n_replicas)]
        self.proxy_addrs = [f"proxy/{i}" for i in range(n_proxy_leaders)]
        self.leader_addrs = [f"leader/{i}" for i in range(n_leaders)]

        self.acceptors = [Acceptor(a, i) for i, a in enumerate(self.acceptor_addrs)]
        self.replicas = [
            Replica(addr, i, n_replicas, make_state_machine(state_machine), seed=seed)
            for i, addr in enumerate(self.replica_addrs)
        ]
        self.proxies = [
            ProxyLeader(addr, self.acceptor_addrs, self.quorums, self.replica_addrs,
                        seed=seed)
            for addr in self.proxy_addrs
        ]
        self.leaders = [
            MenciusLeader(addr, i, n_leaders, self.leader_addrs, self.proxy_addrs,
                          seed=seed)
            for i, addr in enumerate(self.leader_addrs)
        ]
        # client i talks to leader i % m (paper: any leader)
        self.clients = [
            Client(f"client/{i}", i, self.leader_addrs[i % n_leaders],
                   self.acceptor_addrs, self.quorums, self.replica_addrs,
                   consistency=consistency, history=self.history, seed=seed)
            for i in range(n_clients)
        ]
        for group in (self.acceptors, self.replicas, self.proxies, self.leaders,
                      self.clients):
            self.net.add_nodes(group)

    def total_skips(self) -> int:
        return sum(l.skips_issued for l in self.leaders)


# ---------------------------------------------------------------------------
# Vanilla (fused-server) Mencius - paper Fig. 25 baseline
# ---------------------------------------------------------------------------


class VanillaMenciusServer(Replica):
    """One fused vanilla-Mencius server: Mencius leader + acceptor + replica
    in a single process, matching the fused accounting of
    ``vanilla_mencius_model`` (every machine plays every role; there are no
    proxies or grids).

    Phase 2 is self-broadcast to a thrifty quorum of *peer* servers - the
    machine's own acceptor vote is a local fact, exactly the cost the fused
    table omits - and ``Chosen`` goes over the wire to the ``m - 1`` peers
    while the local replica component applies directly.  All lanes run at
    ballot 0 (the failure-free baseline the table models), so the acceptor
    component reduces to voting; the replica component is inherited whole
    from :class:`~repro.core.roles.Replica` (prefix-order execution,
    slot-ownership replies, exactly-once client table).
    """

    def __init__(self, addr: str, server_id: int, n_servers: int, f: int,
                 peers: Sequence[str], state_machine, seed: int = 0) -> None:
        super().__init__(addr, server_id, n_servers, state_machine, seed=seed)
        self.server_id = server_id
        self.n_servers = n_servers
        self.quorum = f + 1  # majority f+1 among the 2f peers (valid: 2f >= f+1)
        self.peers = [p for p in peers if p != addr]
        self.lane_rng = random.Random(seed * 48271 + server_id)
        self.next_round = 0
        self.ballot = 0
        self.skips_issued = 0
        # self-broadcast phase-2 state: slot -> peer-acceptor acks
        self.pending2: Dict[int, Set[int]] = {}
        self.pending_ranges: Dict[Tuple[int, int], Set[int]] = {}
        self._proposed: Dict[int, Any] = {}  # slot -> in-flight command

    @property
    def next_slot(self) -> int:
        return self.next_round * self.n_servers + self.server_id

    def _peer_quorum(self) -> List[str]:
        return self.lane_rng.sample(self.peers, self.quorum)

    def _chose(self, slot: int, value: Any) -> None:
        """Quorum complete: wire Chosen to the peers, apply locally free."""
        for p in self.peers:
            self.send(p, Chosen(slot=slot, value=value))
        if slot not in self.log:
            self.log[slot] = value
            self._execute_ready()

    def _chose_range(self, start: int, stop: int) -> None:
        for p in self.peers:
            self.send(p, ChosenRange(owner=self.server_id, start=start,
                                     stop=stop, n_leaders=self.n_servers))
        noop = noop_command()
        for slot in range(start, stop):
            if slot % self.n_servers == self.server_id and slot not in self.log:
                self.log[slot] = noop
        self._execute_ready()

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ClientRequest):
            slot = self.next_slot
            self.next_round += 1
            self.pending2[slot] = set()
            self._proposed[slot] = msg.command
            for p in self.peers:  # announce the new frontier (interval = 1)
                self.send(p, NextSlotAnnounce(leader_id=self.server_id,
                                              next_slot=self.next_slot))
            for p in self._peer_quorum():
                self.send(p, Phase2a(slot=slot, ballot=self.ballot,
                                     value=msg.command,
                                     leader_id=self.server_id))
        elif isinstance(msg, Phase2a):  # acceptor component: vote
            self.send(src, Phase2b(slot=msg.slot, ballot=msg.ballot,
                                   acceptor_id=self.server_id))
        elif isinstance(msg, Phase2b):
            acks = self.pending2.get(msg.slot)
            if acks is None:
                return
            acks.add(msg.acceptor_id)
            if len(acks) == self.quorum:
                del self.pending2[msg.slot]
                self._chose(msg.slot, self._proposed.pop(msg.slot))
        elif isinstance(msg, NextSlotAnnounce):
            if msg.next_slot > self.next_slot:
                start, stop = self.next_slot, msg.next_slot
                self.pending_ranges[(start, stop)] = set()
                for p in self._peer_quorum():
                    self.send(p, Phase2aRange(ballot=self.ballot,
                                              owner=self.server_id,
                                              start=start, stop=stop,
                                              n_leaders=self.n_servers))
                self.skips_issued += 1
                while self.next_slot < stop:
                    self.next_round += 1
        elif isinstance(msg, Phase2aRange):  # acceptor component: range vote
            self.send(src, Phase2bRange(ballot=msg.ballot, owner=msg.owner,
                                        start=msg.start, stop=msg.stop,
                                        acceptor_id=self.server_id))
        elif isinstance(msg, Phase2bRange):
            key = (msg.start, msg.stop)
            acks = self.pending_ranges.get(key)
            if acks is None:
                return
            acks.add(msg.acceptor_id)
            if len(acks) == self.quorum:
                del self.pending_ranges[key]
                self._chose_range(msg.start, msg.stop)
        else:  # Chosen / ChosenRange from peers -> replica component
            super().on_message(src, msg)


class VanillaMenciusDeployment(BaseDeployment):
    """m = 2f+1 fused Mencius servers, no proxies/grids (paper Fig. 25)."""

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
        m = 2 * f + 1
        self.n_servers = m
        self.server_addrs = [f"server/{i}" for i in range(m)]
        self.servers = [
            VanillaMenciusServer(addr, i, m, f, self.server_addrs,
                                 make_state_machine(state_machine), seed=seed)
            for i, addr in enumerate(self.server_addrs)
        ]
        quorums = MajorityQuorums(f=f)
        # client i talks to server i % m; the fused table has no read path,
        # so the executable declares reads_as_writes and every op lands here
        self.clients = [
            Client(f"client/{i}", i, self.server_addrs[i % m], [], quorums,
                   [], consistency=consistency, history=self.history,
                   seed=seed)
            for i in range(n_clients)
        ]
        self.net.add_nodes(self.servers)
        self.net.add_nodes(self.clients)

    @property
    def replicas(self) -> List[VanillaMenciusServer]:
        return self.servers  # every fused server executes the log

    def total_skips(self) -> int:
        return sum(s.skips_issued for s in self.servers)

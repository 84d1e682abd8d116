"""Protocol deployments: wiring roles into runnable clusters.

``CompartmentalizedMultiPaxos`` is the paper's full protocol (all six
compartmentalizations, each individually toggleable so the ablation study in
``benchmarks/ablation.py`` can walk the same path as paper Fig. 29).

``MultiPaxos`` is the vanilla baseline: 2f+1 colocated servers, the leader
broadcasts Phase 2 itself, majority quorums, f+1 replicas.

``UnreplicatedStateMachine`` is the paper's (non-fault-tolerant) upper bound.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .cluster import Network, Node
from .history import History
from .messages import ClientReply, ClientRequest, ReadReply
from .quorums import GridQuorums, MajorityQuorums, QuorumSystem
from .roles import Acceptor, Batcher, Client, Leader, ProxyLeader, Replica, Unbatcher
from .statemachine import StateMachine, make_state_machine


@dataclass
class DeploymentConfig:
    f: int = 1
    # compartmentalization 1: 0 proxies => vanilla self-broadcast leader
    n_proxy_leaders: int = 0
    # compartmentalization 2: grid quorums if set, else 2f+1 majorities
    grid: Optional[Tuple[int, int]] = None  # (rows, cols)
    # compartmentalization 3
    n_replicas: int = 0  # 0 => f+1
    # compartmentalizations 5/6
    n_batchers: int = 0
    n_unbatchers: int = 0
    batch_size: int = 10
    # reads: "linearizable" | "sequential" | "eventual"
    consistency: str = "linearizable"
    state_machine: str = "kv"
    seed: int = 0
    client_retries: bool = False
    # heartbeat-driven automatic leader failover (deterministic timers)
    auto_failover: bool = False
    # per-(src, dst) message delay, e.g. a GeoSpec's WAN matrix (timers
    # stay local; jitter stacks on top - see Network.send)
    latency_fn: Optional[Any] = None

    @property
    def n_acceptors(self) -> int:
        return self.grid[0] * self.grid[1] if self.grid else 2 * self.f + 1

    @property
    def effective_replicas(self) -> int:
        return self.n_replicas if self.n_replicas > 0 else self.f + 1


class BaseDeployment:
    """Common cluster-running helpers."""

    net: Network
    history: History
    clients: List[Any]

    def run_to_quiescence(self, max_steps: int = 2_000_000) -> int:
        return self.net.run(max_steps=max_steps)

    def all_done(self) -> bool:
        return all(c.done for c in self.clients)

    def results_of(self, client_index: int) -> List[Any]:
        return self.clients[client_index].results

    def total_messages(self) -> Dict[str, int]:
        """Total (sent + received) messages per role, keyed by the
        ``role/<i>`` address prefix - uniform across every deployment
        (MultiPaxos, Mencius, S-Paxos, CRAQ chains, unreplicated)."""
        out: Dict[str, int] = {}
        for addr, node in self.net.nodes.items():
            role = addr.split("/")[0]
            out[role] = out.get(role, 0) + node.msgs_received + node.msgs_sent
        return out


class CompartmentalizedMultiPaxos(BaseDeployment):
    """The paper's protocol; also the vanilla baseline via config toggles."""

    def __init__(self, cfg: DeploymentConfig, n_clients: int = 1,
                 network: Optional[Network] = None) -> None:
        self.cfg = cfg
        self.net = network or Network(seed=cfg.seed,
                                      latency_fn=cfg.latency_fn)
        self.history = History()

        f = cfg.f
        if cfg.grid is not None:
            rows, cols = cfg.grid
            assert rows >= f + 1 and cols >= f + 1, "grid must tolerate f"
            self.quorums: QuorumSystem = GridQuorums(rows=rows, cols=cols)
        else:
            self.quorums = MajorityQuorums(f=f)
        self.quorums.validate()

        self.acceptor_addrs = [f"acceptor/{i}" for i in range(self.quorums.n)]
        self.replica_addrs = [f"replica/{i}" for i in range(cfg.effective_replicas)]
        self.proxy_addrs = [f"proxy/{i}" for i in range(cfg.n_proxy_leaders)]
        self.batcher_addrs = [f"batcher/{i}" for i in range(cfg.n_batchers)]
        self.unbatcher_addrs = [f"unbatcher/{i}" for i in range(cfg.n_unbatchers)]
        self.leader_addrs = [f"leader/{i}" for i in range(f + 1)]

        # acceptors
        self.acceptors = [Acceptor(a, i) for i, a in enumerate(self.acceptor_addrs)]
        # replicas (each owns its own state machine copy)
        self.replicas = [
            Replica(addr, i, cfg.effective_replicas,
                    make_state_machine(cfg.state_machine),
                    unbatchers=self.unbatcher_addrs, seed=cfg.seed)
            for i, addr in enumerate(self.replica_addrs)
        ]
        # proxy leaders
        self.proxies = [
            ProxyLeader(addr, self.acceptor_addrs, self.quorums,
                        self.replica_addrs, seed=cfg.seed)
            for addr in self.proxy_addrs
        ]
        # leaders (f+1 proposers; leader 0 starts active)
        self.leaders = [
            Leader(addr, i, self.acceptor_addrs, self.quorums, self.proxy_addrs,
                   self.replica_addrs,
                   self_broadcast=(cfg.n_proxy_leaders == 0), seed=cfg.seed,
                   peers=self.leader_addrs, auto_failover=cfg.auto_failover)
            for i, addr in enumerate(self.leader_addrs)
        ]
        # batching plane
        self.batchers = [
            Batcher(addr, i, self.leader_addrs[0], cfg.batch_size,
                    acceptors=self.acceptor_addrs, quorums=self.quorums,
                    replicas=self.replica_addrs, seed=cfg.seed)
            for i, addr in enumerate(self.batcher_addrs)
        ]
        self.unbatchers = [Unbatcher(addr) for addr in self.unbatcher_addrs]
        # clients
        self.clients = [
            Client(f"client/{i}", i, self.leader_addrs[0], self.acceptor_addrs,
                   self.quorums, self.replica_addrs, batchers=self.batcher_addrs,
                   consistency=cfg.consistency, history=self.history,
                   seed=cfg.seed, retries=cfg.client_retries)
            for i in range(n_clients)
        ]

        for group in (self.acceptors, self.replicas, self.proxies, self.leaders,
                      self.batchers, self.unbatchers, self.clients):
            self.net.add_nodes(group)

        self.leaders[0].become_leader()
        if cfg.auto_failover:
            for l in self.leaders:
                l.start_failure_detector()
            # heartbeat timers never quiesce: settle phase 1 in a bounded
            # TIME window (drive such deployments with net.run(until=T))
            self.net.run(until=30)
        else:
            self.net.run(max_steps=10_000)  # settle phase 1
        assert self.leaders[0].active, "phase 1 must complete on a clean network"

    # -- convenience -------------------------------------------------------------
    @property
    def leader(self) -> Leader:
        for l in self.leaders:
            if l.active and l.addr not in self.net.crashed:
                return l
        return self.leaders[0]

    def fail_over(self, to_leader: int) -> None:
        """Crash the active leader, promote ``to_leader`` (phase 1 over a
        read quorum; adopted values re-proposed; holes filled with noops)."""
        for l in self.leaders:
            if l.active:
                self.net.crash(l.addr)
        self.leaders[to_leader].become_leader()


def vanilla_multipaxos(f: int = 1, n_clients: int = 1, seed: int = 0,
                       state_machine: str = "kv",
                       client_retries: bool = False) -> CompartmentalizedMultiPaxos:
    """Paper baseline: no proxies, majority quorums, f+1 replicas, no batching."""
    cfg = DeploymentConfig(f=f, n_proxy_leaders=0, grid=None, n_replicas=f + 1,
                           state_machine=state_machine, seed=seed,
                           client_retries=client_retries)
    return CompartmentalizedMultiPaxos(cfg, n_clients=n_clients)


def full_compartmentalized(f: int = 1, n_clients: int = 1, seed: int = 0,
                           n_proxy_leaders: int = 10,
                           grid: Tuple[int, int] = (2, 2),
                           n_replicas: int = 4,
                           n_batchers: int = 0, n_unbatchers: int = 0,
                           batch_size: int = 10,
                           consistency: str = "linearizable",
                           state_machine: str = "kv",
                           client_retries: bool = False) -> CompartmentalizedMultiPaxos:
    """The paper's evaluation deployment (section 8.1, unbatched by default)."""
    cfg = DeploymentConfig(f=f, n_proxy_leaders=n_proxy_leaders, grid=grid,
                           n_replicas=n_replicas, n_batchers=n_batchers,
                           n_unbatchers=n_unbatchers, batch_size=batch_size,
                           consistency=consistency, state_machine=state_machine,
                           seed=seed, client_retries=client_retries)
    return CompartmentalizedMultiPaxos(cfg, n_clients=n_clients)


# ---------------------------------------------------------------------------
# Unreplicated state machine (paper's upper bound; not fault tolerant)
# ---------------------------------------------------------------------------


class _UnreplicatedServer(Node):
    def __init__(self, addr: str, sm: StateMachine) -> None:
        super().__init__(addr)
        self.sm = sm
        self.executed = 0

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ClientRequest):
            result = self.sm.apply_checked(msg.command.op)
            self.executed += 1
            self.send(src, ClientReply(command_uid=msg.command.uid, result=result,
                                       slot=self.executed - 1))


class UnreplicatedStateMachine(BaseDeployment):
    def __init__(self, n_clients: int = 1, seed: int = 0,
                 state_machine: str = "kv",
                 latency_fn: Optional[Any] = None) -> None:
        self.net = Network(seed=seed, latency_fn=latency_fn)
        self.history = History()
        self.server = _UnreplicatedServer("server/0", make_state_machine(state_machine))
        self.net.add_node(self.server)
        self.clients = [
            Client(f"client/{i}", i, "server/0", [], MajorityQuorums(f=0), [],
                   history=self.history, seed=seed)
            for i in range(n_clients)
        ]
        self.net.add_nodes(self.clients)

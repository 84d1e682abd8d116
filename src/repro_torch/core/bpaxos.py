"""Bipartisan Paxos (BPaxos) - a multi-leader variant family member.

BPaxos (PAPERS.md, arXiv 2003.00331) breaks the single-sequencer ceiling
by *decoupling ordering itself*: ``n_proposers`` stateless proposers run
in parallel, and a replicated **dependency service** tracks per-key
conflicts instead of assigning log slots.  A command is committed with a
dependency set; replicas execute the resulting dependency graph in a
conflict-aware deterministic order (strongly connected components in
reverse topological order, vertex-id tie-break within a component - the
EPaxos/BPaxos execution rule).

Wire protocol (failure-free accounting path, one command):

    client -> proposer                       ClientRequest    (1 recv)
    proposer -> every dep node               DepRequest       (d sends)
    every dep node -> proposer               DepReply         (d recvs)
    proposer -> every replica                BPaxosCommit     (n sends)
    owner replica -> client                  ClientReply

The proposer commits at a **majority** of dependency replies (quorum
intersection is what makes the real-time order an edge in the graph);
the remaining replies still arrive and are counted, so every station's
msgs/cmd is exact and seed-independent:

    proposer     (1 + 2 d + n) / p      per proposer
    dep_service  2                      per dep node (recv + reply)
    replica      1 + 1/n                per replica (commit + reply share)

Reads travel the same dependency path as writes (there is no leaderless
read optimization in BPaxos), so the read column equals the write column.
Registration is the multi-leader proof of the registry thesis: two NEW
station slots (``proposer``, ``dep_service``) and both planes, with zero
core edits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from .analytical import DeploymentModel, Station
from .api import knob, register_executable, register_variant
from .cluster import Network, Node
from .history import History
from .messages import ClientReply, ClientRequest, Command, is_noop
from .protocols import BaseDeployment
from .quorums import MajorityQuorums
from .roles import Client
from .statemachine import make_state_machine

Vertex = Tuple[int, int]  # (proposer_id, proposer-local sequence)


# ---------------------------------------------------------------------------
# Messages (BPaxos-only; frozen like repro.core.messages)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DepRequest:
    """Proposer -> dependency service: record ``vertex`` against ``key``."""

    vertex: Vertex
    key: Any


@dataclass(frozen=True)
class DepReply:
    """Dependency service -> proposer: conflicting vertices seen before."""

    vertex: Vertex
    deps: Tuple[Vertex, ...]


@dataclass(frozen=True)
class BPaxosCommit:
    """Proposer -> every replica: vertex committed with its final deps."""

    vertex: Vertex
    command: Command
    deps: Tuple[Vertex, ...]


def _conflict_key(cmd: Command) -> Any:
    """Commands conflict iff they touch the same key (reads included -
    a read must be ordered against the writes it observes)."""
    op = cmd.op
    return op[1] if len(op) > 1 else "_"


# ---------------------------------------------------------------------------
# Roles
# ---------------------------------------------------------------------------


class BPaxosProposer(Node):
    """One of ``p`` parallel proposers: assigns a globally unique vertex,
    gathers a majority of dependency replies, commits to every replica."""

    def __init__(self, addr: str, proposer_id: int,
                 dep_addrs: Sequence[str],
                 replica_addrs: Sequence[str],
                 thrifty: bool = False) -> None:
        super().__init__(addr)
        self.proposer_id = proposer_id
        self.dep_addrs = list(dep_addrs)
        self.replica_addrs = list(replica_addrs)
        self.quorum = len(self.dep_addrs) // 2 + 1
        self.thrifty = thrifty
        self.seq = 0
        # vertex -> [command, union-of-deps, n_acks, committed]
        self.pending: Dict[Vertex, List[Any]] = {}

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ClientRequest):
            vertex = (self.proposer_id, self.seq)
            self.seq += 1
            self.pending[vertex] = [msg.command, set(), 0, False]
            key = _conflict_key(msg.command)
            if self.thrifty:
                # EPaxos-style thrifty: unicast to exactly a quorum of dep
                # nodes - a rotating window so load stays even - instead
                # of broadcasting and discarding the non-quorum replies
                d = len(self.dep_addrs)
                targets = [self.dep_addrs[(vertex[1] + j) % d]
                           for j in range(self.quorum)]
            else:
                targets = self.dep_addrs
            for t in targets:
                self.send(t, DepRequest(vertex=vertex, key=key))
        elif isinstance(msg, DepReply):
            entry = self.pending.get(msg.vertex)
            if entry is None or entry[3]:
                return  # already committed; late replies are just counted
            entry[1].update(msg.deps)
            entry[2] += 1
            if entry[2] >= self.quorum:
                entry[3] = True
                deps = tuple(sorted(entry[1] - {msg.vertex}))
                for r in self.replica_addrs:
                    self.send(r, BPaxosCommit(vertex=msg.vertex,
                                              command=entry[0], deps=deps))


class DepServiceNode(Node):
    """One of ``d = 2f+1`` dependency-service nodes: a per-key conflict
    map.  Reports the last conflicting vertex it recorded (prior ones are
    reachable transitively through that vertex's own deps)."""

    def __init__(self, addr: str) -> None:
        super().__init__(addr)
        self.last_by_key: Dict[Any, Vertex] = {}

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, DepRequest):
            prior = self.last_by_key.get(msg.key)
            deps = (prior,) if prior is not None else ()
            self.last_by_key[msg.key] = msg.vertex
            self.send(src, DepReply(vertex=msg.vertex, deps=deps))


class BPaxosReplica(Node):
    """Executes the committed dependency graph.

    A vertex is eligible once its transitive dependency closure is fully
    committed; the closure's strongly connected components are executed in
    reverse topological order with a vertex-id tie-break inside each
    component.  Every replica sees the same (vertex -> deps) mapping - the
    proposer froze the deps at commit - so the per-key execution order is
    identical everywhere; the owner replica replies."""

    def __init__(self, addr: str, replica_index: int, n_replicas: int,
                 state_machine,
                 client_addr_fn=lambda cid: f"client/{cid}") -> None:
        super().__init__(addr)
        self.replica_index = replica_index
        self.n_replicas = n_replicas
        self.sm = state_machine
        self.client_addr_fn = client_addr_fn
        self.committed: Dict[Vertex, Tuple[Command, Tuple[Vertex, ...]]] = {}
        self.executed: Set[Vertex] = set()
        self.executed_order: List[Vertex] = []
        self.key_order: Dict[Any, List[Vertex]] = {}

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, BPaxosCommit):
            if msg.vertex in self.committed:
                return
            self.committed[msg.vertex] = (msg.command, msg.deps)
            self._try_execute()

    # -- dependency-graph execution ----------------------------------------
    def _ready_closure(self, root: Vertex) -> Optional[Set[Vertex]]:
        """Unexecuted vertices reachable from ``root`` through deps, or
        ``None`` if the closure hits an uncommitted vertex."""
        closure: Set[Vertex] = set()
        stack = [root]
        while stack:
            v = stack.pop()
            if v in self.executed or v in closure:
                continue
            if v not in self.committed:
                return None
            closure.add(v)
            stack.extend(self.committed[v][1])
        return closure

    def _scc_order(self, closure: Set[Vertex]) -> List[List[Vertex]]:
        """Tarjan over the closure subgraph (edges vertex -> dep).  SCCs
        come out dependencies-first; vertices inside an SCC are sorted."""
        index: Dict[Vertex, int] = {}
        low: Dict[Vertex, int] = {}
        on_stack: Set[Vertex] = set()
        stack: List[Vertex] = []
        order: List[List[Vertex]] = []
        counter = [0]

        def strongconnect(v: Vertex) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in self.committed[v][1]:
                if w not in closure:
                    continue
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                order.append(sorted(comp))

        for v in sorted(closure):
            if v not in index:
                strongconnect(v)
        return order

    def _try_execute(self) -> None:
        progress = True
        while progress:
            progress = False
            for v in sorted(self.committed):
                if v in self.executed:
                    continue
                closure = self._ready_closure(v)
                if closure is None:
                    continue
                for comp in self._scc_order(closure):
                    for u in comp:
                        self._execute_vertex(u)
                progress = True

    def _execute_vertex(self, v: Vertex) -> None:
        cmd, _ = self.committed[v]
        self.executed.add(v)
        self.executed_order.append(v)
        result = None if is_noop(cmd) else self.sm.apply_checked(cmd.op)
        self.key_order.setdefault(_conflict_key(cmd), []).append(v)
        if (v[0] + v[1]) % self.n_replicas == self.replica_index:
            self.send(self.client_addr_fn(cmd.client_id),
                      ClientReply(command_uid=cmd.uid, result=result,
                                  slot=None))


# ---------------------------------------------------------------------------
# Deployment
# ---------------------------------------------------------------------------


class BPaxosDeployment(BaseDeployment):
    """p proposers + d dependency-service nodes + n graph-executing
    replicas.  Clients route to proposer ``i % p``; every op (reads too)
    travels the dependency path, so there are no acceptors and no
    leaderless read quorums."""

    def __init__(
        self,
        n_proposers: int = 3,
        n_dep_nodes: int = 3,
        n_replicas: int = 3,
        f: int = 1,
        n_clients: int = 3,
        state_machine: str = "kv",
        consistency: str = "linearizable",
        seed: int = 0,
        thrifty: bool = False,
        latency_fn: Optional[Callable[[str, str], float]] = None,
    ) -> None:
        if n_dep_nodes < 2 * f + 1:
            raise ValueError(
                f"n_dep_nodes must be >= 2f+1 = {2 * f + 1} (dependency "
                f"quorums must intersect under f faults): {n_dep_nodes}")
        self.net = Network(seed=seed, latency_fn=latency_fn)
        self.history = History()
        self.proposer_addrs = [f"proposer/{i}" for i in range(n_proposers)]
        self.dep_addrs = [f"dep_service/{i}" for i in range(n_dep_nodes)]
        self.replica_addrs = [f"replica/{i}" for i in range(n_replicas)]
        self.dep_nodes = [DepServiceNode(a) for a in self.dep_addrs]
        self.replicas = [
            BPaxosReplica(addr, i, n_replicas,
                          make_state_machine(state_machine))
            for i, addr in enumerate(self.replica_addrs)
        ]
        self.proposers = [
            BPaxosProposer(addr, i, self.dep_addrs, self.replica_addrs,
                           thrifty=thrifty)
            for i, addr in enumerate(self.proposer_addrs)
        ]
        # empty acceptor/replica lists: reads take the proposer path too
        self.clients = [
            Client(f"client/{i}", i, self.proposer_addrs[i % n_proposers],
                   [], MajorityQuorums(f=f), [], consistency=consistency,
                   history=self.history, seed=seed)
            for i in range(n_clients)
        ]
        for group in (self.dep_nodes, self.replicas, self.proposers,
                      self.clients):
            self.net.add_nodes(group)


# ---------------------------------------------------------------------------
# Analytical model + registration (both planes, zero core edits)
# ---------------------------------------------------------------------------


def bpaxos_model(n_proposers: int = 3, n_dep_nodes: int = 3,
                 n_replicas: int = 3, f: int = 1,
                 thrifty: bool = False) -> DeploymentModel:
    """BPaxos demand table (derivation in the module docstring).

    The proposer tier scales with ``p`` - sequencing is parallel - while
    the dependency service is the protocol's structural floor: every dep
    node sees every command (2 msgs/cmd), the same ceiling the paper's
    compartmentalized leader has, but bought with parallel proposers
    instead of proxy offload.  Reads cost what writes cost.

    ``thrifty`` (EPaxos-style) unicasts DepRequest to exactly a rotating
    quorum ``q = d//2 + 1`` instead of broadcasting to all ``d``: the
    proposer stops paying for (and discarding) the ``d - q`` non-quorum
    replies, and each dep node's demand drops from 2 to ``2q/d``
    msgs/cmd - the protocol's structural floor moves."""
    p, d, n = n_proposers, n_dep_nodes, n_replicas
    if p < 1:
        raise ValueError(f"n_proposers must be >= 1: {p}")
    if d < 2 * f + 1:
        raise ValueError(
            f"n_dep_nodes must be >= 2f+1 = {2 * f + 1}: {d}")
    if n < 1:
        raise ValueError(f"n_replicas must be >= 1: {n}")
    q = d // 2 + 1 if thrifty else d
    proposer = (1.0 + 2.0 * q + n) / p
    dep = 2.0 * q / d
    replica = 1.0 + 1.0 / n
    stations = (
        Station("proposer", p, proposer, proposer),
        Station("dep_service", d, dep, dep),
        Station("replica", n, replica, replica),
    )
    tag = ",thrifty" if thrifty else ""
    return DeploymentModel(name=f"bpaxos(p={p},d={d},n={n}{tag})",
                           stations=stations)


def _bpaxos_candidates(budget: int, f: int) -> Dict[str, tuple]:
    """Candidate space under a machine budget: the dep tier is pinned at
    2f+1 (more dep replicas buy fault tolerance, not throughput), the
    proposer/replica axes absorb the rest."""
    d = 2 * f + 1
    max_prop = max(budget - d - (f + 1), 1)
    max_replicas = max(budget - d - 1, f + 1)
    return {
        "n_proposers": tuple(range(1, min(max_prop, 8) + 1)),
        "n_dep_nodes": (d,),
        "n_replicas": tuple(range(f + 1, min(max_replicas, f + 7) + 1)),
        "thrifty": (False, True),
    }


def _bpaxos_deployment(n_proposers: int = 3, n_dep_nodes: int = 3,
                       n_replicas: int = 3, f: int = 1, n_clients: int = 3,
                       seed: int = 0, state_machine: str = "kv",
                       thrifty: bool = False,
                       latency_fn: Optional[Callable[[str, str], float]]
                       = None) -> BPaxosDeployment:
    return BPaxosDeployment(n_proposers=n_proposers, n_dep_nodes=n_dep_nodes,
                            n_replicas=n_replicas, f=f, n_clients=n_clients,
                            state_machine=state_machine, seed=seed,
                            thrifty=thrifty, latency_fn=latency_fn)


register_variant(
    name="bpaxos",
    factory=bpaxos_model,
    stations=("proposer", "dep_service", "replica"),
    knobs=(
        knob("n_proposers", (3,)),
        knob("n_dep_nodes", (3,)),
        knob("n_replicas", (3,)),
        knob("thrifty", (False,)),
    ),
    takes_f=True,
    candidate_knobs=_bpaxos_candidates,
    description="Bipartisan Paxos: parallel proposers + dependency service "
                "(arXiv 2003.00331)",
)

register_executable(
    "bpaxos",
    deployment=_bpaxos_deployment,
    # the whole wire protocol is message-deterministic and seed-blind:
    # every station's msgs/cmd is exact at any mix
    exact_stations=("proposer", "dep_service", "replica"),
    rel_tolerance=0.05,
    n_clients=3,
    description="Dependency-graph commit with conflict-aware SCC execution",
)

"""ISS-style round-robin log buckets across leaders (multi-leader family).

"State-Machine Replication Scalability Made Simple" (PAPERS.md,
arXiv 2203.05681 - ISS/Mir) multiplexes the log across leaders at
*bucket* granularity: keys hash into ``n_buckets`` buckets, each bucket
is an independent FIFO lane, and bucket ownership **rotates round-robin
across leaders every ``epoch_length`` commands** so no single leader
owns a hot bucket forever.  Because buckets partition the key space,
cross-bucket commands commute - replicas execute each bucket's lane in
prefix order against a shared state machine and linearizability holds
without a global total order (the bucketing insight this module pins in
``tests/test_multileader_property.py``).

Past the leaders, the deployment is the paper's compartmentalized tail
reused verbatim: proxy leaders, an ``r x w`` acceptor grid, scaled
replicas (``repro.core.roles``).  A bucket's ``seq``-th command travels
as log slot ``seq * n_buckets + bucket`` - globally unique, decoded back
by the replicas.

Leader-station accounting per command (client entry + proxy handoff is
2 msgs; a request entering at a non-owner leader is forwarded, 2 msgs
per hop; an epoch rotation broadcasts new ownership to the other
``L - 1`` leaders, 2(L-1) msgs per rotation):

    leader   (2 + 2 phi + 2 (L-1) rho) / L     phi = forward hops/cmd,
                                               rho = rotations/cmd
    proxy    (1 + 2 col + n) / P               col = grid write column
    acceptor 2 / w                             (station total 2 col / r w)
    replica  1 + 1/n

``phi``/``rho`` depend on request timing, so the executable measures them
and feeds them back (``forward_fraction``, ``rotations_per_cmd`` model
knobs - the Mencius skip-feedback pattern); the analytical default is the
uniform-routing expectation ``phi = (L-1)/L``.  Reads travel the ordered
bucket path like writes (ISS has no leaderless read quorum), so the read
column equals the write column everywhere.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .analytical import DeploymentModel, Station
from .api import knob, register_executable, register_variant
from .cluster import Network, Node
from .history import History
from .messages import Chosen, ClientReply, ClientRequest, Command, Phase2a, is_noop
from .protocols import BaseDeployment
from .quorums import GridQuorums, MajorityQuorums, QuorumSystem
from .roles import Acceptor, Client, ProxyLeader
from .statemachine import make_state_machine


@dataclass(frozen=True)
class IssBucketOwner:
    """Rotation broadcast: ``bucket`` is owned by leader ``owner`` from
    ``next_seq`` on (epoch ``epoch``).  Sent by the outgoing owner to all
    other leaders; the incoming owner picks up the lane from it."""

    bucket: int
    owner: int
    next_seq: int
    epoch: int


def bucket_of(key: Any, n_buckets: int) -> int:
    """crc32 key hashing, same routing family as ``ShardingSpec``."""
    return zlib.crc32(str(key).encode()) % n_buckets


class IssLeader(Node):
    """One of ``L`` leaders; sequences the buckets it currently owns.

    Ownership of bucket ``b`` during epoch ``e = seq // epoch_length`` is
    leader ``(b + e) % L``.  A request for a bucket this leader does not
    own is forwarded to the believed owner (one hop per stale belief -
    measured, not modelled away)."""

    def __init__(self, addr: str, leader_id: int, n_leaders: int,
                 n_buckets: int, epoch_length: int, peers: Sequence[str],
                 proxies: Sequence[str]) -> None:
        super().__init__(addr)
        self.leader_id = leader_id
        self.n_leaders = n_leaders
        self.n_buckets = n_buckets
        self.epoch_length = epoch_length
        self.peers = [p for p in peers if p != addr]
        self.proxies = list(proxies)
        self._proxy_rr = 0
        self.ballot = 0  # failure-free: every lane runs at ballot 0
        # bucket -> next sequence number, for the buckets this leader owns
        self.owned: Dict[int, int] = {
            b: 0 for b in range(n_buckets) if b % n_leaders == leader_id}
        self.believed: Dict[int, int] = {
            b: b % n_leaders for b in range(n_buckets)}
        self.bucket_epoch: Dict[int, int] = {b: 0 for b in range(n_buckets)}
        self.forward_hops = 0
        self.rotations = 0

    def _send_to_proxy(self, msg: Any) -> None:
        proxy = self.proxies[self._proxy_rr % len(self.proxies)]
        self._proxy_rr += 1
        self.send(proxy, msg)

    def _propose(self, bucket: int, command: Command) -> None:
        seq = self.owned[bucket]
        self.owned[bucket] = seq + 1
        slot = seq * self.n_buckets + bucket
        self._send_to_proxy(Phase2a(slot=slot, ballot=self.ballot,
                                    value=command,
                                    leader_id=self.leader_id))
        if self.n_leaders > 1 and (seq + 1) % self.epoch_length == 0:
            self._rotate(bucket, seq + 1)

    def _rotate(self, bucket: int, next_seq: int) -> None:
        epoch = next_seq // self.epoch_length
        new_owner = (bucket + epoch) % self.n_leaders
        del self.owned[bucket]
        self.believed[bucket] = new_owner
        self.bucket_epoch[bucket] = epoch
        self.rotations += 1
        msg = IssBucketOwner(bucket=bucket, owner=new_owner,
                             next_seq=next_seq, epoch=epoch)
        for p in self.peers:
            self.send(p, msg)

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ClientRequest):
            b = bucket_of(_key_of(msg.command), self.n_buckets)
            if b in self.owned:
                self._propose(b, msg.command)
            else:
                # forward to the believed owner; a stale belief costs one
                # more hop once the rotation broadcast lands
                self.forward_hops += 1
                self.send(f"leader/{self.believed[b]}", msg)
        elif isinstance(msg, IssBucketOwner):
            # rotation broadcasts carry strictly increasing epochs per
            # bucket; ignore anything stale (reordered under jitter)
            if msg.epoch > self.bucket_epoch[msg.bucket]:
                self.bucket_epoch[msg.bucket] = msg.epoch
                self.believed[msg.bucket] = msg.owner
                if msg.owner == self.leader_id:
                    self.owned[msg.bucket] = msg.next_seq


def _key_of(cmd: Command) -> Any:
    op = cmd.op
    return op[1] if len(op) > 1 else "_"


class IssReplica(Node):
    """Executes each bucket's lane in prefix order against one shared
    state machine (buckets partition keys, so lanes commute); replies for
    the slots it owns round-robin."""

    def __init__(self, addr: str, replica_index: int, n_replicas: int,
                 n_buckets: int, state_machine,
                 client_addr_fn=lambda cid: f"client/{cid}") -> None:
        super().__init__(addr)
        self.replica_index = replica_index
        self.n_replicas = n_replicas
        self.n_buckets = n_buckets
        self.sm = state_machine
        self.client_addr_fn = client_addr_fn
        self.logs: Dict[int, Dict[int, Command]] = {
            b: {} for b in range(n_buckets)}
        self.executed_upto: Dict[int, int] = {
            b: -1 for b in range(n_buckets)}
        self.executed_by_bucket: Dict[int, List[Tuple[int, Any]]] = {
            b: [] for b in range(n_buckets)}

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, Chosen):
            b = msg.slot % self.n_buckets
            seq = msg.slot // self.n_buckets
            if seq not in self.logs[b]:
                self.logs[b][seq] = msg.value
                self._execute_bucket(b)

    def _execute_bucket(self, b: int) -> None:
        log = self.logs[b]
        while (self.executed_upto[b] + 1) in log:
            seq = self.executed_upto[b] + 1
            self.executed_upto[b] = seq
            cmd = log[seq]
            result = None if is_noop(cmd) else self.sm.apply_checked(cmd.op)
            self.executed_by_bucket[b].append((seq, cmd.uid))
            slot = seq * self.n_buckets + b
            if slot % self.n_replicas == self.replica_index:
                self.send(self.client_addr_fn(cmd.client_id),
                          ClientReply(command_uid=cmd.uid, result=result,
                                      slot=None))


class IssDeployment(BaseDeployment):
    """L bucket-rotating leaders + the compartmentalized tail (proxies,
    acceptor grid, per-bucket replicas).  Client ``i`` enters at leader
    ``i % L``; the bucket routing (and its forwarding cost) is the
    protocol's own job."""

    def __init__(
        self,
        n_leaders: int = 3,
        n_buckets: int = 4,
        epoch_length: int = 4,
        f: int = 1,
        n_proxy_leaders: int = 10,
        grid: Optional[Tuple[int, int]] = (2, 2),
        n_replicas: int = 4,
        n_clients: int = 3,
        state_machine: str = "kv",
        consistency: str = "linearizable",
        seed: int = 0,
        latency_fn: Optional[Callable[[str, str], float]] = None,
    ) -> None:
        if n_buckets < 1:
            raise ValueError(f"n_buckets must be >= 1: {n_buckets}")
        if epoch_length < 1:
            raise ValueError(f"epoch_length must be >= 1: {epoch_length}")
        self.net = Network(seed=seed, latency_fn=latency_fn)
        self.history = History()
        self.n_leaders = n_leaders
        self.n_buckets = n_buckets

        if grid is not None:
            self.quorums: QuorumSystem = GridQuorums(rows=grid[0],
                                                     cols=grid[1])
        else:
            self.quorums = MajorityQuorums(f=f)
        self.quorums.validate()

        self.acceptor_addrs = [f"acceptor/{i}"
                               for i in range(self.quorums.n)]
        self.replica_addrs = [f"replica/{i}" for i in range(n_replicas)]
        self.proxy_addrs = [f"proxy/{i}" for i in range(n_proxy_leaders)]
        self.leader_addrs = [f"leader/{i}" for i in range(n_leaders)]

        self.acceptors = [Acceptor(a, i)
                          for i, a in enumerate(self.acceptor_addrs)]
        self.replicas = [
            IssReplica(addr, i, n_replicas, n_buckets,
                       make_state_machine(state_machine))
            for i, addr in enumerate(self.replica_addrs)
        ]
        self.proxies = [
            ProxyLeader(addr, self.acceptor_addrs, self.quorums,
                        self.replica_addrs, seed=seed)
            for addr in self.proxy_addrs
        ]
        self.leaders = [
            IssLeader(addr, i, n_leaders, n_buckets, epoch_length,
                      self.leader_addrs, self.proxy_addrs)
            for i, addr in enumerate(self.leader_addrs)
        ]
        # empty acceptor/replica lists: reads take the ordered bucket path
        self.clients = [
            Client(f"client/{i}", i, self.leader_addrs[i % n_leaders],
                   [], self.quorums, [], consistency=consistency,
                   history=self.history, seed=seed)
            for i in range(n_clients)
        ]
        for group in (self.acceptors, self.replicas, self.proxies,
                      self.leaders, self.clients):
            self.net.add_nodes(group)

    def total_forward_hops(self) -> int:
        return sum(l.forward_hops for l in self.leaders)

    def total_rotations(self) -> int:
        return sum(l.rotations for l in self.leaders)


# ---------------------------------------------------------------------------
# Analytical model + registration (both planes, zero core edits)
# ---------------------------------------------------------------------------


def iss_model(
    n_leaders: int = 3,
    n_buckets: int = 4,
    epoch_length: int = 4,
    f: int = 1,
    n_proxy_leaders: int = 10,
    grid_rows: int = 2,
    grid_cols: int = 2,
    n_replicas: int = 4,
    forward_fraction: Optional[float] = None,
    rotations_per_cmd: float = 0.0,
) -> DeploymentModel:
    """ISS bucket-rotation demand table (derivation in the module
    docstring).  ``n_buckets`` shapes key partitioning, not message
    counts; ``epoch_length`` enters through the measured rotation rate.
    ``forward_fraction=None`` means the uniform-routing expectation
    ``(L-1)/L``; the executable's feedback loop replaces both overhead
    knobs with measured values."""
    L = n_leaders
    if L < 1:
        raise ValueError(f"n_leaders must be >= 1: {L}")
    if n_buckets < 1:
        raise ValueError(f"n_buckets must be >= 1: {n_buckets}")
    if epoch_length < 1:
        raise ValueError(f"epoch_length must be >= 1: {epoch_length}")
    phi = (L - 1) / L if forward_fraction is None else forward_fraction
    if L == 1:
        phi, rotations_per_cmd = 0.0, 0.0
    r, w = grid_rows, grid_cols
    col = r  # write-quorum size (one grid column)
    leader = (2.0 + 2.0 * phi + 2.0 * (L - 1) * rotations_per_cmd) / L
    proxy = (1 + 2 * col + n_replicas) / max(n_proxy_leaders, 1)
    replica = 1.0 + 1.0 / n_replicas
    stations = (
        Station("leader", L, leader, leader),
        Station("proxy", max(n_proxy_leaders, 1), proxy, proxy),
        Station("acceptor", r * w, 2.0 / w, 2.0 / w),
        Station("replica", n_replicas, replica, replica),
    )
    return DeploymentModel(
        name=(f"iss(L={L},B={n_buckets},E={epoch_length},"
              f"p={n_proxy_leaders},grid={r}x{w},n={n_replicas})"),
        stations=stations,
    )


def _iss_candidates(budget: int, f: int) -> Dict[str, tuple]:
    """Coarsened candidate space under a machine budget: buckets and a
    long epoch are fixed (neither moves the failure-free demand table),
    the leader/proxy/grid/replica axes absorb the budget."""
    min_grid = f + 1
    max_proxies = max(budget - (1 + min_grid + (f + 1)), 1)
    max_replicas = max(budget - (1 + 1 + min_grid), f + 1)
    return {
        "n_leaders": tuple(range(1, min(budget, 5) + 1)),
        "n_buckets": (8,),
        "epoch_length": (64,),
        "n_proxy_leaders": tuple(range(1, min(max_proxies, 8) + 1)),
        "grids": ((2 * f + 1, 1), (f + 1, f + 1)),
        "n_replicas": tuple(range(f + 1, min(max_replicas, f + 7) + 1)),
    }


def _iss_deployment(n_leaders: int = 3, n_buckets: int = 4,
                    epoch_length: int = 4, f: int = 1,
                    n_proxy_leaders: int = 10, grid_rows: int = 2,
                    grid_cols: int = 2, n_replicas: int = 4,
                    forward_fraction: Optional[float] = None,
                    rotations_per_cmd: float = 0.0, n_clients: int = 3,
                    seed: int = 0,
                    state_machine: str = "kv",
                    latency_fn: Optional[Callable[[str, str], float]] = None,
                    ) -> IssDeployment:
    # forwarding/rotation knobs parameterize the *table*; the protocol's
    # own routing behaviour is measured and fed back by _iss_feedback
    del forward_fraction, rotations_per_cmd
    return IssDeployment(n_leaders=n_leaders, n_buckets=n_buckets,
                         epoch_length=epoch_length, f=f,
                         n_proxy_leaders=n_proxy_leaders,
                         grid=(grid_rows, grid_cols), n_replicas=n_replicas,
                         n_clients=n_clients, state_machine=state_machine,
                         seed=seed, latency_fn=latency_fn)


def _iss_feedback(model_cfg: Dict[str, Any], trace: Any) -> Dict[str, Any]:
    """Read the run's own routing statistics into the table: measured
    forward hops per command and rotation broadcasts per command, instead
    of the uniform-routing assumption."""
    dep = trace.deployment
    n = max(trace.n_commands, 1)
    return dict(model_cfg,
                forward_fraction=dep.total_forward_hops() / n,
                rotations_per_cmd=dep.total_rotations() / n)


register_variant(
    name="iss",
    factory=iss_model,
    stations=("leader", "proxy", "acceptor", "replica"),
    knobs=(
        knob("n_leaders", (3,)),
        knob("n_buckets", (4,)),
        knob("epoch_length", (4,)),
        knob("n_proxy_leaders", (10,)),
        knob("grids", ((2, 2),), keys=("grid_rows", "grid_cols")),
        knob("n_replicas", (4,)),
    ),
    takes_f=True,
    candidate_knobs=_iss_candidates,
    description="ISS/Mir round-robin log buckets rotating across leaders "
                "(arXiv 2203.05681)",
)

register_executable(
    "iss",
    deployment=_iss_deployment,
    model_feedback=_iss_feedback,
    # the tail is message-deterministic (exact at any mix); the leader
    # station carries seed-dependent forwarding/rotation timing, exact
    # only against its own run's feedback, so the batched plane (probes
    # at a different seed) gets a real tolerance
    exact_stations=("proxy", "acceptor", "replica"),
    station_tolerances=(("leader", 0.35),),
    rel_tolerance=0.10,
    n_clients=3,
    description="Bucket-rotating multi-leader log over the "
                "compartmentalized tail",
)

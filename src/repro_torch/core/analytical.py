"""Analytical performance models for the paper's evaluation (section 8).

The unit of cost is one *message* handled (sent or received) by a node; a
node processes messages at rate ``alpha`` msgs/sec.  Each protocol deployment
is reduced to a table of **per-server service demands** (expected messages a
single server of each component class handles per command).  Peak throughput
is the bottleneck law

    T_peak = alpha / max_k d_k                     (commands / sec)

and the identity of ``argmax_k d_k`` is the *bottleneck component* - the
quantity the ablation study (paper Fig. 29) tracks as compartmentalizations
are applied one by one.

The model is deliberately parameter-light: ``alpha`` is calibrated on a
single anchor (vanilla MultiPaxos = 25k cmd/s, paper Fig. 28) and everything
else is *predicted*.  ``benchmarks/protocol_messages.py`` measures the
per-role message counts on the real protocol clusters and
``docs/PERFORMANCE_MODEL.md`` documents where the structural model
under/over-predicts (it captures message counts, not JVM/Netty
implementation effects).

Demand tables cover every protocol the paper compartmentalizes, keyed by
the ``VARIANT_MODELS`` registry the sweep axis dispatches on:

* MultiPaxos (:func:`multipaxos_model` / :func:`compartmentalized_model`),
* Mencius (:func:`vanilla_mencius_model` / :func:`mencius_model`,
  paper section 6, Figs. 24-26),
* S-Paxos (:func:`vanilla_spaxos_model` / :func:`spaxos_model`,
  paper section 7, Fig. 27),
* CRAQ (:func:`craq_chain_model` for the sweep axis, :func:`craq_model`
  for the dirty-read fixed point behind Fig. 33),
* unreplicated (:func:`unreplicated_model`).

All of them lower to the same canonical :data:`STATION_ORDER` slots, so a
mixed-variant grid batches into one dense demand tensor
(:func:`stack_demands` -> :mod:`repro.core.sweep`).

Also here: the paper's closed-form read-scalability law (section 8.3)

    T(n) = n * alpha / (n * f_w + f_r)

and the CRAQ skew model backing Fig. 33.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from .api import (
    STATION_INDEX,
    STATION_ORDER,
    VARIANT_MODELS,
    Workload,
    as_f_write,
    knob,
    register_variant,
)

# Paper anchor points (commands/sec), Fig. 28.
PAPER_MULTIPAXOS_UNBATCHED = 25_000.0
PAPER_COMPARTMENTALIZED_UNBATCHED = 150_000.0
PAPER_UNREPLICATED_UNBATCHED = 250_000.0
PAPER_MULTIPAXOS_BATCHED = 200_000.0
PAPER_COMPARTMENTALIZED_BATCHED = 800_000.0
PAPER_UNREPLICATED_BATCHED = 1_000_000.0

# The canonical station vocabulary (STATION_ORDER / STATION_INDEX) is
# *derived* from the variant registry in :mod:`repro.core.api`: every
# station name a registered variant declares maps to one fixed,
# append-ordered slot, so a sweep over heterogeneous deployments lowers to
# a dense [n_configs, K] tensor whose per-row argmax is directly decodable
# back to a component name.  The built-in registrations at the bottom of
# this module allocate the historical order (batcher..tail); runtime
# variants with new station names append after them.  Existing column
# indices are load-bearing for compiled sweeps and never change.


@dataclass(frozen=True)
class Station:
    """A component class: ``servers`` identical nodes, each with per-command
    service demand ``demand_write``/``demand_read`` (message units *per
    server*, i.e. already divided by fan-out across the class)."""

    name: str
    servers: int
    demand_write: float
    demand_read: float = 0.0

    def demand(self, f_write: Union[float, Workload]) -> float:
        f_w = as_f_write(f_write)
        return f_w * self.demand_write + (1.0 - f_w) * self.demand_read


@dataclass(frozen=True)
class DeploymentModel:
    name: str
    stations: Tuple[Station, ...]

    def demands(self, f_write: Union[float, Workload] = 1.0
                ) -> Dict[str, float]:
        """Per-station effective demand at a write fraction (a scalar or a
        :class:`~repro.core.api.Workload`, whose ``f_write`` is used - the
        scalar plane blends only; workload *adaptation* happens at model
        construction via the registry's ``workload_adapter``)."""
        return {s.name: s.demand(f_write) for s in self.stations}

    def bottleneck(self, f_write: Union[float, Workload] = 1.0
                   ) -> Tuple[str, float]:
        ds = self.demands(f_write)
        name = max(ds, key=ds.get)  # type: ignore[arg-type]
        return name, ds[name]

    def peak_throughput(self, alpha: float,
                        f_write: Union[float, Workload] = 1.0) -> float:
        _, d = self.bottleneck(f_write)
        return alpha / d if d > 0 else math.inf

    def total_machines(self) -> int:
        return sum(s.servers for s in self.stations)

    def demand_slots(self) -> Tuple[List[float], List[float], List[int]]:
        """Write/read demands + server counts scattered into the canonical
        :data:`STATION_ORDER` slots (zero where the deployment has no such
        component).  This is the dense row a batched sweep stacks."""
        d_w = [0.0] * len(STATION_ORDER)
        d_r = [0.0] * len(STATION_ORDER)
        srv = [0] * len(STATION_ORDER)
        for s in self.stations:
            i = STATION_INDEX[s.name]
            d_w[i] += s.demand_write
            d_r[i] += s.demand_read
            srv[i] += s.servers
        return d_w, d_r, srv


def stack_demands(models: Sequence[DeploymentModel]
                  ) -> Tuple["np.ndarray", "np.ndarray", "np.ndarray"]:
    """Lower a list of deployments to dense demand tensors.

    Returns ``(demand_write[M, K], demand_read[M, K], machines[M])`` with
    ``K = len(STATION_ORDER)``; column ``k`` of every row is the per-server
    demand of station ``STATION_ORDER[k]`` (0 where absent).  The effective
    demand matrix at write fraction ``f_w`` is
    ``f_w * demand_write + (1 - f_w) * demand_read``, its row-max the
    bottleneck-law denominator, and its row-argmax the bottleneck station.
    """
    import numpy as np

    rows_w, rows_r, rows_m = [], [], []
    for m in models:
        d_w, d_r, srv = m.demand_slots()
        rows_w.append(d_w)
        rows_r.append(d_r)
        rows_m.append(sum(srv))
    return (np.asarray(rows_w, dtype=np.float64),
            np.asarray(rows_r, dtype=np.float64),
            np.asarray(rows_m, dtype=np.int64))


# ---------------------------------------------------------------------------
# Deployment demand tables
# ---------------------------------------------------------------------------


def multipaxos_model(f: int = 1, thrifty: bool = True) -> DeploymentModel:
    """Vanilla MultiPaxos: 2f+1 machines, each proposer+acceptor+replica.

    All messages are counted (no colocation discount), matching the paper's
    own accounting (leader sends/receives >= 3f+4 messages per command).
    """
    n = 2 * f + 1
    n_repl = n  # every machine is a replica
    quorum = f + 1
    contacted = quorum if thrifty else n
    # leader machine: client recv + p2a send + p2b recv + chosen send + its
    # replica-role share of replies
    leader = 1 + contacted + quorum + n_repl + 1.0 / n_repl
    # acceptor role on a non-leader machine: thrifty quorum includes it with
    # probability contacted/n; replica role: chosen recv + reply share
    follower = 2.0 * contacted / n + 1 + 1.0 / n_repl
    return DeploymentModel(
        name=f"multipaxos(f={f})",
        stations=(
            Station("leader", 1, leader, leader),  # MP reads go through leader
            Station("follower", n - 1, follower, follower),
        ),
    )


def compartmentalized_model(
    f: int = 1,
    n_proxy_leaders: int = 10,
    grid_rows: int = 2,
    grid_cols: int = 2,
    n_replicas: int = 4,
    batch_size: int = 1,
    n_batchers: int = 0,
    n_unbatchers: int = 0,
) -> DeploymentModel:
    """Compartmentalized MultiPaxos (paper sections 3-4).

    grid: write quorum = column (``grid_rows`` members), read quorum = row
    (``grid_cols`` members).  ``batch_size=1`` means unbatched.
    """
    r, w = grid_rows, grid_cols
    n_acc = r * w
    B = float(batch_size)
    col = r  # write-quorum size
    row = w  # read-quorum size

    stations: List[Station] = []
    if n_batchers > 0:
        # per cmd: recv 1 + send 1/B (write batch to leader); reads also get
        # prereads amortized over the batch: (2*row + 1)/B
        d_w = (1 + 1 / B) / n_batchers
        d_r = (1 + (2 * row + 1) / B) / n_batchers
        stations.append(Station("batcher", n_batchers, d_w, d_r))
        leader_w = 2.0 / B
    else:
        leader_w = 2.0
    stations.append(Station("leader", 1, leader_w, 0.0))

    # proxy leader: recv p2a + send p2a to column + recv p2b from column +
    # send chosen to replicas
    proxy_per_batch = 1 + col + col + n_replicas
    stations.append(
        Station("proxy", max(n_proxy_leaders, 1),
                proxy_per_batch / B / max(n_proxy_leaders, 1), 0.0))

    # acceptor: writes hit one column (2 msgs each member) -> 2/w per write;
    # reads hit one row (2 msgs each member) -> 2/r per read
    stations.append(Station("acceptor", n_acc, 2.0 / w / B, 2.0 / r / B))

    # replica: every replica receives+executes every write; one replica
    # executes each read; replies owned round-robin (writes) / direct (reads)
    reply_cost = (1 / B) if n_unbatchers > 0 else 1.0
    d_repl_w = 1.0 / B + reply_cost / n_replicas
    d_repl_r = (1.0 / B + reply_cost) / n_replicas
    stations.append(Station("replica", n_replicas, d_repl_w, d_repl_r))

    if n_unbatchers > 0:
        d_ub = (1 / B + 1) / n_unbatchers
        stations.append(Station("unbatcher", n_unbatchers, d_ub, d_ub))

    return DeploymentModel(
        name=(f"compartmentalized(f={f},p={n_proxy_leaders},grid={r}x{w},"
              f"n={n_replicas},B={batch_size})"),
        stations=tuple(stations),
    )


def unreplicated_model(batch_size: int = 1, n_batchers: int = 0,
                       n_unbatchers: int = 0) -> DeploymentModel:
    B = float(batch_size)
    stations = [Station("server", 1, 2.0 / B, 2.0 / B)]
    if n_batchers:
        stations.append(Station("batcher", n_batchers, (1 + 1 / B) / n_batchers,
                                (1 + 1 / B) / n_batchers))
    if n_unbatchers:
        stations.append(Station("unbatcher", n_unbatchers, (1 / B + 1) / n_unbatchers,
                                (1 / B + 1) / n_unbatchers))
    return DeploymentModel(name=f"unreplicated(B={batch_size})",
                           stations=tuple(stations))


# ---------------------------------------------------------------------------
# Protocol-variant demand tables (paper sections 6-7: "compartmentalization
# is a technique, not a protocol")
# ---------------------------------------------------------------------------


def _skip_terms(skip_fraction: float, skip_batch: float) -> float:
    """Noop slots per real command, amortized by the ``Phase2aRange``
    batching factor.  ``skip_fraction`` is the fraction of *log slots*
    filled with noops by lagging leaders; each range message covers
    ``skip_batch`` noop slots, so the chosen path pays an extra
    ``skip_fraction / (1 - skip_fraction) / skip_batch`` messages per
    real command."""
    if not 0.0 <= skip_fraction < 1.0:
        raise ValueError(f"skip_fraction must be in [0, 1): {skip_fraction}")
    if skip_fraction == 0.0:
        return 0.0
    return skip_fraction / (1.0 - skip_fraction) / skip_batch


def mencius_model(
    n_leaders: int = 3,
    f: int = 1,
    n_proxy_leaders: int = 10,
    grid_rows: int = 2,
    grid_cols: int = 2,
    n_replicas: int = 4,
    announce_interval: Optional[float] = None,
    skip_fraction: float = 0.0,
    skip_batch: float = 10.0,
) -> DeploymentModel:
    """Compartmentalized Mencius (paper section 6, Figs. 24-26).

    Round-robin log partitioning: leader ``i`` of ``n_leaders`` owns slots
    ``{k : k % m == i}``, so per-leader sequencing demand is ``2/m`` (client
    recv + proxy send for the owned 1/m of commands).  Everything past the
    leaders is the MultiPaxos compartmentalization: proxy leaders, an
    ``r x w`` acceptor grid, scaled replicas, leaderless reads.

    Two overhead knobs model Mencius' slot-coordination cost:

    * ``announce_interval`` - a leader advertises its frontier to the other
      ``m - 1`` leaders every that many owned commands (``None`` = the
      paper's protocol, where frontiers piggyback on phase-2 traffic at no
      extra message cost; the correctness plane announces every command,
      i.e. ``announce_interval=1`` - the parity benchmark uses that).
    * ``skip_fraction`` - fraction of log slots noop-filled by lagging
      leaders ("skips").  Ranges amortize ``skip_batch`` noops per message
      but still traverse proxy -> grid -> replicas, so a skip storm loads
      the whole chosen path (the transient script
      :func:`repro.core.transient.mencius_skip_storm_schedule`).
    """
    m = n_leaders
    if m < 1:
        raise ValueError(f"n_leaders must be >= 1: {m}")
    r, w = grid_rows, grid_cols
    col = r  # write-quorum size (one grid column)
    noop = _skip_terms(skip_fraction, skip_batch)
    announce = 0.0
    if announce_interval:
        # per system command: the owner sends m-1 frontier messages every
        # announce_interval owned commands and every peer receives one
        announce = 2.0 * (m - 1) / announce_interval

    leader_w = (2.0 + announce + noop) / m
    proxy_per_cmd = (1 + 2 * col + n_replicas) * (1.0 + noop)
    stations = (
        Station("leader", m, leader_w, 0.0),
        Station("proxy", max(n_proxy_leaders, 1),
                proxy_per_cmd / max(n_proxy_leaders, 1), 0.0),
        Station("acceptor", r * w, 2.0 / w * (1.0 + noop), 2.0 / r),
        Station("replica", n_replicas,
                (1.0 + noop) + 1.0 / n_replicas, 2.0 / n_replicas),
    )
    return DeploymentModel(
        name=(f"mencius(m={m},p={n_proxy_leaders},grid={r}x{w},"
              f"n={n_replicas})"),
        stations=stations,
    )


def vanilla_mencius_model(
    f: int = 1,
    announce_interval: Optional[float] = None,
    skip_fraction: float = 0.0,
    skip_batch: float = 10.0,
) -> DeploymentModel:
    """Vanilla Mencius (paper Fig. 25 baseline): ``2f + 1`` servers, each
    simultaneously one of the round-robin leaders, an acceptor and a
    replica.  Load is symmetric, so a server's demand is the balanced mix
    of the MultiPaxos leader cost (for its owned ``1/m`` of commands) and
    the follower cost (for the rest), plus the announce/skip overheads of
    :func:`mencius_model`.  No leaderless read path: reads are writes."""
    m = 2 * f + 1
    quorum = f + 1
    contacted = quorum  # thrifty
    leader_cost = 1 + contacted + quorum + m + 1.0 / m
    follower_cost = 2.0 * contacted / m + 1 + 1.0 / m
    noop = _skip_terms(skip_fraction, skip_batch)
    announce = 0.0
    if announce_interval:
        announce = 2.0 * (m - 1) / announce_interval
    per_server = ((leader_cost + (m - 1) * follower_cost) * (1.0 + noop)
                  + announce) / m
    return DeploymentModel(
        name=f"vanilla_mencius(f={f})",
        stations=(Station("server", m, per_server, per_server),),
    )


def spaxos_model(
    n_disseminators: int = 2,
    n_stabilizers: int = 3,
    f: int = 1,
    n_proxy_leaders: int = 3,
    grid_rows: int = 2,
    grid_cols: int = 2,
    n_replicas: int = 3,
    payload_factor: float = 1.0,
) -> DeploymentModel:
    """Compartmentalized S-Paxos (paper section 7, Fig. 27).

    Data/control split: disseminators persist command *payloads* on every
    stabilizer (majority ack), the MultiPaxos leader orders only small
    command *ids*, and the chosen id is resolved back to a payload by one
    stabilizer which broadcasts it to the replicas.  ``payload_factor``
    scales the cost of payload-carrying messages relative to id-sized ones
    (1.0 = payloads as cheap as ids); the leader's demand is **payload
    independent** - the paper's point - which the transient script
    :func:`repro.core.transient.spaxos_payload_ramp_schedule` turns into a
    dynamics figure.

    Write path (matches ``src/repro/core/spaxos.py`` message for message):
    client -> disseminator -> all stabilizers (ack) -> leader(id) ->
    proxy -> grid column -> Chosen(id) -> one stabilizer -> replicas.
    Reads are the standard leaderless path (grid row + one replica)."""
    P = float(payload_factor)
    r, w = grid_rows, grid_cols
    col = r
    d = max(n_disseminators, 1)
    s = max(n_stabilizers, 1)
    stations = (
        # recv payload + bcast payload to stabilizers; small: acks + ProposeId
        Station("disseminator", d, (P * (1 + s) + s + 1) / d, 0.0),
        # every stabilizer: payload recv + ack; 1/s of commands: Chosen(id)
        # recv + payload bcast to replicas
        Station("stabilizer", s, (P + 1) + (1 + P * n_replicas) / s, 0.0),
        Station("leader", 1, 2.0, 0.0),       # ProposeId recv + Phase2a(id)
        Station("proxy", max(n_proxy_leaders, 1),
                (1 + 2 * col + 1) / max(n_proxy_leaders, 1), 0.0),
        Station("acceptor", r * w, 2.0 / w, 2.0 / r),
        Station("replica", n_replicas, P + 1.0 / n_replicas,
                (1.0 + P) / n_replicas),
    )
    return DeploymentModel(
        name=(f"spaxos(d={n_disseminators},s={n_stabilizers},"
              f"p={n_proxy_leaders},grid={r}x{w},n={n_replicas},P={P:g})"),
        stations=stations,
    )


def vanilla_spaxos_model(f: int = 1,
                         payload_factor: float = 1.0) -> DeploymentModel:
    """Vanilla S-Paxos (paper Fig. 27 baseline): ``2f + 1`` servers, each
    disseminator + stabilizer + acceptor + replica, with a single Paxos
    leader (on server 0) ordering ids.  The dissemination/stabilization
    roles are balanced round-robin; the leader role is not - its id-sized
    phase-2 fan-out sits on top of the shared data-path work, which is why
    vanilla S-Paxos still bottlenecks on one machine."""
    n = 2 * f + 1
    P = float(payload_factor)
    quorum = f + 1
    contacted = quorum  # thrifty
    # balanced per-server data-path work, per system command
    dis_share = (P * (1 + n) + n + 1) / n     # 1/n of commands disseminated
    stab = P + 1.0                            # every server stores + acks
    acceptor = 2.0 * contacted / n
    chosen_recv = 1.0                         # id-sized commit broadcast
    reply_share = P / n                       # round-robin payload replies
    shared = dis_share + stab + acceptor + chosen_recv + reply_share
    leader_extra = 1 + contacted + quorum + n  # ProposeId + p2a/p2b + commit
    return DeploymentModel(
        name=f"vanilla_spaxos(f={f},P={P:g})",
        stations=(
            Station("leader", 1, shared + leader_extra, shared + leader_extra),
            Station("follower", n - 1, shared, shared),
        ),
    )


def craq_chain_model(n_nodes: int = 3, skew_p: float = 0.0,
                     dirty_fraction: float = 0.0) -> DeploymentModel:
    """CRAQ as a static chain demand table for the variant sweep axis.

    ``head``/``chain``/``tail`` stations carry the chain positions.  The
    counts are message-exact against ``repro.core.craq.CraqDeployment``
    (the ``msgcount`` parity benchmark pins them): a write costs the head
    4 messages (client request in, chain write down, ack back up, client
    reply out), every interior node 4 (write + ack, both relayed), and
    the tail 2 (write in, ack out).  A read costs its serving node 2
    (request + reply *or* request + tail forward - same count either
    way); a read that hits the hot key (probability ``skew_p``) while it
    is dirty (``dirty_fraction``) and lands on a non-tail node is
    additionally forwarded to the tail (+2 there).  This is the static
    sibling of :func:`craq_station_demands`, which keeps the paper's
    Fig. 33 parameterization and solves the dirty busy-indicator as a
    throughput fixed point (:func:`craq_model`) - use that for Fig. 33,
    this factory when you want CRAQ batched into a mixed-variant sweep."""
    k = n_nodes
    if k < 2:
        raise ValueError(f"a chain needs >= 2 nodes: {k}")
    p_fwd = skew_p * dirty_fraction
    read_local = 2.0 / k  # uniformly addressed; served or forwarded, 2 msgs
    stations = [Station("head", 1, 4.0, read_local)]
    if k > 2:
        stations.append(Station("chain", k - 2, 4.0, read_local))
    stations.append(
        Station("tail", 1, 2.0, read_local + p_fwd * 2.0 * (k - 1) / k))
    return DeploymentModel(
        name=f"craq(k={k},p={skew_p:g},dirty={dirty_fraction:g})",
        stations=tuple(stations),
    )


# (The pre-registry VARIANT_MODELS dict lived here; it is now a live view
# of the :mod:`repro.core.api` registry, populated by the built-in
# registrations at the bottom of this module.)


def craq_station_demands(n_nodes: int, skew_p: float, f_write: float,
                         alpha: float, T: float,
                         commit_latency_cmds: float = 8.0) -> List[float]:
    """Per-node CRAQ message demands at offered throughput ``T`` (the
    demand mapping behind :func:`craq_model`, exposed so time-varying skew
    schedules can feed the transient engine a chain-demand vector per
    window - paper Fig. 33 as dynamics).

    With probability ``skew_p`` an op targets hot key 0; otherwise a
    uniform cold key.  A read of a *dirty* key is forwarded to the tail;
    the hot key is dirty whenever one of its writes is in flight
    (M/G/inf busy indicator with commit time ``C``)."""
    f_write = as_f_write(f_write)
    k = n_nodes
    lam_w_hot = T * f_write * skew_p
    C = commit_latency_cmds * (2.0 * k) / alpha
    dirty = 1.0 - math.exp(-lam_w_hot * C)
    f_read = 1.0 - f_write
    # every node: writes cost 4 msgs (fwd recv/send + ack recv/send);
    # head also takes client recv + reply send
    demands = []
    for i in range(k):
        d = f_write * 4.0
        if i == 0:
            d += f_write * 2.0
        # reads: uniformly addressed; clean served locally (2 msgs)
        p_fwd = skew_p * dirty
        d += f_read * ((1.0 - p_fwd) * 2.0 / k + p_fwd * (1.0 / k))
        if i == k - 1:  # tail: all forwarded reads + its own share
            d += f_read * p_fwd * 2.0
        demands.append(d)
    return demands


def craq_model(n_nodes: int, skew_p: float, f_write: float,
               alpha: float, commit_latency_cmds: float = 8.0) -> float:
    """CRAQ peak throughput under the paper's skew workload (section 8.4).

    Solves for the fixed point T where the bottleneck node of
    :func:`craq_station_demands` saturates.
    """
    T = alpha / 4.0
    for _ in range(200):
        d = max(craq_station_demands(n_nodes, skew_p, f_write, alpha, T,
                                     commit_latency_cmds))
        T_new = alpha / d
        if abs(T_new - T) < 1e-6 * alpha:
            T = T_new
            break
        T = 0.5 * T + 0.5 * T_new
    return T


# ---------------------------------------------------------------------------
# Calibration + the paper's closed-form law
# ---------------------------------------------------------------------------


def calibrate_alpha(anchor_throughput: float = PAPER_MULTIPAXOS_UNBATCHED,
                    model: Optional[DeploymentModel] = None,
                    f_write: float = 1.0,
                    measured: bool = False,
                    n_commands: int = 40,
                    seed: int = 0,
                    geo: Optional[Any] = None) -> float:
    """alpha such that the anchor deployment peaks at ``anchor_throughput``
    (vanilla MultiPaxos = 25k cmd/s, paper Fig. 28).

    With ``measured=False`` (default) the bottleneck demand comes from the
    anchor's demand *table*.  With ``measured=True`` it is read off an
    **executed** vanilla MultiPaxos run instead of a constant: the
    ``multipaxos`` variant's registered execution plane
    (``repro.core.execution.run_variant``) drives the real cluster and the
    measured per-server messages per command of its bottleneck station
    become the calibration denominator - the 25k anchor then rests on the
    correctness plane, not on the table it is meant to validate.
    ``measured=True`` requires the default anchor (``model=None``).

    ``geo`` (a :class:`~repro.core.api.GeoSpec`, ``measured=True`` only)
    calibrates off a geo-deployed anchor while keeping alpha a *local*
    per-node rate: WAN round trips stretch the run's wall-clock but add
    no per-server work, so the measured-vs-table deviation of the
    bottleneck demand is rescaled by the fraction of the measured mean
    latency that modeled WAN wire time (:func:`repro.core.geo.
    wan_offsets`) does NOT explain - ``d_corr = d_pred + (d_meas -
    d_pred) * r_local / r_total``.  With ``geo=None`` or a uniform
    matrix the correction is exactly the identity, pinning the
    historical calibration value."""
    if measured:
        if model is not None:
            raise TypeError(
                "calibrate_alpha: measured=True executes the registered "
                "'multipaxos' anchor; pass model=None")
        # lazy import: execution imports this module (no cycle at import)
        from .execution import run_variant
        trace = run_variant("multipaxos", workload=Workload(f_write=f_write),
                            n_commands=n_commands, seed=seed, geo=geo)
        d_meas = max(trace.station_msgs.values())
        if geo is None or geo.is_uniform:
            return anchor_throughput * d_meas
        from .geo import wan_offsets
        _, d_pred = multipaxos_model().bottleneck(f_write)
        counts = {name: w + r for name, (w, r) in trace.region_ops.items()}
        total = max(sum(counts.values()), 1)
        r_total = sum(trace.region_latency[name] * n
                      for name, n in counts.items()) / total
        off = wan_offsets({"variant": "multipaxos"}, geo,
                          workload=Workload(f_write=f_write),
                          n_clients=trace.geo_n_clients)
        wan = sum(off[list(geo.regions).index(name)] * n
                  for name, n in counts.items()) / total
        r_local = max(r_total - wan, 1e-12)
        d_corr = d_pred + (d_meas - d_pred) * r_local / max(r_total, 1e-12)
        return anchor_throughput * d_corr
    if geo is not None:
        raise TypeError("calibrate_alpha: geo= requires measured=True "
                        "(the table path has no cluster to deploy on)")
    model = model or multipaxos_model()
    _, d = model.bottleneck(f_write)
    return anchor_throughput * d


def read_scalability_law(n_replicas: float, f_write: Union[float, Workload],
                         alpha_replica: float) -> float:
    """Paper section 8.3:  T = n*alpha / (n*f_w + f_r)."""
    f_write = as_f_write(f_write)
    f_read = 1.0 - f_write
    return n_replicas * alpha_replica / (n_replicas * f_write + f_read)


def ablation_steps(f: int = 1) -> List[Tuple[str, DeploymentModel]]:
    """The paper's Fig. 29a sequence: decouple, then scale each bottleneck."""
    return [
        ("multipaxos", multipaxos_model(f=f)),
        ("decoupled (2 proxies, 3 acc, 2 repl)",
         compartmentalized_model(f=f, n_proxy_leaders=2, grid_rows=3, grid_cols=1,
                                 n_replicas=2)),
        ("3 proxy leaders",
         compartmentalized_model(f=f, n_proxy_leaders=3, grid_rows=3, grid_cols=1,
                                 n_replicas=2)),
        ("5 proxy leaders",
         compartmentalized_model(f=f, n_proxy_leaders=5, grid_rows=3, grid_cols=1,
                                 n_replicas=2)),
        ("7 proxy leaders",
         compartmentalized_model(f=f, n_proxy_leaders=7, grid_rows=3, grid_cols=1,
                                 n_replicas=2)),
        ("3 replicas",
         compartmentalized_model(f=f, n_proxy_leaders=7, grid_rows=3, grid_cols=1,
                                 n_replicas=3)),
        ("10 proxy leaders",
         compartmentalized_model(f=f, n_proxy_leaders=10, grid_rows=3, grid_cols=1,
                                 n_replicas=3)),
        ("paper deployment (10 proxies, 2x2 grid, 4 replicas)",
         compartmentalized_model(f=f, n_proxy_leaders=10, grid_rows=2, grid_cols=2,
                                 n_replicas=4)),
    ]


def mixed_workload_speedup(f_write: float, alpha: float,
                           n_replicas: int = 6) -> Tuple[float, float, float]:
    """(T_multipaxos, T_compartmentalized, speedup) for a read/write mix.

    MultiPaxos treats reads as writes (no read path); compartmentalized
    MultiPaxos serves reads from single replicas (the 16x headline claim is a
    90% read workload, paper section 10)."""
    mp = multipaxos_model(f=1).peak_throughput(alpha, f_write=1.0)
    cmp_model = compartmentalized_model(f=1, n_proxy_leaders=10, grid_rows=4,
                                        grid_cols=4, n_replicas=n_replicas)
    cm = cmp_model.peak_throughput(alpha, f_write=f_write)
    return mp, cm, cm / mp


# ---------------------------------------------------------------------------
# Built-in variant registrations (the registry the whole performance plane
# dispatches on - see repro.core.api; runtime variants register the same
# way with ZERO edits to this file)
# ---------------------------------------------------------------------------


def grids_under(max_cells: int, f: int) -> List[Tuple[int, int]]:
    """Acceptor grids with write quorums (columns) of >= f + 1 members and
    at most ``max_cells`` acceptors, plus the (2f+1, 1) majority column."""
    grids: List[Tuple[int, int]] = [(2 * f + 1, 1)]
    for rows in range(f + 1, max(max_cells, f + 1) + 1):
        for cols in range(1, max(max_cells // rows, 1) + 1):
            if rows * cols <= max_cells and (rows, cols) not in grids:
                grids.append((rows, cols))
    return grids


def effective_batch_size(batch_size: int, batch_fill: float) -> int:
    """Batch size actually achieved at a fill fraction: under sparse or
    bursty arrivals batches close before ``B`` commands accumulate, so the
    amortization a batcher buys shrinks to ``1 + (B - 1) * fill``."""
    return max(1, int(round(1 + (batch_size - 1) * batch_fill)))


def _batch_fill_adapter(config: Dict, workload: Workload) -> Dict:
    """Workload adapter for batched variants: scale the config's batch
    size by the workload's fill hint (no-op at full batches)."""
    B = int(config.get("batch_size", 1))
    if workload.batch_fill >= 1.0 or B <= 1:
        return config
    return {**config, "batch_size": effective_batch_size(B, workload.batch_fill)}


def _craq_workload_adapter(config: Dict, workload: Workload) -> Dict:
    """Workload adapter for CRAQ: skewed reads hit the hot key with
    probability ``skew_p`` and forward to the tail while it is dirty -
    the config inherits the workload's skew hints unless it pins its own."""
    if workload.skew_p <= 0.0 or "skew_p" in config:
        return config
    return {**config, "skew_p": workload.skew_p,
            "dirty_fraction": workload.dirty_fraction}


def _compartmentalized_candidates(budget: int, f: int) -> Dict[str, tuple]:
    """The unbatched discrete config space under a machine budget (knob
    ranges clipped so the smallest other components still fit)."""
    min_grid = f + 1                       # the (f+1, 1) column grid
    min_rest = 1 + min_grid + (f + 1)      # leader + smallest grid + replicas
    max_proxies = max(budget - min_rest, 1)
    max_replicas = max(budget - (1 + 1 + min_grid), f + 1)
    max_grid = budget - (1 + 1 + (f + 1))  # leader + 1 proxy + f+1 replicas
    return {
        "n_proxy_leaders": tuple(range(1, max_proxies + 1)),
        "grids": tuple(grids_under(max_grid, f)),
        "n_replicas": tuple(range(f + 1, max_replicas + 1)),
    }


def _mencius_candidates(budget: int, f: int) -> Dict[str, tuple]:
    """Coarsened Mencius candidate space (the extra leader axis would
    otherwise blow up the cartesian product)."""
    min_grid = f + 1
    max_proxies = max(budget - (1 + min_grid + (f + 1)), 1)
    max_replicas = max(budget - (1 + 1 + min_grid), f + 1)
    return {
        "n_leaders": tuple(range(1, min(budget, 5) + 1)),
        "n_proxy_leaders": tuple(range(1, min(max_proxies, 8) + 1)),
        "grids": ((2 * f + 1, 1), (f + 1, f + 1)),
        "n_replicas": tuple(range(f + 1, min(max_replicas, f + 7) + 1)),
    }


def _spaxos_candidates(budget: int, f: int) -> Dict[str, tuple]:
    """Coarsened S-Paxos candidate space (disseminator/stabilizer axes)."""
    min_grid = f + 1
    max_proxies = max(budget - (1 + min_grid + (f + 1)), 1)
    max_replicas = max(budget - (1 + 1 + min_grid), f + 1)
    return {
        "n_disseminators": tuple(range(1, min(budget, 6) + 1)),
        "n_stabilizers": (2 * f + 1, 2 * f + 3),
        "n_proxy_leaders": tuple(range(1, min(max_proxies, 6) + 1)),
        "grids": ((2 * f + 1, 1), (f + 1, f + 1)),
        "n_replicas": tuple(range(f + 1, min(max_replicas, f + 5) + 1)),
    }


def _craq_candidates(budget: int, f: int) -> Dict[str, tuple]:
    return {"chain_nodes": tuple(range(2, min(budget, 7) + 1))}


# Registration order is load-bearing for *new* station names only: this
# sequence reproduces the historical STATION_ORDER slot layout exactly
# (batcher, leader, proxy, acceptor, replica, unbatcher, server, follower,
# disseminator, stabilizer, head, chain, tail).
register_variant(
    name="compartmentalized",
    factory=compartmentalized_model,
    stations=("batcher", "leader", "proxy", "acceptor", "replica",
              "unbatcher"),
    knobs=(
        knob("n_proxy_leaders", (10,)),
        knob("grids", ((2, 2),), keys=("grid_rows", "grid_cols")),
        knob("n_replicas", (4,)),
        knob("batch_sizes", (1,), keys=("batch_size",)),
        knob("n_batchers", (0,)),
        knob("n_unbatchers", (0,)),
    ),
    takes_f=True,
    implicit_variant_key=True,  # pre-registry config dicts omit "variant"
    workload_adapter=_batch_fill_adapter,
    candidate_knobs=_compartmentalized_candidates,
    description="Compartmentalized MultiPaxos (paper sections 3-4)",
)

register_variant(
    name="unreplicated",
    factory=unreplicated_model,
    stations=("server", "batcher", "unbatcher"),
    takes_f=False,
    workload_adapter=_batch_fill_adapter,
    description="Unreplicated state machine baseline (paper Fig. 28)",
)

register_variant(
    name="multipaxos",
    factory=multipaxos_model,
    stations=("leader", "follower"),
    description="Vanilla MultiPaxos baseline (2f+1 fused servers)",
)

register_variant(
    name="mencius",
    factory=mencius_model,
    stations=("leader", "proxy", "acceptor", "replica"),
    knobs=(
        knob("n_leaders", (3,)),
        knob("n_proxy_leaders", (10,)),
        knob("grids", ((2, 2),), keys=("grid_rows", "grid_cols")),
        knob("n_replicas", (4,)),
    ),
    candidate_knobs=_mencius_candidates,
    description="Compartmentalized Mencius (paper section 6, Figs. 24-26)",
)

register_variant(
    name="vanilla_mencius",
    factory=vanilla_mencius_model,
    stations=("server",),
    description="Vanilla Mencius baseline (paper Fig. 25)",
)

register_variant(
    name="spaxos",
    factory=spaxos_model,
    stations=("disseminator", "stabilizer", "leader", "proxy", "acceptor",
              "replica"),
    knobs=(
        knob("n_disseminators", (2,)),
        knob("n_stabilizers", (3,)),
        knob("n_proxy_leaders", (10,)),
        knob("grids", ((2, 2),), keys=("grid_rows", "grid_cols")),
        knob("n_replicas", (4,)),
    ),
    candidate_knobs=_spaxos_candidates,
    description="Compartmentalized S-Paxos (paper section 7, Fig. 27)",
)

register_variant(
    name="vanilla_spaxos",
    factory=vanilla_spaxos_model,
    stations=("leader", "follower"),
    description="Vanilla S-Paxos baseline (paper Fig. 27)",
)

register_variant(
    name="craq",
    factory=craq_chain_model,
    stations=("head", "chain", "tail"),
    knobs=(knob("chain_nodes", (3,), keys=("n_nodes",)),),
    takes_f=False,
    workload_adapter=_craq_workload_adapter,
    candidate_knobs=_craq_candidates,
    description="CRAQ chain comparison (paper section 8.4, Fig. 33)",
)

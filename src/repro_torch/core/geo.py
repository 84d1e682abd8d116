"""Critical-path WAN latency models: the geo plane's analytical side.

Every analytical model in :mod:`repro.core.analytical` counts *messages
per command* - a throughput currency.  This module lowers the SAME
registered message flows into *critical-path WAN round trips*: given a
:class:`~repro.core.api.GeoSpec` (regions, RTT matrix, placement, client
weights), each variant's per-op-class latency is the sum of hop delays
along the chain the real cluster walks, with quorum legs taken in
expectation over the deployment's uniform-random quorum picks:

* a one-way hop between regions ``i`` and ``j`` costs
  ``local_delay + one_way(i, j)`` (``one_way = rtt/2``, 0 intra-region),
  exactly :meth:`GeoSpec.hop_delay` - the function the execution plane's
  ``Network.latency_fn`` realizes, so measured and predicted latency are
  two views of one number;
* a *broadcast-wait-quorum* leg (Phase 2a/2b, S-Paxos stabilization,
  BPaxos dependency service) is the k-th smallest round trip when the
  sender broadcasts to everyone, or ``E[max over quorum members]`` when
  the sender picks one quorum uniformly at random (the deployments'
  ``pick_write_quorum`` / ``pick_read_quorum``);
* a *fan-out-then-reply* leg (Chosen to replicas, the owner replies)
  averages over the uniformly-assigned responder.

Per-region tensors come from iterating the actual closed-loop client
population: client ``i`` lives in ``geo.client_region(i, n_clients)``
and enters the cluster at entry replica ``i % entry_count`` - the same
deterministic routing the deployments use - then latencies average
within each region.  Regions that host no client report the expectation
over entry points (what a client placed there *would* see).

The models here are failure-free and queueing-free: pure wire time.
:meth:`repro.core.sweep.CompiledSweep.geo_latency` composes these WAN
offsets with the jitted MVA queueing curves into the (config x region)
latency surface; :func:`repro.core.execution.validate_variant` checks
them against real measured cluster latency per region.

Stdlib-only on purpose: the docs-link checker imports this module
without jax/numpy installed, and the execution plane must not grow a
jax dependency.

Adding a variant: :func:`register_geo_path` installs a
``(config, geo, n_clients) -> (write[R], read[R])`` lowering under the
variant's name - runtime-registered variants join the geo plane with
zero edits here, same contract as the demand-table registry.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from .api import GeoSpec, Workload, resolve_workload, variant_spec

Config = Dict[str, Any]

# (config, geo, n_clients) -> (per-region write latency, per-region read
# latency), both length geo.n_regions
GeoPathFn = Callable[[Config, GeoSpec, int], Tuple[List[float], List[float]]]

_GEO_PATHS: Dict[str, GeoPathFn] = {}


def register_geo_path(name: str, fn: GeoPathFn) -> None:
    """Install (or replace) a variant's critical-path lowering."""
    _GEO_PATHS[name] = fn


def geo_variants() -> Tuple[str, ...]:
    """Variants with a registered critical-path latency lowering."""
    return tuple(_GEO_PATHS)


@dataclass(frozen=True)
class GeoLatency:
    """Per-region critical-path wire latency of one deployment.

    ``write[r]`` / ``read[r]`` are the expected commit / read latencies
    (virtual time units) seen by a client in region ``r``; variants that
    execute reads through the write path (``reads_as_writes``) report
    ``read == write``.
    """

    variant: str
    regions: Tuple[str, ...]
    write: Tuple[float, ...]
    read: Tuple[float, ...]

    def blended(self, workload: Optional[Union[Workload, float]] = None,
                f_write: Optional[float] = None) -> Tuple[float, ...]:
        """Mix write/read latency at a workload's write fraction."""
        w = resolve_workload(workload, f_write, where="GeoLatency.blended")
        return tuple(w.f_write * wr + w.f_read * rd
                     for wr, rd in zip(self.write, self.read))


# ---------------------------------------------------------------------------
# hop algebra
# ---------------------------------------------------------------------------


def _rt(geo: GeoSpec, i: int, j: int) -> float:
    """Round trip between regions: there and back (2 local hops +
    full RTT).  ``i == j`` still costs two local hops - the wire goes
    through the network queue even for same-region (and self-addressed)
    sends."""
    return 2.0 * geo.local_delay + 2.0 * geo.one_way(i, j)


def _mean(xs) -> float:
    xs = list(xs)
    return sum(xs) / len(xs)


def _regions(geo: GeoSpec, kind: str, n: int) -> List[int]:
    return [geo.region_of(kind, i) for i in range(n)]


def _majority_quorums(n: int, k: int) -> List[Tuple[int, ...]]:
    return list(itertools.combinations(range(n), k))


def _grid_quorums(rows: int, cols: int
                  ) -> Tuple[List[Tuple[int, ...]], List[Tuple[int, ...]]]:
    """(write quorums, read quorums) of a row-major ``rows x cols`` grid:
    write quorums are columns, read quorums are rows - the same id
    layout as ``quorums.GridQuorums``."""
    writes = [tuple(r * cols + c for r in range(rows)) for c in range(cols)]
    reads = [tuple(r * cols + c for c in range(cols)) for r in range(rows)]
    return writes, reads


def _quorum_leg(geo: GeoSpec, src_region: int,
                quorums: Sequence[Tuple[int, ...]],
                member_regions: Sequence[int]) -> float:
    """E over a uniformly-picked quorum of the max round trip to its
    members: the sender unicasts to one quorum and waits for all of it
    (``pick_write_quorum`` / ``pick_read_quorum`` semantics)."""
    return _mean(max(_rt(geo, src_region, member_regions[m]) for m in q)
                 for q in quorums)


def _kth_smallest_rt(geo: GeoSpec, src_region: int,
                     member_regions: Sequence[int], k: int) -> float:
    """Broadcast to everyone, wait for the ``k`` fastest acks."""
    return sorted(_rt(geo, src_region, m) for m in member_regions)[k - 1]


def _per_region(geo: GeoSpec, n_clients: int, entry_count: int,
                lat: Callable[[int, int], Tuple[float, float]]
                ) -> Tuple[List[float], List[float]]:
    """Average ``lat(client_region, entry_index) -> (write, read)`` over
    the real client population: client ``i`` sits in
    ``client_region(i, n_clients)`` and enters at ``i % entry_count``.
    Regions hosting no client get the uniform-entry expectation."""
    sums_w = [0.0] * geo.n_regions
    sums_r = [0.0] * geo.n_regions
    counts = [0] * geo.n_regions
    for i in range(n_clients):
        rc = geo.client_region(i, n_clients)
        w, r = lat(rc, i % entry_count)
        sums_w[rc] += w
        sums_r[rc] += r
        counts[rc] += 1
    write: List[float] = []
    read: List[float] = []
    for rc in range(geo.n_regions):
        if counts[rc]:
            write.append(sums_w[rc] / counts[rc])
            read.append(sums_r[rc] / counts[rc])
        else:
            pairs = [lat(rc, e) for e in range(entry_count)]
            write.append(_mean(p[0] for p in pairs))
            read.append(_mean(p[1] for p in pairs))
    return write, read


def _reject_batching(cfg: Config, variant: str) -> None:
    if cfg.get("n_batchers", 0) or cfg.get("n_unbatchers", 0):
        raise ValueError(
            f"geo critical-path model for {variant!r} does not cover "
            "batched deployments: the batcher's FLUSH_AFTER timer adds "
            "latency the wire-time model cannot see")


def _acceptor_quorums(cfg: Config, f: int
                      ) -> Tuple[int, List[Tuple[int, ...]],
                                 List[Tuple[int, ...]]]:
    """(n_acceptors, write quorums, read quorums) for a grid config;
    the ``(2f+1, 1)`` grid lowers to majority quorums exactly like the
    compartmentalized deployment does."""
    rows = int(cfg.get("grid_rows", 2))
    cols = int(cfg.get("grid_cols", 2))
    if (rows, cols) == (2 * f + 1, 1):
        n = 2 * f + 1
        maj = _majority_quorums(n, f + 1)
        return n, maj, maj
    wq, rq = _grid_quorums(rows, cols)
    return rows * cols, wq, rq


def _preread(geo: GeoSpec, rc: int, read_quorums: Sequence[Tuple[int, ...]],
             acc: Sequence[int], reps: Sequence[int]) -> float:
    """The linearizable leaderless read: Preread round to one random
    read quorum, then a round trip to one random replica."""
    return (_quorum_leg(geo, rc, read_quorums, acc)
            + _mean(_rt(geo, rc, rep) for rep in reps))


def _ordered_tail(geo: GeoSpec, entry: int, rc: int,
                  prox: Sequence[int], wq: Sequence[Tuple[int, ...]],
                  acc: Sequence[int], reps: Sequence[int]) -> float:
    """The shared proxy-leader commit tail: entry station -> round-robin
    proxy -> Phase 2 quorum -> Chosen fan-out -> owning replica replies
    to the client.  ``prox`` empty means the sequencer self-broadcasts
    (no proxy hop)."""
    if not prox:
        return (_quorum_leg(geo, entry, wq, acc)
                + _mean(geo.hop_delay(entry, rep) + geo.hop_delay(rep, rc)
                        for rep in reps))
    return _mean(
        geo.hop_delay(entry, p)
        + _quorum_leg(geo, p, wq, acc)
        + _mean(geo.hop_delay(p, rep) + geo.hop_delay(rep, rc)
                for rep in reps)
        for p in prox)


# ---------------------------------------------------------------------------
# per-variant lowerings (mirror the deployments in protocols/mencius/
# spaxos/craq/bpaxos/iss - every leg here is a send the real cluster makes)
# ---------------------------------------------------------------------------


def _path_compartmentalized(cfg: Config, geo: GeoSpec, n_clients: int
                            ) -> Tuple[List[float], List[float]]:
    _reject_batching(cfg, "compartmentalized")
    f = int(cfg.get("f", 1))
    n_acc, wq, rq = _acceptor_quorums(cfg, f)
    n_prox = int(cfg.get("n_proxy_leaders", 10))
    n_rep = int(cfg.get("n_replicas", 4))
    acc = _regions(geo, "acceptor", n_acc)
    prox = _regions(geo, "proxy", n_prox)
    reps = _regions(geo, "replica", n_rep)
    leader = geo.region_of("leader", 0)

    def lat(rc: int, _e: int) -> Tuple[float, float]:
        write = (geo.hop_delay(rc, leader)
                 + _ordered_tail(geo, leader, rc, prox, wq, acc, reps))
        return write, _preread(geo, rc, rq, acc, reps)

    return _per_region(geo, n_clients, 1, lat)


def _path_multipaxos(cfg: Config, geo: GeoSpec, n_clients: int
                     ) -> Tuple[List[float], List[float]]:
    f = int(cfg.get("f", 1))
    n = 2 * f + 1
    wq = _majority_quorums(n, f + 1)
    acc = _regions(geo, "acceptor", n)
    reps = _regions(geo, "replica", n)
    leader = geo.region_of("leader", 0)

    def lat(rc: int, _e: int) -> Tuple[float, float]:
        w = (geo.hop_delay(rc, leader)
             + _ordered_tail(geo, leader, rc, (), wq, acc, reps))
        return w, w  # reads_as_writes

    return _per_region(geo, n_clients, 1, lat)


def _path_mencius(cfg: Config, geo: GeoSpec, n_clients: int
                  ) -> Tuple[List[float], List[float]]:
    f = int(cfg.get("f", 1))
    m = int(cfg.get("n_leaders", 3))
    n_acc, wq, rq = _acceptor_quorums(cfg, f)
    prox = _regions(geo, "proxy", int(cfg.get("n_proxy_leaders", 4)))
    acc = _regions(geo, "acceptor", n_acc)
    reps = _regions(geo, "replica", int(cfg.get("n_replicas", 3)))
    leaders = _regions(geo, "leader", m)

    def lat(rc: int, e: int) -> Tuple[float, float]:
        write = (geo.hop_delay(rc, leaders[e])
                 + _ordered_tail(geo, leaders[e], rc, prox, wq, acc, reps))
        return write, _preread(geo, rc, rq, acc, reps)

    return _per_region(geo, n_clients, m, lat)


def _path_vanilla_mencius(cfg: Config, geo: GeoSpec, n_clients: int
                          ) -> Tuple[List[float], List[float]]:
    f = int(cfg.get("f", 1))
    m = 2 * f + 1
    servers = _regions(geo, "server", m)

    def lat(rc: int, e: int) -> Tuple[float, float]:
        peers = [servers[j] for j in range(m) if j != e]
        quorums = _majority_quorums(m - 1, f + 1)
        phase2 = _mean(max(_rt(geo, servers[e], peers[j]) for j in q)
                       for q in quorums)
        # slot-order execution: after Phase 2 commits, the proposer still
        # waits for peers' skip/fill announcements (Chosen out, ChosenRange
        # back) before it may execute and reply; peer echoes overlap, so a
        # mean over peers tracks the measured wait
        skip_echo = _mean(_rt(geo, servers[e], p) for p in peers)
        w = _rt(geo, rc, servers[e]) + phase2 + skip_echo
        return w, w  # reads_as_writes; the proposing server itself replies

    return _per_region(geo, n_clients, m, lat)


def _path_spaxos(cfg: Config, geo: GeoSpec, n_clients: int
                 ) -> Tuple[List[float], List[float]]:
    f = int(cfg.get("f", 1))
    n_dis = int(cfg.get("n_disseminators", 2))
    n_stab = int(cfg.get("n_stabilizers", 3))
    n_acc, wq, rq = _acceptor_quorums(cfg, f)
    dis = _regions(geo, "disseminator", n_dis)
    stab = _regions(geo, "stabilizer", n_stab)
    prox = _regions(geo, "proxy", int(cfg.get("n_proxy_leaders", 3)))
    acc = _regions(geo, "acceptor", n_acc)
    reps = _regions(geo, "replica", int(cfg.get("n_replicas", 3)))
    leader = geo.region_of("leader", 0)
    maj = n_stab // 2 + 1

    def lat(rc: int, e: int) -> Tuple[float, float]:
        d = dis[e]
        # disseminate payload, wait for a stabilizer majority of acks
        stab_leg = _kth_smallest_rt(geo, d, stab, maj)
        # ordered id commit; the proxy routes Chosen(id) through a
        # round-robin stabilizer that resolves it to the payload before
        # the replica fan-out
        tail = _mean(
            geo.hop_delay(leader, p)
            + _quorum_leg(geo, p, wq, acc)
            + _mean(geo.hop_delay(p, st)
                    + _mean(geo.hop_delay(st, rep) + geo.hop_delay(rep, rc)
                            for rep in reps)
                    for st in stab)
            for p in prox)
        write = (geo.hop_delay(rc, d) + stab_leg
                 + geo.hop_delay(d, leader) + tail)
        return write, _preread(geo, rc, rq, acc, reps)

    return _per_region(geo, n_clients, n_dis, lat)


def _path_vanilla_spaxos(cfg: Config, geo: GeoSpec, n_clients: int
                         ) -> Tuple[List[float], List[float]]:
    f = int(cfg.get("f", 1))
    n = 2 * f + 1
    servers = _regions(geo, "server", n)
    maj = n // 2 + 1
    quorums = _majority_quorums(n, f + 1)

    def lat(rc: int, e: int) -> Tuple[float, float]:
        s = servers[e]
        # disseminate to all n (including a self-send, which still pays
        # two local hops through the queue), wait for a majority
        stab_leg = _kth_smallest_rt(geo, s, servers, maj)
        phase2 = _mean(max(_rt(geo, servers[0], servers[j]) for j in q)
                       for q in quorums)
        w = (geo.hop_delay(rc, s) + stab_leg
             + geo.hop_delay(s, servers[0]) + phase2
             + _mean(geo.hop_delay(servers[0], t) + geo.hop_delay(t, rc)
                     for t in servers))
        return w, w  # reads_as_writes

    return _per_region(geo, n_clients, n, lat)


def _path_craq(cfg: Config, geo: GeoSpec, n_clients: int
               ) -> Tuple[List[float], List[float]]:
    k = int(cfg.get("n_nodes", 3))
    chain = _regions(geo, "chain", k)

    def lat(rc: int, _e: int) -> Tuple[float, float]:
        # head-to-tail ChainWrite, tail-to-head ChainAck: one round trip
        # per adjacent pair, plus the client's trip to the head
        write = (_rt(geo, rc, chain[0])
                 + sum(_rt(geo, chain[i], chain[i + 1])
                       for i in range(k - 1)))
        # clean read at a uniformly-random chain node (the failure-free
        # closed loop keeps at most one write in flight, so the dirty
        # tail-forward path is rare - covered by the tolerance)
        read = _mean(_rt(geo, rc, c) for c in chain)
        return write, read

    return _per_region(geo, n_clients, 1, lat)


def _path_bpaxos(cfg: Config, geo: GeoSpec, n_clients: int
                 ) -> Tuple[List[float], List[float]]:
    n_prop = int(cfg.get("n_proposers", 3))
    n_dep = int(cfg.get("n_dep_nodes", 3))
    thrifty = bool(cfg.get("thrifty", False))
    props = _regions(geo, "proposer", n_prop)
    deps = _regions(geo, "dep_service", n_dep)
    reps = _regions(geo, "replica", int(cfg.get("n_replicas", 3)))
    q = n_dep // 2 + 1

    def lat(rc: int, e: int) -> Tuple[float, float]:
        pr = props[e]
        rts = [_rt(geo, pr, d) for d in deps]
        if thrifty:
            # unicast to a rotating q-window of dep nodes, wait for all
            dep_leg = _mean(max(rts[(s + j) % n_dep] for j in range(q))
                            for s in range(n_dep))
        else:
            # broadcast to all d, wait for the q fastest
            dep_leg = sorted(rts)[q - 1]
        w = (geo.hop_delay(rc, pr) + dep_leg
             + _mean(geo.hop_delay(pr, rep) + geo.hop_delay(rep, rc)
                     for rep in reps))
        return w, w  # reads execute through the dependency graph too

    return _per_region(geo, n_clients, n_prop, lat)


def _path_iss(cfg: Config, geo: GeoSpec, n_clients: int
              ) -> Tuple[List[float], List[float]]:
    f = int(cfg.get("f", 1))
    n_lead = int(cfg.get("n_leaders", 3))
    n_acc, wq, _rq = _acceptor_quorums(cfg, f)
    prox = _regions(geo, "proxy", int(cfg.get("n_proxy_leaders", 10)))
    acc = _regions(geo, "acceptor", n_acc)
    reps = _regions(geo, "replica", int(cfg.get("n_replicas", 4)))
    leaders = _regions(geo, "leader", n_lead)

    def lat(rc: int, e: int) -> Tuple[float, float]:
        le = leaders[e]
        # the command's bucket owner rotates per epoch; over the run each
        # leader owns ~1/L of the buckets, so forwarding costs one hop to
        # a uniformly-random owner (free when the entry leader owns it)
        w = geo.hop_delay(rc, le) + _mean(
            (0.0 if o == e else geo.hop_delay(le, leaders[o]))
            + _ordered_tail(geo, leaders[o], rc, prox, wq, acc, reps)
            for o in range(n_lead))
        return w, w  # reads ride the ordered path

    return _per_region(geo, n_clients, n_lead, lat)


def _path_unreplicated(cfg: Config, geo: GeoSpec, n_clients: int
                       ) -> Tuple[List[float], List[float]]:
    _reject_batching(cfg, "unreplicated")
    server = geo.region_of("server", 0)

    def lat(rc: int, _e: int) -> Tuple[float, float]:
        w = _rt(geo, rc, server)
        return w, w

    return _per_region(geo, n_clients, 1, lat)


for _name, _fn in (
    ("compartmentalized", _path_compartmentalized),
    ("multipaxos", _path_multipaxos),
    ("mencius", _path_mencius),
    ("vanilla_mencius", _path_vanilla_mencius),
    ("spaxos", _path_spaxos),
    ("vanilla_spaxos", _path_vanilla_spaxos),
    ("craq", _path_craq),
    ("bpaxos", _path_bpaxos),
    ("iss", _path_iss),
    ("unreplicated", _path_unreplicated),
):
    register_geo_path(_name, _fn)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def predict_geo_latency(config: Config, geo: GeoSpec,
                        n_clients: Optional[int] = None) -> GeoLatency:
    """Lower one config's message flow into per-region wire latency.

    ``n_clients`` defaults to the variant's registered executable client
    count so predictions line up with what ``run_variant`` measures."""
    variant = str(config.get("variant", "compartmentalized"))
    try:
        fn = _GEO_PATHS[variant]
    except KeyError:
        raise ValueError(
            f"variant {variant!r} has no registered geo path; choose from "
            f"{sorted(_GEO_PATHS)} or register_geo_path it") from None
    if n_clients is None:
        exe = variant_spec(variant).executable
        n_clients = exe.n_clients if exe is not None else 3
    write, read = fn(dict(config), geo, n_clients)
    return GeoLatency(variant=variant, regions=geo.regions,
                      write=tuple(write), read=tuple(read))


def zero_rtt(geo: GeoSpec) -> GeoSpec:
    """The same placement/weights/local_delay with an all-zero RTT
    matrix: the degenerate spec whose numbers must equal today's
    single-delay ones."""
    n = geo.n_regions
    return replace(geo, rtt=tuple((0.0,) * n for _ in range(n)))


def wan_offsets(config: Config, geo: GeoSpec,
                workload: Optional[Union[Workload, float]] = None,
                n_clients: Optional[int] = None) -> Tuple[float, ...]:
    """Per-region *extra* wire latency the WAN matrix adds on top of the
    uniform-delay baseline - the additive term
    :meth:`CompiledSweep.geo_latency` stacks onto the MVA queueing
    curves.  Exactly zero for a uniform matrix."""
    lat = predict_geo_latency(config, geo, n_clients=n_clients)
    base = predict_geo_latency(config, zero_rtt(geo), n_clients=n_clients)
    mixed = lat.blended(workload)
    base_mixed = base.blended(workload)
    return tuple(a - b for a, b in zip(mixed, base_mixed))


# which address kinds each variant places (the placement axis the
# autotuner searches); "replica" is the read/execute edge tier that hub
# placements deliberately leave spread
STATION_KINDS: Dict[str, Tuple[str, ...]] = {
    "compartmentalized": ("leader", "proxy", "acceptor", "replica"),
    "multipaxos": ("leader", "acceptor", "replica"),
    "mencius": ("leader", "proxy", "acceptor", "replica"),
    "vanilla_mencius": ("server",),
    "spaxos": ("leader", "proxy", "acceptor", "replica",
               "disseminator", "stabilizer"),
    "vanilla_spaxos": ("server",),
    "craq": ("chain",),
    "bpaxos": ("proposer", "dep_service", "replica"),
    "iss": ("leader", "proxy", "acceptor", "replica"),
    "unreplicated": ("server",),
}


def geo_station_kinds(variant: str) -> Tuple[str, ...]:
    """Address kinds a variant's placement can pin (registry-extensible
    via the STATION_KINDS mapping)."""
    try:
        return STATION_KINDS[variant]
    except KeyError:
        raise ValueError(
            f"variant {variant!r} has no registered station kinds; add it "
            "to repro.core.geo.STATION_KINDS") from None


def placement_candidates(variant: str, geo: GeoSpec
                         ) -> Dict[str, GeoSpec]:
    """The placement family ``autotune_placement`` searches:

    * ``spread`` - the default round-robin cycle (empty placement);
    * ``single/<region>`` - every station pinned to one region (remote
      clients pay the full client<->cluster WAN round trip);
    * ``hub/<region>`` - the ordering core pinned to one region but the
      replica tier spread, so read legs and commit fan-out average over
      nearby replicas (only distinct from ``single`` for variants with a
      separate replica tier).
    """
    kinds = geo_station_kinds(variant)
    out: Dict[str, GeoSpec] = {"spread": replace(geo, placement=())}
    hub_kinds = tuple(k for k in kinds if k != "replica")
    for r, name in enumerate(geo.regions):
        out[f"single/{name}"] = replace(
            geo, placement=tuple((k, (r,)) for k in kinds))
        if hub_kinds != kinds:
            out[f"hub/{name}"] = replace(
                geo, placement=tuple((k, (r,)) for k in hub_kinds))
    return out

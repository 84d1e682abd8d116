"""The generic execution harness: run any registered variant's *real*
cluster, check linearizability, and parity-check measured message counts
against the analytical demand table - two planes, one registry.

The paper's evidence for "compartmentalization is a technique, not a
protocol" is dual: message-count tables derived analytically *and* real
protocol executions that agree with them.  This module makes that
cross-validation loop a first-class call.  A variant whose
:class:`~repro.core.api.VariantSpec` declares an
:class:`~repro.core.api.ExecutableSpec` (its ``deployment`` factory takes
the **same canonical config dict** as its analytical factory) gets, with
zero edits to this file:

* :func:`run_variant` - drive the deployment with ``Workload``-shaped
  closed-loop traffic (write fraction, key skew, batched arrivals through
  the variant's own batchers), collect the operation history, run the
  linearizability checker, and bucket measured per-station messages per
  command into the *same* :data:`~repro.core.api.STATION_ORDER` slots the
  demand tensors use;
* :func:`validate_variant` - an analytical-vs-measured parity report per
  station (exact where the executable declares it - S-Paxos' leader is
  exactly 2 id-only msgs/cmd - within declared tolerance elsewhere);
* :func:`repro.core.analytical.calibrate_alpha` ``(measured=True)`` - the
  25k anchor derived from an executed vanilla run instead of a constant.

``benchmarks/protocol_messages.py`` is one zero-branch loop over
:func:`~repro.core.api.executable_variants` calling
:func:`validate_variant`; the per-variant physics (address -> station
bucketing, measured-parameter feedback such as Mencius' observed skip
rate, tolerances) lives in the registered :class:`ExecutableSpec`, as
data.

The built-in executables for all six shipped variants are registered at
the bottom of this module; runtime variants attach theirs with
:func:`~repro.core.api.register_executable` (or directly in
``register_variant(executable=...)``) and ride the same calls.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple, Union

from .api import (
    Config,
    ExecutableSpec,
    STATION_ORDER,
    ShardingSpec,
    Workload,
    executable_variants,
    register_executable,
    resolve_workload,
    variant_spec,
)
from .craq import CraqDeployment
from .geo import predict_geo_latency
from .history import History
from .linearizability import check_linearizable, check_slot_order
from .mencius import MenciusDeployment, VanillaMenciusDeployment
from .protocols import (
    CompartmentalizedMultiPaxos,
    DeploymentConfig,
    UnreplicatedStateMachine,
)
from .sharding import partition_history, partition_ops
from .spaxos import SPaxosDeployment, VanillaSPaxosDeployment

__all__ = [
    "AutoscaledExecutionTrace", "ExecutionTrace", "ParityReport",
    "ShardedDeployment", "ShardedExecutionTrace", "ShardedParityReport",
    "StationParity", "default_config", "resizable_stations",
    "resize_config", "run_autoscaled", "run_sharded", "run_variant",
    "station_knob_map", "validate_sharded", "validate_variant",
    "workload_ops",
]


# ---------------------------------------------------------------------------
# Workload-shaped op streams
# ---------------------------------------------------------------------------


def workload_ops(workload: Workload, n_commands: int, seed: int = 0,
                 n_cold_keys: int = 4) -> List[Tuple]:
    """A deterministic op stream shaped by a :class:`Workload`: exactly
    ``round(n_commands * f_write)`` writes, shuffled; skewed ops
    (probability ``skew_p``) target the single hot key, the rest a small
    shared cold key space (shared keys keep the linearizability check
    non-vacuous when the stream is split across concurrent clients)."""
    rng = random.Random(seed * 0x9E3779B1 + 1)
    n_writes = round(n_commands * workload.f_write)
    writes = [True] * n_writes + [False] * (n_commands - n_writes)
    rng.shuffle(writes)
    ops: List[Tuple] = []
    for i, is_write in enumerate(writes):
        hot = workload.skew_p > 0.0 and rng.random() < workload.skew_p
        key = "hot" if hot else f"k{rng.randrange(n_cold_keys)}"
        ops.append(("put", key, i) if is_write else ("get", key))
    return ops


# ---------------------------------------------------------------------------
# ExecutionTrace: one measured run
# ---------------------------------------------------------------------------


@dataclass
class ExecutionTrace:
    """One executed, measured, checked run of a variant's deployment.

    ``station_msgs`` is measured (sent + received) messages per command
    **per server**, keyed by canonical station name - the same unit and
    vocabulary as ``DeploymentModel.demands``; server counts come from the
    variant's own demand table for the same config (for fused-role
    baselines like vanilla MultiPaxos the model's "machine" aggregates
    several deployment nodes).  ``station_totals`` / ``station_nodes``
    keep the raw accounting."""

    variant: str
    config: Config
    workload: Workload
    n_commands: int
    seed: int
    deployment: Any
    history: History
    station_msgs: Dict[str, float]
    station_totals: Dict[str, int]
    station_servers: Dict[str, int]
    station_nodes: Dict[str, int]
    steps: int
    linearizable: bool
    checker: str
    violations: Tuple[str, ...] = ()
    # geo plane (run_variant(geo=...)): the active spec, the client count
    # the latency_fn split clients by, and measured mean client latency
    # (virtual time units) per region - overall and per op class - with
    # the realized (writes, reads) counts behind each mean
    geo: Optional[Any] = None
    geo_n_clients: int = 0
    region_latency: Dict[str, float] = field(default_factory=dict)
    region_write_latency: Dict[str, float] = field(default_factory=dict)
    region_read_latency: Dict[str, float] = field(default_factory=dict)
    region_ops: Dict[str, Tuple[int, int]] = field(default_factory=dict)

    @property
    def n_writes(self) -> int:
        return sum(1 for o in self.history.ops if not o.is_read)

    @property
    def n_reads(self) -> int:
        return self.n_commands - self.n_writes

    def demand_slots(self) -> List[float]:
        """Measured per-server msgs/cmd scattered into the canonical
        :data:`STATION_ORDER` columns (zero where the deployment has no
        such component) - directly comparable to a compiled sweep row."""
        row = [0.0] * len(STATION_ORDER)
        for name, d in self.station_msgs.items():
            row[STATION_ORDER.index(name)] += d
        return row

    def describe(self) -> str:
        pairs = ", ".join(f"{s} {d:.2f}" for s, d in self.station_msgs.items())
        return (f"{self.variant}: {self.n_commands} cmds "
                f"({self.n_writes} writes) in {self.steps} deliveries; "
                f"msgs/cmd/server: {pairs}; "
                f"linearizable={self.linearizable} ({self.checker})")


def _check_history(history: History, sm_kind: str = "kv",
                   exhaustive_limit: int = 24,
                   ) -> Tuple[bool, str, Tuple[str, ...]]:
    """Linearizability verdict: exhaustive Wing-Gong search on small
    histories (ground truth), the paper's slot-order check on large ones
    (cheap, sound for slot-stamped histories).  A large history with no
    slot stamps at all (CRAQ: versions are per-key, so responses carry no
    global log position) would make the slot-order check vacuously true -
    those fall back to the exhaustive search too, which closed-loop
    histories keep cheap (branching bounded by the client count)."""
    stamped = any(o.slot is not None for o in history.complete())
    if len(history) <= exhaustive_limit or not stamped:
        ok = check_linearizable(history, sm_kind)
        return ok, "exhaustive", () if ok else ("no linearization found",)
    violations = tuple(check_slot_order(history))
    return not violations, "slot_order", violations


def _check_history_partitioned(history: History, sm_kind: str = "kv",
                               exhaustive_limit: int = 24,
                               ) -> Tuple[bool, str, Tuple[str, ...]]:
    """Per-key-partition linearizability: KV keys are independent objects,
    so by Herlihy & Wing's locality theorem a history is linearizable iff
    every per-key sub-history is - the decomposition accepts *exactly* the
    histories the whole-history checker accepts while keeping the
    exhaustive search exponential only in per-key concurrency.  Each
    partition still picks its checker by size via :func:`_check_history`
    (key-less histories fall into one partition = the whole check)."""
    parts = partition_history(history, lambda key: key)
    for part, sub in sorted(parts.items(), key=lambda kv: str(kv[0])):
        ok, checker, violations = _check_history(
            sub, sm_kind=sm_kind, exhaustive_limit=exhaustive_limit)
        if not ok:
            return False, f"per_key[{part}]/{checker}", violations
    return True, "per_key_partition", ()


def default_config(name: str, f: int = 1) -> Config:
    """The variant's default-knob config dict (the first point of its
    declared knob product) - what :func:`run_variant` uses when no config
    is given."""
    return next(iter(variant_spec(name).configs(f=f)))


def _executable_of(name: str) -> ExecutableSpec:
    spec = variant_spec(name)
    if spec.executable is None:
        raise ValueError(
            f"variant {name!r} declares no execution plane; executable "
            f"variants: {list(executable_variants())} (attach one with "
            f"register_executable)")
    return spec.executable


def _build_deployment(exe: ExecutableSpec, cfg: Config, n_clients: int,
                      seed: int, state_machine: str,
                      latency_fn: Optional[Any] = None) -> Any:
    """Instantiate the executable's deployment and zero message counters
    (setup traffic such as Phase 1 is not part of the per-command cost).
    ``latency_fn`` (a GeoSpec matrix realization) is only forwarded when
    set, so executables registered before the geo plane keep working."""
    build_cfg = {k: v for k, v in cfg.items() if k != "variant"}
    if latency_fn is not None:
        build_cfg["latency_fn"] = latency_fn
    dep = exe.deployment(**build_cfg, n_clients=n_clients, seed=seed,
                         state_machine=state_machine)
    for node in dep.net.nodes.values():
        node.msgs_sent = 0
        node.msgs_received = 0
    return dep


def _assign_ops(dep: Any, ops: List[Tuple]) -> None:
    """Split an op stream round-robin across a deployment's closed-loop
    clients."""
    per_client: List[List[Tuple]] = [[] for _ in dep.clients]
    for i, op in enumerate(ops):
        per_client[i % len(per_client)].append(op)
    for client, client_ops in zip(dep.clients, per_client):
        if client_ops:
            client.run_ops(client_ops)


def _drive(name: str, dep: Any, max_steps: int) -> int:
    steps = dep.run_to_quiescence(max_steps=max_steps)
    if not dep.all_done():
        stuck = [c.addr for c in dep.clients if not c.done]
        raise RuntimeError(
            f"run_variant({name!r}): clients {stuck} not done after "
            f"{steps} deliveries (max_steps={max_steps})")
    return steps


def _station_msgs(spec: Any, exe: ExecutableSpec, dep: Any,
                  servers: Dict[str, int], n_commands: int,
                  ) -> Tuple[Dict[str, float], Dict[str, int],
                             Dict[str, int], Dict[str, int]]:
    """Bucket measured (sent + received) messages into canonical station
    slots, per command per server."""
    totals: Dict[str, int] = {}
    nodes: Dict[str, int] = {}
    for addr, node in dep.net.nodes.items():
        if exe.station_of is not None:
            station = exe.station_of(addr, dep)
        else:
            role = addr.split("/", 1)[0]
            station = role if role in spec.stations else None
        if station is None:
            continue
        totals[station] = totals.get(station, 0) + (node.msgs_sent
                                                    + node.msgs_received)
        nodes[station] = nodes.get(station, 0) + 1
    denom = max(n_commands, 1)
    msgs = {
        station: total / denom / servers.get(station, nodes[station])
        for station, total in totals.items()
    }
    stations_present = {s: servers.get(s, nodes[s]) for s in totals}
    return msgs, totals, stations_present, nodes


def _measured_region_latency(history: History, geo: Any, n_clients: int,
                             ) -> Tuple[Dict[str, float], Dict[str, float],
                                        Dict[str, float],
                                        Dict[str, Tuple[int, int]]]:
    """Mean measured client latency per region (blended, write, read)
    plus the realized (writes, reads) counts: client ``i`` sits in
    ``geo.client_region(i, n_clients)``, its latency is the virtual-time
    span between invocation and response."""
    sums: Dict[str, List[float]] = {}
    for o in history.complete():
        r = geo.regions[geo.client_region(o.client_id, n_clients)]
        acc = sums.setdefault(r, [0.0, 0, 0.0, 0])  # [w_sum, w_n, r_sum, r_n]
        d = o.response_time - o.invoke_time
        if o.is_read:
            acc[2] += d
            acc[3] += 1
        else:
            acc[0] += d
            acc[1] += 1
    blended: Dict[str, float] = {}
    writes: Dict[str, float] = {}
    reads: Dict[str, float] = {}
    counts: Dict[str, Tuple[int, int]] = {}
    for r, (ws, wn, rs, rn) in sums.items():
        counts[r] = (wn, rn)
        blended[r] = (ws + rs) / (wn + rn)
        if wn:
            writes[r] = ws / wn
        if rn:
            reads[r] = rs / rn
    return blended, writes, reads, counts


def _trace_of(name: str, cfg: Config, w: Workload, dep: Any,
              n_commands: int, seed: int, steps: int,
              exhaustive_limit: int, state_machine: str,
              per_key: bool = False, geo: Optional[Any] = None,
              geo_n_clients: int = 0) -> ExecutionTrace:
    """Measure + check one driven deployment into an ExecutionTrace.

    ``per_key=True`` decomposes the linearizability check by key
    partition (sound *and* complete by locality - see
    :func:`repro.core.sharding.partition_history`)."""
    spec = variant_spec(name)
    exe = _executable_of(name)
    model = spec.model(cfg, w)  # server counts + station sanity check
    servers = {s.name: s.servers for s in model.stations}
    msgs, totals, stations_present, nodes = _station_msgs(
        spec, exe, dep, servers, n_commands)
    if per_key:
        ok, checker, violations = _check_history_partitioned(
            dep.history, sm_kind=state_machine,
            exhaustive_limit=exhaustive_limit)
    else:
        ok, checker, violations = _check_history(
            dep.history, sm_kind=state_machine,
            exhaustive_limit=exhaustive_limit)
    blended: Dict[str, float] = {}
    wlat: Dict[str, float] = {}
    rlat: Dict[str, float] = {}
    rops: Dict[str, Tuple[int, int]] = {}
    if geo is not None:
        blended, wlat, rlat, rops = _measured_region_latency(
            dep.history, geo, geo_n_clients)
    return ExecutionTrace(
        variant=name, config=cfg, workload=w, n_commands=n_commands,
        seed=seed, deployment=dep, history=dep.history, station_msgs=msgs,
        station_totals=totals, station_servers=stations_present,
        station_nodes=nodes, steps=steps, linearizable=ok, checker=checker,
        violations=violations, geo=geo, geo_n_clients=geo_n_clients,
        region_latency=blended, region_write_latency=wlat,
        region_read_latency=rlat, region_ops=rops)


def run_variant(name: str,
                config: Optional[Config] = None,
                workload: Optional[Union[Workload, float]] = None,
                n_commands: int = 60,
                seed: int = 0,
                n_clients: Optional[int] = None,
                max_steps: int = 2_000_000,
                exhaustive_limit: int = 24,
                jitter: float = 0.0,
                state_machine: str = "kv",
                geo: Optional[Any] = None) -> ExecutionTrace:
    """Execute one config of a registered variant end to end.

    Builds the deployment from the variant's :class:`ExecutableSpec`,
    zeroes message counters (setup traffic such as Phase 1 is not part of
    the per-command cost), splits a :func:`workload_ops` stream
    round-robin across the closed-loop clients, runs the network to
    quiescence, checks linearizability, and buckets measured per-station
    msgs/cmd into canonical station slots.  Generic over the registry:
    zero per-variant branches here.

    ``geo`` (a :class:`~repro.core.api.GeoSpec`) realizes the WAN matrix
    through the network's ``latency_fn`` hook: every message pays
    ``local_delay + one_way(region(src), region(dst))``, timers stay
    local, ``jitter`` stacks on top.  The trace then carries measured
    per-region client latency (``region_latency`` et al.) - the measured
    side of the latency parity rows ``validate_variant(geo=...)`` adds."""
    exe = _executable_of(name)
    cfg = dict(config) if config is not None else default_config(name)
    w = resolve_workload(workload, where="run_variant")
    n_cl = n_clients if n_clients is not None else exe.n_clients

    latency_fn = geo.latency_fn(n_cl) if geo is not None else None
    dep = _build_deployment(exe, cfg, n_cl, seed, state_machine,
                            latency_fn=latency_fn)
    if jitter:
        # reorder messages across links (seeded): linearizability must
        # hold regardless; message-count parity is unaffected (counts,
        # not timings)
        dep.net.jitter = jitter

    op_mix = replace(w, f_write=1.0) if exe.reads_as_writes else w
    ops = workload_ops(op_mix, n_commands, seed=seed)
    _assign_ops(dep, ops)
    steps = _drive(name, dep, max_steps)
    return _trace_of(name, cfg, w, dep, n_commands, seed, steps,
                     exhaustive_limit, state_machine, geo=geo,
                     geo_n_clients=n_cl)


# ---------------------------------------------------------------------------
# Parity: measured vs analytical, one generic loop
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StationParity:
    """One station's measured-vs-analytical comparison."""

    station: str
    measured: float
    predicted: float
    rel_err: float
    tolerance: float
    exact: bool
    ok: bool

    def describe(self) -> str:
        tag = "exact" if self.exact else f"tol {self.tolerance:g}"
        mark = "ok" if self.ok else "FAIL"
        return (f"{self.station} {self.measured:.3f}/{self.predicted:.3f} "
                f"({tag}: {mark})")


@dataclass
class ParityReport:
    """Analytical-vs-measured msgs/cmd parity for one executed config.

    ``passed`` requires every station row within its declared tolerance
    *and* the execution's history linearizable."""

    variant: str
    config: Config
    model_config: Config
    workload: Workload
    rows: Tuple[StationParity, ...]
    trace: ExecutionTrace

    @property
    def stations_ok(self) -> bool:
        return all(r.ok for r in self.rows)

    @property
    def passed(self) -> bool:
        return self.stations_ok and self.trace.linearizable

    def row(self, station: str) -> StationParity:
        for r in self.rows:
            if r.station == station:
                return r
        raise KeyError(f"no parity row for station {station!r}; have "
                       f"{[r.station for r in self.rows]}")

    def max_rel_err(self) -> float:
        return max((r.rel_err for r in self.rows), default=0.0)

    def summary(self) -> str:
        pairs = ", ".join(
            f"{r.station} {r.measured:.2f}/{r.predicted:.2f}"
            for r in self.rows)
        verdict = "parity OK" if self.passed else "PARITY FAIL"
        return (f"{verdict}: measured/modelled msgs per cmd per server: "
                f"{pairs}; linearizable={self.trace.linearizable} "
                f"({self.trace.checker})")

    def __str__(self) -> str:
        lines = [f"{self.variant} @ {self.workload.describe()}: "
                 f"{'PASS' if self.passed else 'FAIL'}"]
        lines += [f"  {r.describe()}" for r in self.rows]
        if not self.trace.linearizable:
            lines.append(f"  NOT LINEARIZABLE ({self.trace.checker}): "
                         f"{list(self.trace.violations)}")
        return "\n".join(lines)


def validate_variant(name: str,
                     config: Optional[Config] = None,
                     workload: Optional[Union[Workload, float]] = None,
                     n_commands: int = 60,
                     seed: int = 0,
                     **run_kwargs: Any) -> ParityReport:
    """Execute a variant's deployment and parity-check its measured
    per-station msgs/cmd against its analytical demand table.

    The model side is the registered factory on the *same* config -
    workload-adapted exactly as the sweep plane would
    (``VariantSpec.adapt``), then refined by the executable's
    ``model_feedback`` with statistics measured off this very run (e.g.
    Mencius' observed skip rate), so the comparison is apples-to-apples.
    One generic loop; every per-variant fact is declared data in the
    :class:`ExecutableSpec`.

    Passing ``geo=`` (forwarded to :func:`run_variant`) additionally
    emits one ``wan_latency/<region>`` row per client-bearing region:
    measured mean client latency against the critical-path prediction of
    :func:`repro.core.geo.predict_geo_latency`, blended at the region's
    *realized* write mix and judged by the executable's registered
    ``latency_tolerance``."""
    cfg = dict(config) if config is not None else default_config(name)
    w = resolve_workload(workload, where="validate_variant")
    trace = run_variant(name, cfg, w, n_commands=n_commands, seed=seed,
                        **run_kwargs)
    rows, model_cfg = _parity_rows(name, cfg, w, trace)
    if trace.geo is not None:
        rows += _geo_latency_rows(name, cfg, trace)
    return ParityReport(variant=name, config=cfg, model_config=model_cfg,
                        workload=w, rows=tuple(rows), trace=trace)


def _geo_latency_rows(name: str, cfg: Config, trace: ExecutionTrace,
                      ) -> List[StationParity]:
    """Measured-vs-predicted per-region latency rows (the latency
    analogue of the msgs/cmd parity rows).

    The prediction blends the critical-path write/read latencies at each
    region's *realized* op counts, so the comparison is not polluted by
    how the round-robin op split happened to land per region.  Variants
    whose read path rides the write path (``reads_as_writes``) were
    driven write-only, so the blend degenerates to the write path."""
    exe = _executable_of(name)
    geo = trace.geo
    predicted = predict_geo_latency(
        dict(cfg, variant=name), geo, n_clients=trace.geo_n_clients)
    rows: List[StationParity] = []
    for i, region in enumerate(geo.regions):
        counts = trace.region_ops.get(region)
        if not counts:
            continue
        wn, rn = counts
        pred = (wn * predicted.write[i] + rn * predicted.read[i]) / (wn + rn)
        m = trace.region_latency[region]
        rel = abs(m - pred) / max(abs(pred), 1e-12)
        tol = exe.latency_tolerance
        rows.append(StationParity(
            station=f"wan_latency/{region}", measured=m, predicted=pred,
            rel_err=rel, tolerance=tol, exact=False, ok=rel <= tol))
    return rows


def _parity_rows(name: str, cfg: Config, w: Workload, trace: ExecutionTrace,
                 ) -> Tuple[List[StationParity], Config]:
    """The measured-vs-table station rows for one executed trace.

    The table is blended at the *realized* write fraction of the executed
    op stream (exact mix up to rounding), so parity is not polluted by
    the generator's rounding of ``f_write * n_commands`` - nor, for a
    shard, by the hash split's per-shard mix.  Shared by
    :func:`validate_variant` and the per-shard loop of
    :func:`validate_sharded` (shard-scaled tables: per-shard msgs per
    *shard-local* command against the same per-command table)."""
    spec = variant_spec(name)
    exe = _executable_of(name)
    model_cfg = spec.adapt(cfg, w)
    if exe.model_feedback is not None:
        model_cfg = exe.model_feedback(dict(model_cfg), trace)
    realized = replace(w, f_write=trace.n_writes / max(trace.n_commands, 1))
    predicted = spec.build(model_cfg).demands(realized)

    stations = list(trace.station_msgs)
    stations += [s for s, d in predicted.items()
                 if s not in trace.station_msgs and d > 0.0]
    rows = []
    for station in sorted(stations, key=STATION_ORDER.index):
        m = trace.station_msgs.get(station, 0.0)
        p = predicted.get(station, 0.0)
        exact = station in exe.exact_stations
        tol = exe.tolerance_for(station)
        rel = abs(m - p) / max(abs(p), 1e-12)
        ok = abs(m - p) <= 1e-9 if exact else rel <= tol
        rows.append(StationParity(station=station, measured=m, predicted=p,
                                  rel_err=rel, tolerance=tol, exact=exact,
                                  ok=ok))
    return rows, model_cfg


# ---------------------------------------------------------------------------
# Sharded execution: N independent variant groups behind hash routing
# ---------------------------------------------------------------------------


class ShardedDeployment:
    """N independent registered-variant groups behind hash-based
    client-side routing.

    Each shard is a full deployment of the variant (its own network,
    clients, history), built from the *same* canonical config dict the
    analytical factory consumes - or per-shard configs, e.g. an
    :func:`~repro.core.autotune.autotune_sharded` split.  Keys route by
    ``sharding.shard_of`` (stable crc32); shards never exchange messages,
    which is what makes per-shard parity and per-key-partition
    linearizability sound (no cross-shard transaction path exists - by
    locality, per-shard checks compose).

    The per-shard networks have independent virtual clocks.  ``submit`` +
    ``run_to_quiescence`` is the whole-run flow (:func:`run_sharded`);
    live scenarios (the resharding replay) instead advance shards in
    lockstep phases via ``step_all(until=...)`` and measure completion
    deltas at phase boundaries."""

    def __init__(self, name: str, sharding: ShardingSpec,
                 config: Optional[Config] = None,
                 configs: Optional[List[Config]] = None,
                 n_clients: Optional[int] = None, seed: int = 0,
                 state_machine: str = "kv") -> None:
        exe = _executable_of(name)
        if configs is not None:
            if len(configs) != sharding.n_shards:
                raise ValueError(
                    f"{len(configs)} per-shard configs for "
                    f"{sharding.n_shards} shards")
            cfgs = [dict(c) for c in configs]
        else:
            base = dict(config) if config is not None else default_config(name)
            cfgs = [dict(base) for _ in range(sharding.n_shards)]
        self.name = name
        self.sharding = sharding
        self.configs: Tuple[Config, ...] = tuple(cfgs)
        self.seed = seed
        self.state_machine = state_machine
        n_cl = n_clients if n_clients is not None else exe.n_clients
        # distinct per-shard seeds: shards are independent systems, not
        # replicas of one seed
        self.shards: List[Any] = [
            _build_deployment(exe, cfg, n_cl, seed * 1009 + s, state_machine)
            for s, cfg in enumerate(cfgs)
        ]
        self.ops_per_shard: List[int] = [0] * sharding.n_shards

    def __len__(self) -> int:
        return len(self.shards)

    def route(self, key: Any) -> int:
        """The shard that owns ``key`` (stable hash routing)."""
        return self.sharding.shard_of(key)

    def submit(self, ops: List[Tuple]) -> Dict[int, List[Tuple]]:
        """Route an op stream to shards by key hash and assign each
        shard's slice round-robin to its closed-loop clients."""
        parts = partition_ops(ops, self.sharding)
        for s, shard_ops in parts.items():
            if shard_ops:
                _assign_ops(self.shards[s], shard_ops)
                self.ops_per_shard[s] += len(shard_ops)
        return parts

    def run_to_quiescence(self, max_steps: int = 2_000_000) -> List[int]:
        """Drain every shard's network; per-shard delivery counts."""
        return [_drive(self.name, dep, max_steps) for dep in self.shards]

    def step_all(self, until: float,
                 skip: Tuple[int, ...] = ()) -> None:
        """Advance every shard's virtual clock to ``until`` (lockstep
        phase boundary), except shards listed in ``skip`` - how a live
        replay freezes the migrating shard while the others serve."""
        for s, dep in enumerate(self.shards):
            if s not in skip:
                dep.net.run(until=until)

    def all_done(self) -> bool:
        return all(dep.all_done() for dep in self.shards)

    @property
    def histories(self) -> List[History]:
        return [dep.history for dep in self.shards]

    def completed_counts(self) -> List[int]:
        """Responses observed so far, per shard - delta these across phase
        boundaries to get completion rates without comparing timestamps
        across the shards' independent clocks."""
        return [len(dep.history.complete()) for dep in self.shards]


@dataclass
class ShardedExecutionTrace:
    """One executed, measured, checked run of a sharded system.

    ``shards[s]`` is shard *s*'s own :class:`ExecutionTrace` (station
    msgs per *shard-local* command, per-key-partition linearizability
    verdict); a shard that received no ops carries an empty trace."""

    variant: str
    sharding: ShardingSpec
    workload: Workload
    n_commands: int
    seed: int
    deployment: ShardedDeployment
    shards: Tuple[ExecutionTrace, ...]
    ops_per_shard: Tuple[int, ...]

    @property
    def linearizable(self) -> bool:
        return all(t.linearizable for t in self.shards)

    @property
    def n_writes(self) -> int:
        return sum(t.n_writes for t in self.shards)

    def describe(self) -> str:
        split = "/".join(str(n) for n in self.ops_per_shard)
        return (f"{self.variant} x {self.sharding.describe()}: "
                f"{self.n_commands} cmds split {split}; "
                f"linearizable={self.linearizable} (per-key partitions)")


def run_sharded(name: str,
                sharding: ShardingSpec,
                config: Optional[Config] = None,
                workload: Optional[Union[Workload, float]] = None,
                n_commands: int = 96,
                seed: int = 0,
                n_clients: Optional[int] = None,
                n_cold_keys: int = 16,
                max_steps: int = 2_000_000,
                exhaustive_limit: int = 24,
                state_machine: str = "kv",
                configs: Optional[List[Config]] = None,
                ) -> ShardedExecutionTrace:
    """Execute a sharded system of a registered variant end to end.

    One :func:`workload_ops` stream (a wider cold-key space than the
    single-group default, so keys actually spread across shards) is hash-
    routed to ``sharding.n_shards`` independent deployments; each shard
    runs to quiescence and is measured exactly like :func:`run_variant`,
    with linearizability checked per key partition."""
    exe = _executable_of(name)
    w = resolve_workload(workload, where="run_sharded")
    sd = ShardedDeployment(name, sharding, config=config, configs=configs,
                           n_clients=n_clients, seed=seed,
                           state_machine=state_machine)
    op_mix = replace(w, f_write=1.0) if exe.reads_as_writes else w
    ops = workload_ops(op_mix, n_commands, seed=seed,
                       n_cold_keys=n_cold_keys)
    sd.submit(ops)
    steps = sd.run_to_quiescence(max_steps=max_steps)
    traces = tuple(
        _trace_of(name, sd.configs[s], w, sd.shards[s],
                  sd.ops_per_shard[s], seed, steps[s], exhaustive_limit,
                  state_machine, per_key=True)
        for s in range(len(sd)))
    return ShardedExecutionTrace(
        variant=name, sharding=sharding, workload=w, n_commands=n_commands,
        seed=seed, deployment=sd, shards=traces,
        ops_per_shard=tuple(sd.ops_per_shard))


@dataclass
class ShardedParityReport:
    """Per-shard parity against the shard-scaled tables.

    Each populated shard gets a full :class:`ParityReport` (its table
    blended at the shard's own realized write mix); ``passed`` requires
    every shard's stations within tolerance *and* every shard's per-key
    partitions linearizable.  Empty shards (no keys hashed there) are
    skipped - they did no work to compare."""

    variant: str
    sharding: ShardingSpec
    workload: Workload
    reports: Tuple[Optional[ParityReport], ...]
    trace: ShardedExecutionTrace

    @property
    def shards_checked(self) -> int:
        return sum(1 for r in self.reports if r is not None)

    @property
    def passed(self) -> bool:
        return (self.trace.linearizable
                and self.shards_checked > 0
                and all(r.stations_ok for r in self.reports
                        if r is not None))

    def summary(self) -> str:
        verdict = "parity OK" if self.passed else "PARITY FAIL"
        per = "; ".join(
            f"s{i}: " + ("empty" if r is None else
                         f"max rel err {r.max_rel_err():.3f}")
            for i, r in enumerate(self.reports))
        return (f"{verdict} across {self.sharding.describe()} "
                f"({self.shards_checked} checked): {per}; "
                f"linearizable={self.trace.linearizable}")


def validate_sharded(name: str,
                     sharding: ShardingSpec,
                     config: Optional[Config] = None,
                     workload: Optional[Union[Workload, float]] = None,
                     n_commands: int = 96,
                     seed: int = 0,
                     **run_kwargs: Any) -> ShardedParityReport:
    """Execute a sharded system and parity-check every shard against its
    own (shard-scaled) analytical table.

    Station msgs are per shard-local command, so the comparison point is
    the same per-command table regardless of the shard's traffic share;
    the blend uses each shard's *realized* write mix (the hash split
    does not preserve the global mix per shard)."""
    w = resolve_workload(workload, where="validate_sharded")
    strace = run_sharded(name, sharding, config=config, workload=w,
                         n_commands=n_commands, seed=seed, **run_kwargs)
    reports: List[Optional[ParityReport]] = []
    for s, trace in enumerate(strace.shards):
        if trace.n_commands == 0:
            reports.append(None)
            continue
        rows, model_cfg = _parity_rows(name, strace.deployment.configs[s],
                                       w, trace)
        reports.append(ParityReport(
            variant=name, config=dict(strace.deployment.configs[s]),
            model_config=model_cfg, workload=w, rows=tuple(rows),
            trace=trace))
    return ShardedParityReport(variant=name, sharding=sharding, workload=w,
                               reports=tuple(reports), trace=strace)


# ---------------------------------------------------------------------------
# The autoscale replay: live station add/drain on a real cluster
# ---------------------------------------------------------------------------


def station_knob_map(name: str, config: Optional[Config] = None,
                     workload: Optional[Union[Workload, float]] = None,
                     ) -> Dict[str, str]:
    """Which config key resizes which station - derived from the
    registry, zero per-variant branches.

    For every single-key integer knob the variant declares, build the
    analytical model at ``knob`` and ``knob + 1`` and diff the
    per-station server counts: a knob that moves exactly one station's
    count by exactly one IS that station's resize handle
    (compartmentalized: ``n_proxy_leaders`` -> ``proxy``,
    ``n_replicas`` -> ``replica``).  Coupled knobs (acceptor grids) and
    knobs that reshape several stations (``f``) are excluded - resizing
    them is a reconfiguration, not an elastic add/drain.  Runtime
    variants get their resize handles the moment they register knobs."""
    spec = variant_spec(name)
    cfg = dict(config) if config is not None else default_config(name)
    cfg.pop("variant", None)
    w = resolve_workload(workload, where="station_knob_map")
    base_srv = spec.model(cfg, w).demand_slots()[2]
    mapping: Dict[str, str] = {}
    for kn in spec.knobs:
        if len(kn.keys) != 1:
            continue
        key = kn.keys[0]
        cur = cfg.get(key)
        if not isinstance(cur, int) or isinstance(cur, bool):
            continue
        up = dict(cfg)
        up[key] = cur + 1
        try:
            up_srv = spec.model(up, w).demand_slots()[2]
        except Exception:
            continue
        diffs = [i for i in range(len(base_srv)) if up_srv[i] != base_srv[i]]
        if (len(diffs) == 1
                and up_srv[diffs[0]] == base_srv[diffs[0]] + 1):
            mapping[STATION_ORDER[diffs[0]]] = key
    return mapping


def resizable_stations(name: str, config: Optional[Config] = None,
                       ) -> Tuple[str, ...]:
    """The stations :func:`run_autoscaled` can live-resize for this
    variant (see :func:`station_knob_map`); empty for knobless variants
    like ``unreplicated``."""
    return tuple(sorted(station_knob_map(name, config)))


def resize_config(name: str, config: Config, station: str, delta: int,
                  ) -> Config:
    """One elastic action lowered onto the config dict: the station's
    registry-derived resize knob moves by ``delta`` (floor 1)."""
    mapping = station_knob_map(name, config)
    key = mapping.get(station)
    if key is None:
        raise ValueError(
            f"variant {name!r} cannot resize station {station!r}; "
            f"resizable: {sorted(mapping) or 'none'}")
    cfg = dict(config)
    new = int(cfg[key]) + int(delta)
    if new < 1:
        raise ValueError(
            f"resize would drop {station!r} ({key}) below 1: {new}")
    cfg[key] = new
    return cfg


@dataclass
class AutoscaledExecutionTrace:
    """One autoscale plan replayed live on a real registered-variant
    cluster, epoch by epoch.

    Each resize is an epoch boundary: the old deployment drains to
    quiescence (stop routing + flush in-flight ops), a fresh deployment
    at the resized config warms by replaying the committed KV state
    (migration puts + continuity ``get`` probes, all paying virtual
    time), and traffic resumes.  ``window_rates`` include that
    reconfiguration overhead, ``serve_rates`` exclude it - their ratio
    per action window is the *measured* dip the transient plane's
    :meth:`~repro.core.autoscale.AutoscaleTrace.predicted_dip` is
    parity-checked against (``dip_rows``), within
    ``max(0.35, exe.latency_tolerance)``.  Safety is non-negotiable:
    every epoch's history is per-key-partition linearizable and every
    continuity probe returns the pre-resize committed value."""

    variant: str
    initial_config: Config
    final_config: Config
    plan: Tuple[Dict[str, Any], ...]
    load: Tuple[float, ...]            # [W] multipliers
    window_ops: Tuple[int, ...]        # [W] commands served per window
    window_rates: Tuple[float, ...]    # [W] cmds per virtual time, incl.
    serve_rates: Tuple[float, ...]     # [W] excl. reconfiguration cost
    machines: Tuple[int, ...]          # [W] provisioned servers
    machine_time: float
    epochs: Tuple[Tuple[int, Config], ...]  # (start window, config)
    dip_rows: Tuple[Dict[str, Any], ...]    # per action: measured vs
    tolerance: float                        # predicted dip ratio
    linearizable: bool
    checkers: Tuple[str, ...]          # per epoch
    continuity_ok: bool
    continuity: Tuple[Tuple[str, Any, Any], ...]  # (key, want, got)
    steps: int

    @property
    def dips_ok(self) -> bool:
        return all(r["ok"] for r in self.dip_rows)

    @property
    def passed(self) -> bool:
        return self.linearizable and self.continuity_ok and self.dips_ok

    def describe(self) -> str:
        acts = ", ".join(
            f"w{a['window']} {'+' if a['delta'] > 0 else '-'}{a['station']}"
            for a in self.plan) or "no actions"
        dips = ", ".join(
            f"w{r['window']} {r['measured']:.2f}/{r['predicted']:.2f}"
            for r in self.dip_rows if r["predicted"] is not None)
        return (f"{self.variant} autoscaled over {len(self.load)} windows "
                f"({len(self.epochs)} epochs): {acts}; machine_time "
                f"{self.machine_time:.2f}; dips meas/pred: {dips or 'n/a'}; "
                f"linearizable={self.linearizable} "
                f"continuity={self.continuity_ok}")


def _last_committed_puts(history: History) -> Dict[Any, Any]:
    """Last committed value per key, in response-time order - the state
    an epoch hands its successor."""
    last: Dict[Any, Any] = {}
    for o in sorted(history.complete(), key=lambda o: o.response_time):
        if o.op[0] == "put":
            last[o.op[1]] = o.op[2]
    return last


def run_autoscaled(name: str,
                   plan: Any,
                   load: Optional[Any] = None,
                   config: Optional[Config] = None,
                   workload: Optional[Union[Workload, float]] = None,
                   n_commands_per_window: int = 36,
                   n_clients: Optional[int] = None,
                   seed: int = 0,
                   state_machine: str = "kv",
                   exhaustive_limit: int = 24,
                   max_steps: int = 2_000_000,
                   ) -> AutoscaledExecutionTrace:
    """Replay an autoscale plan against a real registered-variant
    cluster, staying linearizable across every resize.

    ``plan`` is an :class:`~repro.core.autoscale.AutoscaleTrace` (its
    :meth:`plan`, ``load`` and per-action ``predicted_dip`` are used) or
    a plain sequence of ``{"window", "station", "delta"}`` dicts.  Each
    window serves a :func:`workload_ops` stream sized by its load
    multiplier through the live deployment; a window with an action
    first retires the old epoch - drain to quiescence, flush in-flight
    ops - then builds the resized deployment via the registry-derived
    :func:`resize_config` (zero core edits for any variant that declares
    resize knobs) and warms it by replaying committed state, with the
    whole drain+warm cost paid in measured virtual time.  The per-action
    measured dip (rate including reconfiguration cost over rate without)
    is compared to the transient plane's prediction within
    ``max(0.35, latency_tolerance)`` - the same replay-parity discipline
    as the failover and resharding replays."""
    exe = _executable_of(name)
    spec = variant_spec(name)
    w = resolve_workload(workload, where="run_autoscaled")
    cfg = dict(config) if config is not None else default_config(name)
    n_cl = n_clients if n_clients is not None else exe.n_clients
    tol = max(0.35, exe.latency_tolerance)

    predicted: Dict[int, Optional[float]] = {}
    if hasattr(plan, "plan"):                     # AutoscaleTrace duck type
        if load is None:
            load = [float(x) for x in plan.load]
        actions = list(plan.plan())
        for a in actions:
            predicted[int(a["window"])] = plan.predicted_dip(
                int(a["window"]))
        plan_rows = tuple(dict(a) for a in actions)
    else:
        plan_rows = tuple(dict(a) for a in plan)
    if load is None:
        horizon = max((int(a["window"]) for a in plan_rows), default=0) + 2
        load = [1.0] * horizon
    load = [float(x) for x in load]
    if not load or min(load) <= 0.0:
        raise ValueError("load must be a non-empty positive vector")
    peak = max(load)
    by_window: Dict[int, List[Dict[str, Any]]] = {}
    for a in plan_rows:
        wdx = int(a["window"])
        if not 0 <= wdx < len(load):
            raise ValueError(
                f"action window {wdx} outside the {len(load)}-window "
                f"horizon")
        by_window.setdefault(wdx, []).append(a)

    dep = _build_deployment(exe, cfg, n_cl, seed, state_machine)
    epochs: List[Tuple[int, Config]] = [(0, dict(cfg))]
    checkers: List[str] = []
    continuity: List[Tuple[str, Any, Any]] = []
    window_ops: List[int] = []
    window_rates: List[float] = []
    serve_rates: List[float] = []
    machines: List[int] = []
    dip_rows: List[Dict[str, Any]] = []
    lin_ok = True
    steps = 0
    committed: Dict[Any, Any] = {}

    def _retire(dep: Any) -> None:
        nonlocal lin_ok, steps
        steps += dep.run_to_quiescence(max_steps=max_steps)  # flush
        ok, checker, _ = _check_history_partitioned(
            dep.history, sm_kind=state_machine,
            exhaustive_limit=exhaustive_limit)
        lin_ok = lin_ok and ok
        checkers.append(checker)
        committed.update(_last_committed_puts(dep.history))

    op_mix = replace(w, f_write=1.0) if exe.reads_as_writes else w
    for wdx in range(len(load)):
        overhead = 0.0
        if wdx in by_window:
            _retire(dep)                         # drain + flush old epoch
            for a in by_window[wdx]:
                cfg = resize_config(name, cfg, str(a["station"]),
                                    int(a["delta"]))
            dep = _build_deployment(exe, cfg, n_cl, seed + len(epochs),
                                    state_machine)
            epochs.append((wdx, dict(cfg)))
            if committed:                        # warm: migrate state
                keys = sorted(committed, key=str)
                t0 = dep.net.now
                per = [[] for _ in dep.clients]
                for i, k in enumerate(keys):
                    per[i % len(per)].append(k)
                for client, mine in zip(dep.clients, per):
                    ops = ([("put", k, committed[k]) for k in mine]
                           + [("get", k) for k in mine])
                    if ops:
                        client.run_ops(ops)
                steps += _drive(name, dep, max_steps)
                overhead = dep.net.now - t0
                first_get: Dict[Any, Any] = {}
                for o in sorted(dep.history.complete(),
                                key=lambda o: o.response_time):
                    if o.op[0] == "get" and o.op[1] not in first_get:
                        first_get[o.op[1]] = o.result
                for k in keys:
                    continuity.append((str(k), committed[k],
                                       first_get.get(k)))
        n_ops = max(2, round(n_commands_per_window * load[wdx] / peak))
        ops = workload_ops(op_mix, n_ops,
                           seed=seed * 131 + 7 * wdx + len(epochs))
        t0 = dep.net.now
        _assign_ops(dep, ops)
        steps += _drive(name, dep, max_steps)
        serve = max(dep.net.now - t0, 1e-12)
        window_ops.append(n_ops)
        serve_rates.append(n_ops / serve)
        window_rates.append(n_ops / (serve + overhead))
        machines.append(sum(spec.model(cfg, w).demand_slots()[2]))
        if wdx in by_window:
            measured = serve / (serve + overhead)
            pred = predicted.get(wdx)
            ok = pred is None or abs(measured - pred) <= tol
            dip_rows.append({"window": wdx, "measured": measured,
                             "predicted": pred, "ok": ok})
    _retire(dep)

    cont_ok = all(got == want for _, want, got in continuity)
    return AutoscaledExecutionTrace(
        variant=name, initial_config=dict(epochs[0][1]),
        final_config=dict(cfg), plan=plan_rows, load=tuple(load),
        window_ops=tuple(window_ops), window_rates=tuple(window_rates),
        serve_rates=tuple(serve_rates), machines=tuple(machines),
        machine_time=sum(machines) / len(machines),
        epochs=tuple(epochs), dip_rows=tuple(dip_rows), tolerance=tol,
        linearizable=lin_ok, checkers=tuple(checkers),
        continuity_ok=cont_ok, continuity=tuple(continuity), steps=steps)


# ---------------------------------------------------------------------------
# Built-in execution planes (normalized behind the same canonical config
# dicts the analytical factories consume)
# ---------------------------------------------------------------------------


def _compartmentalized_deployment(f: int = 1, n_proxy_leaders: int = 10,
                                  grid_rows: int = 2, grid_cols: int = 2,
                                  n_replicas: int = 4, batch_size: int = 1,
                                  n_batchers: int = 0, n_unbatchers: int = 0,
                                  n_clients: int = 3, seed: int = 0,
                                  state_machine: str = "kv",
                                  latency_fn: Optional[Any] = None,
                                  ) -> CompartmentalizedMultiPaxos:
    # the (2f+1, 1) "grid" is the majority-quorum column: lower it to the
    # majority quorum system the deployment uses for that shape
    grid = None if (grid_rows, grid_cols) == (2 * f + 1, 1) else (grid_rows,
                                                                  grid_cols)
    cfg = DeploymentConfig(f=f, n_proxy_leaders=n_proxy_leaders, grid=grid,
                           n_replicas=n_replicas, n_batchers=n_batchers,
                           n_unbatchers=n_unbatchers, batch_size=batch_size,
                           state_machine=state_machine, seed=seed,
                           latency_fn=latency_fn)
    return CompartmentalizedMultiPaxos(cfg, n_clients=n_clients)


def _compartmentalized_feedback(model_cfg: Config,
                                trace: ExecutionTrace) -> Config:
    """Feed the *realized* batch fill into the table.

    Closed-loop traffic rarely fills configured batches: with C
    outstanding clients a size-B batcher flushes by timer at ~C commands,
    so the amortization denominator the wire actually enjoyed is
    ``n_commands / batches_flushed`` - the measured counterpart of the
    ``Workload.batch_fill`` hint (``effective_batch_size``) the sweep
    plane's adapter applies.  Unbatched configs pass through untouched."""
    if model_cfg.get("n_batchers", 0) <= 0 or model_cfg.get(
            "batch_size", 1) <= 1:
        return model_cfg
    dep = trace.deployment
    write_batches = sum(b.batch_seq for b in dep.batchers)
    read_batches = sum(b.preread_seq for b in dep.batchers)
    # the write-stream fill drives the leader/proxy/replica write path
    # (the table's headline 2/B leader term is exact against it); fall
    # back to the read-stream fill for read-only runs
    if trace.n_writes and write_batches:
        b_eff = trace.n_writes / write_batches
    elif trace.n_reads and read_batches:
        b_eff = trace.n_reads / read_batches
    else:
        return model_cfg
    return dict(model_cfg, batch_size=max(b_eff, 1.0))


def _multipaxos_deployment(f: int = 1, thrifty: bool = True,
                           n_clients: int = 2, seed: int = 0,
                           state_machine: str = "kv",
                           latency_fn: Optional[Any] = None,
                           ) -> CompartmentalizedMultiPaxos:
    # vanilla: self-broadcast leader, majority quorums, and - matching the
    # fused-server accounting of multipaxos_model - a replica per machine
    del thrifty  # the deployment always contacts thrifty majorities
    cfg = DeploymentConfig(f=f, n_proxy_leaders=0, grid=None,
                           n_replicas=2 * f + 1, state_machine=state_machine,
                           seed=seed, latency_fn=latency_fn)
    return CompartmentalizedMultiPaxos(cfg, n_clients=n_clients)


def _multipaxos_station_of(addr: str, dep: Any) -> Optional[str]:
    """Fused-server bucketing for the vanilla baseline: the model's
    ``leader`` station is machine 0 (the leader role; its colocated
    acceptor/replica role costs are the model's reply-share term) and
    ``follower`` the other 2f machines (acceptor + replica roles).  The
    standby leader objects are idle and unmapped."""
    role, _, idx = addr.partition("/")
    if role == "leader":
        return "leader" if idx == "0" else None
    if role in ("acceptor", "replica"):
        return None if idx == "0" else "follower"
    return None


def _mencius_deployment(n_leaders: int = 3, f: int = 1,
                        n_proxy_leaders: int = 10, grid_rows: int = 2,
                        grid_cols: int = 2, n_replicas: int = 4,
                        announce_interval: Optional[float] = None,
                        skip_fraction: float = 0.0, skip_batch: float = 10.0,
                        n_clients: int = 3, seed: int = 0,
                        state_machine: str = "kv",
                        latency_fn: Optional[Any] = None,
                        ) -> MenciusDeployment:
    # announce/skip knobs parameterize the *table*; the protocol's own
    # announce-every-command / range-skip behaviour is measured and fed
    # back by _mencius_feedback
    del announce_interval, skip_fraction, skip_batch
    return MenciusDeployment(n_leaders=n_leaders, f=f,
                             n_proxy_leaders=n_proxy_leaders,
                             grid=(grid_rows, grid_cols),
                             n_replicas=n_replicas, n_clients=n_clients,
                             state_machine=state_machine, seed=seed,
                             latency_fn=latency_fn)


def _mencius_feedback(model_cfg: Config, trace: ExecutionTrace) -> Config:
    """Feed the run's own slot-coordination statistics into the table:
    the correctness plane announces its frontier on every owned command
    (``announce_interval=1``, where the paper's protocol piggybacks it)
    and lagging leaders range-fill vacant slots - the effective
    ``skip_fraction`` and per-range amortization ``skip_batch`` are read
    off the run instead of assumed."""
    dep = trace.deployment
    n_ranges = dep.total_skips()
    n_slots = max(r.executed_upto for r in dep.replicas) + 1
    n_noops = max(n_slots - trace.n_writes, 0)
    cfg = dict(model_cfg, announce_interval=1.0)
    if n_noops and n_ranges:
        cfg.update(skip_fraction=n_noops / n_slots,
                   skip_batch=n_noops / n_ranges)
    return cfg


def _spaxos_deployment(n_disseminators: int = 2, n_stabilizers: int = 3,
                       f: int = 1, n_proxy_leaders: int = 3,
                       grid_rows: int = 2, grid_cols: int = 2,
                       n_replicas: int = 3, payload_factor: float = 1.0,
                       n_clients: int = 2, seed: int = 0,
                       state_machine: str = "kv",
                       latency_fn: Optional[Any] = None,
                       ) -> SPaxosDeployment:
    del payload_factor  # table-only knob: message *counts* are size-blind
    return SPaxosDeployment(f=f, n_disseminators=n_disseminators,
                            n_stabilizers=n_stabilizers,
                            n_proxy_leaders=n_proxy_leaders,
                            grid=(grid_rows, grid_cols),
                            n_replicas=n_replicas, n_clients=n_clients,
                            state_machine=state_machine, seed=seed,
                            latency_fn=latency_fn)


def _vanilla_mencius_deployment(f: int = 1,
                                announce_interval: Optional[float] = None,
                                skip_fraction: float = 0.0,
                                skip_batch: float = 10.0, n_clients: int = 3,
                                seed: int = 0, state_machine: str = "kv",
                                latency_fn: Optional[Any] = None,
                                ) -> VanillaMenciusDeployment:
    # announce/skip knobs parameterize the table; the fused servers
    # announce every command and range-fill, measured back by feedback
    del announce_interval, skip_fraction, skip_batch
    return VanillaMenciusDeployment(f=f, n_clients=n_clients,
                                    state_machine=state_machine, seed=seed,
                                    latency_fn=latency_fn)


def _vanilla_mencius_feedback(model_cfg: Config,
                              trace: ExecutionTrace) -> Config:
    """Same feedback loop as compartmentalized Mencius: the fused servers
    announce their frontier on every owned command and range-fill vacant
    slots; the table's skip knobs are read off the run."""
    dep = trace.deployment
    n_ranges = dep.total_skips()
    n_slots = max(s.executed_upto for s in dep.servers) + 1
    n_noops = max(n_slots - trace.n_writes, 0)
    cfg = dict(model_cfg, announce_interval=1.0)
    if n_noops and n_ranges:
        cfg.update(skip_fraction=n_noops / n_slots,
                   skip_batch=n_noops / n_ranges)
    return cfg


def _vanilla_spaxos_deployment(f: int = 1, payload_factor: float = 1.0,
                               n_clients: int = 3, seed: int = 0,
                               state_machine: str = "kv",
                               latency_fn: Optional[Any] = None,
                               ) -> VanillaSPaxosDeployment:
    del payload_factor  # table-only knob: message *counts* are size-blind
    return VanillaSPaxosDeployment(f=f, n_clients=n_clients,
                                   state_machine=state_machine, seed=seed,
                                   latency_fn=latency_fn)


def _vanilla_spaxos_station_of(addr: str, dep: Any) -> Optional[str]:
    """Fused-server bucketing: server 0 carries the colocated leader role
    (the model's ``leader`` machine); the other 2f are ``follower``s."""
    role, _, idx = addr.partition("/")
    if role != "server":
        return None
    return "leader" if idx == "0" else "follower"


def _craq_deployment(n_nodes: int = 3, skew_p: float = 0.0,
                     dirty_fraction: float = 0.5, n_clients: int = 2,
                     seed: int = 0, state_machine: str = "kv",
                     latency_fn: Optional[Any] = None,
                     ) -> CraqDeployment:
    # skew/dirty parameterize the table; the run's actual forwarding
    # fraction is measured and fed back by _craq_feedback
    del skew_p, dirty_fraction, state_machine  # chain nodes are always kv
    return CraqDeployment(n_nodes=n_nodes, n_clients=n_clients, seed=seed,
                          latency_fn=latency_fn)


def _craq_station_of(addr: str, dep: Any) -> Optional[str]:
    role, _, idx = addr.partition("/")
    if role != "chain":
        return None
    i = int(idx)
    if i == 0:
        return "head"
    return "tail" if i == len(dep.chain_addrs) - 1 else "chain"


def _craq_feedback(model_cfg: Config, trace: ExecutionTrace) -> Config:
    """Feed the measured dirty-read forwarding fraction into the table:
    with concurrent writers even a nominally uniform run forwards some
    reads to the tail while their key is dirty.  A *user* config that
    pins its own skew knobs keeps them (the workload adapter's
    ``dirty_fraction`` is a hint; the measured fraction replaces it)."""
    if trace.n_reads == 0 or trace.config.get("skew_p"):
        return model_cfg
    forwarded = sum(n.tail_forwards for n in trace.deployment.nodes)
    # the table's forwarded fraction is skew_p * dirty_fraction, over
    # reads that land on the k-1 non-tail nodes
    k = len(trace.deployment.chain_addrs)
    p_fwd = forwarded / trace.n_reads * k / max(k - 1, 1)
    return dict(model_cfg, skew_p=min(p_fwd, 1.0), dirty_fraction=1.0)


def _unreplicated_deployment(n_clients: int = 2, seed: int = 0,
                             state_machine: str = "kv", batch_size: int = 1,
                             n_batchers: int = 0, n_unbatchers: int = 0,
                             latency_fn: Optional[Any] = None,
                             ) -> UnreplicatedStateMachine:
    if n_batchers or n_unbatchers or batch_size != 1:
        raise ValueError("the unreplicated execution plane is unbatched; "
                         "batching knobs parameterize the table only")
    return UnreplicatedStateMachine(n_clients=n_clients, seed=seed,
                                    state_machine=state_machine,
                                    latency_fn=latency_fn)


# Parity notes per plane (all measured write-only unless stated):
# * compartmentalized / spaxos: station totals per command are
#   deterministic (random quorum/column picks move messages *within* a
#   station, never across), so tolerances are tight and the headline
#   leader counts (2 msgs/cmd; S-Paxos: 2 id-only msgs) are exact.
# * multipaxos: the fused-machine model folds the leader machine's
#   acceptor role and chosen-recv into its follower/reply terms slightly
#   differently than the wire counts them - the leader row lands within
#   ~5%, followers are exact in expectation.
# * mencius: exact once the run's announce/skip parameters are fed back;
#   the proxy row absorbs range-path edge messages.
# * craq: message-exact chain accounting; under mixed workloads the
#   measured forwarding fraction is fed back.
# * vanilla_mencius: the fused table omits the owner machine's own
#   colocated acceptor vote and chosen-recv (local facts on a fused
#   server); the wire plane lands within ~2% once skips are fed back.
# * vanilla_spaxos: wire totals match the table exactly (self-sends are
#   counted on both sides, like the model); only the thrifty quorum draw
#   moves acceptor messages between the leader and follower rows.
register_executable(
    "compartmentalized",
    deployment=_compartmentalized_deployment,
    model_feedback=_compartmentalized_feedback,
    exact_stations=("leader",),
    rel_tolerance=0.10,
    n_clients=3,
    description="CompartmentalizedMultiPaxos cluster (paper sections 3-4)",
)

register_executable(
    "multipaxos",
    deployment=_multipaxos_deployment,
    station_of=_multipaxos_station_of,
    rel_tolerance=0.10,
    reads_as_writes=True,  # the vanilla table has no read path (paper s.3)
    n_clients=2,
    description="vanilla MultiPaxos (self-broadcast leader, fused servers)",
)

register_executable(
    "mencius",
    deployment=_mencius_deployment,
    model_feedback=_mencius_feedback,
    rel_tolerance=0.10,
    station_tolerances=(("proxy", 0.25),),
    # slot-order execution waits are only partially captured by the wire
    # model (geo.py) - give the WAN latency rows extra headroom
    latency_tolerance=0.5,
    n_clients=3,
    description="MenciusDeployment (round-robin leaders + range skips)",
)

register_executable(
    "spaxos",
    deployment=_spaxos_deployment,
    exact_stations=("leader",),
    rel_tolerance=0.10,
    n_clients=2,
    description="SPaxosDeployment (id-ordering leader, data-path split)",
)

register_executable(
    "craq",
    deployment=_craq_deployment,
    station_of=_craq_station_of,
    model_feedback=_craq_feedback,
    rel_tolerance=0.10,
    n_clients=2,
    description="CraqDeployment chain (dirty reads forward to the tail)",
)

register_executable(
    "vanilla_mencius",
    deployment=_vanilla_mencius_deployment,
    model_feedback=_vanilla_mencius_feedback,
    rel_tolerance=0.10,
    reads_as_writes=True,  # the fused table has no read path (paper Fig. 25)
    latency_tolerance=0.5,  # slot-order skip echoes only partially modeled
    n_clients=3,
    description="VanillaMenciusDeployment (fused leader+acceptor+replica)",
)

register_executable(
    "vanilla_spaxos",
    deployment=_vanilla_spaxos_deployment,
    station_of=_vanilla_spaxos_station_of,
    rel_tolerance=0.10,
    reads_as_writes=True,  # the fused table has no read path (paper Fig. 27)
    n_clients=3,
    description="VanillaSPaxosDeployment (fused servers, leader on 0)",
)

register_executable(
    "unreplicated",
    deployment=_unreplicated_deployment,
    exact_stations=("server",),
    rel_tolerance=0.05,
    n_clients=2,
    description="UnreplicatedStateMachine upper bound",
)

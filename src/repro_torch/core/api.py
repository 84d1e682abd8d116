"""The performance-plane public API: a pluggable protocol-variant registry
and a workload-first evaluation surface.

The paper's closing argument is that compartmentalization is "a technique,
not a protocol": practitioners should be able to apply it to *their*
protocol incrementally.  This module makes that claim executable.  A
protocol variant is not a branch in a sweep loop - it is a declarative
:class:`VariantSpec`: a name, a knob space (knob name -> value iterable,
including coupled knobs like ``(rows, cols)`` acceptor grids), a model
factory, and the station slots the variant's demand table emits.
:func:`register_variant` installs it, after which the variant rides the
entire batched stack with **zero core-file edits**:

* ``SweepSpec(variants=(..., "your_variant"))`` enumerates its knob
  product (``repro.core.sweep``),
* the canonical station vocabulary (:data:`STATION_ORDER`) grows by
  stable, append-ordered allocation, so its demand rows batch into the
  same dense tensors as every built-in protocol,
* ``autotune_variants`` searches it under a machine budget via its
  declared ``candidate_knobs``,
* ``CompiledSweep.transient`` scripts it through time,
* and - when the spec also declares an :class:`ExecutableSpec` - the
  variant's **real cluster** executes, linearizability-checks and
  measured-vs-analytical parity-checks through
  ``repro.core.execution.run_variant`` / ``validate_variant``: two
  planes, one registry.

The second abstraction is :class:`Workload`: "90% reads, Zipf-skewed on a
hot key, bursty arrivals, batches half full" is **one value passed once**
instead of an ``f_write`` scalar plus scattered kwargs.  Engines consume
the parts they understand: every engine blends write/read demand by
``f_write``; variants that declare a ``workload_adapter`` additionally
reshape their demand tables under skew or partial batch fill (CRAQ's
dirty-read forwarding, batcher amortization); the transient engine turns
``arrival="bursty"`` into scripted demand-surge windows.

This module is dependency-light on purpose (stdlib only): the registry
must be importable by tooling (``scripts/check_docs_links.py`` validates
variant names cited in the docs) without dragging in JAX.

Legacy compatibility: every evaluation entry point that used to take a
bare ``f_write=`` scalar still accepts it, funneled through
:func:`resolve_workload`, which emits a ``DeprecationWarning`` and wraps
the scalar in a :class:`Workload`.
"""
from __future__ import annotations

import contextlib
import itertools
import warnings
import zlib
from collections import abc
from dataclasses import dataclass, replace
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Union,
)

Config = Dict[str, Any]

#: Reserved sweep-axis names a knob may not shadow (``SweepSpec`` fields
#: that are not knob value iterables).
_RESERVED_KNOB_NAMES = frozenset({"f", "variants", "knob_values"})


# ---------------------------------------------------------------------------
# Workload: the evaluation point, passed once
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Workload:
    """A workload mix as one value: write fraction, per-key skew, arrival
    pattern and batch-fill hints.

    Fields and which engine consumes them:

    * ``f_write`` - fraction of commands that are writes.  Every engine:
      the effective demand is ``f_w * d_write + (1 - f_w) * d_read``.
    * ``skew_p`` - probability an operation targets the hot key (0 =
      uniform).  Consumed by variants whose :class:`VariantSpec` declares
      a ``workload_adapter`` (CRAQ: skewed dirty reads forward to the
      tail); key-agnostic variants ignore it - which is exactly the
      paper's Fig. 33 claim.
    * ``dirty_fraction`` - fraction of hot-key reads that find the key
      dirty (write in flight).  A hint for adapters that do not solve the
      throughput fixed point (``craq_model`` does; the sweep-axis table
      takes the hint).
    * ``arrival`` - ``"steady"`` (default) or ``"bursty"``.  The
      transient engine scripts bursty arrivals as demand-surge windows:
      during a burst every station's demand is multiplied by
      ``burst_factor`` (offered load transiently exceeds provisioned
      capacity), for ``burst_fraction`` of the run split across
      ``n_bursts`` evenly spaced surges.
    * ``batch_fill`` - fraction of batch slots that actually fill (1.0 =
      full batches).  Variants with batchers amortize downstream demand
      by the *effective* batch size ``1 + (B - 1) * batch_fill`` - under
      sparse arrivals batching buys less (paper Figs. 30-31 as a knob).
    """

    f_write: float = 1.0
    skew_p: float = 0.0
    dirty_fraction: float = 0.5
    arrival: str = "steady"
    burst_factor: float = 4.0
    burst_fraction: float = 0.25
    n_bursts: int = 3
    batch_fill: float = 1.0
    name: Optional[str] = None

    def __post_init__(self) -> None:
        for fname in ("f_write", "skew_p", "dirty_fraction", "batch_fill"):
            v = getattr(self, fname)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"Workload.{fname} must be in [0, 1]: {v}")
        if self.arrival not in ("steady", "bursty"):
            raise ValueError(
                f"Workload.arrival must be 'steady' or 'bursty': "
                f"{self.arrival!r}")
        if not 0.0 < self.burst_fraction < 1.0:
            raise ValueError(
                f"Workload.burst_fraction must be in (0, 1): "
                f"{self.burst_fraction}")
        if self.burst_factor <= 0.0:
            raise ValueError(
                f"Workload.burst_factor must be positive: {self.burst_factor}")
        if self.n_bursts < 1:
            raise ValueError(f"Workload.n_bursts must be >= 1: {self.n_bursts}")

    @property
    def f_read(self) -> float:
        return 1.0 - self.f_write

    @classmethod
    def read_mix(cls, read_fraction: float, **kwargs: Any) -> "Workload":
        """Workload from a read fraction (``read_mix(0.9)`` = 90% reads)."""
        return cls(f_write=1.0 - read_fraction, **kwargs)

    @property
    def adapts_demands(self) -> bool:
        """True when variant ``workload_adapter``s must be consulted (the
        workload reshapes demand tables beyond the write/read blend)."""
        return self.skew_p > 0.0 or self.batch_fill < 1.0

    def describe(self) -> str:
        parts = [f"{100 * self.f_read:.0f}% reads"]
        if self.skew_p > 0:
            parts.append(f"skew p={self.skew_p:g}")
        if self.arrival != "steady":
            parts.append(f"{self.arrival} x{self.burst_factor:g}")
        if self.batch_fill < 1.0:
            parts.append(f"batch fill {self.batch_fill:g}")
        label = ", ".join(parts)
        return f"{self.name} ({label})" if self.name else label


#: Common evaluation points (the paper's three workload mixes).
WRITE_ONLY = Workload(f_write=1.0, name="write_only")
MIXED_50_50 = Workload(f_write=0.5, name="50pct_reads")
READ_HEAVY = Workload(f_write=0.1, name="90pct_reads")


def as_f_write(workload_or_f: Union["Workload", float]) -> float:
    """The scalar write fraction of either a :class:`Workload` or a bare
    float (the scalar model plane's native blend parameter)."""
    if isinstance(workload_or_f, Workload):
        return workload_or_f.f_write
    return float(workload_or_f)


def resolve_workload(workload: Optional[Union["Workload", float]] = None,
                     f_write: Optional[float] = None,
                     *,
                     default: Optional["Workload"] = None,
                     where: str = "this call") -> "Workload":
    """Coerce the ``(workload, legacy f_write kwarg)`` pair to a Workload.

    The deprecation shim behind every evaluation entry point: passing the
    old ``f_write=`` scalar (or a bare float where a Workload is
    expected) still works but warns; pass ``Workload(f_write=...)``
    instead."""
    if f_write is not None:
        if workload is not None:
            raise TypeError(
                f"{where}: pass either workload= or the legacy f_write=, "
                f"not both")
        warnings.warn(
            f"{where}: f_write= is deprecated; pass "
            f"workload=Workload(f_write=...) instead",
            DeprecationWarning, stacklevel=3)
        return Workload(f_write=float(f_write))
    if workload is None:
        return default if default is not None else Workload()
    if isinstance(workload, Workload):
        return workload
    if isinstance(workload, (int, float)) and not isinstance(workload, bool):
        warnings.warn(
            f"{where}: a bare write-fraction scalar is deprecated; pass "
            f"workload=Workload(f_write=...) instead",
            DeprecationWarning, stacklevel=3)
        return Workload(f_write=float(workload))
    raise TypeError(f"{where}: expected a Workload (or legacy float), got "
                    f"{type(workload).__name__}")


# ---------------------------------------------------------------------------
# ShardingSpec: the shard axis, as one value
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardingSpec:
    """State partitioned across ``n_shards`` independent replicated groups.

    A sharded system runs N copies of a registered variant, each owning a
    hash partition of the key space; clients route by key.  One spec
    drives every plane:

    * **analytical / sweep / transient** - each shard ``s`` sees a
      fraction ``w_s`` of the traffic, so its station demands are the
      per-command table scaled by ``w_s`` (probabilistic-routing visit
      ratios).  The sharded demand tensor ``[M, S, K]`` flattens to
      ``[M, S*K]`` and flows through the *same* jitted MVA/fluid/scan
      paths; the bottleneck law becomes
      ``T = min_s alpha / (w_s * max_k d[k])`` - uniform weights
      multiply peak throughput by exactly ``n_shards``.
    * **execution** - ``shard_of(key)`` is stable crc32 hash routing
      (never Python's per-process randomized ``hash``), used by
      :class:`~repro.core.execution.ShardedDeployment` for client-side
      routing and by the history partitioner for per-key-partition
      linearizability checks.

    Per-shard weights reuse the :class:`Workload` skew machinery: under
    ``skew_p > 0`` the shard owning the hot key absorbs
    ``skew_p + (1 - skew_p) / S`` of the traffic (hot key plus its share
    of the uniform remainder) and every other shard
    ``(1 - skew_p) / S``.  Explicit ``weights`` override the derivation
    (they are normalized); ``hot_key`` names the key whose owner is the
    hot shard (the execution harness's hot key is ``"hot"``).
    """

    n_shards: int = 1
    weights: Optional[Tuple[float, ...]] = None
    hot_key: str = "hot"

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(
                f"ShardingSpec.n_shards must be >= 1: {self.n_shards}")
        if self.weights is not None:
            w = tuple(float(x) for x in self.weights)
            if len(w) != self.n_shards:
                raise ValueError(
                    f"ShardingSpec.weights must have n_shards="
                    f"{self.n_shards} entries: got {len(w)}")
            if any(x < 0.0 for x in w) or sum(w) <= 0.0:
                raise ValueError(
                    f"ShardingSpec.weights must be non-negative with a "
                    f"positive sum: {w}")
            object.__setattr__(self, "weights", w)

    def shard_of(self, key: Any) -> int:
        """Stable hash routing: which shard owns ``key``.  crc32 keeps the
        mapping identical across processes and runs (Python's builtin
        ``hash`` is randomized per process)."""
        return zlib.crc32(str(key).encode()) % self.n_shards

    @property
    def hot_shard(self) -> int:
        """The shard that owns the workload's hot key."""
        return self.shard_of(self.hot_key)

    def resolved_weights(
            self, workload: Optional["Workload"] = None) -> Tuple[float, ...]:
        """Per-shard traffic fractions, normalized to sum to 1.

        Explicit ``weights`` win; otherwise the :class:`Workload` skew
        derives them (hot shard ``skew_p + (1 - skew_p)/S``, the rest
        ``(1 - skew_p)/S``); with no skew the split is uniform."""
        s = self.n_shards
        if self.weights is not None:
            total = sum(self.weights)
            return tuple(x / total for x in self.weights)
        p = workload.skew_p if workload is not None else 0.0
        if p <= 0.0 or s == 1:
            return (1.0 / s,) * s
        base = (1.0 - p) / s
        return tuple(base + p if i == self.hot_shard else base
                     for i in range(s))

    def describe(self) -> str:
        if self.weights is not None:
            w = ", ".join(f"{x:g}" for x in self.resolved_weights())
            return f"{self.n_shards} shards (weights {w})"
        return f"{self.n_shards} shards"


#: The degenerate single-group spec (every plane's implicit default).
UNSHARDED = ShardingSpec(n_shards=1)


# ---------------------------------------------------------------------------
# GeoSpec: the geo axis, as one value
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GeoSpec:
    """A geo-replicated deployment as one value: named regions, a
    directed per-region-pair RTT matrix, a placement (which region hosts
    each station replica) and per-region client weights.

    One spec drives every plane:

    * **analytical / sweep** - ``repro.core.geo`` lowers each registered
      variant's message flow into critical-path WAN round trips per op
      class (write commit path, read-quorum path, CRAQ chain hops),
      producing per-region latency offsets that compose with the jitted
      MVA queueing latencies (``CompiledSweep.geo_latency``);
    * **execution** - :meth:`latency_fn` realizes the same matrix on the
      deterministic message-level network, so ``run_variant`` measures
      per-region latencies that parity-check against the analytical
      critical path (``validate_variant(geo=...)``);
    * **batched execution** - ``execute_configs(geo=...)`` fans every
      config into per-region lanes (one closed-loop client population
      per region) whose latency histograms carry the WAN offsets.

    Conventions: ``rtt[i][j]`` is the *round-trip* time for a message
    leaving region ``i`` toward ``j`` and its reply, in the same
    virtual-time units as the network's ``default_latency`` (must be
    square, zero-diagonal, non-negative; asymmetric matrices are allowed
    - e.g. a healing path after a region outage - and :attr:`symmetric`
    reports whether the matrix is direction-free); a one-way hop costs
    ``local_delay + rtt/2`` (local
    hops, including self-sends, cost ``local_delay`` - the uniform
    all-zero matrix therefore reproduces today's single-delay numbers
    exactly).  ``placement`` maps a station kind (the ``role`` part of a
    ``role/<i>`` address) to a cycle of region indices: replica ``i`` of
    kind ``k`` lives in ``placement[k][i % len(placement[k])]``; kinds
    without an entry default to the round-robin cycle ``i % n_regions``.
    Clients are split into contiguous blocks by ``client_weights``
    (largest-remainder apportionment; uniform when ``None``).
    """

    regions: Tuple[str, ...]
    rtt: Tuple[Tuple[float, ...], ...]
    placement: Tuple[Tuple[str, Tuple[int, ...]], ...] = ()
    client_weights: Optional[Tuple[float, ...]] = None
    local_delay: float = 1.0

    def __post_init__(self) -> None:
        regions = tuple(str(r) for r in self.regions)
        if not regions:
            raise ValueError("GeoSpec needs at least one region")
        if len(set(regions)) != len(regions):
            raise ValueError(f"GeoSpec region names must be unique: {regions}")
        object.__setattr__(self, "regions", regions)
        n = len(regions)
        rtt = tuple(tuple(float(x) for x in row) for row in self.rtt)
        if len(rtt) != n or any(len(row) != n for row in rtt):
            raise ValueError(
                f"GeoSpec.rtt must be a {n}x{n} matrix for regions {regions}")
        for i in range(n):
            if rtt[i][i] != 0.0:
                raise ValueError(
                    f"GeoSpec.rtt diagonal must be zero: rtt[{i}][{i}]="
                    f"{rtt[i][i]}")
            for j in range(n):
                if rtt[i][j] < 0.0:
                    raise ValueError(
                        f"GeoSpec.rtt must be non-negative: rtt[{i}][{j}]="
                        f"{rtt[i][j]}")
        object.__setattr__(self, "rtt", rtt)
        placement = tuple(
            (str(kind), tuple(int(r) for r in cycle))
            for kind, cycle in self.placement)
        for kind, cycle in placement:
            if not cycle:
                raise ValueError(
                    f"GeoSpec.placement[{kind!r}] must be a non-empty "
                    f"region-index cycle")
            for r in cycle:
                if not 0 <= r < n:
                    raise ValueError(
                        f"GeoSpec.placement[{kind!r}] region index {r} out "
                        f"of range for {n} regions")
        if len(set(k for k, _ in placement)) != len(placement):
            raise ValueError("GeoSpec.placement kinds must be unique")
        object.__setattr__(self, "placement", placement)
        if self.client_weights is not None:
            w = tuple(float(x) for x in self.client_weights)
            if len(w) != n:
                raise ValueError(
                    f"GeoSpec.client_weights must have {n} entries: "
                    f"got {len(w)}")
            if any(x < 0.0 for x in w) or sum(w) <= 0.0:
                raise ValueError(
                    f"GeoSpec.client_weights must be non-negative with a "
                    f"positive sum: {w}")
            object.__setattr__(self, "client_weights", w)
        if self.local_delay < 0.0:
            raise ValueError(
                f"GeoSpec.local_delay must be non-negative: "
                f"{self.local_delay}")

    @classmethod
    def uniform(cls, n_regions: int = 3, local_delay: float = 1.0,
                **kwargs: Any) -> "GeoSpec":
        """An all-zero-RTT matrix over ``n_regions`` regions: region
        labels exist but every hop costs ``local_delay`` - byte-identical
        behaviour to a geo-less deployment."""
        names = tuple(f"r{i}" for i in range(n_regions))
        zero = tuple((0.0,) * n_regions for _ in range(n_regions))
        return cls(regions=names, rtt=zero, local_delay=local_delay,
                   **kwargs)

    @property
    def n_regions(self) -> int:
        return len(self.regions)

    @property
    def is_uniform(self) -> bool:
        """True when every inter-region RTT is zero (the degenerate case
        that must reproduce single-delay numbers exactly)."""
        return all(x == 0.0 for row in self.rtt for x in row)

    @property
    def symmetric(self) -> bool:
        """True when ``rtt[i][j] == rtt[j][i]`` for every pair - the
        direction-free case ``wan_offsets`` keeps exact.  Directed
        matrices (a congested heal path after a region outage) are
        legal; each hop reads its own directed half-RTT."""
        n = self.n_regions
        return all(self.rtt[i][j] == self.rtt[j][i]
                   for i in range(n) for j in range(i + 1, n))

    def one_way(self, i: int, j: int) -> float:
        """WAN half-RTT between regions ``i`` and ``j`` (0 for i == j);
        the *extra* delay a hop pays on top of ``local_delay``."""
        return 0.0 if i == j else self.rtt[i][j] / 2.0

    def hop_delay(self, i: int, j: int) -> float:
        """Total one-way message delay between regions ``i`` and ``j``."""
        return self.local_delay + self.one_way(i, j)

    def region_of(self, kind: str, index: int) -> int:
        """Region index hosting replica ``index`` of station ``kind``."""
        for k, cycle in self.placement:
            if k == kind:
                return cycle[index % len(cycle)]
        return index % self.n_regions

    def resolved_client_weights(self) -> Tuple[float, ...]:
        """Per-region client traffic fractions, normalized to sum to 1."""
        if self.client_weights is None:
            return (1.0 / self.n_regions,) * self.n_regions
        total = sum(self.client_weights)
        return tuple(x / total for x in self.client_weights)

    def client_counts(self, n_clients: int) -> Tuple[int, ...]:
        """How many of ``n_clients`` closed-loop clients sit in each
        region (largest-remainder apportionment of the weights)."""
        w = self.resolved_client_weights()
        quotas = [x * n_clients for x in w]
        counts = [int(q) for q in quotas]
        rem = n_clients - sum(counts)
        order = sorted(range(len(w)), key=lambda i: quotas[i] - counts[i],
                       reverse=True)
        for i in order[:rem]:
            counts[i] += 1
        return tuple(counts)

    def client_region(self, index: int, n_clients: int) -> int:
        """Region of client ``index``: clients form contiguous blocks in
        region order, sized by :meth:`client_counts`."""
        counts = self.client_counts(n_clients)
        edge = 0
        for r, c in enumerate(counts):
            edge += c
            if index < edge:
                return r
        return self.n_regions - 1

    def latency_fn(self, n_clients: int) -> Callable[[str, str], float]:
        """The network's per-message delay function realizing this spec:
        ``delay(src, dst) = local_delay + one_way(region(src),
        region(dst))``.  Client addresses split into contiguous
        per-region blocks; station addresses follow :meth:`region_of`."""
        def region_of_addr(addr: str) -> int:
            kind, _, idx = addr.partition("/")
            i = int(idx) if idx.isdigit() else 0
            if kind == "client":
                return self.client_region(i, n_clients)
            return self.region_of(kind, i)

        def delay(src: str, dst: str) -> float:
            return self.local_delay + self.one_way(
                region_of_addr(src), region_of_addr(dst))

        return delay

    def relabeled(self, perm: Sequence[int]) -> "GeoSpec":
        """The same physical deployment with regions renumbered by
        ``perm`` (``perm[new] = old``).  Placement-autotune results must
        be invariant under this transformation (up to the relabeling)."""
        p = tuple(int(i) for i in perm)
        if sorted(p) != list(range(self.n_regions)):
            raise ValueError(
                f"relabeled() needs a permutation of range({self.n_regions})"
                f": got {p}")
        inv = [0] * len(p)
        for new, old in enumerate(p):
            inv[old] = new
        return GeoSpec(
            regions=tuple(self.regions[old] for old in p),
            rtt=tuple(tuple(self.rtt[a][b] for b in p) for a in p),
            placement=tuple((kind, tuple(inv[r] for r in cycle))
                            for kind, cycle in self.placement),
            client_weights=(None if self.client_weights is None else
                            tuple(self.client_weights[old] for old in p)),
            local_delay=self.local_delay)

    def describe(self) -> str:
        w = ", ".join(f"{x:g}" for x in self.resolved_client_weights())
        return (f"{self.n_regions} regions ({', '.join(self.regions)}; "
                f"client weights {w})")


# ---------------------------------------------------------------------------
# AutoscalePolicy: the elastic-control contract, as one value
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AutoscalePolicy:
    """An elastic-scaling policy as one declarative value.

    The policy is the *contract* the autoscale controller
    (``repro.core.autoscale.Controller``) enforces per control window:

    * ``target_low`` / ``target_high`` - the per-station utilization
      band.  A station above ``target_high`` gains one server; a station
      below ``target_low`` loses one, but only when the *predicted*
      post-drain utilization ``u * c / (c - 1)`` stays at or under
      ``target_high`` (the hysteresis guard: a drain whose inverse add
      would immediately re-trigger is never taken, so constant load
      converges to zero actions);
    * ``queue_high`` - mean queue depth per server that forces an add
      even inside the utilization band (the queue-based load-leveling
      signal; ``0`` disables it);
    * ``cooldown_windows`` - control windows that must pass after any
      action before the next one (reconfiguration has a modelled demand
      spike; back-to-back resizes would stack spikes);
    * ``min_counts`` / ``max_counts`` - per-station floors/ceilings as
      ``(station, count)`` pairs; stations without an entry fall back to
      1 / unbounded.  Floors also thread through
      ``autotune.variant_candidate_configs`` so the tuner never proposes
      a config the policy would be unable to hold;
    * ``machine_budget`` - total-machine ceiling across all stations
      (``None`` = unbounded); adds that would exceed it are skipped;
    * ``spike_factor`` / ``spike_fraction`` - the modelled cost of a
      resize: the resized station's demand is multiplied by
      ``spike_factor`` for the first ``spike_fraction`` of the window
      the action lands in (``transient.reconfiguration_schedule``).

    Stdlib-only on purpose - the policy travels to the JAX-free
    execution plane (``execution.run_autoscaled``) unchanged.
    """

    target_low: float = 0.45
    target_high: float = 0.75
    queue_high: float = 0.0
    cooldown_windows: int = 1
    min_counts: Tuple[Tuple[str, int], ...] = ()
    max_counts: Tuple[Tuple[str, int], ...] = ()
    machine_budget: Optional[int] = None
    spike_factor: float = 1.5
    spike_fraction: float = 0.25

    def __post_init__(self) -> None:
        if not 0.0 < self.target_low < self.target_high <= 1.0:
            raise ValueError(
                f"AutoscalePolicy needs 0 < target_low < target_high <= 1: "
                f"got ({self.target_low}, {self.target_high})")
        if self.queue_high < 0.0:
            raise ValueError(
                f"AutoscalePolicy.queue_high must be non-negative: "
                f"{self.queue_high}")
        if self.cooldown_windows < 0:
            raise ValueError(
                f"AutoscalePolicy.cooldown_windows must be >= 0: "
                f"{self.cooldown_windows}")
        for label, pairs in (("min_counts", self.min_counts),
                             ("max_counts", self.max_counts)):
            norm = tuple((str(s), int(c)) for s, c in pairs)
            if any(c < 1 for _, c in norm):
                raise ValueError(
                    f"AutoscalePolicy.{label} entries must be >= 1: {norm}")
            if len(set(s for s, _ in norm)) != len(norm):
                raise ValueError(
                    f"AutoscalePolicy.{label} stations must be unique: "
                    f"{norm}")
            object.__setattr__(self, label, norm)
        for s, lo in self.min_counts:
            hi = self.max_for(s)
            if hi is not None and lo > hi:
                raise ValueError(
                    f"AutoscalePolicy: min_counts[{s!r}]={lo} exceeds "
                    f"max_counts[{s!r}]={hi}")
        if self.machine_budget is not None and self.machine_budget < 1:
            raise ValueError(
                f"AutoscalePolicy.machine_budget must be >= 1 or None: "
                f"{self.machine_budget}")
        if self.spike_factor < 1.0:
            raise ValueError(
                f"AutoscalePolicy.spike_factor must be >= 1 (a resize "
                f"never makes the window cheaper): {self.spike_factor}")
        if not 0.0 <= self.spike_fraction <= 1.0:
            raise ValueError(
                f"AutoscalePolicy.spike_fraction must be in [0, 1]: "
                f"{self.spike_fraction}")

    def min_for(self, station: str) -> int:
        """The policy's floor for ``station`` (1 when unpinned)."""
        for s, c in self.min_counts:
            if s == station:
                return c
        return 1

    def max_for(self, station: str) -> Optional[int]:
        """The policy's ceiling for ``station`` (None = unbounded)."""
        for s, c in self.max_counts:
            if s == station:
                return c
        return None

    def describe(self) -> str:
        bits = [f"band [{self.target_low:g}, {self.target_high:g}]",
                f"cooldown {self.cooldown_windows}w"]
        if self.queue_high > 0.0:
            bits.append(f"queue>{self.queue_high:g}")
        if self.machine_budget is not None:
            bits.append(f"budget {self.machine_budget}")
        return ", ".join(bits)


# ---------------------------------------------------------------------------
# Knobs + VariantSpec + ExecutableSpec: a protocol variant as a declaration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExecutableSpec:
    """The *execution plane* of a variant: how to build and account for the
    real (deterministic, message-level) cluster behind the demand table.

    A variant with an executable is evaluated on **two planes from one
    registration**: the analytical plane (its ``factory`` demand table,
    swept/batched by ``repro.core.sweep``) and the execution plane (a real
    protocol cluster driven by ``repro.core.execution.run_variant``, whose
    measured per-station messages per command are parity-checked against
    the table by ``validate_variant``).

    * ``deployment(**config, n_clients=..., seed=...)`` builds the cluster
      (a ``repro.core.protocols.BaseDeployment``) from the **same
      canonical config dict** the analytical factory consumes (model-only
      knobs such as ``payload_factor`` are accepted and ignored);
    * ``station_of(addr, deployment) -> station | None`` buckets a node
      address into the canonical station vocabulary (``None`` = not a
      station, e.g. clients).  Default: the ``role/<i>`` address prefix
      when it names a declared station;
    * ``model_feedback(model_config, trace) -> model_config`` optionally
      feeds *measured* run statistics back into the demand table before
      the parity comparison (Mencius: the observed noop-skip rate and the
      per-command frontier announcements; CRAQ: the observed dirty-read
      forwarding fraction) so the comparison is apples-to-apples;
    * ``rel_tolerance`` / ``station_tolerances`` bound the allowed
      relative error per station (data, not code - the parity loop stays
      generic); ``exact_stations`` must match to 1e-9 (S-Paxos' leader:
      exactly 2 id-only msgs/cmd);
    * ``reads_as_writes`` - the protocol has no separate read path (the
      paper's vanilla baselines: reads go through the log like writes),
      so the harness drives reads as writes to match the table;
    * ``latency_tolerance`` bounds the relative error of the measured
      per-region mean latency vs the ``repro.core.geo`` critical-path
      prediction when ``validate_variant`` runs under a :class:`GeoSpec`
      (queueing and slot-ordering waits sit on top of the WAN path, so
      these are looser than the msgs/cmd tolerances);
    * ``n_clients`` is the default closed-loop client population.
    """

    deployment: Callable[..., Any]
    station_of: Optional[Callable[[str, Any], Optional[str]]] = None
    model_feedback: Optional[Callable[[Config, Any], Config]] = None
    rel_tolerance: float = 0.15
    station_tolerances: Tuple[Tuple[str, float], ...] = ()
    exact_stations: Tuple[str, ...] = ()
    reads_as_writes: bool = False
    latency_tolerance: float = 0.35
    n_clients: int = 3
    description: str = ""

    def tolerance_for(self, station: str) -> float:
        for name, tol in self.station_tolerances:
            if name == station:
                return tol
        return self.rel_tolerance


@dataclass(frozen=True)
class Knob:
    """One axis of a variant's knob space.

    ``name`` is the public sweep-axis name (a ``SweepSpec`` field for the
    built-ins, a ``knob_values`` key for runtime variants); ``keys`` are
    the config-dict entries one value sets.  A coupled knob has several
    keys and tuple values - e.g. the acceptor grid: ``name="grids"``,
    ``keys=("grid_rows", "grid_cols")``, values like ``(2, 2)``."""

    name: str
    keys: Tuple[str, ...]
    values: Tuple[Any, ...]

    def __post_init__(self) -> None:
        if not self.keys:
            raise ValueError(f"knob {self.name!r} has no config keys")
        if self.name in _RESERVED_KNOB_NAMES:
            raise ValueError(f"knob name {self.name!r} is reserved")

    def entries(self, value: Any) -> Iterator[Tuple[str, Any]]:
        """(config key, value) pairs one knob value expands to."""
        if len(self.keys) == 1:
            yield self.keys[0], value
            return
        vt = tuple(value)
        if len(vt) != len(self.keys):
            raise ValueError(
                f"knob {self.name!r} couples {len(self.keys)} keys "
                f"{self.keys} but got value {value!r}")
        yield from zip(self.keys, vt)


def knob(name: str, values: Sequence[Any],
         keys: Optional[Sequence[str]] = None) -> Knob:
    """Convenience :class:`Knob` builder (``keys`` defaults to ``name``)."""
    return Knob(name=name, keys=tuple(keys) if keys is not None else (name,),
                values=tuple(values))


@dataclass(frozen=True)
class VariantSpec:
    """A protocol variant, declaratively.

    * ``factory(**config)`` builds the variant's ``DeploymentModel``
      (the demand table);
    * ``stations`` are the canonical slot names the table emits -
      registration allocates any new name an append-ordered column in
      :data:`STATION_ORDER`;
    * ``knobs`` is the default sweep space (``SweepSpec`` fields and
      ``knob_values`` override per-knob);
    * ``takes_f`` - configs carry the fault-tolerance parameter ``f``;
    * ``implicit_variant_key`` - configs omit the ``variant`` key (the
      default ``compartmentalized`` variant, for backward compatibility
      with pre-registry config dicts);
    * ``workload_adapter(config, workload) -> config`` - optional hook
      reshaping the config under a :class:`Workload` (skew, batch fill).
      Consulted only when ``workload.adapts_demands``; must return the
      input dict *itself* (identity, not a copy) when it has nothing to
      do - callers use that to skip rebuilding the row's model;
    * ``candidate_knobs(budget, f) -> {knob name: values}`` - optional
      knob-space generator for the budgeted cross-variant autotuner
      (``autotune_variants``); variants without one contribute their
      default knob product (a single config for knobless baselines);
    * ``executable`` - the optional :class:`ExecutableSpec` execution
      plane: declare it (here or later via :func:`register_executable`)
      and the variant's real cluster runs, linearizability-checks and
      parity-checks through ``repro.core.execution`` with zero core-file
      edits.
    """

    name: str
    factory: Callable[..., Any]
    stations: Tuple[str, ...]
    knobs: Tuple[Knob, ...] = ()
    takes_f: bool = True
    implicit_variant_key: bool = False
    workload_adapter: Optional[Callable[[Config, "Workload"], Config]] = None
    candidate_knobs: Optional[
        Callable[[int, int], Mapping[str, Sequence[Any]]]] = None
    executable: Optional[ExecutableSpec] = None
    description: str = ""

    def __post_init__(self) -> None:
        if not self.name or not self.name.replace("_", "a").isalnum():
            raise ValueError(f"variant name must be a [a-z0-9_] identifier: "
                             f"{self.name!r}")
        if not self.stations:
            raise ValueError(f"variant {self.name!r} declares no stations")
        names = [k.name for k in self.knobs]
        if len(set(names)) != len(names):
            raise ValueError(f"variant {self.name!r} has duplicate knob "
                             f"names: {names}")
        keys = [key for k in self.knobs for key in k.keys]
        if len(set(keys)) != len(keys):
            raise ValueError(f"variant {self.name!r} has overlapping knob "
                             f"config keys: {keys}")

    def knob_names(self) -> Tuple[str, ...]:
        return tuple(k.name for k in self.knobs)

    def _values_for(self, k: Knob,
                    overrides: Mapping[str, Sequence[Any]]) -> Tuple[Any, ...]:
        values = tuple(overrides.get(k.name, k.values))
        if not values:
            raise ValueError(
                f"variant {self.name!r}: knob {k.name!r} has no values")
        return values

    def configs(self, f: int = 1,
                overrides: Mapping[str, Sequence[Any]] = {},
                ) -> Iterator[Config]:
        """The variant's knob product as config dicts.

        ``overrides`` replaces any declared knob's value iterable by
        name; unknown override names are rejected (a typo'd knob name
        silently sweeping nothing is the failure mode this API exists to
        kill)."""
        unknown = set(overrides) - set(self.knob_names())
        if unknown:
            raise ValueError(
                f"variant {self.name!r} has no knob(s) {sorted(unknown)}; "
                f"declared: {list(self.knob_names())}")
        spaces = [
            [tuple(k.entries(v)) for v in self._values_for(k, overrides)]
            for k in self.knobs
        ]
        for combo in itertools.product(*spaces):
            cfg: Config = {}
            if not self.implicit_variant_key:
                cfg["variant"] = self.name
            if self.takes_f:
                cfg["f"] = f
            for entries in combo:
                cfg.update(entries)
            yield cfg

    def size(self, overrides: Mapping[str, Sequence[Any]] = {}) -> int:
        """Cardinality of :meth:`configs` - computed arithmetically from
        the knob-space cardinalities, never by enumeration."""
        n = 1
        for k in self.knobs:
            n *= len(self._values_for(k, overrides))
        return n

    def adapt(self, config: Config,
              workload: Optional["Workload"]) -> Config:
        """The config with the ``variant`` key stripped and, when the
        workload carries demand-shaping hints, the ``workload_adapter``
        applied.  Returns the *same* dict object the adapter received
        when the adapter had nothing to do (callers key off identity to
        skip model rebuilds)."""
        cfg = {k: v for k, v in config.items() if k != "variant"}
        if (workload is not None and workload.adapts_demands
                and self.workload_adapter is not None):
            return self.workload_adapter(cfg, workload)
        return cfg

    def build(self, config: Config) -> Any:
        """``factory(**config)`` plus a station check: every station the
        model emits must be declared in ``stations`` (i.e. have a
        registered column), otherwise batched lowering would die with a
        bare ``KeyError`` deep in ``demand_slots``."""
        model = self.factory(**config)
        undeclared = [s.name for s in getattr(model, "stations", ())
                      if s.name not in _STATION_SLOTS]
        if undeclared:
            raise ValueError(
                f"variant {self.name!r} built a model emitting "
                f"station(s) {undeclared} that have no registered column "
                f"- list every station name the factory can emit in "
                f"register_variant(stations=...)")
        return model

    def model(self, config: Config,
              workload: Optional["Workload"] = None) -> Any:
        """Build the deployment model for one config, optionally adapted
        to a workload (skew / batch-fill hints)."""
        return self.build(self.adapt(config, workload))


# ---------------------------------------------------------------------------
# The registry + the derived canonical station vocabulary
# ---------------------------------------------------------------------------

_REGISTRY: "Dict[str, VariantSpec]" = {}
_STATIONS: List[str] = []
_STATION_SLOTS: Dict[str, int] = {}


def _allocate_stations(names: Sequence[str]) -> None:
    for n in names:
        if n not in _STATION_SLOTS:
            _STATION_SLOTS[n] = len(_STATIONS)
            _STATIONS.append(n)


def register_variant(spec: Optional[VariantSpec] = None, *,
                     override: bool = False,
                     **kwargs: Any) -> Union[VariantSpec, Callable]:
    """Install a :class:`VariantSpec` in the registry.

    Three call shapes::

        register_variant(VariantSpec(...))            # direct
        register_variant(name=..., factory=..., ...)  # kwargs
        @register_variant(name=..., stations=..., ...)  # decorator on the
        def my_model(...): ...                          # model factory

    Station slots are allocated append-ordered and never reclaimed
    (compiled sweeps address stations by column index), so registration
    order is load-bearing only for *new* station names.  Re-registering
    an existing name requires ``override=True``."""
    if spec is None and "factory" not in kwargs:
        def _decorate(factory: Callable[..., Any]) -> Callable[..., Any]:
            register_variant(VariantSpec(factory=factory, **kwargs),
                             override=override)
            return factory
        return _decorate
    if spec is None:
        spec = VariantSpec(**kwargs)
    elif kwargs:
        raise TypeError("pass either a VariantSpec or keyword fields, "
                        "not both")
    if not isinstance(spec, VariantSpec):
        raise TypeError(f"expected a VariantSpec, got {type(spec).__name__}")
    if spec.name in _REGISTRY and not override:
        raise ValueError(
            f"variant {spec.name!r} is already registered; pass "
            f"override=True to replace it")
    _allocate_stations(spec.stations)
    _REGISTRY[spec.name] = spec
    return spec


def unregister_variant(name: str) -> None:
    """Remove a variant from the registry (tests / plugin teardown).

    Its station slots stay allocated - the vocabulary is append-only
    because compiled demand tensors address columns by index."""
    if name not in _REGISTRY:
        raise ValueError(f"variant {name!r} is not registered")
    del _REGISTRY[name]


def register_executable(name: str,
                        executable: Optional[ExecutableSpec] = None,
                        *, override: bool = False,
                        **kwargs: Any) -> ExecutableSpec:
    """Attach an execution plane to an already-registered variant.

    Either pass an :class:`ExecutableSpec` or its keyword fields.  The
    variant's :class:`VariantSpec` is replaced in the registry with one
    carrying the executable; station slots are untouched.  Replacing an
    existing executable requires ``override=True``."""
    spec = variant_spec(name)
    if executable is None:
        executable = ExecutableSpec(**kwargs)
    elif kwargs:
        raise TypeError("pass either an ExecutableSpec or keyword fields, "
                        "not both")
    if not isinstance(executable, ExecutableSpec):
        raise TypeError(
            f"expected an ExecutableSpec, got {type(executable).__name__}")
    if spec.executable is not None and not override:
        raise ValueError(
            f"variant {name!r} already declares an executable; pass "
            f"override=True to replace it")
    _REGISTRY[name] = replace(spec, executable=executable)
    return executable


def variant_spec(name: str) -> VariantSpec:
    """Look up a registered variant (ValueError names the known set)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown variant {name!r}; choose from "
                         f"{sorted(_REGISTRY)}") from None


def registered_variants() -> Tuple[str, ...]:
    """Registered variant names, in registration order."""
    return tuple(_REGISTRY)


def executable_variants() -> Tuple[str, ...]:
    """Names of variants that declare an execution plane, in registration
    order - the domain of ``repro.core.execution.run_variant`` /
    ``validate_variant`` and of the ``msgcount`` parity benchmark's
    zero-branch loop."""
    return tuple(n for n, s in _REGISTRY.items() if s.executable is not None)


@contextlib.contextmanager
def temporary_variants() -> Iterator[None]:
    """Scope runtime registrations: on exit the registry is restored to
    its entry snapshot, so a test's ``register_variant`` /
    ``register_executable`` calls cannot leak into other tests' registry
    views.  Station slots allocated inside the scope stay allocated - the
    station vocabulary is append-only because compiled demand tensors
    address columns by index (re-registering the same variant later
    reuses its columns)."""
    snapshot = dict(_REGISTRY)
    try:
        yield
    finally:
        _REGISTRY.clear()
        _REGISTRY.update(snapshot)


class _StationOrder(abc.Sequence):
    """Live, registry-derived view of the canonical station vocabulary.

    Behaves like the tuple it replaced (indexing, ``len``, iteration,
    ``.index``, containment) but grows append-ordered as variants with
    new station names register.  Existing column indices never change."""

    def __getitem__(self, i):  # supports slices like a tuple
        return tuple(_STATIONS)[i] if isinstance(i, slice) else _STATIONS[i]

    def __len__(self) -> int:
        return len(_STATIONS)

    def __contains__(self, name: object) -> bool:
        return name in _STATION_SLOTS

    def index(self, name: str, *args: Any) -> int:
        if args:  # honor tuple.index's start/stop bounds
            return tuple(_STATIONS).index(name, *args)
        try:
            return _STATION_SLOTS[name]
        except KeyError:
            raise ValueError(f"{name!r} is not a registered station") from None

    def __eq__(self, other: object) -> bool:
        return tuple(_STATIONS) == other

    def __hash__(self):  # keep usable as a dict key like the old tuple
        return hash(tuple(_STATIONS))

    def __repr__(self) -> str:
        return f"StationOrder{tuple(_STATIONS)!r}"


class _StationIndex(abc.Mapping):
    """Live ``station name -> column`` mapping (see :class:`_StationOrder`)."""

    def __getitem__(self, name: str) -> int:
        return _STATION_SLOTS[name]

    def __iter__(self) -> Iterator[str]:
        return iter(_STATIONS)

    def __len__(self) -> int:
        return len(_STATIONS)

    def __repr__(self) -> str:
        return f"StationIndex({dict(_STATION_SLOTS)!r})"


class _VariantModels(abc.Mapping):
    """Live ``variant name -> model factory`` view of the registry (the
    pre-registry ``VARIANT_MODELS`` dict, kept as a compatibility
    surface)."""

    def __getitem__(self, name: str) -> Callable[..., Any]:
        return _REGISTRY[name].factory

    def __iter__(self) -> Iterator[str]:
        return iter(_REGISTRY)

    def __len__(self) -> int:
        return len(_REGISTRY)

    def __repr__(self) -> str:
        return (f"VariantModels({{" +
                ", ".join(f"{n!r}: {s.factory.__name__}"
                          for n, s in _REGISTRY.items()) + "})")


#: Canonical station vocabulary - one fixed, append-ordered column per
#: station name any registered variant emits.  Derived from the registry;
#: import the *object* (it is live), never snapshot it at import time if
#: runtime variant registration matters to you.
STATION_ORDER = _StationOrder()

#: Live ``station name -> column index`` mapping over :data:`STATION_ORDER`.
STATION_INDEX = _StationIndex()

#: Live ``variant name -> factory`` mapping (compatibility view of the
#: registry; prefer :func:`variant_spec` for the full declaration).
VARIANT_MODELS = _VariantModels()

"""Vectorized compartmentalization sweeps.

The paper's evaluation is not one deployment but a *surface*: throughput as
a function of every compartmentalization knob (proxy leaders, acceptor grid
shape, replicas, batchers, batch size) - and, since the paper's sections 6-7
argue compartmentalization is "a technique, not a protocol", of the
**protocol variant** itself - under every workload.  This module lowers
a grid of configurations into dense demand tensors once
(:func:`compile_sweep`) and then answers whole-surface questions with
vectorized numpy (bottleneck law), one batched device loop (full MVA /
fluid curves), or one batched execution of closed-loop client populations
(``.execute``) instead of a Python loop over ``DeploymentModel`` objects.

Pipeline:

    SweepSpec  --configs()-->  knob dicts (one ``variant`` axis value each)
               --compile_sweep-->  CompiledSweep (demand_write/read [M, K])
               --.peak_throughput/.bottlenecks-->  bottleneck-law surface
               --.mva/.fluid-->  one device loop, X[M, N] curves
               --.execute-->  one batched device execution, measured surface

The variant axis is the **registry** (:mod:`repro_torch.core.api`): every
registered :class:`~repro_torch.core.api.VariantSpec` declares its knob space,
so :meth:`SweepSpec.configs`, :func:`model_for` and the autotuner's
candidate generators are generic loops with zero per-variant branches -
a variant registered at runtime sweeps here with no edits to this file.
``K = len(STATION_ORDER)`` is the canonical (registry-derived) station
vocabulary; a config's missing components occupy zero-demand slots, which
are exactly inert under both MVA and the fluid model, so heterogeneous
deployments - MultiPaxos next to Mencius next to S-Paxos next to CRAQ -
batch together losslessly and one batched call evaluates the whole
mixed-variant grid.  Methods that run on a device take ``device=None``,
which means ``cuda``; without a card they raise unless given
``device="cpu"``.

Evaluation methods take a :class:`~repro_torch.core.api.Workload` - write
fraction, per-key skew, arrival pattern, batch-fill hints, passed once -
with the legacy ``f_write=`` scalar kwarg kept behind a
``DeprecationWarning`` shim.

"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .analytical import (
    STATION_ORDER,
    DeploymentModel,
    stack_demands,
)
from .api import (
    Config,
    ShardingSpec,
    Workload,
    resolve_workload,
    variant_spec,
)
from .sharding import flatten_shards, shard_demands
from .simulator import fluid_throughput_from_demands, mva_curves_from_demands

#: SweepSpec fields that are knob value iterables for the built-in
#: variants (knob name == field name); everything else is sweep plumbing.
_LEGACY_KNOB_FIELDS = (
    "n_proxy_leaders", "grids", "n_replicas", "batch_sizes", "n_batchers",
    "n_unbatchers", "n_leaders", "n_disseminators", "n_stabilizers",
    "chain_nodes",
)


@dataclass(frozen=True)
class SweepSpec:
    """A cartesian grid over the compartmentalization knobs, swept per
    protocol ``variant``.

    ``variants`` is the protocol axis: any name in the variant registry
    (:func:`repro_torch.core.api.registered_variants`), including variants
    registered at runtime.  Each variant consumes exactly the knobs its
    :class:`~repro_torch.core.api.VariantSpec` declares; per-knob values come
    from (highest priority first):

    1. ``knob_values`` - generic ``((knob name, values), ...)`` overrides,
       the only way to sweep knobs of runtime-registered variants;
    2. the named legacy field below, when the knob name matches one
       (``grids`` entries are ``(rows, cols)`` - write quorums are
       columns with ``rows`` members, read quorums rows with ``cols``);
    3. the variant's declared knob defaults.

    For backward compatibility, configs of the default
    ``compartmentalized`` variant omit the ``variant`` key
    (:func:`model_for` defaults it).
    """

    f: int = 1
    variants: Tuple[str, ...] = ("compartmentalized",)
    n_proxy_leaders: Tuple[int, ...] = (10,)
    grids: Tuple[Tuple[int, int], ...] = ((2, 2),)
    n_replicas: Tuple[int, ...] = (4,)
    batch_sizes: Tuple[int, ...] = (1,)
    n_batchers: Tuple[int, ...] = (0,)
    n_unbatchers: Tuple[int, ...] = (0,)
    n_leaders: Tuple[int, ...] = (3,)          # mencius
    n_disseminators: Tuple[int, ...] = (2,)    # spaxos
    n_stabilizers: Tuple[int, ...] = (3,)      # spaxos
    chain_nodes: Tuple[int, ...] = (3,)        # craq
    knob_values: Tuple[Tuple[str, Tuple[Any, ...]], ...] = ()

    def knob_space(self, variant: str) -> Dict[str, Tuple[Any, ...]]:
        """The per-knob value overrides this spec supplies for one
        variant (only knobs the variant declares; see class docstring
        for precedence)."""
        spec = variant_spec(variant)
        generic = {name: tuple(values) for name, values in self.knob_values}
        space: Dict[str, Tuple[Any, ...]] = {}
        for name in spec.knob_names():
            if name in generic:
                space[name] = generic[name]
            elif name in _LEGACY_KNOB_FIELDS:
                space[name] = tuple(getattr(self, name))
        return space

    def size(self) -> int:
        """Number of configs - computed arithmetically from the knob-space
        cardinalities (O(#variants)), never by enumerating the product."""
        return sum(variant_spec(v).size(self.knob_space(v))
                   for v in self.variants)

    def configs(self) -> Iterator[Config]:
        """One generic loop over the registry: each variant's declared
        knob space crossed into config dicts (zero per-variant branches)."""
        for variant in self.variants:
            spec = variant_spec(variant)  # raises on unknown variants
            yield from spec.configs(f=self.f,
                                    overrides=self.knob_space(variant))


def model_for(config: Config,
              workload: Optional[Workload] = None) -> DeploymentModel:
    """The per-config ``DeploymentModel`` a compiled sweep row corresponds
    to (the scalar reference path the batched path is tested against).
    Dispatches on ``config["variant"]`` through the variant registry; a
    config without the key is a compartmentalized-MultiPaxos knob dict
    (the pre-variant format the autotuner's greedy moves still emit).
    With a ``workload``, the variant's ``workload_adapter`` (if any) may
    reshape the config first (skew, batch-fill hints)."""
    variant = config.get("variant", "compartmentalized")
    return variant_spec(variant).model(config, workload)


def config_variant(config: Config) -> str:
    """The variant a sweep config belongs to (display/grouping helper)."""
    return str(config.get("variant", "compartmentalized"))


@dataclass(frozen=True)
class GeoLatencySurface:
    """A (config x region) latency surface from ONE batched MVA call.

    ``wan[m, r]`` is the *extra* critical-path wire time the WAN matrix
    adds for config ``m`` seen from region ``r`` on top of the
    uniform-delay baseline (workload-blended, :func:`repro_torch.core.geo.
    wan_offsets` - exactly zero for a uniform matrix, so the surface then
    reads identically to the plain MVA percentiles); ``queueing[m]`` the
    closed-loop MVA residence time at the evaluated client population.
    Assuming exponential queueing on top of a deterministic WAN offset,
    the percentiles are ``p50 = wan + ln(2) * queueing`` and ``p99 = wan
    + ln(100) * queueing``.  The RTT matrix must be expressed in the same
    time unit as ``1 / alpha`` for the sum to be meaningful.
    """

    regions: Tuple[str, ...]
    weights: np.ndarray    # [R] resolved client weights (rows sum to 1)
    wan: np.ndarray        # [M, R]
    queueing: np.ndarray   # [M]
    mean: np.ndarray       # [M, R]
    p50: np.ndarray        # [M, R]
    p99: np.ndarray        # [M, R]

    def worst_p99(self) -> np.ndarray:
        """[M] max p99 over client-bearing regions (fairness objective:
        the latency the worst-placed client population experiences)."""
        mask = self.weights > 0
        return self.p99[:, mask].max(axis=1)

    def blended_p99(self) -> np.ndarray:
        """[M] client-weighted mean p99 across regions."""
        return self.p99 @ self.weights


@dataclass(frozen=True)
class CompiledSweep:
    """A grid of deployments lowered to dense demand tensors.

    ``demand_write``/``demand_read`` are [M, K] per-server service demands
    in canonical :data:`STATION_ORDER` slots; ``machines`` is [M] total
    servers.  All evaluation methods are vectorized over the M axis and
    take a :class:`~repro_torch.core.api.Workload` (legacy ``f_write=`` kwarg
    shimmed with a ``DeprecationWarning``).
    """

    models: Tuple[DeploymentModel, ...]
    demand_write: np.ndarray
    demand_read: np.ndarray
    machines: np.ndarray
    configs: Optional[Tuple[Config, ...]] = None

    def __len__(self) -> int:
        return len(self.models)

    def demands(self, workload: Optional[Union[Workload, float]] = None,
                f_write: Optional[float] = None,
                sharding: Optional[ShardingSpec] = None) -> np.ndarray:
        """Effective [M, K] demand matrix under a workload.

        The write/read blend is a vectorized re-weighting of the
        precompiled tensors.  When the workload carries demand-*shaping*
        hints (skew, partial batch fill) and this sweep carries configs,
        rows of variants that declare a ``workload_adapter`` are
        recomputed through it (CRAQ rows pick up dirty-read forwarding,
        batched rows lose amortization).

        With a :class:`~repro_torch.core.api.ShardingSpec` the tensor gains a
        shard axis - [M, S, K] with row ``[m, s]`` the per-command table
        scaled by shard *s*'s traffic fraction (visit-ratio lowering;
        shard weights derive from the workload's skew).  Note the
        shard-local hot key is what the *sharding* weights model; the
        per-row variant adapters still see the same workload."""
        w = resolve_workload(workload, f_write, where="CompiledSweep.demands")
        if sharding is not None:
            base = self.demands(w)
            return shard_demands(base, sharding, w)
        out = (w.f_write * self.demand_write
               + (1.0 - w.f_write) * self.demand_read)
        if not (w.adapts_demands and self.configs is not None):
            return out
        k = out.shape[1]
        for i, cfg in enumerate(self.configs):
            spec = variant_spec(config_variant(cfg))
            if spec.workload_adapter is None:
                continue
            stripped = {key: v for key, v in cfg.items() if key != "variant"}
            adapted = spec.workload_adapter(stripped, w)
            if adapted is stripped:
                continue  # adapter no-op: the precompiled row stands
            model = spec.build(adapted)
            d_w, d_r, _ = model.demand_slots()
            row = (w.f_write * np.asarray(d_w[:k])
                   + (1.0 - w.f_write) * np.asarray(d_r[:k]))
            if len(d_w) > k and (any(d_w[k:]) or any(d_r[k:])):
                raise ValueError(
                    f"config {i} ({model.name}) emits stations beyond this "
                    f"compiled sweep's {k} columns - recompile the sweep")
            out[i] = row
        return out

    def peak_throughput(self, alpha: float,
                        workload: Optional[Union[Workload, float]] = None,
                        f_write: Optional[float] = None,
                        sharding: Optional[ShardingSpec] = None) -> np.ndarray:
        """Bottleneck-law peak throughput, [M] cmds/s.

        Sharded, the law becomes ``min_s alpha / (w_s * max_k d[m, k])``
        (every shard must keep up with its traffic share) - the max over
        the flattened (shard, station) columns computes exactly that, so
        uniform weights scale peak by ``n_shards``."""
        d = self.demands(workload, f_write, sharding)
        d_max = d.reshape(d.shape[0], -1).max(axis=1)
        with np.errstate(divide="ignore"):
            return np.where(d_max > 0, alpha / np.maximum(d_max, 1e-300),
                            np.inf)

    def bottleneck_indices(self,
                           workload: Optional[Union[Workload, float]] = None,
                           f_write: Optional[float] = None,
                           sharding: Optional[ShardingSpec] = None,
                           ) -> np.ndarray:
        d = self.demands(workload, f_write, sharding)
        return d.reshape(d.shape[0], -1).argmax(axis=1)

    def bottlenecks(self, workload: Optional[Union[Workload, float]] = None,
                    f_write: Optional[float] = None,
                    sharding: Optional[ShardingSpec] = None) -> List[str]:
        """Name of the saturating station per config, [M] (sharded:
        ``s<shard>/<station>``)."""
        idx = self.bottleneck_indices(workload, f_write, sharding)
        if sharding is None:
            return [STATION_ORDER[i] for i in idx]
        k = self.demand_write.shape[1]
        return [f"s{i // k}/{STATION_ORDER[i % k]}" for i in idx]

    def mva(self, alpha: float, n_clients_max: int = 512,
            workload: Optional[Union[Workload, float]] = None,
            f_write: Optional[float] = None,
            sharding: Optional[ShardingSpec] = None,
            device=None,
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full closed-loop latency-throughput surface in ONE batched
        device loop.

        Returns (clients[N], X[M, N] cmds/s, R[M, N] seconds).  Sharded
        rows flatten the [M, S, K] tensor to [M, S*K] first: the same
        batched MVA then solves every shard's station loads jointly
        (each column's demand is already visit-ratio-scaled)."""
        d = self.demands(workload, f_write, sharding)
        if sharding is not None:
            d = flatten_shards(d)
        return mva_curves_from_demands(d / alpha, n_clients_max,
                                       device=device)

    def geo_latency(self, alpha: float, geo: Any,
                    workload: Optional[Union[Workload, float]] = None,
                    f_write: Optional[float] = None,
                    n_clients: int = 64, device=None) -> GeoLatencySurface:
        """Per-region latency surface for the whole grid in ONE batched
        MVA call.

        Composes the per-config WAN latency excess (:func:`repro_torch.
        core.geo.wan_offsets`, O(M) Python, no device work) with the
        batched MVA queueing solve (one device loop over all M configs) to
        a (config x region) :class:`GeoLatencySurface`.  ``geo`` is a
        :class:`~repro_torch.core.api.GeoSpec`; its placement decides which
        region each station sits in and its client weights decide the
        per-region blend.  Batched configs have no WAN lowering and raise
        ``ValueError``."""
        from .geo import wan_offsets
        if self.configs is None:
            raise ValueError(
                "CompiledSweep.geo_latency needs per-row configs; compile "
                "with compile_sweep(spec) rather than compile_models(models)")
        w = resolve_workload(workload, f_write,
                             where="CompiledSweep.geo_latency")
        _, _, resid = self.mva(alpha, n_clients_max=n_clients, workload=w,
                               device=device)
        queueing = np.asarray(resid[:, -1], dtype=float)
        regions = tuple(geo.regions)
        weights = np.asarray(geo.resolved_client_weights(), dtype=float)
        wan = np.empty((len(self), len(regions)), dtype=float)
        for i, cfg in enumerate(self.configs):
            wan[i] = wan_offsets(cfg, geo, workload=w, n_clients=n_clients)
        mean = wan + queueing[:, None]
        p50 = wan + float(np.log(2.0)) * queueing[:, None]
        p99 = wan + float(np.log(100.0)) * queueing[:, None]
        return GeoLatencySurface(regions=regions, weights=weights, wan=wan,
                                 queueing=queueing, mean=mean, p50=p50,
                                 p99=p99)

    def fluid(self, alpha: float, n_clients: int,
              workload: Optional[Union[Workload, float]] = None,
              f_write: Optional[float] = None,
              sharding: Optional[ShardingSpec] = None,
              sim_time: float = 1.0, n_steps: int = 2000,
              device=None) -> np.ndarray:
        """Batched fluid cross-check, [M] cmds/s in one device loop."""
        d = self.demands(workload, f_write, sharding)
        if sharding is not None:
            d = flatten_shards(d)
        return fluid_throughput_from_demands(
            d / alpha, n_clients, sim_time, n_steps, device=device)

    def execute(self, workload: Optional[Union[Workload, float]] = None,
                n_commands: int = 48, seeds: Union[int, Sequence[int]] = 4,
                sharding: Optional[ShardingSpec] = None,
                **kwargs):
        """*Measure* every config in the sweep: probe-calibrate each
        variant's execution plane off the real cluster, then run the whole
        (config x seed) grid of closed-loop client populations in ONE
        batched device execution (:func:`repro_torch.core.
        batched_execution.execute_configs`; ``device`` and every other
        keyword pass through to it).  The plane next to :meth:`mva`
        (steady state): same grid, same one-call shape, but the
        per-station msgs/cmd surface is measured, not modelled.  Requires
        a config-bearing sweep (``compile_sweep``) whose variants all
        register executables.  With a ``sharding``
        every config becomes ``n_shards`` independent lanes sharing one
        probe, command budgets split by shard weight."""
        if self.configs is None:
            raise ValueError(
                "CompiledSweep.execute needs per-row configs; compile with "
                "compile_sweep(spec) rather than compile_models(models)")
        from .batched_execution import execute_configs
        return execute_configs(self.configs, workload=workload,
                               n_commands=n_commands, seeds=seeds,
                               sharding=sharding, **kwargs)

    def subset(self, indices: Sequence[int]) -> "CompiledSweep":
        """Row-select a sweep (e.g. a shortlist for the expensive
        transient objective); carries configs when present."""
        idx = list(int(i) for i in indices)
        return CompiledSweep(
            models=tuple(self.models[i] for i in idx),
            demand_write=self.demand_write[idx],
            demand_read=self.demand_read[idx],
            machines=self.machines[idx],
            configs=(tuple(self.configs[i] for i in idx)
                     if self.configs is not None else None))

    def top_k(self, alpha: float, k: int = 5,
              workload: Optional[Union[Workload, float]] = None,
              f_write: Optional[float] = None,
              budget: Optional[int] = None,
              sharding: Optional[ShardingSpec] = None,
              ) -> List[Tuple[int, float, str]]:
        """Best configs by bottleneck-law peak: [(index, peak, bottleneck)].

        Ties in peak break toward fewer machines; ``budget`` masks out
        deployments using more than that many servers (sharded: more than
        ``budget / n_shards`` per group - every shard runs a copy)."""
        w = resolve_workload(workload, f_write, where="CompiledSweep.top_k")
        peaks = self.peak_throughput(alpha, w, sharding=sharding)
        machines = self.machines * (sharding.n_shards if sharding else 1)
        if budget is not None:
            peaks = np.where(machines <= budget, peaks, -np.inf)
        order = np.lexsort((machines, -peaks))
        names = self.bottlenecks(w, sharding=sharding)
        return [(int(i), float(peaks[i]), names[i])
                for i in order[:k] if np.isfinite(peaks[i]) and peaks[i] > 0]


def compile_models(models: Sequence[DeploymentModel],
                   configs: Optional[Sequence[Config]] = None) -> CompiledSweep:
    """Lower an explicit list of deployments (e.g. the Fig. 29 ablation
    steps, or hand-built models) into a batched sweep."""
    d_w, d_r, machines = stack_demands(models)
    return CompiledSweep(models=tuple(models), demand_write=d_w,
                         demand_read=d_r, machines=machines,
                         configs=tuple(configs) if configs is not None else None)


def compile_sweep(spec: SweepSpec) -> CompiledSweep:
    """Compile a knob grid into demand tensors (the config -> demand-matrix
    compiler).  O(size) Python work happens once, here; everything after is
    vectorized."""
    configs = list(spec.configs())
    models = [model_for(c) for c in configs]
    compiled = compile_models(models, configs)
    return compiled

"""Budget-constrained deployment search ("How should a system be
compartmentalized?", paper section 9).

Given a machine budget M, a workload mix ``f_write`` and the calibrated
per-node rate ``alpha``, :func:`autotune` answers the question the paper's
authors answered by hand: *which* deployment - how many proxy leaders, what
acceptor grid, how many replicas, batchers, unbatchers - maximizes peak
throughput?  Two complementary engines:

* **Exhaustive**: enumerate the discrete config space under the budget via
  :mod:`repro_torch.core.sweep` (one compiled batch, thousands of
  configs) and take the argmax, breaking ties toward fewer machines.

* **Greedy bottleneck-following** (:func:`bottleneck_trace`): start from
  the minimal decoupled deployment and repeatedly scale whatever station is
  currently saturating - exactly the procedure behind the paper's Fig. 29
  ablation staircase.  The returned trace *is* the bottleneck-migration
  narrative: at every step it names the saturating station, the knob turned,
  and the resulting peak.

The greedy trace explains the optimum; the exhaustive search certifies it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .analytical import DeploymentModel, multipaxos_model
from .api import (
    STATION_INDEX,
    AutoscalePolicy,
    ShardingSpec,
    Workload,
    resolve_workload,
    variant_spec,
)
from .sweep import (
    CompiledSweep,
    Config,
    SweepSpec,
    compile_models,
    compile_sweep,
    config_variant,
    model_for,
)
from .transient import Event


@dataclass(frozen=True)
class TraceStep:
    """One rung of the bottleneck-migration staircase."""

    step: int
    label: str                 # the knob turned to get here
    config: Optional[Config]   # None for the vanilla MultiPaxos baseline
    machines: int
    peak: float                # cmds/s at this rung
    bottleneck: str            # station saturating at this rung


@dataclass(frozen=True)
class AutotuneResult:
    best_config: Config
    best_model: DeploymentModel
    best_peak: float
    best_bottleneck: str
    machines: int              # servers used by the best deployment
    budget: int
    n_candidates: int          # feasible configs enumerated
    trace: Tuple[TraceStep, ...]  # greedy bottleneck-migration staircase
    objective: str = "peak"    # what "best" ranked by
    best_p99: Optional[float] = None  # seed-mean p99 s (fault objectives)


@dataclass(frozen=True)
class VariantChoice:
    """Best deployment of one protocol variant under the budget."""

    variant: str
    config: Config
    model: DeploymentModel
    peak: float                # cmds/s (bottleneck law)
    machines: int
    bottleneck: str


@dataclass(frozen=True)
class VariantAutotuneResult:
    """Cross-variant budget search: which protocol wins at budget B?"""

    winner: VariantChoice
    per_variant: Dict[str, VariantChoice]  # best of each variant
    budget: int
    n_candidates: int          # feasible configs across all variants


def candidate_spec(budget: int, f: int = 1, batching: bool = False,
                   batch_sizes: Tuple[int, ...] = (10, 50, 100)) -> SweepSpec:
    """The discrete config space under a machine budget.

    Grids keep write quorums (columns) of at least ``f + 1`` members so f
    failures are survivable; the ``(2f+1, 1)`` column is the
    majority-quorum degenerate case the ablation starts from.  Knob ranges
    are clipped so the *smallest* other components still fit: anything
    larger can never be feasible and would only bloat the batch.  The
    unbatched clipping is the compartmentalized variant's registered
    ``candidate_knobs`` - one source of truth shared with
    :func:`autotune_variants`.
    """
    knobs = variant_spec("compartmentalized").candidate_knobs(budget, f)
    max_proxies = knobs["n_proxy_leaders"][-1]
    max_replicas = knobs["n_replicas"][-1]
    if not batching:
        return SweepSpec(
            f=f,
            n_proxy_leaders=knobs["n_proxy_leaders"],
            grids=knobs["grids"],
            n_replicas=knobs["n_replicas"],
        )
    # batched spec: batchers/unbatchers dominate, everything else is cheap
    # per-batch - coarsen the other knobs to keep the product tractable
    min_rest = 1 + (f + 1) + (f + 1)       # leader + smallest grid + replicas
    max_bu = max(budget - min_rest - 1, 1)
    return SweepSpec(
        f=f,
        n_proxy_leaders=tuple(range(1, min(max_proxies, 4) + 1)),
        grids=((2 * f + 1, 1), (f + 1, f + 1)),
        n_replicas=tuple(range(f + 1, min(max_replicas, f + 3) + 1)),
        batch_sizes=batch_sizes,
        n_batchers=tuple(range(1, min(max_bu, 12) + 1)),
        n_unbatchers=tuple(range(1, min(max_bu, 12) + 1)),
    )


def _eval(config: Config, alpha: float, workload: Workload
          ) -> Tuple[float, str, int, float]:
    """(peak, bottleneck, machines, total demand).  Total demand is the
    plateau tie-breaker: a move that keeps the peak flat but lowers the
    summed demand (e.g. +1 batcher shifting the bottleneck to the
    unbatcher) is still progress toward the next rung."""
    m = model_for(config, workload)
    bn, _ = m.bottleneck(workload)
    total = sum(m.demands(workload).values())
    return m.peak_throughput(alpha, workload), bn, m.total_machines(), total


# knob-turn candidates per bottleneck station: (label, config transform)
def _moves(config: Config, batching: bool) -> Dict[str, List[Tuple[str, Config]]]:
    r, w = config["grid_rows"], config["grid_cols"]
    moves: Dict[str, List[Tuple[str, Config]]] = {
        "proxy": [("+1 proxy leader",
                   {**config, "n_proxy_leaders": config["n_proxy_leaders"] + 1})],
        "replica": [("+1 replica",
                     {**config, "n_replicas": config["n_replicas"] + 1})],
        "acceptor": [
            ("+1 grid column (write sharding)", {**config, "grid_cols": w + 1}),
            ("+1 grid row (read sharding)", {**config, "grid_rows": r + 1}),
        ],
        "batcher": [], "unbatcher": [], "leader": [],
    }
    if batching:
        if config["n_batchers"] == 0:
            on = {**config, "n_batchers": 1, "n_unbatchers": 1,
                  "batch_size": 100}
            moves["leader"] = [("enable batching (1 batcher, 1 unbatcher)", on)]
        else:
            moves["batcher"] = [("+1 batcher",
                                 {**config, "n_batchers": config["n_batchers"] + 1})]
            moves["unbatcher"] = [("+1 unbatcher",
                                   {**config,
                                    "n_unbatchers": config["n_unbatchers"] + 1})]
    return moves


def bottleneck_trace(budget: int, alpha: float,
                     workload: Optional[Union[Workload, float]] = None,
                     f_write: Optional[float] = None,
                     f: int = 1, batching: bool = False,
                     max_steps: int = 64) -> List[TraceStep]:
    """Greedy bottleneck-following from vanilla MultiPaxos up to the budget.

    Step 0 is the un-decoupled baseline; step 1 decouples into the minimal
    compartmentalized deployment; every further step scales the currently
    saturating station (trying each applicable knob, keeping the best that
    fits the budget).  Stops when the bottleneck has no scaling knob left
    (the sequencing leader, in unbatched mode) or no move improves.
    """
    w = resolve_workload(workload, f_write, where="bottleneck_trace")
    mp = multipaxos_model(f=f)
    trace: List[TraceStep] = [TraceStep(
        step=0, label="vanilla MultiPaxos", config=None,
        machines=mp.total_machines(),
        peak=mp.peak_throughput(alpha, w),
        bottleneck=mp.bottleneck(w)[0])]

    # paper Fig. 29a step 1: decouple into 2 proxies, 2f+1 acceptors, f+1
    # replicas (1 proxy would *lose* throughput vs the fused leader)
    config: Config = dict(f=f, n_proxy_leaders=2, grid_rows=2 * f + 1,
                          grid_cols=1, n_replicas=f + 1, batch_size=1,
                          n_batchers=0, n_unbatchers=0)
    peak, bn, machines, total = _eval(config, alpha, w)
    if machines > budget:
        return trace
    trace.append(TraceStep(step=1, label="decouple (2 proxy leaders)",
                           config=dict(config), machines=machines, peak=peak,
                           bottleneck=bn))

    seen = {tuple(sorted(config.items()))}
    for step in range(2, max_steps):
        best: Optional[Tuple[float, float, str, Config, str, int]] = None
        for label, cand in _moves(config, batching)[bn]:
            key = tuple(sorted(cand.items()))
            if key in seen:
                continue
            p, b, m, tot = _eval(cand, alpha, w)
            if m > budget:
                continue
            if best is None or (p, -tot) > (best[0], -best[1]):
                best = (p, tot, b, cand, label, m)
        # take the move if it raises the peak, or keeps it flat while
        # freeing headroom (bottleneck migrates within a plateau)
        if best is None or best[0] < peak * (1 - 1e-9):
            break
        if best[0] <= peak * (1 + 1e-9) and best[1] >= total * (1 - 1e-9):
            break
        peak, total, bn, config, label, machines = best
        seen.add(tuple(sorted(config.items())))
        trace.append(TraceStep(step=step, label=label, config=dict(config),
                               machines=machines, peak=peak, bottleneck=bn))
    return trace


def autotune(budget: int, alpha: float,
             workload: Optional[Union[Workload, float]] = None,
             f_write: Optional[float] = None, f: int = 1,
             batching: bool = False,
             compiled: Optional[CompiledSweep] = None,
             objective: str = "peak",
             fault_events: Optional[List[Event]] = None,
             shortlist: int = 16,
             transient_kwargs: Optional[Dict] = None) -> AutotuneResult:
    """Best deployment for a machine budget, plus the greedy
    bottleneck-migration trace that explains it.

    ``workload`` is the evaluation point (write mix, skew, arrival and
    batch-fill hints - one :class:`~repro_torch.core.api.Workload` value; the
    legacy ``f_write=`` scalar still works behind a deprecation shim).

    ``objective`` selects the figure of merit:

    * ``"peak"`` (default) - steady-state bottleneck-law throughput;
    * ``"p99_under_failover"`` - tail latency under faults: the top
      ``shortlist`` feasible configs by peak are re-ranked by seed-mean
      p99 latency from the batched transient engine running
      ``fault_events`` (default: leader crash over the middle of the run)
      - deployments that merely tie on steady-state mean separate here by
      how deep and long their failover stall is.

    ``compiled`` lets callers reuse an already-compiled candidate space
    (e.g. to autotune many workload mixes against one batch).  The
    transient run's device travels in ``transient_kwargs``
    (``{"device": "cpu"}`` on the host; ``cuda`` by default)."""
    w = resolve_workload(workload, f_write, where="autotune")
    # smallest deployment the candidate space contains: leader + 1 proxy +
    # the (f+1, 1) column grid + f+1 replicas
    if budget < 1 + 1 + (f + 1) + (f + 1):
        raise ValueError(
            f"budget {budget} cannot hold leader + 1 proxy + {(f+1)}x1 "
            f"grid + {f+1} replicas for f={f}")
    if compiled is None:
        compiled = compile_sweep(candidate_spec(budget, f=f, batching=batching))
    if compiled.configs is None:
        raise ValueError(
            "compiled sweep carries no configs - build it with compile_sweep "
            "(or pass configs to compile_models)")
    feasible = compiled.machines <= budget
    if not feasible.any():
        raise ValueError(
            f"no candidate in the compiled sweep fits budget {budget} "
            f"(smallest uses {int(compiled.machines.min())} machines)")
    peaks = np.where(feasible, compiled.peak_throughput(alpha, w),
                     -np.inf)
    # argmax; ties break toward fewer machines
    order = np.lexsort((compiled.machines, -peaks))
    best_p99: Optional[float] = None
    if objective == "peak":
        best_i = int(order[0])
    elif objective == "p99_under_failover":
        # re-rank the peak shortlist by tail latency under the fault script
        # (one batched transient call over shortlist x seeds lanes)
        short = [int(i) for i in order[:shortlist] if np.isfinite(peaks[i])]
        sub = compiled.subset(short)
        events = fault_events or [Event("leader", 0.4, 0.6, 1e9)]
        res = sub.transient(alpha, workload=w, events=events,
                            **(transient_kwargs or {}))
        p99 = res.seed_mean_p99()
        pick = int(np.lexsort((sub.machines, p99))[0])
        best_i = short[pick]
        best_p99 = float(p99[pick])
    else:
        raise ValueError(f"unknown objective {objective!r}")
    best_config = dict(compiled.configs[best_i])
    # report the workload-*adapted* model (when the workload reshapes
    # demands, the compiled row's peak came from it - the unadapted model
    # would name a different bottleneck and disagree with best_peak)
    best_model = (model_for(best_config, w) if w.adapts_demands
                  else compiled.models[best_i])
    best_peak = float(peaks[best_i])
    best_bn = best_model.bottleneck(w)[0]
    machines = int(compiled.machines[best_i])

    trace = tuple(bottleneck_trace(budget, alpha, workload=w, f=f,
                                   batching=batching))
    # the greedy climber can escape a coarsened exhaustive grid (it has no
    # cartesian-product blowup to worry about) - keep whichever won.  Only
    # meaningful when peak is the objective being maximized.
    last = trace[-1]
    if objective == "peak" and last.config is not None \
            and last.peak > best_peak:
        best_config = dict(last.config)
        best_model = model_for(best_config, w)
        best_peak, best_bn, machines = (last.peak, last.bottleneck,
                                        last.machines)
    return AutotuneResult(
        best_config=best_config,
        best_model=best_model,
        best_peak=best_peak,
        best_bottleneck=best_bn,
        machines=machines,
        budget=budget,
        n_candidates=int(feasible.sum()),
        trace=trace,
        objective=objective,
        best_p99=best_p99,
    )


# ---------------------------------------------------------------------------
# Cross-variant search: which protocol wins at budget B?
# ---------------------------------------------------------------------------


def _meets_floors(model: DeploymentModel,
                  policy: Optional[AutoscalePolicy]) -> bool:
    """True when every station the deployment actually provisions sits
    at or above the policy's pinned per-station floor.  Stations the
    variant does not have (zero servers) are exempt - a floor on
    ``proxy`` cannot disqualify a chain protocol."""
    if policy is None or not policy.min_counts:
        return True
    srv = model.demand_slots()[2]
    for station, lo in policy.min_counts:
        col = STATION_INDEX.get(station)
        if col is None or col >= len(srv):
            continue
        if 0 < srv[col] < lo:
            return False
    return True


def variant_candidate_configs(budget: int, f: int = 1,
                              variants: Tuple[str, ...] = (
                                  "compartmentalized", "mencius", "spaxos"),
                              policy: Optional[AutoscalePolicy] = None,
                              ) -> List[Config]:
    """The per-variant discrete config spaces under one machine budget.

    One generic loop over the variant registry: each
    :class:`~repro_torch.core.api.VariantSpec` that declares ``candidate_knobs``
    contributes its budget-clipped knob product (compartmentalized
    MultiPaxos gets the full :func:`candidate_spec` space; Mencius and
    S-Paxos declare coarsened grids - their extra axes would otherwise
    blow up the cartesian product); variants without one contribute their
    default knob product (a single config for the knobless baselines).
    Over-budget combinations are kept (the batched eval masks them by
    ``machines``) so one compiled space serves nearby budgets too.
    Runtime-registered variants ride this search with no edits here.

    An :class:`~repro_torch.core.api.AutoscalePolicy` with pinned
    ``min_counts`` prunes configs provisioned *below* a floor up front:
    the autotuner's fewer-machines tie-break would otherwise hand the
    elastic controller a starting point it could never legally reach by
    draining (floors bind drains, so they must bind the search too)."""
    configs: List[Config] = []
    for variant in variants:
        spec = variant_spec(variant)
        overrides = (spec.candidate_knobs(budget, f)
                     if spec.candidate_knobs is not None else {})
        configs.extend(spec.configs(f=f, overrides=overrides))
    if policy is not None and policy.min_counts:
        configs = [c for c in configs if _meets_floors(model_for(c), policy)]
    return configs


def autotune_variants(budget: int, alpha: float,
                      workload: Optional[Union[Workload, float]] = None,
                      f_write: Optional[float] = None,
                      f: int = 1,
                      variants: Tuple[str, ...] = (
                          "compartmentalized", "mencius", "spaxos"),
                      compiled: Optional[CompiledSweep] = None,
                      policy: Optional[AutoscalePolicy] = None,
                      ) -> VariantAutotuneResult:
    """Search across protocol variants under one machine budget.

    Lowers every variant's candidate space into ONE compiled demand tensor
    (heterogeneous station sets pad into the canonical slots), evaluates
    the whole mixed batch with the vectorized bottleneck law at one
    :class:`~repro_torch.core.api.Workload`, and reports the best deployment of
    each variant plus the overall winner - the paper's "a technique, not
    a protocol" claim as a search result.  Ties break toward fewer
    machines, like :func:`autotune` - unless an autoscale ``policy``
    pins per-station ``min_counts``, in which case deployments below a
    floor are infeasible however few machines they use (the controller
    could never drain back up to legality)."""
    w = resolve_workload(workload, f_write, where="autotune_variants")
    if compiled is None:
        configs = variant_candidate_configs(budget, f=f, variants=variants,
                                            policy=policy)
        compiled = compile_models([model_for(c) for c in configs], configs)
    if compiled.configs is None:
        raise ValueError(
            "compiled sweep carries no configs - build it with compile_sweep "
            "(or pass configs to compile_models)")
    feasible = compiled.machines <= budget
    if policy is not None and policy.min_counts:
        floors_ok = np.asarray([_meets_floors(m, policy)
                                for m in compiled.models])
        feasible = feasible & floors_ok
    peaks = np.where(feasible, compiled.peak_throughput(alpha, w),
                     -np.inf)
    order = np.lexsort((compiled.machines, -peaks))
    per_variant: Dict[str, VariantChoice] = {}
    for i in order:
        i = int(i)
        if not np.isfinite(peaks[i]) or peaks[i] <= 0:
            break  # sorted: everything after is infeasible too
        v = config_variant(compiled.configs[i])
        if v not in per_variant:
            # workload-adapted model: consistent with the peak the row
            # was ranked by (skew/batch-fill reshape the demand table)
            m = (model_for(compiled.configs[i], w) if w.adapts_demands
                 else compiled.models[i])
            per_variant[v] = VariantChoice(
                variant=v, config=dict(compiled.configs[i]), model=m,
                peak=float(peaks[i]), machines=int(compiled.machines[i]),
                bottleneck=m.bottleneck(w)[0])
    if not per_variant:
        # name each variant's smallest deployment so the caller can see
        # how far off the budget is, per protocol
        mins: Dict[str, int] = {}
        for i, cfg in enumerate(compiled.configs):
            v = config_variant(cfg)
            m = int(compiled.machines[i])
            mins[v] = min(mins.get(v, m), m)
        detail = ", ".join(f"{v} needs >= {m}" for v, m in sorted(mins.items()))
        raise ValueError(
            f"no candidate of any variant fits budget {budget} "
            f"(per-variant minimum machines: {detail})")
    winner = max(per_variant.values(), key=lambda c: (c.peak, -c.machines))
    return VariantAutotuneResult(winner=winner, per_variant=per_variant,
                                 budget=budget,
                                 n_candidates=int(feasible.sum()))


# ---------------------------------------------------------------------------
# Policy search: which autoscale policy saves the most machine-hours?
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PolicyChoice:
    """One policy's scorecard on the load schedule (``policy`` None is
    the frozen static baseline)."""

    policy: Optional[AutoscalePolicy]
    trace: "object"            # AutoscaleTrace (full evidence)
    machine_time: float        # machine x run-fraction integral
    peak_p99: float            # worst-window p99, seconds
    peak_machines: int


@dataclass(frozen=True)
class PolicyAutotuneResult:
    """Verdict of :func:`autotune_policy`: the cheapest policy whose
    worst-window p99 stays within ``p99_slack`` of the static baseline."""

    winner: PolicyChoice
    static: PolicyChoice
    choices: Tuple[PolicyChoice, ...]
    p99_slack: float

    def describe(self) -> str:
        saved = 1.0 - self.winner.machine_time / self.static.machine_time
        pol = (self.winner.policy.describe() if self.winner.policy
               else "static")
        return (f"winner {pol}: machine_time "
                f"{self.winner.machine_time:.2f} vs static "
                f"{self.static.machine_time:.2f} ({saved:.0%} saved), "
                f"peak p99 {self.winner.peak_p99:.3e}s vs "
                f"{self.static.peak_p99:.3e}s "
                f"(slack {self.p99_slack:.2f})")


def autotune_policy(policies: Tuple[AutoscalePolicy, ...],
                    base: np.ndarray, servers: np.ndarray,
                    load: np.ndarray, *,
                    p99_slack: float = 1.10,
                    budget: Optional[int] = None,
                    **kwargs) -> PolicyAutotuneResult:
    """Search an :class:`~repro_torch.core.api.AutoscalePolicy` grid on one
    deployment and load schedule: every policy (plus the frozen static
    baseline) becomes one lane of a single
    :func:`repro_torch.core.autoscale.autoscale_grid` run - shared probes, one
    batched full-horizon replay - and the winner is the policy with the
    smallest machine-time integral whose worst-window p99 stays within
    ``p99_slack`` x the static baseline's (and whose peak provisioning
    fits ``budget``, when given).  The same feasibility-mask +
    ``lexsort`` idiom as the budget autotuners; if no policy qualifies,
    the static baseline wins.  ``kwargs`` go to ``autoscale_grid``,
    ``device`` among them."""
    from .autoscale import autoscale_grid
    if not policies:
        raise ValueError("autotune_policy needs at least one policy")
    if p99_slack <= 0.0:
        raise ValueError(f"p99_slack must be positive: {p99_slack}")
    lanes: List[Optional[AutoscalePolicy]] = list(policies) + [None]
    base = np.asarray(base, dtype=np.float64)
    servers = np.asarray(servers)
    bases = np.repeat(base[None, :], len(lanes), axis=0)
    srv = np.repeat(servers[None, :], len(lanes), axis=0)
    traces = autoscale_grid(bases, srv, lanes, load, **kwargs)
    choices = tuple(PolicyChoice(
        policy=t.policy, trace=t, machine_time=t.machine_time,
        peak_p99=t.peak_p99(), peak_machines=t.peak_machines)
        for t in traces)
    static = choices[-1]
    cap = p99_slack * static.peak_p99
    pool = [c for c in choices[:-1]
            if c.peak_p99 <= cap
            and (budget is None or c.peak_machines <= budget)]
    if not pool:
        winner = static
    else:
        mt = np.asarray([c.machine_time for c in pool])
        p9 = np.asarray([c.peak_p99 for c in pool])
        winner = pool[int(np.lexsort((p9, mt))[0])]
    return PolicyAutotuneResult(winner=winner, static=static,
                                choices=choices, p99_slack=p99_slack)


# ---------------------------------------------------------------------------
# Sharded search: split one machine budget across shard groups
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardChoice:
    """One shard group's slice of a sharded budget split."""

    shard: int
    weight: float              # traffic fraction routed to this shard
    budget: int                # machines allocated by the split
    machines: int              # machines the chosen config actually uses
    config: Config
    peak: float                # shard-local peak, cmds/s
    effective: float           # peak / weight: system cap if this binds


@dataclass(frozen=True)
class ShardedAutotuneResult:
    """A machine budget split across shards, each shard autotuned.

    ``total_peak = min_s peak_s / w_s``: the system saturates when the
    worst-provisioned shard can no longer keep up with its traffic
    share.  Under skew the split is *asymmetric* - the hot shard buys
    more machines per unit of budget."""

    sharding: "ShardingSpec"
    budget: int
    weights: Tuple[float, ...]
    shards: Tuple[ShardChoice, ...]
    total_peak: float          # cmds/s across the whole sharded system
    bottleneck_shard: int      # the shard binding total_peak
    machines: int              # sum of machines actually used
    n_candidates: int          # candidate configs in the per-shard space


def autotune_sharded(budget: int, alpha: float, sharding: "ShardingSpec",
                     workload: Optional[Union[Workload, float]] = None,
                     f_write: Optional[float] = None, f: int = 1,
                     compiled: Optional[CompiledSweep] = None,
                     ) -> ShardedAutotuneResult:
    """Split a machine budget across ``sharding.n_shards`` groups and pick
    each group's best deployment.

    The compiled candidate space is shared by all shards (one batched
    bottleneck-law evaluation); a lookup table maps every per-shard
    budget ``b`` to the best peak any config achieves with ``<= b``
    machines.  A greedy water-filling loop then grants machines one at a
    time to whichever shard currently binds
    ``total = min_s peak_s / w_s`` - so under key skew the hot shard
    (larger ``w_s``) ends up with a bigger, different config than the
    cold shards, which is exactly why the split is searched rather than
    divided evenly."""
    w = resolve_workload(workload, f_write, where="autotune_sharded")
    s = sharding.n_shards
    weights = np.asarray(sharding.resolved_weights(w), dtype=np.float64)
    min_b = 1 + 1 + (f + 1) + (f + 1)
    if budget < s * min_b:
        raise ValueError(
            f"budget {budget} cannot hold {s} shards x {min_b} machines "
            f"(leader + 1 proxy + ({f+1})x1 grid + {f+1} replicas each)")
    max_b = budget - (s - 1) * min_b
    if compiled is None:
        compiled = compile_sweep(candidate_spec(max_b, f=f))
    if compiled.configs is None:
        raise ValueError(
            "compiled sweep carries no configs - build it with compile_sweep")
    peaks = compiled.peak_throughput(alpha, w)
    machines = compiled.machines.astype(np.int64)

    # best config for every per-shard budget: exact at-cost table, then a
    # prefix max so best_idx[b] is the best config using <= b machines
    # (ties break toward fewer machines via the >= prefix update)
    best_peak = np.full(max_b + 1, -np.inf)
    best_idx = np.full(max_b + 1, -1, dtype=np.int64)
    for i, b in enumerate(machines):
        if b <= max_b and peaks[i] > best_peak[b]:
            best_peak[b] = peaks[i]
            best_idx[b] = i
    for b in range(1, max_b + 1):
        if best_peak[b - 1] >= best_peak[b]:
            best_peak[b] = best_peak[b - 1]
            best_idx[b] = best_idx[b - 1]
    if best_idx[min_b] < 0:
        raise ValueError(
            f"no candidate config fits the per-shard floor of {min_b} "
            f"machines (smallest uses {int(machines.min())})")

    # water-fill: every machine goes to the shard binding the system cap
    budgets = np.full(s, min_b, dtype=np.int64)
    while int(budgets.sum()) < budget:
        with np.errstate(divide="ignore"):
            eff = np.where(weights > 0, best_peak[budgets] / weights, np.inf)
        # ties (uniform weights) break toward the least-provisioned shard,
        # so symmetric traffic gets a symmetric split
        budgets[int(np.lexsort((budgets, eff))[0])] += 1

    shards = []
    for i in range(s):
        idx = int(best_idx[budgets[i]])
        peak_i = float(best_peak[budgets[i]])
        eff = peak_i / weights[i] if weights[i] > 0 else np.inf
        shards.append(ShardChoice(
            shard=i, weight=float(weights[i]), budget=int(budgets[i]),
            machines=int(machines[idx]), config=dict(compiled.configs[idx]),
            peak=peak_i, effective=float(eff)))
    effective = np.array([c.effective for c in shards])
    bottleneck = int(np.argmin(effective))
    return ShardedAutotuneResult(
        sharding=sharding,
        budget=budget,
        weights=tuple(float(x) for x in weights),
        shards=tuple(shards),
        total_peak=float(effective[bottleneck]),
        bottleneck_shard=bottleneck,
        machines=sum(c.machines for c in shards),
        n_candidates=len(compiled),
    )


# ---------------------------------------------------------------------------
# placement search (geo plane)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlacementChoice:
    """Best deployment under one placement of stations onto regions."""

    placement: str             # candidate name: "spread", "single/<r>", ...
    geo: "GeoSpec"             # the GeoSpec carrying that placement
    config: Config
    index: int                 # row in the compiled candidate sweep
    machines: int
    worst_p99: float           # max p99 over client-bearing regions
    blended_p99: float         # client-weighted mean p99
    region_p50: Tuple[float, ...]
    region_p99: Tuple[float, ...]
    peak: float                # bottleneck-law peak (cmds/s)


@dataclass(frozen=True)
class PlacementAutotuneResult:
    """Which placement (and which config under it) wins at budget B?

    ``single_region_best`` is the best fully-pinned candidate - the
    baseline a geo-aware placement has to beat for spread clients."""

    best: PlacementChoice
    per_placement: Dict[str, PlacementChoice]
    single_region_best: Optional[PlacementChoice]
    budget: int
    n_candidates: int          # feasible configs per placement
    regions: Tuple[str, ...]


def autotune_placement(budget: int, alpha: float, geo: "GeoSpec",
                       workload: Optional[Union[Workload, float]] = None,
                       f_write: Optional[float] = None, f: int = 1,
                       variant: str = "compartmentalized",
                       n_clients: int = 64,
                       compiled: Optional[CompiledSweep] = None,
                       device=None,
                       ) -> PlacementAutotuneResult:
    """Search station placements under a machine budget, ranking by the
    *worst client-bearing region's* blended p99 latency.

    The candidate family (:func:`repro_torch.core.geo.\
placement_candidates`) is ``spread`` (round-robin),
    ``single/<region>`` (everything pinned) and ``hub/<region>`` (ordering
    core pinned, replica tier spread).  For
    each placement one :meth:`CompiledSweep.geo_latency` call scores every
    config x region at once; the per-placement winner minimizes worst-
    region p99, breaking ties toward blended p99 and then fewer machines.
    The throughput-shaped knobs (how many proxies, grid shape) and the
    latency-shaped placement compose: the same compiled candidate space
    serves both axes.  Batched candidates are dropped (no WAN lowering).

    The search first canonicalizes the region labeling (sorted by region
    name, via :meth:`GeoSpec.relabeled`), so the result is invariant
    under region relabeling: the default round-robin cycles behind the
    ``spread`` / ``hub`` candidates walk the regions tuple in order, and
    without canonicalization two labelings of the same physical WAN
    would score physically different deployments.  Results are keyed by
    region *name* throughout, so callers never see the canonical frame.
    The MVA solves run on ``device`` (``None`` = ``cuda``; ``"cpu"`` on
    the host).
    """
    from .geo import placement_candidates
    w = resolve_workload(workload, f_write, where="autotune_placement")
    canon = tuple(sorted(range(geo.n_regions), key=lambda i: geo.regions[i]))
    geo = geo.relabeled(canon)
    if compiled is None:
        configs = [c for c in variant_candidate_configs(budget, f, (variant,))
                   if not c.get("n_batchers") and not c.get("n_unbatchers")]
        compiled = compile_models([model_for(c) for c in configs], configs)
    if compiled.configs is None:
        raise ValueError(
            "autotune_placement needs a config-bearing sweep; compile with "
            "compile_sweep(spec) rather than compile_models(models)")
    feasible = compiled.machines <= budget
    if not feasible.any():
        raise ValueError(
            f"no placement candidate fits in budget={budget} "
            f"(smallest candidate uses {int(compiled.machines.min())})")
    peaks = compiled.peak_throughput(alpha, w)
    per: Dict[str, PlacementChoice] = {}
    for name, placed in placement_candidates(variant, geo).items():
        surf = compiled.geo_latency(alpha, placed, workload=w,
                                    n_clients=n_clients, device=device)
        worst = surf.worst_p99()
        blend = surf.blended_p99()
        score = np.where(feasible, worst, np.inf)
        i = int(np.lexsort((compiled.machines, blend, score))[0])
        per[name] = PlacementChoice(
            placement=name, geo=placed, config=dict(compiled.configs[i]),
            index=i, machines=int(compiled.machines[i]),
            worst_p99=float(worst[i]), blended_p99=float(blend[i]),
            region_p50=tuple(float(x) for x in surf.p50[i]),
            region_p99=tuple(float(x) for x in surf.p99[i]),
            peak=float(peaks[i]))

    def rank(c: PlacementChoice) -> Tuple[float, float, int]:
        return (c.worst_p99, c.blended_p99, c.machines)

    best = min(per.values(), key=rank)
    singles = [c for n, c in per.items() if n.startswith("single/")]
    single_best = min(singles, key=rank) if singles else None
    return PlacementAutotuneResult(
        best=best, per_placement=per, single_region_best=single_best,
        budget=budget, n_candidates=int(feasible.sum()),
        regions=tuple(geo.regions))

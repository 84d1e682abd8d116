"""Elastic autoscaling: close the loop from measured load to live resize.

Every other plane picks one *static* configuration (the autotuner's
verdict) and holds it; production traffic breathes - diurnal cycles,
flash crowds, region outages.  This module adds the controller the
ROADMAP's last open tentpole asks for: an
:class:`~repro_torch.core.api.AutoscalePolicy` (utilization band, hysteresis
guard, cooldown, per-station floors/ceilings, machine budget) driven by
a :class:`Controller` that watches the **transient engine's own measured
signals** - per-window throughput and the per-window queue-depth surface
(:meth:`~repro_torch.core.transient.TransientResult.window_queue_depth`) - and
resizes stations one server at a time, with every resize paying a
modelled reconfiguration spike
(:func:`~repro_torch.core.transient.reconfiguration_schedule`, the ISS-style
epoch-rotation cost).

How load breathes in a closed network
-------------------------------------
The engine is closed-loop with zero think time, which means a
population alone cannot carry a low-load signal: even a handful of
clients pin the bottleneck near 1 (``X(N)`` saturates at the tiny
population ``sum(d)/max(d)``).  The controller therefore splits its two
signals honestly.  *Utilization* is the utilization law
``u_k = lambda_w * d_k`` on the offered rate, anchored in the engine's
own units by ONE saturated probe of the initial provisioning
(``lambda_peak = peak_utilization x measured capacity`` - real
queueing included, not just ``1/max(d)``); it is exact, can exceed 1
under a flash crowd, and responds to every resize through ``d_k``.
*Queue depth, throughput and p99* are measured per window by
population-shaped probes (``round(n_peak * load[w] / max(load))``
clients) - one batched
:func:`~repro_torch.core.transient.simulate_transient` call over ALL
(config x policy) lanes per window, so a whole policy grid shares each
probe.  The final full-horizon replay uses the
complementary approximation the repo's burst machinery already uses
(offered load as a demand multiplier): the whole (policy x seed) grid,
actions lowered to one piecewise schedule with spikes, in ONE batched
device step loop - that is the trace
:func:`repro_torch.core.execution.run_autoscaled` parity-checks the real
cluster's dip/recovery shape against.

Why constant load converges (the hysteresis guard)
--------------------------------------------------
A drain is only taken when the *predicted* post-drain utilization
``u * c / (c - 1)`` stays at or under ``target_high``; an add requires
``u > target_high``.  After a drain, measured utilization can only land
at or below the prediction (the probe's throughput falls when demand
rises), so the inverse add can never trigger - counts move monotonically
until the band, a floor, or the guard stops them, and a constant-load
trace reaches zero actions.  ``tests/test_autoscale.py`` pins this
property, plus machine-time monotonicity in the band.

Entry points: :func:`autoscale_grid` (the batched (config x policy)
grid), :class:`Controller` (one policy, the scalar wrapper),
:meth:`repro_torch.core.sweep.CompiledSweep.autoscale` (the compiled-grid
method), :func:`diurnal_load` / :func:`flash_crowd_load` (arrival
shapes), and :func:`repro_torch.core.autotune.autotune_policy` (policy search
on the grid).  ``autoscale_grid`` takes ``device=None`` (``cuda``;
``"cpu"`` runs on the host) and hands it to every probe and to the
replay; :class:`Controller` and ``autotune_policy`` pass it through.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .api import (
    STATION_ORDER,
    AutoscalePolicy,
    Config,
    Workload,
    resolve_workload,
)
from .transient import (
    TransientResult,
    reconfiguration_schedule,
    simulate_transient,
)

__all__ = [
    "AutoscaleAction", "AutoscaleTrace", "Controller", "autoscale_grid",
    "diurnal_load", "flash_crowd_load",
]


# ---------------------------------------------------------------------------
# Arrival shapes
# ---------------------------------------------------------------------------


def diurnal_load(n_windows: int = 12, low: float = 0.25,
                 high: float = 1.0, phase: float = 0.0,
                 sharpness: float = 1.0) -> np.ndarray:
    """One diurnal cycle as per-window load multipliers, [W]: a raised
    cosine from ``low`` (trough) to ``high`` (peak), peak mid-run.
    ``sharpness > 1`` raises the cosine to a power - a narrower peak and
    a wider trough dwell, the shape real diurnal traffic has and the one
    that makes elasticity pay."""
    if n_windows < 2:
        raise ValueError(f"need >= 2 windows: {n_windows}")
    if not 0.0 < low <= high:
        raise ValueError(f"need 0 < low <= high: ({low}, {high})")
    if sharpness <= 0.0:
        raise ValueError(f"sharpness must be positive: {sharpness}")
    t = (np.arange(n_windows) + 0.5) / n_windows
    shape = 0.5 * (1.0 - np.cos(2.0 * np.pi * (t + phase)))
    return low + (high - low) * shape ** sharpness


def flash_crowd_load(n_windows: int = 12, base: float = 0.3,
                     peak: float = 1.0, start: float = 0.5,
                     width: float = 0.25) -> np.ndarray:
    """A flash crowd, [W]: steady ``base`` load with a sudden ``peak``
    plateau covering ``width`` of the run from fraction ``start``."""
    if n_windows < 2:
        raise ValueError(f"need >= 2 windows: {n_windows}")
    if not 0.0 < base <= peak:
        raise ValueError(f"need 0 < base <= peak: ({base}, {peak})")
    t = (np.arange(n_windows) + 0.5) / n_windows
    out = np.full(n_windows, float(base))
    out[(t >= start) & (t < start + width)] = float(peak)
    return out


# ---------------------------------------------------------------------------
# Trace types
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AutoscaleAction:
    """One resize decision: ``delta`` servers (+1 add / -1 drain) on
    ``station``, effective from control window ``window``; ``count`` is
    the post-action server count and ``utilization`` / ``queue_depth``
    the measured signals that triggered it."""

    window: int
    station: str
    column: int
    delta: int
    count: int
    utilization: float
    queue_depth: float

    def describe(self) -> str:
        verb = "add" if self.delta > 0 else "drain"
        return (f"w{self.window}: {verb} {self.station} -> {self.count} "
                f"(u={self.utilization:.2f}, q={self.queue_depth:.1f})")


def _slice_lane(res: TransientResult, m: int) -> TransientResult:
    """Row-select one lane (M = 1) of a batched TransientResult."""
    sl = slice(m, m + 1)
    return replace(res, dt=res.dt[sl], flows=res.flows[sl],
                   throughput=res.throughput[sl],
                   latency_mean=res.latency_mean[sl],
                   latency_p50=res.latency_p50[sl],
                   latency_p99=res.latency_p99[sl],
                   completed=res.completed[sl], hist=res.hist[sl],
                   bin_edges=res.bin_edges[sl],
                   queue_sums=(None if res.queue_sums is None
                               else res.queue_sums[sl]))


@dataclass(frozen=True)
class AutoscaleTrace:
    """One lane's closed-loop autoscale run: what the controller saw,
    what it did, and what it cost.

    Window metrics (``utilization``/``queue_depth``/``throughput``/
    ``p99``) are *measured* per control window off the population-shaped
    probes; ``counts[w]`` is the provisioning in effect during window w
    and ``machine_time`` its integral in machine x run-fraction units
    (multiply by the wall horizon for machine-hours; a static deployment
    of ``m`` machines scores exactly ``m``).  ``result`` is the lane's
    slice of the final batched full-horizon replay
    (:func:`~repro_torch.core.transient.reconfiguration_schedule` demands over
    ``step_bounds``), whose dip/recovery shape the execution plane
    parity-checks."""

    policy: Optional[AutoscalePolicy]
    stations: Tuple[str, ...]      # [K] column names
    servers0: np.ndarray           # [K] initial provisioning
    load: np.ndarray               # [W] offered-load multipliers
    population: np.ndarray         # [W] probe client populations
    counts: np.ndarray             # [W, K] servers in effect per window
    actions: Tuple[AutoscaleAction, ...]
    utilization: np.ndarray        # [W, K] u = lambda_w * d (anchored)
    queue_depth: np.ndarray        # [W, K] mean queue depth (probe)
    throughput: np.ndarray         # [W] probe seed-mean cmds/s
    p99: np.ndarray                # [W] probe seed-mean p99 seconds
    machines: np.ndarray           # [W] total servers per window
    machine_time: float            # machine x run-fraction integral
    result: TransientResult        # full-horizon replay, M = 1
    step_bounds: np.ndarray        # [W'] replay schedule bounds (steps)
    replay_window: np.ndarray      # [W'] control window per replay window
    replay_spike: np.ndarray       # [W'] bool: reconfiguration spike seg
    label: str = ""

    @property
    def n_windows(self) -> int:
        return len(self.load)

    @property
    def peak_machines(self) -> int:
        return int(self.machines.max())

    def peak_p99(self) -> float:
        """Worst window p99 - the "at equal p99" comparison point (quiet
        windows are trivially fast; the peak window is what provisioning
        is for)."""
        return float(self.p99.max())

    def replay_rates(self) -> np.ndarray:
        """Seed-mean replay throughput per replay window, [W']."""
        return self.result.window_throughput(self.step_bounds)[0].mean(axis=0)

    def predicted_dip(self, window: int) -> Optional[float]:
        """The transient prediction of the resize dip at control window
        ``window``: replay throughput during the reconfiguration spike
        segment over throughput during the rest of the same window (same
        load multiplier, so the ratio isolates the spike).  None when the
        window has no spike segment."""
        here = self.replay_window == window
        spike = here & self.replay_spike
        post = here & ~self.replay_spike
        if not spike.any() or not post.any():
            return None
        rates = self.replay_rates()
        denom = float(rates[post].mean())
        return float(rates[spike].mean()) / max(denom, 1e-12)

    def plan(self) -> Tuple[Dict[str, Any], ...]:
        """The action sequence as plain data - the contract the JAX-free
        execution plane (:func:`repro_torch.core.execution.run_autoscaled`)
        replays: ``{"window", "station", "delta"}`` per resize."""
        return tuple({"window": a.window, "station": a.station,
                      "delta": a.delta} for a in self.actions)

    def describe(self) -> str:
        pol = self.policy.describe() if self.policy else "static"
        acts = "; ".join(a.describe() for a in self.actions) or "no actions"
        return (f"{self.label or 'lane'} [{pol}]: "
                f"machine_time {self.machine_time:.2f} "
                f"(static would be {int(self.servers0.sum())}), "
                f"peak p99 {self.peak_p99():.3e}s; {acts}")


# ---------------------------------------------------------------------------
# The control loop
# ---------------------------------------------------------------------------


def _mva_population(d: np.ndarray, u_target: float, cap: int = 2048) -> int:
    """Smallest closed-loop population driving the bottleneck of demand
    row ``d`` to utilization ``u_target``, by the exact MVA recursion
    (R_k(n) = d_k (1 + q_k(n-1)), X = n / sum R, q = X R).  This anchors
    the load schedule in absolute terms: ``load[w] = 1`` means "offered
    load that fills the *initial* provisioning to ``u_target``"."""
    d = np.asarray(d, dtype=np.float64)
    d = d[d > 0.0]
    if d.size == 0:
        return 1
    d_max = float(d.max())
    q = np.zeros(d.size)
    for n in range(1, cap + 1):
        r = d * (1.0 + q)
        x = n / r.sum()
        q = x * r
        if x * d_max >= u_target:
            return n
    return cap


def _decide(policy: AutoscalePolicy, u: np.ndarray, q: np.ndarray,
            counts: np.ndarray, active: np.ndarray, eligible: np.ndarray,
            names: Sequence[str]) -> List[Tuple[int, int]]:
    """One window's resize decisions for one lane: a list of
    ``(column, delta)``.  Stations scale *independently* - the paper's
    claim, taken literally: each eligible station may gain or lose one
    server per window, so a ramp can restore the bottleneck tier while
    the same window still drains a cold one.  Drains come first
    (coldest-first), freeing budget for adds (hottest-first); when the
    machine budget binds, the coldest pending adds are dropped.  Only
    ``eligible`` stations (live-resizable on the execution plane) are
    action candidates; ``active`` stations all contribute signals and
    machine accounting."""
    adds: List[Tuple[float, int]] = []
    drains: List[Tuple[float, int]] = []
    for k in np.nonzero(eligible)[0]:
        c = int(counts[k])
        over = u[k] > policy.target_high
        backlog = (policy.queue_high > 0.0
                   and q[k] / c > policy.queue_high)
        if over or backlog:
            hi = policy.max_for(names[k])
            if hi is None or c < hi:
                adds.append((float(u[k]), int(k)))
            continue
        if c <= max(1, policy.min_for(names[k])):
            continue
        if u[k] >= policy.target_low:
            continue
        # the hysteresis guard: never drain when the predicted post-drain
        # utilization u * c / (c - 1) would leave the band upward
        if u[k] * c / (c - 1) > policy.target_high:
            continue
        drains.append((float(u[k]), int(k)))
    moves = [(k, -1) for _, k in sorted(drains)]
    total = int(counts[active].sum()) - len(moves)
    for _, k in sorted(adds, reverse=True):
        if (policy.machine_budget is not None
                and total + 1 > policy.machine_budget):
            break
        total += 1
        moves.append((k, 1))
    return moves


def autoscale_grid(
    bases: np.ndarray,
    servers: np.ndarray,
    policies: Sequence[Optional[AutoscalePolicy]],
    load: np.ndarray,
    *,
    n_clients: Optional[int] = None,
    peak_utilization: float = 0.9,
    seeds: Union[int, Sequence[int]] = 2,
    probe_steps: int = 800,
    n_steps: int = 4000,
    exponential_service: bool = False,
    station_names: Optional[Sequence[str]] = None,
    labels: Optional[Sequence[str]] = None,
    resizable: Optional[Sequence[Optional[Sequence[str]]]] = None,
    probe_kwargs: Optional[Dict[str, Any]] = None,
    device=None,
) -> List[AutoscaleTrace]:
    """Run the closed autoscale loop over a (config x policy) lane grid.

    ``bases[l]`` is lane *l*'s effective per-server demand row ([K]
    seconds, already divided by alpha) at its initial provisioning
    ``servers[l]``; ``policies[l]`` is its
    :class:`~repro_torch.core.api.AutoscalePolicy` (``None`` freezes the lane:
    the static baseline every headline compares against).  ``load[w]``
    is window *w*'s offered-load multiplier.

    The load schedule needs an absolute anchor: ``load = max(load)``
    means "``peak_utilization`` of the initial provisioning's *measured*
    capacity" (one saturated probe anchors ``lambda_peak`` per lane),
    and when ``n_clients`` is None the probe population is calibrated to
    match by the exact MVA recursion.  Per window, ONE batched probe
    (:func:`simulate_transient` over all lanes, population
    ``round(n_peak * load[w] / max(load))``) measures queue depth,
    throughput and p99, while utilization is the utilization law
    ``load[w] * lambda_peak * d`` on the current counts (see the module
    docstring for why the split); each policy then resizes every
    triggered station by at most one server - stations scale
    independently - effective next window (scaling a station from ``c``
    to ``c'`` servers rescales its per-server demand by ``c / c'``).  After
    the horizon, every lane's action plan is lowered to one
    :func:`~repro_torch.core.transient.reconfiguration_schedule` on a
    shared window grid and the whole (lane x seed) batch replays in ONE
    batched device step loop - the policy-search shape
    :meth:`~repro_torch.core.sweep.CompiledSweep.autoscale` exposes.
    ``device`` (``None`` = ``cuda``) runs the capacity probe, the window
    probes and the replay."""
    bases = np.atleast_2d(np.asarray(bases, dtype=np.float64))
    servers0 = np.atleast_2d(np.asarray(servers)).astype(np.int64)
    if servers0.shape != bases.shape:
        raise ValueError(
            f"servers shape {servers0.shape} != bases shape {bases.shape}")
    n_lanes, k = bases.shape
    if len(policies) != n_lanes:
        raise ValueError(f"{len(policies)} policies for {n_lanes} lanes")
    load = np.asarray(load, dtype=np.float64)
    if load.ndim != 1 or load.size < 2:
        raise ValueError("load must be a [W >= 2] multiplier vector")
    if np.any(load <= 0.0):
        raise ValueError("load multipliers must be positive")
    if station_names is None:
        names: Tuple[str, ...] = tuple(
            STATION_ORDER[i] if i < len(STATION_ORDER) else f"col{i}"
            for i in range(k))
    else:
        names = tuple(str(s) for s in station_names)
        if len(names) != k:
            raise ValueError(f"{len(names)} station names for K={k}")
    labels = (tuple(labels) if labels is not None
              else ("",) * n_lanes)
    if resizable is not None and len(resizable) != n_lanes:
        raise ValueError(
            f"{len(resizable)} resizable entries for {n_lanes} lanes")
    pk = dict(probe_kwargs or {})

    w_count = load.size
    load_norm = load / load.max()
    if not 0.0 < peak_utilization <= 1.0:
        raise ValueError(
            f"peak_utilization must be in (0, 1]: {peak_utilization}")
    if n_clients is None:
        n_clients = max(_mva_population(bases[lane], peak_utilization)
                        for lane in range(n_lanes))
    n_clients = int(n_clients)
    population = np.maximum(
        np.round(n_clients * load_norm).astype(int), 1)
    active = (servers0 > 0) & (bases > 0)
    eligible = active.copy()
    if resizable is not None:
        for lane, allowed in enumerate(resizable):
            if allowed is None:
                continue
            allow = set(str(s) for s in allowed)
            for col, nm in enumerate(names):
                if nm not in allow:
                    eligible[lane, col] = False

    # Anchor the offered rate in the engine's own units: one saturated
    # probe of the initial provisioning measures each lane's capacity
    # (real queueing included - not just 1/d_max), and "load = 1.0"
    # means peak_utilization of THAT.  A closed zero-think-time network
    # pins its bottleneck near 1 at any population, so utilization must
    # come from the utilization law u = lambda * d on this measured
    # anchor; queue depth / throughput / p99 stay per-window probe
    # measurements, where population genuinely moves them.
    n_cap = max(_mva_population(bases[lane], 0.995)
                for lane in range(n_lanes))
    d0 = np.where(active, bases, 0.0)
    cap_probe = simulate_transient(
        d0, n_clients=n_cap, seeds=seeds, n_steps=probe_steps,
        exponential_service=exponential_service, device=device,
        **dict(probe_kwargs or {}))
    lam_peak = peak_utilization * cap_probe.seed_mean_throughput()  # [L]
    counts = np.where(active, servers0, 0).astype(np.int64)

    counts_hist = np.zeros((w_count, n_lanes, k), dtype=np.int64)
    util = np.zeros((w_count, n_lanes, k))
    qdepth = np.zeros((w_count, n_lanes, k))
    xput = np.zeros((w_count, n_lanes))
    p99 = np.zeros((w_count, n_lanes))
    cooldown = np.zeros(n_lanes, dtype=np.int64)
    lane_actions: List[List[AutoscaleAction]] = [[] for _ in range(n_lanes)]

    for w in range(w_count):
        counts_hist[w] = counts
        with np.errstate(invalid="ignore"):
            d = np.where(active, bases * servers0 / np.maximum(counts, 1),
                         0.0)
        probe = simulate_transient(
            d, n_clients=int(population[w]), seeds=seeds,
            n_steps=probe_steps, exponential_service=exponential_service,
            device=device, **pk)
        x = probe.seed_mean_throughput()                      # [L]
        q = probe.window_queue_depth(
            np.zeros(1, dtype=np.int32))[:, :, 0, :].mean(axis=1)  # [L, K]
        util[w] = (load_norm[w] * lam_peak)[:, None] * d
        qdepth[w] = q
        xput[w] = x
        p99[w] = probe.seed_mean_p99()
        if w == w_count - 1:
            break  # a decision here could only land beyond the horizon
        for lane in range(n_lanes):
            policy = policies[lane]
            if policy is None:
                continue
            if cooldown[lane] > 0:
                cooldown[lane] -= 1
                continue
            moves = _decide(policy, util[w, lane], qdepth[w, lane],
                            counts[lane], active[lane], eligible[lane],
                            names)
            if not moves:
                continue
            for col, delta in moves:
                counts[lane, col] += delta
                lane_actions[lane].append(AutoscaleAction(
                    window=w + 1, station=names[col], column=col,
                    delta=delta, count=int(counts[lane, col]),
                    utilization=float(util[w, lane, col]),
                    queue_depth=float(qdepth[w, lane, col])))
            cooldown[lane] = policy.cooldown_windows

    # ---- one batched full-horizon replay over every lane ----
    starts = [w / w_count for w in range(w_count)]
    cuts: set = set()
    for lane in range(n_lanes):
        policy = policies[lane]
        if policy is None or policy.spike_fraction <= 0.0:
            continue
        for a in lane_actions[lane]:
            # bit-identical to reconfiguration_schedule's own span cut,
            # so every lane lands on the same refined window grid
            lo = starts[a.window]
            end = starts[a.window + 1] if a.window + 1 < w_count else 1.0
            cut = lo + policy.spike_fraction * (end - lo)
            if cut < 1.0:
                cuts.add(cut)
    extra = sorted(cuts)

    scheds, bounds = [], None
    for lane in range(n_lanes):
        policy = policies[lane]
        with np.errstate(invalid="ignore"):
            rows = [np.where(active[lane],
                             load_norm[w] * bases[lane] * servers0[lane]
                             / np.maximum(counts_hist[w, lane], 1),
                             0.0)[None, :]
                    for w in range(w_count)]
        sched, b = reconfiguration_schedule(
            rows, starts, n_steps,
            # one epoch rebuild per action window, however many stations
            # it resizes - so one whole-row spike per distinct window
            actions=[(wd, None)
                     for wd in sorted({a.window
                                       for a in lane_actions[lane]})],
            spike_factor=(policy.spike_factor if policy else 1.0),
            spike_fraction=(policy.spike_fraction if policy else 0.0),
            extra_cuts=extra)
        scheds.append(sched)
        if bounds is None:
            bounds = b
        elif not np.array_equal(bounds, b):
            raise RuntimeError("lanes disagree on the shared window grid")
    demands = np.concatenate(scheds, axis=1)          # [W', L, K]
    replay = simulate_transient(
        demands, bounds, n_clients=n_clients, seeds=seeds, n_steps=n_steps,
        exponential_service=exponential_service, device=device)

    refined = sorted(set(starts) | cuts)
    base_bounds = np.asarray([round(s * n_steps) for s in starts])
    replay_window = (np.searchsorted(base_bounds, bounds, side="right")
                     - 1).astype(np.int64)

    traces: List[AutoscaleTrace] = []
    for lane in range(n_lanes):
        policy = policies[lane]
        spike = np.zeros(len(refined), dtype=bool)
        if policy is not None and policy.spike_fraction > 0.0:
            for a in lane_actions[lane]:
                # same arithmetic as the cut generation above, so the
                # spike-end boundary compares exactly equal
                lo = starts[a.window]
                end = (starts[a.window + 1] if a.window + 1 < w_count
                       else 1.0)
                hi = lo + policy.spike_fraction * (end - lo)
                for j, f in enumerate(refined):
                    if lo <= f < hi:
                        spike[j] = True
        machines = counts_hist[:, lane, :].sum(axis=1).astype(np.float64)
        traces.append(AutoscaleTrace(
            policy=policy,
            stations=names,
            servers0=servers0[lane].copy(),
            load=load.copy(),
            population=population.copy(),
            counts=counts_hist[:, lane, :].copy(),
            actions=tuple(lane_actions[lane]),
            utilization=util[:, lane, :].copy(),
            queue_depth=qdepth[:, lane, :].copy(),
            throughput=xput[:, lane].copy(),
            p99=p99[:, lane].copy(),
            machines=machines,
            machine_time=float(machines.mean()),
            result=_slice_lane(replay, lane),
            step_bounds=np.asarray(bounds).copy(),
            replay_window=replay_window.copy(),
            replay_spike=spike,
            label=labels[lane]))
    return traces


class Controller:
    """One policy's closed loop - the scalar wrapper around
    :func:`autoscale_grid` (which see for the probe/replay mechanics).

    ``run`` consumes raw demand rows (the sweep plane's currency);
    ``run_config`` starts from a registered-variant config dict, deriving
    the per-server demand row and initial provisioning from the
    variant's own analytical model - so any registry variant autoscales
    with zero edits here."""

    def __init__(self, policy: AutoscalePolicy) -> None:
        if not isinstance(policy, AutoscalePolicy):
            raise TypeError(f"Controller needs an AutoscalePolicy, got "
                            f"{type(policy).__name__}")
        self.policy = policy

    def run(self, base: np.ndarray, servers: np.ndarray, load: np.ndarray,
            **kwargs: Any) -> AutoscaleTrace:
        """Close the loop over one lane: ``base`` [K] per-server demand
        seconds (already / alpha) at provisioning ``servers`` [K]."""
        return autoscale_grid(np.asarray(base)[None, :],
                              np.asarray(servers)[None, :],
                              [self.policy], load, **kwargs)[0]

    def run_config(self, config: Config, load: np.ndarray, *, alpha: float,
                   workload: Optional[Union[Workload, float]] = None,
                   **kwargs: Any) -> AutoscaleTrace:
        """Close the loop over one registered-variant config: demand row
        and server counts come from the variant's analytical model, and
        actions are restricted to the stations the execution plane can
        live-resize (:func:`repro_torch.core.execution.resizable_stations` -
        the registry-derived knob map), so the emitted plan replays on a
        real cluster via :func:`~repro_torch.core.execution.run_autoscaled`
        without translation.  Pass ``resizable=[None]`` to lift the
        restriction for purely analytical exploration."""
        from .execution import resizable_stations
        from .sweep import config_variant, model_for
        w = resolve_workload(workload, where="Controller.run_config")
        model = model_for(dict(config), w)
        d_w, d_r, servers = model.demand_slots()
        k = len(STATION_ORDER)
        row = (w.f_write * np.asarray(d_w[:k], dtype=np.float64)
               + (1.0 - w.f_write) * np.asarray(d_r[:k], dtype=np.float64))
        variant = config_variant(config)
        kwargs.setdefault("labels", [variant])
        kwargs.setdefault("resizable",
                          [resizable_stations(variant, config)])
        return self.run(row / alpha, np.asarray(servers[:k]), load, **kwargs)

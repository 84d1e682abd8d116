"""Scripted-event schedules and the histogram helpers of the transient plane.

This is the host-side (numpy) half of the reference's transient module:
the :class:`Event` vocabulary, the piecewise-constant demand schedule
builders, tandem routing over active stations (:func:`_routing`) and the
log-interpolated quantile read of a latency histogram
(:func:`_quantile_from_hist`), which the batched execution plane shares.
The stochastic token engine itself (``simulate_transient`` and its result
type) is not part of this package yet.

Demands are piecewise-constant in time: ``demands[w]`` holds during steps
``step_bounds[w] <= i < step_bounds[w+1]``.  Builders:

* :func:`failover_schedule` - multiply one station's demand inside a
  window (``factor=CRASH`` freezes it: leader crash + failover);
* :func:`scale_schedule` - step a station's demand at one instant;
* :func:`schedule_from_demands` - arbitrary per-window demand matrices;
* :func:`mencius_skip_storm_schedule` / :func:`spaxos_payload_ramp_schedule`
  - protocol-variant scripts;
* :func:`resharding_schedule` - a live hot-shard split under load;
* :func:`reconfiguration_schedule` - an autoscale action plan lowered onto
  a piecewise demand schedule, resize spikes included;
* :func:`region_partition_schedule` - a region dropping off the WAN.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

from .analytical import (
    STATION_INDEX,
    STATION_ORDER,
    DeploymentModel,
    mencius_model,
    spaxos_model,
)
from .api import ShardingSpec, Workload, resolve_workload

#: Demand multiplier that effectively freezes a station (a crash: in-flight
#: service stalls and resumes on recovery when the multiplier lifts).
CRASH = 1e9


# ---------------------------------------------------------------------------
# Scripted-event schedules (piecewise-constant demand tensors)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Event:
    """Multiply ``station``'s demand by ``factor`` during a run fraction.

    ``station`` is a canonical :data:`repro.core.analytical.STATION_ORDER`
    name or a raw column index; ``start``/``stop`` are fractions of the
    simulated horizon in [0, 1]."""

    station: Union[str, int]
    start: float
    stop: float
    factor: float

    def column(self) -> int:
        if isinstance(self.station, str):
            return STATION_INDEX[self.station]
        return int(self.station)


def _as_base(demands: np.ndarray) -> np.ndarray:
    """Coerce [K] / [M, K] / [W, M, K] to a [M, K] window-0 base."""
    d = np.asarray(demands, dtype=np.float64)
    if d.ndim == 1:
        d = d[None, :]
    if d.ndim == 3:
        d = d[0]
    return d


def build_schedule(base: np.ndarray, events: Sequence[Event], n_steps: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Lower events over a [M, K] base matrix to (demands[W, M, K],
    step_bounds[W]).  Overlapping events compose multiplicatively."""
    base = _as_base(base)
    cuts = {0}
    spans = []
    for e in events:
        lo = int(round(np.clip(e.start, 0.0, 1.0) * n_steps))
        hi = int(round(np.clip(e.stop, 0.0, 1.0) * n_steps))
        spans.append((lo, hi, e.column(), e.factor))
        cuts.update(c for c in (lo, hi) if 0 <= c < n_steps)
    bounds = np.array(sorted(cuts), dtype=np.int32)
    out = np.repeat(base[None, :, :], len(bounds), axis=0)
    for w, b in enumerate(bounds):
        for lo, hi, col, factor in spans:
            if lo <= b < hi:
                out[w, :, col] *= factor
    return out, bounds


def failover_schedule(base: np.ndarray, station: Union[str, int] = "leader",
                      start: float = 0.35, stop: float = 0.6,
                      factor: float = CRASH, n_steps: int = 4000
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Crash ``station`` during [start, stop) of the run, then recover."""
    return build_schedule(base, [Event(station, start, stop, factor)], n_steps)


def scale_schedule(base: np.ndarray, station: Union[str, int], at: float,
                   factor: float, n_steps: int = 4000
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Step ``station``'s demand by ``factor`` at run fraction ``at`` for
    the rest of the run (factor < 1 = scale-up, > 1 = scale-down)."""
    return build_schedule(base, [Event(station, at, 1.0, factor)], n_steps)


def burst_events(n_stations: int, factor: float = 4.0,
                 fraction: float = 0.25, n_bursts: int = 3) -> List[Event]:
    """Arrival bursts as scripted events: ``n_bursts`` evenly spaced
    surge windows covering ``fraction`` of the run, during which EVERY
    station's demand is multiplied by ``factor`` (offered load transiently
    exceeding provisioned capacity, in the closed-network approximation).
    One :class:`Event` per station column per surge, so bursts compose
    multiplicatively with any other scripted event (a leader crash during
    a burst is just one schedule).  This is how
    ``Workload(arrival="bursty")`` lowers onto the engine."""
    if n_bursts < 1:
        raise ValueError(f"n_bursts must be >= 1: {n_bursts}")
    if not 0.0 < fraction < 1.0:
        raise ValueError(f"burst fraction must be in (0, 1): {fraction}")
    events: List[Event] = []
    seg = 1.0 / n_bursts
    surge = fraction * seg
    for b in range(n_bursts):
        start = b * seg + (seg - surge) / 2.0
        events.extend(Event(k, start, start + surge, factor)
                      for k in range(n_stations))
    return events


def schedule_from_demands(windows: Sequence[np.ndarray],
                          starts: Sequence[float], n_steps: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Arbitrary piecewise schedule: ``windows[w]`` ([M, K] or [K]) holds
    from run fraction ``starts[w]`` (first must be 0) to the next start.
    This is how batch-fill ramps and time-varying skew are scripted: build
    each window's demand matrix from the analytical model and stack."""
    if len(windows) != len(starts):
        raise ValueError(f"{len(windows)} windows vs {len(starts)} starts")
    if starts[0] != 0.0:
        raise ValueError("first window must start at fraction 0")
    if list(starts) != sorted(starts):
        raise ValueError("window starts must be nondecreasing")
    mats = [_as_base(w) for w in windows]
    if len({m.shape for m in mats}) != 1:
        raise ValueError("all windows must share the same [M, K] shape")
    bounds = np.array([int(round(s * n_steps)) for s in starts],
                      dtype=np.int32)
    return np.stack(mats), bounds


def _demand_row(model: DeploymentModel, f_write: float = 1.0) -> np.ndarray:
    """One model's effective demand scattered into canonical slots, [1, K]."""
    d_w, d_r, _ = model.demand_slots()
    row = (f_write * np.asarray(d_w, dtype=np.float64)
           + (1.0 - f_write) * np.asarray(d_r, dtype=np.float64))
    return row[None, :]


def mencius_skip_storm_schedule(
    alpha: float,
    n_leaders: int = 3,
    start: float = 0.35,
    stop: float = 0.7,
    skip_fraction: float = 0.5,
    slow_factor: float = 3.0,
    skip_batch: float = 10.0,
    n_steps: int = 4000,
    workload: Optional[Workload] = None,
    f_write: Optional[float] = None,
    **mencius_kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mencius slow-leader skip storm (paper section 6 dynamics).

    During ``[start, stop)`` one of the ``n_leaders`` lags: its owned slots
    are noop-filled at ``skip_fraction`` of the log (the Phase2aRange skip
    traffic loads proxies, the grid and the replicas per
    :func:`repro.core.analytical.mencius_model`), and the leader station
    itself drains ``slow_factor`` x slower (the hot lane is the laggard's).
    After ``stop`` the leader catches up and demands return to the healthy
    table.  Returns ``(demands[W, 1, K], step_bounds[W])`` ready for
    :func:`simulate_transient` (demands already divided by ``alpha``)."""
    w = resolve_workload(workload, f_write,
                         where="mencius_skip_storm_schedule")
    healthy = _demand_row(
        mencius_model(n_leaders=n_leaders, **mencius_kwargs),
        w.f_write) / alpha
    storm = _demand_row(
        mencius_model(n_leaders=n_leaders, skip_fraction=skip_fraction,
                      skip_batch=skip_batch, **mencius_kwargs),
        w.f_write) / alpha
    storm = storm.copy()
    storm[0, STATION_INDEX["leader"]] *= slow_factor
    return schedule_from_demands([healthy, storm, healthy],
                                 [0.0, start, stop], n_steps)


def spaxos_payload_ramp_schedule(
    alpha: float,
    payload_factors: Sequence[float] = (1.0, 2.0, 4.0, 8.0),
    n_steps: int = 4000,
    workload: Optional[Workload] = None,
    f_write: Optional[float] = None,
    **spaxos_kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """S-Paxos payload-size ramp (paper section 7 dynamics).

    Each window scales payload-carrying messages by the next
    ``payload_factors`` entry via
    :func:`repro.core.analytical.spaxos_model`: the data path
    (disseminators, stabilizers, replicas) drains slower window by window
    while the id-ordering leader's demand stays exactly flat - the
    decoupling the protocol exists for, as dynamics.  Returns
    ``(demands[W, 1, K], step_bounds[W])`` for
    :func:`simulate_transient` (demands already divided by ``alpha``)."""
    if len(payload_factors) < 2:
        raise ValueError("need >= 2 payload windows to ramp")
    w = resolve_workload(workload, f_write,
                         where="spaxos_payload_ramp_schedule")
    windows = [
        _demand_row(spaxos_model(payload_factor=p, **spaxos_kwargs),
                    w.f_write) / alpha
        for p in payload_factors
    ]
    starts = [i / len(windows) for i in range(len(windows))]
    return schedule_from_demands(windows, starts, n_steps)


def resharding_schedule(
    base: np.ndarray,
    sharding: "ShardingSpec",
    start: float = 0.4,
    stop: float = 0.55,
    migration_factor: float = CRASH,
    n_steps: int = 4000,
    workload: Optional[Workload] = None,
    f_write: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Live resharding: split the hot shard in two, under load.

    Three windows over ``(n_shards + 1) * K`` flattened columns (the
    original shards plus the destination group, idle pre-split):

    1. ``[0, start)`` - steady state at the sharding's (skew-derived)
       weights; the destination shard carries zero demand.
    2. ``[start, stop)`` - the migration window: the hot shard freezes
       while its state streams out (``migration_factor`` multiplies its
       every station; the default :data:`CRASH` models a full
       stop-the-world handoff), so hot-partition traffic stalls and
       overall throughput dips.
    3. ``[stop, 1)`` - post-split: the hot shard's traffic is halved,
       the freed half served by the destination - the bottleneck law's
       ``min_s alpha/(w_s d_max)`` *rises*, so throughput recovers above
       its pre-split level.

    ``base`` is a single deployment's per-command demand row ([K] or
    [1, K]), already divided by ``alpha`` like the other schedule
    builders.  Returns ``(demands[3, 1, (S+1)*K], step_bounds[3])`` for
    :func:`simulate_transient`; replayed on the real cluster by
    ``tests/test_sharded_execution.py``, mirroring the leader-failover
    replay."""
    from .sharding import flatten_shards, shard_demands, split_weights
    if not 0.0 < start < stop < 1.0:
        raise ValueError(
            f"need 0 < start < stop < 1: start={start}, stop={stop}")
    w = resolve_workload(workload, f_write, where="resharding_schedule")
    row = _as_base(base)  # [1, K]
    pre_w, post_w, hot = split_weights(sharding, w)
    pre = flatten_shards(shard_demands(row, sharding, weights=pre_w))
    post = flatten_shards(shard_demands(row, sharding, weights=post_w))
    k = row.shape[1]
    mig = pre.copy()
    mig[:, hot * k:(hot + 1) * k] *= migration_factor
    return schedule_from_demands([pre, mig, post], [0.0, start, stop],
                                 n_steps)


def reconfiguration_schedule(
    windows: Sequence[np.ndarray],
    starts: Sequence[float],
    n_steps: int,
    *,
    actions: Sequence[Tuple[int, Union[str, int]]] = (),
    spike_factor: float = 1.5,
    spike_fraction: float = 0.25,
    extra_cuts: Sequence[float] = (),
) -> Tuple[np.ndarray, np.ndarray]:
    """An autoscale plan as a piecewise demand schedule, spikes included.

    ``windows[w]`` ([M, K] or [K]) holds from run fraction ``starts[w]``
    to the next start - the controller's post-action demand matrices
    (resized stations already rescaled by ``c0 / c``).  Each ``actions``
    entry ``(window, station)`` marks a resize landing at the start of
    that window: the marked demand is additionally multiplied by
    ``spike_factor`` during the first ``spike_fraction`` of the window
    (state transfer / warm-up traffic riding the reconfiguration, the
    ISS-style epoch-rotation cost).  ``station`` is a canonical station
    name, a raw column index (flattened shard columns), or ``None`` to
    spike the *whole row* - migration commands traverse every station of
    the pipeline, which is what the execution plane's warm phase
    (:func:`repro.core.execution.run_autoscaled`) actually replays.

    ``extra_cuts`` forces additional window boundaries (run fractions)
    even where no demand changes - lanes of a batched policy grid must
    share ONE ``step_bounds`` vector, so the union of every lane's cut
    fractions is passed to each lane's schedule.

    Composes through :func:`schedule_from_demands`; returns
    ``(demands[W', M, K], step_bounds[W'])`` for
    :func:`simulate_transient`."""
    if len(windows) != len(starts):
        raise ValueError(f"{len(windows)} windows vs {len(starts)} starts")
    if spike_factor < 1.0:
        raise ValueError(f"spike_factor must be >= 1: {spike_factor}")
    if not 0.0 <= spike_fraction <= 1.0:
        raise ValueError(
            f"spike_fraction must be in [0, 1]: {spike_fraction}")
    mats = [_as_base(m) for m in windows]
    base_starts = [float(s) for s in starts]
    ends = base_starts[1:] + [1.0]

    spans = []  # (spike_start, spike_stop, column)
    for w, station in actions:
        w = int(w)
        if not 0 <= w < len(mats):
            raise ValueError(
                f"action window {w} out of range for {len(mats)} windows")
        if station is None:
            col = None
        else:
            col = (STATION_INDEX[station] if isinstance(station, str)
                   else int(station))
            if not 0 <= col < mats[w].shape[1]:
                raise ValueError(
                    f"action column {col} out of range for K="
                    f"{mats[w].shape[1]}")
        lo = base_starts[w]
        hi = lo + spike_fraction * (ends[w] - lo)
        spans.append((lo, hi, col))

    cuts = set(base_starts)
    cuts.update(hi for _, hi, _ in spans if hi < 1.0)
    cuts.update(float(c) for c in extra_cuts if 0.0 <= float(c) < 1.0)
    refined = sorted(cuts)

    out = []
    for f in refined:
        w = max(i for i, s in enumerate(base_starts) if s <= f)
        mat = mats[w].copy()
        for lo, hi, col in spans:
            if lo <= f < hi:
                if col is None:
                    mat *= spike_factor
                else:
                    mat[:, col] *= spike_factor
        out.append(mat)
    return schedule_from_demands(out, refined, n_steps)


def region_partition_schedule(
    base: np.ndarray,
    model: DeploymentModel,
    geo: "Any",
    region: Union[str, int],
    start: float = 0.4,
    stop: float = 0.6,
    n_steps: int = 4000,
) -> Tuple[np.ndarray, np.ndarray]:
    """A whole region drops off the WAN during [start, stop), then heals.

    For each station with ``c`` servers of which ``m`` sit in the
    partitioned region (per the :class:`~repro.core.api.GeoSpec`'s
    placement cycles), the surviving ``c - m`` servers absorb the
    station's full traffic - demand per surviving server rises by
    ``c / (c - m)``.  A station entirely inside the region freezes
    (:data:`CRASH`) until the partition heals: that is the failure
    mode a ``single/<region>`` placement risks and a spread placement
    amortizes, so this schedule is how the placement autotuner's
    choices get stress-tested under faults.

    ``base`` is the deployment's per-command demand row ([K] or
    [1, K]) already divided by ``alpha``; ``model`` supplies the
    per-station server counts.  Returns ``(demands[W, M, K],
    step_bounds[W])`` for :func:`simulate_transient`."""
    if not 0.0 < start < stop < 1.0:
        raise ValueError(
            f"need 0 < start < stop < 1: start={start}, stop={stop}")
    if isinstance(region, str):
        r = list(geo.regions).index(region)
    else:
        r = int(region)
        if not 0 <= r < geo.n_regions:
            raise ValueError(
                f"region index {r} out of range for {geo.n_regions} regions")
    _, _, servers = model.demand_slots()
    events: List[Event] = []
    for k, c in enumerate(servers):
        if c <= 0:
            continue
        kind = STATION_ORDER[k]
        lost = sum(1 for i in range(c) if geo.region_of(kind, i) == r)
        if lost == 0:
            continue
        factor = CRASH if lost >= c else c / float(c - lost)
        events.append(Event(k, start, stop, factor))
    return build_schedule(base, events, n_steps)




# ---------------------------------------------------------------------------
# Host-side helpers shared with the execution plane
# ---------------------------------------------------------------------------


def _routing(active: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-deployment tandem routing over active stations.

    active: [M, K] bool.  Returns (entry[M], next_station[M, K]) where
    ``next_station[m, k] == K`` marks command completion after station k
    (inactive rows point to K too; they never host commands)."""
    m, k = active.shape
    entry = np.zeros(m, dtype=np.int32)
    nxt = np.full((m, k), k, dtype=np.int32)
    for i in range(m):
        idx = np.nonzero(active[i])[0]
        if idx.size == 0:
            raise ValueError(f"deployment row {i} has no active station")
        entry[i] = idx[0]
        nxt[i, idx[:-1]] = idx[1:]
    return entry, nxt


def _quantile_from_hist(hist: np.ndarray, edges: np.ndarray, q: float
                        ) -> np.ndarray:
    """hist: [M, S, B]; edges: [M, B+1] (log-spaced).  Returns [M, S]
    latency at quantile q, log-interpolated inside the landing bin."""
    cum = hist.cumsum(axis=2)
    total = np.maximum(cum[:, :, -1], 1)
    target = q * total
    idx = np.minimum((cum < target[:, :, None]).sum(axis=2),
                     hist.shape[2] - 1)
    lo = np.take_along_axis(np.broadcast_to(edges[:, None, :-1], hist.shape),
                            idx[:, :, None], axis=2)[:, :, 0]
    hi = np.take_along_axis(np.broadcast_to(edges[:, None, 1:], hist.shape),
                            idx[:, :, None], axis=2)[:, :, 0]
    below = np.where(idx > 0,
                     np.take_along_axis(cum, np.maximum(idx - 1, 0)[:, :, None],
                                        axis=2)[:, :, 0], 0)
    inbin = np.maximum(
        np.take_along_axis(hist, idx[:, :, None], axis=2)[:, :, 0], 1)
    frac = np.clip((target - below) / inbin, 0.0, 1.0)
    return lo * (hi / lo) ** frac

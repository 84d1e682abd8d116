"""Batched stochastic transient simulator of the closed queueing network.

The paper's headline claims are about *dynamics*, not just steady state:
throughput dips and recovers when a leader fails (section 5), degrades
under skew for CRAQ but not for the compartmentalized deployment
(Fig. 33), and ramps as batches fill (Figs. 30-31).  This module
simulates the closed network *through time*, stochastically, in one
batched device step loop over every (deployment x seed) lane, so a whole
transient figure (dozens of deployments, many seeds) is one call instead
of a Python event loop per cell.

Model
-----
N closed-loop clients, one outstanding command each (the paper's
benchmark harness).  Each station is a FIFO queue with per-command service
demand ``d_k`` seconds (exponential with mean ``d_k``, or deterministic);
commands traverse the active stations in slot order and re-enter on
completion (zero think time).  With exponential service this is exactly
the product-form network MVA solves, so steady-state throughput must
match :func:`repro_torch.core.simulator.mva_curve`.

Time advances in fixed steps ``dt`` (default: slowest station's demand /
``oversample``).  Remaining service is tracked in *work* units (fractions
of one service) and drained at ``dt / d_k(t)`` per step, so
**time-varying demands act on in-flight work**: a crashed station
(demand x ~1e9) freezes mid-service and resumes after recovery, a scaled
station drains faster from the next step on.  Completion residuals carry
into the next service, so a saturated server's long-run rate is exactly
``1/d_k`` with no discretization bias.

The engine (:func:`_transient_batch`) runs the step loop through
:func:`repro_torch.kernels.ops.transient_lanes`: on the card one launch
of the CUDA kernel a block of ``BLOCK_STEPS`` steps, on the CPU the plain
loop (:func:`repro_torch.kernels.ref.ref_transient_lanes`).  Both take
every step in float32 in the reference's order, so flows, completions,
queue sums and histograms equal the reference's bit for bit.  Each lane
finishes at most one command a step; the step loop writes that
command's latency a step, and the run's latencies are binned by one
launch of the CUDA :func:`repro_torch.kernels.ops.latency_hist` kernel
(its plain version for CPU tensors).  Service draws are common random
numbers: every deployment under seed ``s`` sees the same stream, drawn on
the host from a ``torch.Generator`` seeded with ``s`` (or injected, to
replay the reference's own draws).

Scripted events
---------------
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

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .analytical import (
    STATION_INDEX,
    STATION_ORDER,
    DeploymentModel,
    mencius_model,
    spaxos_model,
)
from .api import ShardingSpec, Workload, resolve_workload
from .device import resolve_device
from .simulator import demand_vector
from ..kernels.ops import latency_hist, transient_lanes

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


# ---------------------------------------------------------------------------
# The batched step engine (one lane = one deployment x seed)
# ---------------------------------------------------------------------------

#: Steps a launch of the step kernel runs at most; the plain loop steps in
#: the same blocks.  A launch-size constant only: no result depends on it.
BLOCK_STEPS = 1024


@dataclass(frozen=True)
class TransientInputs:
    """The engine's inputs on the device, one row per (deployment x seed)
    lane in config-major order (lane ``m * S + s``).

    demands_w: [W, L, K] float32 seconds per command per window;
    step_bounds: [W] host int32, the first step of each window; dt: [L]
    float32; entry: [L] int64; nxt: [L, K] int64 tandem routing (K =
    completion); bin_edges: [L, n_bins + 1] float32, the edges samples are
    binned against; seeds: [S]; draws: optional [S, n_steps + 1, K]
    float32 service draws, one stream per seed that every deployment
    shares (common random numbers)."""

    demands_w: torch.Tensor
    step_bounds: np.ndarray
    dt: torch.Tensor
    entry: torch.Tensor
    nxt: torch.Tensor
    bin_edges: torch.Tensor
    seeds: np.ndarray
    draws: Optional[torch.Tensor] = None


def transient_inputs_from_numpy(demands_w, step_bounds, dt, entry, nxt,
                                bin_edges, seeds, draws=None, *,
                                device) -> TransientInputs:
    """Turn the reference engine's numpy inputs into the port's lane tensors.

    demands_w: [W, M, K] seconds (float64 rounds to float32, as the
    reference's device arrays do); step_bounds: [W]; dt: [M]; entry: [M];
    nxt: [M, K]; bin_edges: [M, n_bins + 1]; seeds: [S]; draws: optional
    [S, n_steps + 1, K] exponential service draws - pass the numbers the
    reference drew (``jax.random.exponential(fold_in(key(0), s), ...)``)
    to reproduce its exponential mode exactly.  Deployment rows are
    repeated over the S seeds."""
    dev = resolve_device(device)
    seeds = np.asarray(seeds, dtype=np.int32)
    s = seeds.size

    def per_lane(a, dtype, axis=0):
        a = np.repeat(np.asarray(a), s, axis=axis).astype(dtype)
        return torch.from_numpy(a).to(dev)

    return TransientInputs(
        demands_w=per_lane(demands_w, np.float32, axis=1),
        step_bounds=np.asarray(step_bounds, dtype=np.int32),
        dt=per_lane(dt, np.float32),
        entry=per_lane(entry, np.int64),
        nxt=per_lane(nxt, np.int64),
        bin_edges=per_lane(bin_edges, np.float32),
        seeds=seeds,
        draws=(None if draws is None else torch.from_numpy(
            np.asarray(draws, dtype=np.float32)).to(dev)),
    )


def _seed_draws(seeds: np.ndarray, n_steps: int, k: int) -> torch.Tensor:
    """[S, n_steps + 1, K] float32 exponential service draws on the host,
    one ``torch.Generator`` per seed value: a lane's stream depends on its
    own seed only, and the card and the CPU see the same numbers."""
    out = torch.empty((seeds.size, n_steps + 1, k))
    for i, s in enumerate(seeds):
        gen = torch.Generator()
        gen.manual_seed(int(s) & 0xFFFF_FFFF_FFFF_FFFF)
        out[i].exponential_(generator=gen)
    return out


def _bin_block(lat: torch.Tensor, rec: torch.Tensor,
               edges: torch.Tensor) -> torch.Tensor:
    """[L, n_bins] int32 counts of the recorded latencies.  lat/rec: [L,
    ...] (each lane's samples, in any shape); edges: [L, n_bins + 1]
    float32.  A sample lands in bin
    ``#{j : edges_j < lat} - 1``, clipped to the end bins (a NaN in bin 0):
    one launch of the ``latency_hist`` kernel on the card."""
    n_lanes = lat.shape[0]
    return latency_hist(lat.reshape(n_lanes, -1), rec.reshape(n_lanes, -1),
                        edges)


def _transient_batch(inp: TransientInputs, n_clients: int, n_steps: int,
                     warmup_steps: int, n_bins: int, exponential: bool
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
    """Run every lane for ``n_steps`` steps.  Returns, in the reference's
    shapes and dtypes, (flows[M, S, n_steps] int32, done[M, S] int32,
    lat_sum[M, S] float32, hist[M, S, n_bins] int32, qsum[M, S, W, K]
    float32).

    The step is the reference's ``_one_lane`` step with the same float32
    operations, run in blocks of ``BLOCK_STEPS`` steps through
    :func:`repro_torch.kernels.ops.transient_lanes` (one launch of the
    CUDA kernel a block on the card, the plain loop on the CPU).  Around
    it:

    * the window of step ``i`` depends on ``i`` only, so it is looked up on
      the host ([n_steps] int32), and each window's service rate
      ``dt / max(d, 1e-30)`` (or 1e30 for a zero demand) is computed once,
      elementwise as the step would;
    * a lane finishes at most one command a step (only the last active
      station finishes, one head at a time): the step loop writes each
      step's finish count and that command's latency, and a count above
      one raises.  So a step's latency sum is exact, and the running
      float32 sum is taken on the host in step order, as the reference's
      scan does;
    * the recorded latencies (finished, past the warmup) are binned by one
      ``latency_hist`` launch, and ``done`` is the histogram's mass: every
      recorded sample lands in exactly one bin.

    Nothing synchronises with the host until the loop ends."""
    d_w = inp.demands_w
    dev = d_w.device
    n_windows, n_lanes, k = d_w.shape
    s = inp.seeds.size
    m = n_lanes // s
    dt = inp.dt

    if exponential:
        draws = inp.draws
        if draws is None:
            draws = _seed_draws(inp.seeds, n_steps, k).to(dev)
        elif tuple(draws.shape) != (s, n_steps + 1, k):
            raise ValueError(f"draws must be {(s, n_steps + 1, k)}: "
                             f"{tuple(draws.shape)}")
        draw0 = draws[:, 0].repeat(m, 1)                      # [L, K]
    else:
        draws = None
        draw0 = torch.ones((n_lanes, k), device=dev)

    # a window may zero an active station's demand ("free" service): drain
    # instantly rather than stall (still one completion per step)
    rates = torch.where(d_w > 0, dt[None, :, None]
                        / torch.clamp_min(d_w, 1e-30), 1e30)  # [W, L, K]
    window_of = torch.from_numpy(
        np.searchsorted(inp.step_bounds, np.arange(n_steps), side="right")
        .astype(np.int32) - 1).to(dev)                        # [T]

    finishes_at = inp.nxt == k                                # [L, K]
    arrive_at = torch.where(finishes_at, inp.entry[:, None], inp.nxt)
    entry = inp.entry[:, None]
    state = dict(
        stage=entry.repeat(1, n_clients),                     # [L, N]
        rank=torch.arange(n_clients, device=dev).repeat(n_lanes, 1),
        enter_t=torch.zeros((n_lanes, n_clients), device=dev),
        q=torch.zeros((n_lanes, k), dtype=torch.long, device=dev).scatter_(
            1, entry, n_clients),
        work=torch.zeros((n_lanes, k), device=dev).scatter_(
            1, entry, draw0.gather(1, entry)),
        qsum=torch.zeros((n_lanes, n_windows, k), device=dev))
    flows = torch.empty((n_lanes, n_steps), dtype=torch.int32, device=dev)
    lat1 = torch.empty((n_lanes, n_steps), device=dev)
    for i0 in range(0, n_steps, BLOCK_STEPS):
        transient_lanes(rates, window_of, dt, finishes_at, arrive_at, draws,
                        **state, flows=flows, lat1=lat1, i0=i0,
                        i1=min(i0 + BLOCK_STEPS, n_steps))

    recorded = torch.arange(n_steps, device=dev) >= warmup_steps
    rec = (flows > 0) & recorded[None, :]
    hist = _bin_block(lat1, rec, inp.bin_edges)
    step_lat = torch.where(rec, lat1, 0.0)
    flows_np = flows.cpu().numpy()
    if n_steps and flows_np.max() > 1:
        raise RuntimeError(f"a lane finished {flows_np.max()} commands in "
                           f"one step: the step loop's state is corrupt")
    # the reference's float32 running sum, step by step in step order
    lat_sum = np.add.accumulate(step_lat.cpu().numpy(), axis=1,
                                dtype=np.float32)[:, -1]
    hist_np = hist.cpu().numpy()
    return (flows_np.reshape(m, s, n_steps),
            hist_np.sum(axis=1).astype(np.int32).reshape(m, s),
            lat_sum.reshape(m, s),
            hist_np.astype(np.int32).reshape(m, s, n_bins),
            state["qsum"].cpu().numpy().reshape(m, s, n_windows, k))


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TransientResult:
    """Batched transient run over M deployments x S seeds.

    ``flows[m, s, i]`` is completions during step i (dt[m] seconds each);
    scalar summaries are post-warmup.  Latency quantiles come from a
    log-spaced histogram (``hist``/``bin_edges``), so they are exact to
    within one bin width (~11% with the default 96 bins per 4 decades)."""

    dt: np.ndarray                 # [M] seconds per step
    flows: np.ndarray              # [M, S, n_steps] completions per step
    throughput: np.ndarray         # [M, S] post-warmup cmds/s
    latency_mean: np.ndarray       # [M, S] seconds
    latency_p50: np.ndarray        # [M, S] seconds
    latency_p99: np.ndarray        # [M, S] seconds
    completed: np.ndarray          # [M, S] post-warmup completions
    hist: np.ndarray               # [M, S, n_bins]
    bin_edges: np.ndarray          # [M, n_bins + 1]
    n_steps: int
    warmup_steps: int
    queue_sums: np.ndarray = None  # [M, S, W, K] per-window queue integral
    # Host wall-clock seconds of the device step loop, binning included,
    # synchronised ("scan").
    timings: Optional[Dict[str, float]] = None

    def throughput_trace(self, n_windows: int = 40
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-window throughput: (t_centers[M, n_windows] seconds,
        X[M, S, n_windows] cmds/s).  The transient figure primitive."""
        per = self.n_steps // n_windows
        used = per * n_windows
        f = self.flows[:, :, :used].reshape(
            self.flows.shape[0], self.flows.shape[1], n_windows, per)
        x = f.sum(axis=3) / (per * self.dt[:, None, None])
        centers = (np.arange(n_windows) + 0.5) * per * self.dt[:, None]
        return centers, x

    def window_throughput(self, step_bounds: np.ndarray,
                          settle: float = 0.3) -> np.ndarray:
        """Mean throughput per *schedule* window, [M, S, W] cmds/s.

        The first ``settle`` fraction of each window is excluded: after a
        demand change (or the cold start) the trace spends a few round
        trips draining backlog queued under the previous window's
        demands, and that transition would otherwise bias the window mean
        - reported per-window rates could even exceed the window's own
        bottleneck-law cap."""
        bounds = [int(b) for b in step_bounds] + [self.n_steps]
        out = []
        for w in range(len(bounds) - 1):
            lo, hi = bounds[w], bounds[w + 1]
            lo = min(lo + int((hi - lo) * settle), max(hi - 1, lo))
            out.append(self.flows[:, :, lo:hi].sum(axis=2)
                       / ((hi - lo) * self.dt[:, None]))
        return np.stack(out, axis=-1)

    def window_queue_depth(self, step_bounds: np.ndarray) -> np.ndarray:
        """Mean queue depth per *schedule* window and station,
        [M, S, W, K] commands - the controller's backlog signal.

        ``queue_sums[..., w, k]`` integrates station k's queue over every
        step of window w; dividing by the window's step count gives the
        time-average depth (waiters + the one in service).  Pass the same
        ``step_bounds`` the run was scheduled with."""
        if self.queue_sums is None:
            raise ValueError("this result carries no queue_sums surface")
        bounds = [int(b) for b in step_bounds] + [self.n_steps]
        steps = np.maximum(np.diff(np.asarray(bounds, dtype=np.float64)), 1.0)
        return self.queue_sums / steps[None, None, :, None]

    def seed_mean_throughput(self) -> np.ndarray:
        """[M] post-warmup throughput averaged over seeds."""
        return self.throughput.mean(axis=1)

    def seed_mean_p99(self) -> np.ndarray:
        """[M] p99 latency averaged over seeds."""
        return self.latency_p99.mean(axis=1)


def simulate_transient(
    demands: np.ndarray,
    step_bounds: Optional[np.ndarray] = None,
    *,
    n_clients: int = 64,
    seeds: Union[int, Sequence[int]] = 8,
    n_steps: int = 4000,
    dt: Optional[Union[float, np.ndarray]] = None,
    oversample: float = 4.0,
    exponential_service: bool = True,
    warmup_frac: float = 0.25,
    n_bins: int = 96,
    draws: Optional[np.ndarray] = None,
    device=None,
) -> TransientResult:
    """Run the batched engine over a (possibly scheduled) demand tensor.

    demands: [W, M, K] piecewise windows (or [M, K] / [K] for a single
    steady window), in seconds per command per station - i.e. already
    divided by alpha, like :func:`simulator.mva_curves_from_demands`.
    ``step_bounds[w]`` is the first step of window w (from
    :func:`build_schedule` et al.); omitted = one window from step 0.
    ``seeds`` is a count or explicit list; every (deployment, seed) lane
    runs in ONE batched device loop.  ``dt`` defaults per deployment to the
    window-0 bottleneck demand / ``oversample``.

    Exponential service draws one stream per seed (common random numbers
    across deployments) from a ``torch.Generator`` seeded with the seed
    value; ``draws`` ([S, n_steps + 1, K]) injects a stream instead, e.g.
    the reference's own.  ``device=None`` means ``cuda``; without a card
    the call raises unless given ``device="cpu"``."""
    dev = resolve_device(device)
    d = np.asarray(demands, dtype=np.float64)
    if d.ndim == 1:
        d = d[None, :]
    if d.ndim == 2:
        d = d[None, :, :]
    if step_bounds is None:
        step_bounds = np.zeros((d.shape[0],), dtype=np.int32)
    step_bounds = np.asarray(step_bounds, dtype=np.int32)
    if step_bounds.shape[0] != d.shape[0]:
        raise ValueError(f"{d.shape[0]} windows vs "
                         f"{step_bounds.shape[0]} step bounds")
    if step_bounds[0] != 0:
        raise ValueError("step_bounds[0] must be 0 (the first window "
                         "covers the start of the run)")
    if np.any(np.diff(step_bounds) < 0):
        raise ValueError("step_bounds must be nondecreasing")
    _, m, k = d.shape

    active = d.max(axis=0) > 0                     # [M, K]
    entry, nxt = _routing(active)
    if dt is None:
        # resolve the *fastest* window's bottleneck: each station completes
        # at most once per step, so dt must stay below the smallest
        # per-window bottleneck demand (crash windows only raise the max,
        # so they never shrink dt)
        dt_arr = d.max(axis=2).min(axis=0) / oversample
    else:
        dt_arr = np.broadcast_to(np.asarray(dt, dtype=np.float64), (m,))
    if np.any(dt_arr <= 0):
        raise ValueError("dt must be positive (zero-demand window 0 row?)")

    # log-spaced latency bins: from half the fastest window's zero-load
    # round-trip up to the simulated horizon (the longest observable wait)
    rtt = np.maximum((d * active[None]).sum(axis=2).min(axis=0), 1e-12)
    lo = rtt * 0.5
    hi = np.maximum(n_steps * dt_arr, lo * 10.0)
    ratio = (hi / lo) ** (1.0 / n_bins)
    bin_edges = lo[:, None] * ratio[:, None] ** np.arange(n_bins + 1)[None, :]

    if isinstance(seeds, (int, np.integer)):
        seeds_arr = np.arange(int(seeds), dtype=np.int32)
    else:
        seeds_arr = np.asarray(list(seeds), dtype=np.int32)
    warmup_steps = int(n_steps * warmup_frac)

    # samples are binned against float32 edges, as the reference's device
    # arrays hold them; quantiles read the float64 edges
    inp = transient_inputs_from_numpy(d, step_bounds, dt_arr, entry, nxt,
                                      bin_edges, seeds_arr, draws,
                                      device=dev)
    t0 = time.perf_counter()
    flows, done, lat_sum, hist, qsum = _transient_batch(
        inp, n_clients=n_clients, n_steps=n_steps,
        warmup_steps=warmup_steps, n_bins=n_bins,
        exponential=bool(exponential_service))
    scan_s = time.perf_counter() - t0

    measured = dt_arr[:, None] * (n_steps - warmup_steps)
    return TransientResult(
        dt=dt_arr,
        flows=flows,
        throughput=done / measured,
        latency_mean=lat_sum / np.maximum(done, 1),
        latency_p50=_quantile_from_hist(hist, bin_edges, 0.50),
        latency_p99=_quantile_from_hist(hist, bin_edges, 0.99),
        completed=done,
        hist=hist,
        bin_edges=bin_edges,
        n_steps=n_steps,
        warmup_steps=warmup_steps,
        queue_sums=qsum,
        timings={"scan": scan_s},
    )


def transient_throughput(model: DeploymentModel, alpha: float,
                         n_clients: int = 64,
                         workload: Optional[Workload] = None,
                         f_write: Optional[float] = None,
                         **kwargs) -> TransientResult:
    """Single-deployment convenience wrapper (M = 1): the transient
    engine's answer to :func:`simulator.mva_curve`'s steady state."""
    w = resolve_workload(workload, f_write, where="transient_throughput")
    d = demand_vector(model, w.f_write) / alpha
    return simulate_transient(d[None, :], n_clients=n_clients, **kwargs)

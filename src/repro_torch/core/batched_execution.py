"""Batched closed-loop execution: "measured" as cheap as "modelled".

:func:`repro_torch.core.execution.run_variant` is the ground truth of the
measured plane - a Python event loop over a real message-passing cluster,
linearizability-checked, ~milliseconds per few dozen commands.  Perfect
for parity smoke, hopeless for *surfaces*: the paper's measured
throughput/latency figures sweep config grids x client populations.  This
module lowers a registered variant's execution plane into a step loop over
every (config x seed) lane at once, so a whole grid of closed-loop client
populations executes on the device in one batched loop and emits
*measured* per-station msgs/cmd plus latency p50/p99 histograms.

How "measured" stays honest
---------------------------
The per-station message costs are **probe-calibrated, not copied from the
table**: for each config the real cluster runs once write-only and (for
mixed workloads) once at the target mix through :func:`run_variant`, at a
probe size and seed disjoint from anything the parity tests compare
against.  The probes yield per-class per-station msgs/cmd vectors
``cost_write``/``cost_read``; the device engine then *executes* the
client populations - every lane realizes exactly
``round(n_commands * f_write)`` writes, shuffled per seed and split
round-robin across clients, mirroring :func:`workload_ops` - and the
measured surface is the completion-weighted blend of the probed costs.

The engine: stations are FIFO queues draining work at ``dt / d_k`` per
step, with the service demand chosen per the *class of the command at the
head* (writes traverse the write path's demands, reads the read path's),
commands walking the active stations in canonical slot order.  Clients park
once their op budget drains, so the run has a makespan - measured
throughput is ``n_commands / t_last`` - and every completion emits a
latency sample.  The samples are binned on the device by the hand-written
CUDA kernel :func:`repro_torch.kernels.ops.latency_hist` with the transient
plane's binning, so p50/p99 read identically across planes.

The step loop is eager PyTorch: the (config x seed) lanes and the clients
are explicit batch dimensions, all state lives on the device, every step
runs in float32 op by op in the reference's order (so completions, drain
counts and makespans match it exactly), and nothing synchronises with the
host until the loop ends.  Unlike the reference, which returns immutable
per-step outputs, the loop writes step ``i``'s completion mask and
latencies in place into preallocated ``[L, n_steps, N]`` tensors, and the
histogram and the float64 latency sums are taken on the device; only the
histogram, the drain counts, the makespans and the sums cross to the host.

Entry points: :func:`run_variant_batched` (one config),
:func:`execute_configs` (any config list, e.g. a sweep's),
:meth:`repro_torch.core.sweep.CompiledSweep.execute` (the compiled-grid
method), :func:`validate_batched` (measured-vs-analytical parity on the
batched surface) and :func:`measured_capacity`.  Each takes ``device=None``,
which means ``cuda``; without a card it raises unless given
``device="cpu"``.
"""
from __future__ import annotations

import math
import time
import zlib
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .analytical import STATION_ORDER, calibrate_alpha
from .api import Config, ShardingSpec, Workload, resolve_workload, variant_spec
from .execution import StationParity, default_config, run_variant
from .sharding import shard_weights, split_counts
from .device import resolve_device
from .sweep import config_variant
from .transient import _quantile_from_hist, _routing
from ..kernels.ops import latency_hist

__all__ = [
    "BatchedExecutionResult", "BatchedParityReport", "LaneInputs",
    "execute_configs", "lane_inputs_from_numpy", "measured_capacity",
    "run_variant_batched", "validate_batched",
]


# ---------------------------------------------------------------------------
# Probe calibration: per-class per-station msgs/cmd off the real cluster
# ---------------------------------------------------------------------------


def _probe_costs(name: str, cfg: Config, w: Workload, exe: Any,
                 probe_n: int, probe_seed: int, state_machine: str
                 ) -> Tuple[np.ndarray, np.ndarray, Any]:
    """Calibrate (cost_write[K], cost_read[K], feedback_trace) for one
    config by executing the real cluster.

    The write costs come from a write-only probe run.  Read costs come
    from a probe at the *target* mix, decomposed against the write probe -
    so read-path costs that only exist under concurrent writers (CRAQ's
    dirty-read forwarding) are captured at the mix they occur at."""
    k = len(STATION_ORDER)
    t_w = run_variant(name, cfg, replace(w, f_write=1.0),
                      n_commands=probe_n, seed=probe_seed,
                      state_machine=state_machine)
    cost_w = np.asarray(t_w.demand_slots(), dtype=np.float64)[:k]
    if exe.reads_as_writes or w.f_write >= 1.0:
        return cost_w, cost_w.copy(), t_w
    t_mix = run_variant(name, cfg, w, n_commands=probe_n,
                        seed=probe_seed + 1, state_machine=state_machine)
    mix = np.asarray(t_mix.demand_slots(), dtype=np.float64)[:k]
    n_wr, n_rd = t_mix.n_writes, probe_n - t_mix.n_writes
    if n_rd == 0:
        return cost_w, cost_w.copy(), t_mix
    cost_r = np.maximum((mix * probe_n - cost_w * n_wr) / n_rd, 0.0)
    return cost_w, cost_r, t_mix


def _class_streams(n_commands: int, f_write: float, n_clients: int,
                   seeds: np.ndarray, base_seed: int
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Per-seed per-client op-class streams: exactly
    ``round(n_commands * f_write)`` writes (class 1), shuffled per seed
    and split round-robin across clients - the same realized mix
    :func:`repro_torch.core.execution.workload_ops` produces, so the write
    count is seed-independent.  Returns (cls[S, N, L] int32,
    budget[N] int32, n_writes)."""
    n_w = round(n_commands * f_write)
    length = max(-(-n_commands // n_clients), 1)
    cls = np.zeros((len(seeds), n_clients, length), dtype=np.int32)
    budget = np.zeros((n_clients,), dtype=np.int32)
    for i in range(n_commands):
        budget[i % n_clients] += 1
    for si, s in enumerate(seeds):
        flags = np.array([1] * n_w + [0] * (n_commands - n_w), np.int32)
        np.random.default_rng([base_seed, int(s)]).shuffle(flags)
        pos = np.zeros((n_clients,), dtype=np.int64)
        for i in range(n_commands):
            c = i % n_clients
            cls[si, c, pos[c]] = flags[i]
            pos[c] += 1
    return cls, budget, n_w


# ---------------------------------------------------------------------------
# The device engine (one lane = one config x seed client population)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LaneInputs:
    """The engine's inputs on the device, one row per (config x seed) lane
    in config-major order (lane ``m * S + s``).

    d_w/d_r: [L, K] float32 per-class service seconds; entry: [L] int64;
    nxt: [L, K] int64 tandem routing (K = completion); cls: [L, N, n_ops]
    int64 op classes per client; budget: [L, N] int64; dt: [L] float32;
    draws: optional [L, n_steps + 1, K] float32 service draws for the
    exponential mode."""

    d_w: torch.Tensor
    d_r: torch.Tensor
    entry: torch.Tensor
    nxt: torch.Tensor
    cls: torch.Tensor
    budget: torch.Tensor
    dt: torch.Tensor
    seeds: np.ndarray
    draws: Optional[torch.Tensor] = None


def lane_inputs_from_numpy(d_w, d_r, entry, nxt, cls, budget, dt, seeds,
                           draws=None, *, device) -> LaneInputs:
    """Turn the reference engine's numpy inputs into the port's lane tensors.

    d_w/d_r: [M, K] seconds (float64 rounds to float32, as the reference's
    device arrays do); entry: [M]; nxt: [M, K]; cls: [M, S, N, n_ops];
    budget: [M, N]; dt: [M]; seeds: [S]; draws: optional
    [M, S, n_steps + 1, K] exponential service draws - pass the numbers
    the reference drew to reproduce its exponential mode exactly.  Config
    rows are repeated over the S seeds."""
    dev = resolve_device(device)
    seeds = np.asarray(seeds, dtype=np.int32)
    s = seeds.size
    m = np.asarray(d_w).shape[0]

    def per_lane(a, dtype):
        a = np.repeat(np.asarray(a), s, axis=0).astype(dtype)
        return torch.from_numpy(a).to(dev)

    cls = np.asarray(cls)
    lane_draws = None
    if draws is not None:
        d = np.asarray(draws, dtype=np.float32)
        lane_draws = torch.from_numpy(
            d.reshape((m * s,) + d.shape[2:])).to(dev)
    return LaneInputs(
        d_w=per_lane(d_w, np.float32),
        d_r=per_lane(d_r, np.float32),
        entry=per_lane(entry, np.int64),
        nxt=per_lane(nxt, np.int64),
        cls=torch.from_numpy(
            cls.reshape((m * s,) + cls.shape[2:]).astype(np.int64)).to(dev),
        budget=per_lane(budget, np.int64),
        dt=per_lane(dt, np.float32),
        seeds=seeds,
        draws=lane_draws,
    )


def _execute_batch(inp: LaneInputs, n_clients: int, n_steps: int,
                   exponential: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """Run every lane for ``n_steps`` steps.  Returns (fin[L, n_steps, N]
    bool, lat[L, n_steps, N] float32, done_w[L], done_r[L] int64,
    t_last[L] float32), all on the lanes' device and not synchronised.

    Without injected draws the exponential mode draws from a
    ``torch.Generator`` seeded from the lanes' seed list.

    The step is the reference's ``_one_exec_lane`` step with the same
    float32 operations, arranged to launch few device ops per step:

    * station tensors carry one extra column ``k``, the slot parked
      clients sit at; it is never busy-complete (its rate is 0 and its
      work starts at +inf), so ``complete[stage]`` needs no clip and no
      ``stage < k`` mask, and the reference's dropped out-of-range
      scatters land there harmlessly;
    * the service rate ``dt / max(d, 1e-30)`` (or 1e30 for a zero demand)
      of each class is computed once, elementwise exactly as the step
      would, and the step picks the head class's row;
    * the op-class table has one zero column past the longest stream, so
      the current op's class is read without a clip (a client whose index
      reaches it has parked, and its class is never used);
    * drain counts and makespans are read after the loop - done_w/done_r
      from each client's final op index over its class stream, t_last as
      ``(i + 1) * dt`` of the last step with a completion - which equals
      the reference's running sums exactly."""
    d_w, d_r, dt = inp.d_w, inp.d_r, inp.dt
    dev = d_w.device
    n_lanes, k = d_w.shape
    gen = None
    if not exponential:
        draw0 = torch.ones((n_lanes, k), device=dev)
    elif inp.draws is not None:
        if inp.draws.shape != (n_lanes, n_steps + 1, k):
            raise ValueError(f"draws must be {(n_lanes, n_steps + 1, k)}: "
                             f"{tuple(inp.draws.shape)}")
        draw0 = inp.draws[:, 0]
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(zlib.crc32(inp.seeds.astype(np.int64).tobytes()))
        draw0 = torch.empty((n_lanes, k), device=dev).exponential_(
            generator=gen)
    inf_col = torch.full((n_lanes, 1), float("inf"), device=dev)

    def rate_of(d):
        # a zero demand for the head's class (a read at the leader) drains
        # instantly - still one completion per step
        r = torch.where(d > 0, dt[:, None] / torch.clamp_min(d, 1e-30), 1e30)
        return torch.cat([r, torch.zeros_like(inf_col)], dim=1)

    rate_w, rate_r = rate_of(d_w), rate_of(d_r)                 # [L, K+1]
    no = torch.zeros((n_lanes, 1), dtype=torch.bool, device=dev)
    finishes_at = torch.cat([inp.nxt == k, no], dim=1)
    arrive_at = torch.where(finishes_at, inp.entry[:, None],
                            torch.cat([inp.nxt, inp.nxt[:, :1]], dim=1))
    cls = torch.cat([inp.cls, torch.zeros_like(inp.cls[:, :, :1])], dim=2)
    entry = inp.entry[:, None]

    alive0 = inp.budget > 0                                      # [L, N]
    stage = torch.where(alive0, entry, k)                        # k = parked
    rank = torch.cumsum(alive0.long(), dim=1) - 1
    enter_t = torch.zeros((n_lanes, n_clients), device=dev)
    op_i = torch.zeros((n_lanes, n_clients), dtype=torch.long, device=dev)
    q = torch.zeros((n_lanes, k + 1), dtype=torch.long,
                    device=dev).scatter_add_(
        1, entry, alive0.long().sum(dim=1, keepdim=True))
    work = torch.cat([torch.zeros((n_lanes, k), device=dev), inf_col],
                     dim=1).scatter_(1, entry, draw0.gather(1, entry))

    # preallocated outputs, written one step row at a time in place
    fin_all = torch.empty((n_lanes, n_steps, n_clients), dtype=torch.bool,
                          device=dev)
    lat_all = torch.empty((n_lanes, n_steps, n_clients), device=dev)
    t_ends = (torch.arange(1, n_steps + 1, dtype=torch.float32, device=dev)
              [:, None] * dt[None, :])                          # [n_steps, L]
    ones = torch.ones((n_lanes, n_clients), dtype=torch.long, device=dev)

    for i in range(n_steps):
        if not exponential:
            draw_i = 1.0
        elif gen is None:
            draw_i = torch.cat([inp.draws[:, i + 1], inf_col], dim=1)
        else:
            draw_i = torch.cat([torch.empty((n_lanes, k), device=dev)
                                .exponential_(generator=gen), inf_col], dim=1)
        t_end = t_ends[i][:, None]                               # [L, 1]

        cls_cur = cls.gather(2, op_i[:, :, None])[:, :, 0]       # [L, N]
        # the head command's class picks each station's service demand
        head = rank == 0
        head_cls = torch.zeros_like(q).scatter_add_(
            1, stage, torch.where(head, cls_cur, 0))
        rate = torch.where(head_cls > 0, rate_w, rate_r)

        busy = q > 0
        work = torch.where(busy, work - rate, work)
        complete = busy & (work <= 0.0)                          # [L, K+1]

        dep_here = complete.gather(1, stage)                     # [L, N]
        moving = dep_here & head
        fin = fin_all[:, i]
        torch.logical_and(moving, finishes_at.gather(1, stage), out=fin)
        torch.sub(t_end, enter_t, out=lat_all[:, i])

        op_i += fin
        # next hop, or next op; a client whose budget drained parks
        enters = moving & (~fin | (op_i < inp.budget))
        dest = arrive_at.gather(1, stage)
        q_dep = q - complete.long()
        # a mover's new rank is its destination's queue length; any other
        # client at a station that completed moves up one
        rank = torch.where(moving, q_dep.gather(1, dest),
                           rank - dep_here.long())
        goes_to = torch.where(enters, dest, k)
        stage = torch.where(moving, goes_to, stage)
        enter_t = torch.where(fin, t_end, enter_t)
        arrivals = torch.zeros_like(q).scatter_add_(1, goes_to, ones)
        q = q_dep + arrivals
        # new head enters service: carry the completion residual on a busy
        # server, fresh draw on an idle one
        fresh = torch.where(busy, complete & (q > 0), arrivals > 0)
        work = torch.where(
            fresh, draw_i + torch.where(complete, work, 0.0), work)

    done_w = _class_done(inp.cls == 1, op_i)
    done_r = _class_done(inp.cls == 0, op_i)
    any_fin = fin_all.any(dim=2)                                 # [L, n_steps]
    last = n_steps - 1 - any_fin.flip(1).to(torch.uint8).argmax(dim=1)
    t_last = torch.where(any_fin.any(dim=1),
                         t_ends.gather(0, last[None, :])[0], 0.0)
    return fin_all, lat_all, done_w, done_r, t_last


def _class_done(is_cls: torch.Tensor, op_i: torch.Tensor) -> torch.Tensor:
    """[L] completed ops of one class: client n of lane l completed its
    first ``op_i[l, n]`` ops, whose classes are ``cls[l, n, :op_i]``."""
    counts = torch.cumsum(is_cls.long(), dim=2)
    counts = torch.cat([torch.zeros_like(counts[:, :, :1]), counts], dim=2)
    return counts.gather(2, op_i[:, :, None])[:, :, 0].sum(dim=1)


def _masked_sum_f64(lat: torch.Tensor, fin: torch.Tensor) -> torch.Tensor:
    """Per-lane float64 sum of the latencies where ``fin`` is set, taken on
    the device in step chunks of at most ~2^27 elements."""
    n_lanes, n_steps, n_clients = lat.shape
    step = max(1, (1 << 27) // max(n_lanes * n_clients, 1))
    out = torch.zeros((n_lanes,), dtype=torch.float64, device=lat.device)
    for lo in range(0, n_steps, step):
        chunk = lat[:, lo:lo + step].double()
        out += torch.where(fin[:, lo:lo + step], chunk, 0.0).sum(dim=(1, 2))
    return out


# ---------------------------------------------------------------------------
# Public surface
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BatchedExecutionResult:
    """One batched execution: M configs x S seeds of closed-loop clients.

    ``station_msgs[m]`` is the measured per-station msgs/cmd/server row
    (canonical :data:`STATION_ORDER` columns) - probe-calibrated per-class
    costs blended by the completions the engine realized; it is
    seed-independent because every lane drains its full op budget at the
    exact generator mix.  Latency/throughput are per (config, seed)."""

    configs: Tuple[Config, ...]
    workload: Workload
    n_commands: int
    n_clients: int
    seeds: np.ndarray              # [S]
    station_msgs: np.ndarray       # [M, K] msgs/cmd/server
    n_writes: np.ndarray           # [M] realized writes per lane
    cost_write: np.ndarray         # [M, K] probe-calibrated write costs
    cost_read: np.ndarray          # [M, K] probe-calibrated read costs
    throughput: np.ndarray         # [M, S] cmds/s (n_commands / makespan)
    latency_mean: np.ndarray       # [M, S] seconds
    latency_p50: np.ndarray        # [M, S]
    latency_p99: np.ndarray        # [M, S]
    completed: np.ndarray          # [M, S] ops drained (== lane budget)
    hist: np.ndarray               # [M, S, B]
    bin_edges: np.ndarray          # [M, B + 1]
    dt: np.ndarray                 # [M] seconds per step
    n_steps: int
    alpha: float
    # Shard axis (sharded runs only): rows become M_cfg x n_shards lanes
    # in config-major order; ``lane_config[m]`` / ``lane_shard[m]`` map a
    # lane back to its (config, shard) and ``lane_commands[m]`` is its
    # command budget (largest-remainder split of ``n_commands`` by the
    # shard traffic weights).  All None when no ShardingSpec was given.
    sharding: Optional[ShardingSpec] = None
    lane_config: Optional[np.ndarray] = None   # [M] config index
    lane_shard: Optional[np.ndarray] = None    # [M] shard index
    lane_commands: Optional[np.ndarray] = None  # [M] per-lane op budget
    # Geo axis (``geo=`` runs only, mutually exclusive with sharding):
    # rows become M_cfg x n_regions lanes in config-major order - one
    # closed-loop client population per region, command budgets split by
    # the region client weights.  ``wan_offset[m]`` is the lane's
    # analytical WAN latency excess (repro_torch.core.geo.wan_offsets;
    # zero for a uniform matrix), already folded into latency_mean/p50/p99
    # and bin_edges.
    geo: Optional[Any] = None
    lane_region: Optional[np.ndarray] = None   # [M] region index
    wan_offset: Optional[np.ndarray] = None    # [M]
    # Host wall-clock seconds of the run's phases: "probe" (real-cluster
    # calibration), "scan" (the device step loop, synchronised) and
    # "hist" (binning + the float64 latency sums, synchronised).
    timings: Optional[Dict[str, float]] = None

    def __len__(self) -> int:
        return len(self.configs)

    def variant(self, m: int) -> str:
        return config_variant(self.configs[m])

    def shard_lanes(self, config_index: int = 0) -> np.ndarray:
        """Row indices of config ``config_index``'s shard (or region)
        lanes - the whole row range when the run was neither sharded nor
        geo-replicated."""
        if self.lane_config is None:
            return np.asarray([config_index])
        return np.nonzero(self.lane_config == config_index)[0]

    def region_latency(self, config_index: int = 0,
                       which: str = "p99") -> Dict[str, float]:
        """Seed-mean latency per client-bearing region for one config
        (geo runs only).  ``which`` is ``"mean"``, ``"p50"`` or
        ``"p99"``."""
        if self.geo is None or self.lane_region is None:
            raise ValueError("region_latency needs a geo= run")
        stat = {"mean": self.latency_mean, "p50": self.latency_p50,
                "p99": self.latency_p99}[which]
        out: Dict[str, float] = {}
        for lane in self.shard_lanes(config_index):
            if self.lane_commands is not None \
                    and self.lane_commands[lane] == 0:
                continue  # no clients in this region
            region = self.geo.regions[int(self.lane_region[lane])]
            out[region] = float(stat[lane].mean())
        return out

    def sharded_throughput(self, config_index: int = 0) -> np.ndarray:
        """Aggregate cmds/s of one config across its shard lanes, per
        seed.  Shard groups are independent clusters draining their
        traffic fractions concurrently, so the system rate is the sum of
        the per-shard rates."""
        return self.throughput[self.shard_lanes(config_index)].sum(axis=0)

    def station_row(self, m: int) -> Dict[str, float]:
        """Measured msgs/cmd/server of config m, keyed by station name
        (nonzero columns only) - the same vocabulary as
        ``ExecutionTrace.station_msgs``."""
        return {STATION_ORDER[k]: float(v)
                for k, v in enumerate(self.station_msgs[m]) if v > 0.0}

    def describe(self, m: int = 0) -> str:
        pairs = ", ".join(f"{s} {d:.2f}"
                          for s, d in self.station_row(m).items())
        return (f"{self.variant(m)}: {self.n_commands} cmds x "
                f"{len(self.seeds)} seeds ({int(self.n_writes[m])} writes); "
                f"msgs/cmd/server: {pairs}; "
                f"p50 {self.latency_p50[m].mean():.2e}s "
                f"p99 {self.latency_p99[m].mean():.2e}s")


@dataclass(frozen=True)
class _Lowered:
    """A config grid lowered to the engine's numpy inputs (host side)."""

    configs: Tuple[Config, ...]
    workload: Workload
    seeds: np.ndarray                # [S]
    alpha: float
    lane_n: np.ndarray               # [M] per-lane op budget
    lane_cfg: np.ndarray             # [M]
    lane_shard: np.ndarray           # [M]
    sharded: bool
    geoed: bool
    wan_off: np.ndarray              # [M]
    cost_w: np.ndarray               # [M, K]
    cost_r: np.ndarray               # [M, K]
    n_writes: np.ndarray             # [M]
    d_w: np.ndarray                  # [M, K]
    d_r: np.ndarray                  # [M, K]
    entry: np.ndarray                # [M]
    nxt: np.ndarray                  # [M, K]
    cls: np.ndarray                  # [M, S, N, n_ops]
    budget: np.ndarray               # [M, N]
    dt: np.ndarray                   # [M]
    edges: np.ndarray                # [M, B + 1] float64
    n_steps: int
    probe_s: float


def _lower_configs(configs: Sequence[Config], w: Workload,
                   n_commands: int, seeds_arr: np.ndarray, n_clients: int, *,
                   alpha: Optional[float] = None,
                   probe_n: Optional[int] = None, probe_seed: int = 7919,
                   exponential_service: bool = False,
                   oversample: float = 4.0, n_bins: int = 64,
                   state_machine: str = "kv", max_steps: int = 200_000,
                   sharding: Optional[ShardingSpec] = None,
                   geo: Optional[Any] = None) -> _Lowered:
    """Probe-calibrate every config and lower the grid to lane inputs,
    the step bound and the latency bin edges.  The keyword defaults are
    :func:`execute_configs`'s (a test holds them equal)."""
    t0 = time.perf_counter()
    n_probe = probe_n if probe_n is not None else n_commands
    k = len(STATION_ORDER)
    n_cfg = len(configs)
    a = alpha if alpha is not None else calibrate_alpha()

    sharded = sharding is not None and sharding.n_shards > 1
    geoed = geo is not None and geo.n_regions > 1
    n_sh = (sharding.n_shards if sharded
            else geo.n_regions if geoed else 1)
    if sharded:
        lane_n = np.tile(split_counts(n_commands, shard_weights(sharding, w)),
                         n_cfg).astype(np.int64)
    elif geoed:
        lane_n = np.tile(
            split_counts(n_commands,
                         np.asarray(geo.resolved_client_weights())),
            n_cfg).astype(np.int64)
    else:
        lane_n = np.full((n_cfg,), n_commands, dtype=np.int64)
    m = n_cfg * n_sh
    lane_cfg = np.repeat(np.arange(n_cfg), n_sh)
    lane_shard = np.tile(np.arange(n_sh), n_cfg)

    wan_off = np.zeros((m,))
    if geo is not None:
        from .geo import wan_offsets
        for i, raw in enumerate(configs):
            cfg = dict(raw)
            cfg.setdefault("variant", "compartmentalized")
            off = wan_offsets(cfg, geo, workload=w, n_clients=n_clients)
            wan_off[i * n_sh:(i + 1) * n_sh] = np.asarray(off)[:n_sh]

    cost_w = np.zeros((n_cfg, k))
    cost_r = np.zeros((n_cfg, k))
    d_w_cfg = np.zeros((n_cfg, k))
    d_r_cfg = np.zeros((n_cfg, k))
    f_eff = np.zeros((n_cfg,))
    for i, raw in enumerate(configs):
        cfg = dict(raw)
        cfg.setdefault("variant", "compartmentalized")
        name = config_variant(cfg)
        spec = variant_spec(name)
        if spec.executable is None:
            raise ValueError(
                f"config {i}: variant {name!r} declares no execution plane")
        exe = spec.executable
        cost_w[i], cost_r[i], _ = _probe_costs(
            name, cfg, w, exe, n_probe, probe_seed, state_machine)
        dw_row, dr_row, _ = spec.model(cfg, w).demand_slots()
        d_w_cfg[i, :len(dw_row)] = np.asarray(dw_row[:k]) / a
        d_r_cfg[i, :len(dr_row)] = np.asarray(dr_row[:k]) / a
        f_eff[i] = 1.0 if exe.reads_as_writes else w.f_write

    # expand configs to lanes: shards of a config share its probe costs
    # and per-command demands - a shard runs the full deployment, it just
    # sees a fraction of the traffic
    cost_w = np.repeat(cost_w, n_sh, axis=0)
    cost_r = np.repeat(cost_r, n_sh, axis=0)
    d_w = np.repeat(d_w_cfg, n_sh, axis=0)
    d_r = np.repeat(d_r_cfg, n_sh, axis=0)
    f_eff = np.repeat(f_eff, n_sh)

    cls_all: List[np.ndarray] = []
    budget_all: List[np.ndarray] = []
    n_writes = np.zeros((m,), dtype=np.int64)
    for i in range(m):
        cls, budget, n_w = _class_streams(int(lane_n[i]), f_eff[i],
                                          n_clients, seeds_arr,
                                          base_seed=probe_seed + i)
        cls_all.append(cls)
        budget_all.append(budget)
        n_writes[i] = n_w
    length = max(c.shape[2] for c in cls_all)
    cls_all = [np.pad(c, ((0, 0), (0, 0), (0, length - c.shape[2])))
               for c in cls_all]

    blend = f_eff[:, None] * d_w + (1.0 - f_eff[:, None]) * d_r
    # station activity is a property of the *config's* mix, not of any one
    # shard's integer split: a zero-command lane still routes through its
    # config's active stations (and trivially drains nothing)
    cfg_w = np.zeros((m,), dtype=bool)
    cfg_r = np.zeros((m,), dtype=bool)
    for i in range(n_cfg):
        rows = slice(i * n_sh, (i + 1) * n_sh)
        cfg_w[rows] = bool(n_writes[rows].sum() > 0)
        cfg_r[rows] = bool(n_writes[rows].sum() < int(lane_n[rows].sum()))
    active = ((cfg_w[:, None] & (d_w > 0))
              | (cfg_r[:, None] & (d_r > 0)))               # [M, K]
    entry, nxt = _routing(active)
    dt = blend.max(axis=1) / oversample
    if np.any(dt <= 0):
        raise ValueError("a config row has zero effective demand")

    # deterministic makespan bound: each station serves every command at
    # most once, plus one step per (command, station) for instant drains
    d_hot = np.where(active, np.maximum(d_w, d_r), 0.0)
    span = (lane_n + n_clients) * d_hot.sum(axis=1)
    steps = span / dt + (lane_n + n_clients) * active.sum(axis=1)
    margin = 4.0 if exponential_service else 1.3
    n_steps = int(math.ceil(margin * float(steps.max()))) + 8
    # rounded up to a multiple of 256, as the reference does; it also sets
    # the top bin edge below, so the port keeps it
    n_steps = -(-n_steps // 256) * 256
    if n_steps > max_steps:
        raise ValueError(
            f"execute_configs: bound of {n_steps} steps exceeds max_steps="
            f"{max_steps}; raise max_steps or shrink the grid")

    rtt = np.maximum((blend * active).sum(axis=1), 1e-12)
    lo = rtt * 0.5
    hi = np.maximum(n_steps * dt, lo * 10.0)
    ratio = (hi / lo) ** (1.0 / n_bins)
    edges = lo[:, None] * ratio[:, None] ** np.arange(n_bins + 1)[None, :]

    return _Lowered(
        configs=tuple(configs), workload=w, seeds=seeds_arr, alpha=a,
        lane_n=lane_n, lane_cfg=lane_cfg, lane_shard=lane_shard,
        sharded=sharded, geoed=geoed, wan_off=wan_off, cost_w=cost_w,
        cost_r=cost_r, n_writes=n_writes, d_w=d_w, d_r=d_r, entry=entry,
        nxt=nxt, cls=np.stack(cls_all), budget=np.stack(budget_all), dt=dt,
        edges=edges, n_steps=n_steps,
        probe_s=time.perf_counter() - t0)


def _lane_inputs(low: _Lowered, device) -> LaneInputs:
    return lane_inputs_from_numpy(low.d_w, low.d_r, low.entry, low.nxt,
                                  low.cls, low.budget, low.dt, low.seeds,
                                  device=device)


def _lane_edges(low: _Lowered, device) -> torch.Tensor:
    """[M * S, B + 1] float32 bin edges per lane: samples are binned against
    float32 edges, as the reference's device arrays hold them."""
    e = np.repeat(low.edges, low.seeds.size, axis=0).astype(np.float32)
    return torch.from_numpy(e).to(device)


def execute_configs(
    configs: Sequence[Config],
    workload: Optional[Union[Workload, float]] = None,
    n_commands: int = 48,
    seeds: Union[int, Sequence[int]] = 4,
    n_clients: int = 8,
    alpha: Optional[float] = None,
    probe_n: Optional[int] = None,
    probe_seed: int = 7919,
    exponential_service: bool = False,
    oversample: float = 4.0,
    n_bins: int = 64,
    state_machine: str = "kv",
    max_steps: int = 200_000,
    sharding: Optional[ShardingSpec] = None,
    geo: Optional[Any] = None,
    device=None,
) -> BatchedExecutionResult:
    """Execute a grid of registered-variant configs as one batched device
    run of closed-loop client populations.

    Per config: probe-calibrate per-class per-station message costs off
    the real cluster (:func:`run_variant` at ``probe_n``/``probe_seed``,
    disjoint from reference runs), lower the variant's demand table to
    per-class service times, build per-seed op-class streams at the exact
    generator mix, then run every (config x seed) lane through ONE batched
    device step loop and histogram the emitted latency samples with the
    CUDA :func:`repro_torch.kernels.ops.latency_hist` kernel (its plain
    version on ``device="cpu"``).

    ``exponential_service=False`` (default) is the parity mode: service is
    deterministic, the makespan is bounded, and every lane provably drains
    its budget.  ``True`` matches the MVA product-form assumptions for
    latency-surface work; its draws come from a ``torch.Generator`` seeded
    from ``seeds``.

    With a :class:`~repro_torch.core.api.ShardingSpec` each config expands
    to ``n_shards`` lanes - independent shard groups sharing the config's
    probe calibration, each draining its largest-remainder slice of
    ``n_commands`` (per the shard traffic weights) behind its own client
    population.  Rows of the result are then (config x shard) in
    config-major order; ``lane_config`` / ``lane_shard`` /
    ``lane_commands`` map them back and
    :meth:`BatchedExecutionResult.sharded_throughput` aggregates.

    With a :class:`~repro_torch.core.api.GeoSpec` (mutually exclusive with
    sharding) each config instead expands to ``n_regions`` lanes - one
    closed-loop client population per region, command budgets split by
    the region client weights - and every lane's latency statistics
    (mean/p50/p99/histogram edges) carry the analytical WAN latency
    *excess* of its region (:func:`repro_torch.core.geo.wan_offsets`, same
    units as ``1 / alpha``; exactly zero for a uniform matrix).  The
    queueing part stays measured; the WAN part is deterministic wire time
    the step engine has no wires for."""
    if not configs:
        raise ValueError("execute_configs: empty config list")
    if geo is not None and sharding is not None:
        raise ValueError(
            "execute_configs: geo= and sharding= are mutually exclusive "
            "(region lanes and shard lanes both multiply the row axis)")
    dev = resolve_device(device)
    w = resolve_workload(workload, where="execute_configs")
    if isinstance(seeds, (int, np.integer)):
        seeds_arr = np.arange(int(seeds), dtype=np.int32)
    else:
        seeds_arr = np.asarray(list(seeds), dtype=np.int32)
    if seeds_arr.size == 0:
        raise ValueError("execute_configs: need at least one seed")

    low = _lower_configs(configs, w, n_commands, seeds_arr, n_clients,
                         alpha=alpha, probe_n=probe_n, probe_seed=probe_seed,
                         exponential_service=exponential_service,
                         oversample=oversample, n_bins=n_bins,
                         state_machine=state_machine, max_steps=max_steps,
                         sharding=sharding, geo=geo)
    m, s, n_steps = low.lane_n.size, seeds_arr.size, low.n_steps

    t0 = time.perf_counter()
    fin, lat, done_w_t, done_r_t, t_last_t = _execute_batch(
        _lane_inputs(low, dev), n_clients=n_clients, n_steps=n_steps,
        exponential=bool(exponential_service))
    done_w = done_w_t.cpu().numpy().reshape(m, s).astype(np.int64)
    scan_s = time.perf_counter() - t0
    done_r = done_r_t.cpu().numpy().reshape(m, s).astype(np.int64)
    done = done_w + done_r
    lane_n = low.lane_n
    if not np.all(done == lane_n[:, None]):
        short = np.argwhere(done != lane_n[:, None])
        raise RuntimeError(
            f"execute_configs: lanes {short.tolist()} drained "
            f"{done[tuple(short.T)].tolist()} of their op budgets in "
            f"{n_steps} steps - raise oversample margin or max_steps")

    t0 = time.perf_counter()
    hist = latency_hist(lat.view(m * s, -1), fin.view(m * s, -1),
                        _lane_edges(low, dev))
    hist = hist.cpu().numpy().reshape(m, s, n_bins)
    lat_sum = _masked_sum_f64(lat, fin).cpu().numpy().reshape(m, s)
    hist_s = time.perf_counter() - t0
    t_last = t_last_t.cpu().numpy().reshape(m, s).astype(np.float64)
    del fin, lat

    edges = low.edges
    wan_off = low.wan_off
    if geo is not None:
        # shift the (geometric) bin edges by each lane's deterministic WAN
        # offset AFTER binning: a sample in [e_k, e_k+1) is in
        # [e_k + wan, e_k+1 + wan) of the shifted edges, so histogram and
        # quantiles both read as total (wire + queueing) latency
        edges = edges + wan_off[:, None]

    # completion-weighted blend of the probe-calibrated per-class costs:
    # the measured msgs/cmd surface (float64, so exact stations stay exact)
    msgs = (done_w[:, 0, None] * low.cost_w
            + done_r[:, 0, None] * low.cost_r) / np.maximum(lane_n, 1)[:, None]

    sharded, geoed = low.sharded, low.geoed
    return BatchedExecutionResult(
        configs=tuple(dict(configs[int(ci)]) for ci in low.lane_cfg),
        workload=w,
        n_commands=n_commands,
        n_clients=n_clients,
        seeds=seeds_arr,
        station_msgs=msgs,
        n_writes=done_w[:, 0].copy(),
        cost_write=low.cost_w,
        cost_read=low.cost_r,
        throughput=lane_n[:, None] / np.maximum(t_last, 1e-30),
        latency_mean=lat_sum / np.maximum(done, 1) + wan_off[:, None],
        latency_p50=_quantile_from_hist(hist, edges, 0.50),
        latency_p99=_quantile_from_hist(hist, edges, 0.99),
        completed=done.astype(np.float64),
        hist=hist,
        bin_edges=edges,
        dt=low.dt,
        n_steps=n_steps,
        alpha=low.alpha,
        sharding=sharding if sharded else None,
        lane_config=low.lane_cfg if (sharded or geoed) else None,
        lane_shard=low.lane_shard if sharded else None,
        lane_commands=lane_n if (sharded or geoed) else None,
        geo=geo,
        lane_region=low.lane_shard if geoed else None,
        wan_offset=wan_off if geo is not None else None,
        timings={"probe": low.probe_s, "scan": scan_s, "hist": hist_s},
    )


def run_variant_batched(name: str,
                        config: Optional[Config] = None,
                        workload: Optional[Union[Workload, float]] = None,
                        n_commands: int = 48,
                        seeds: Union[int, Sequence[int]] = 4,
                        n_clients: Optional[int] = None,
                        **kwargs: Any) -> BatchedExecutionResult:
    """One variant config through the batched executor (M = 1): the
    batched sibling of :func:`repro_torch.core.execution.run_variant`."""
    spec = variant_spec(name)
    if spec.executable is None:
        raise ValueError(
            f"variant {name!r} declares no execution plane; the batched "
            f"executor drives registered executables only")
    cfg = dict(config) if config is not None else default_config(name)
    cfg.setdefault("variant", name)
    n_cl = n_clients if n_clients is not None else spec.executable.n_clients
    return execute_configs([cfg], workload=workload, n_commands=n_commands,
                           seeds=seeds, n_clients=n_cl, **kwargs)


def measured_capacity(name: str,
                      config: Optional[Config] = None,
                      workload: Optional[Union[Workload, float]] = None,
                      n_commands: int = 96,
                      seeds: Union[int, Sequence[int]] = 3,
                      n_clients: Optional[int] = None,
                      **kwargs: Any) -> float:
    """Saturated cmds/s of one variant config off the batched executor:
    the execution-plane twin of the transient capacity anchor.

    A closed population this deep pins the bottleneck station near full
    utilization, so the seed-mean makespan rate IS the config's peak
    service rate - the ``lam_peak`` an :class:`~repro_torch.core.api.\
AutoscalePolicy` band is anchored against, only measured on the
    message-level cluster instead of the token simulator."""
    spec = variant_spec(name)
    n_cl = n_clients if n_clients is not None else max(
        8, 2 * spec.executable.n_clients if spec.executable else 8)
    res = run_variant_batched(name, config=config, workload=workload,
                              n_commands=n_commands, seeds=seeds,
                              n_clients=n_cl, **kwargs)
    return float(res.throughput[0].mean())


# ---------------------------------------------------------------------------
# Parity: batched-measured vs analytical (the validate_variant analogue)
# ---------------------------------------------------------------------------


@dataclass
class BatchedParityReport:
    """Measured-vs-analytical msgs/cmd parity for one batched config."""

    variant: str
    config: Config
    model_config: Config
    workload: Workload
    rows: Tuple[StationParity, ...]
    result: BatchedExecutionResult

    @property
    def passed(self) -> bool:
        return all(r.ok for r in self.rows)

    def row(self, station: str) -> StationParity:
        for r in self.rows:
            if r.station == station:
                return r
        raise KeyError(f"no parity row for station {station!r}")

    def max_rel_err(self) -> float:
        return max((r.rel_err for r in self.rows), default=0.0)

    def __str__(self) -> str:
        lines = [f"{self.variant} @ {self.workload.describe()} [batched]: "
                 f"{'PASS' if self.passed else 'FAIL'}"]
        lines += [f"  {r.describe()}" for r in self.rows]
        return "\n".join(lines)


def validate_batched(name: str,
                     config: Optional[Config] = None,
                     workload: Optional[Union[Workload, float]] = None,
                     n_commands: int = 48,
                     seeds: Union[int, Sequence[int]] = 4,
                     **kwargs: Any) -> BatchedParityReport:
    """Parity-check the batched executor's measured per-station msgs/cmd
    against the variant's analytical demand table - the
    :func:`~repro_torch.core.execution.validate_variant` analogue on the
    batched plane, with the same feedback loop: measured-parameter
    refinement comes off a real probe run of this very grid cell."""
    spec = variant_spec(name)
    if spec.executable is None:
        raise ValueError(f"variant {name!r} declares no execution plane")
    exe = spec.executable
    cfg = dict(config) if config is not None else default_config(name)
    cfg.setdefault("variant", name)
    w = resolve_workload(workload, where="validate_batched")
    res = run_variant_batched(name, cfg, w, n_commands=n_commands,
                              seeds=seeds, **kwargs)

    model_cfg = spec.adapt(cfg, w)
    if exe.model_feedback is not None:
        # the feedback statistics (skip rates, forwarding fractions) come
        # off a fresh probe run at this config - same loop as the scalar
        # plane, measured not assumed
        probe = run_variant(name, cfg,
                            replace(w, f_write=1.0) if exe.reads_as_writes
                            else w,
                            n_commands=n_commands,
                            seed=kwargs.get("probe_seed", 7919))
        model_cfg = exe.model_feedback(dict(model_cfg), probe)
    if res.geo is not None and res.lane_config is not None:
        # geo runs fan the config into region lanes; parity is against the
        # command-weighted aggregate (regions share the config's costs)
        lanes = res.shard_lanes(0)
        weights = res.lane_commands[lanes].astype(float)
        nw = float(res.n_writes[lanes].sum())
        agg = ((res.station_msgs[lanes] * weights[:, None]).sum(axis=0)
               / max(weights.sum(), 1.0))
        measured = {STATION_ORDER[j]: float(v)
                    for j, v in enumerate(agg) if v > 0.0}
    else:
        nw = float(res.n_writes[0])
        measured = res.station_row(0)
    realized = replace(w, f_write=nw / n_commands)
    predicted = spec.build(model_cfg).demands(realized)

    stations = list(measured)
    stations += [s for s, d in predicted.items()
                 if s not in measured and d > 0.0]
    rows = []
    for station in sorted(stations, key=STATION_ORDER.index):
        mm = measured.get(station, 0.0)
        p = predicted.get(station, 0.0)
        exact = station in exe.exact_stations
        tol = exe.tolerance_for(station)
        rel = abs(mm - p) / max(abs(p), 1e-12)
        ok = abs(mm - p) <= 1e-9 if exact else rel <= tol
        rows.append(StationParity(station=station, measured=mm, predicted=p,
                                  rel_err=rel, tolerance=tol, exact=exact,
                                  ok=ok))
    return BatchedParityReport(variant=name, config=cfg,
                               model_config=model_cfg, workload=w,
                               rows=tuple(rows), result=res)

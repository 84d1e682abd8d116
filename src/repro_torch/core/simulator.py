"""PyTorch performance simulators for the protocol deployments.

Two engines, both deterministic:

* :func:`mva_curve` - exact Mean Value Analysis of the closed queueing
  network induced by a deployment's demand table (N closed-loop clients, one
  outstanding command each - exactly the paper's benchmark setup).  One
  kernel launch over the client count, batched over deployments, so one
  call sweeps a whole latency-throughput figure (paper Fig. 28).

* :func:`fluid_throughput` - a slot-stepped fluid simulation of the same
  network (service-rate-limited token buckets per station).  Independent
  dynamics from MVA; used as a cross-check.

Both device engines run in float32, each step in the reference's order,
so they agree with the JAX package (which never enables x64) to float32
rounding; on the card each is one launch of a hand-written kernel
(``kernels/csrc/mva_scan.cu``, ``kernels/csrc/fluid_scan.cu``), equal bit
for bit to its plain loop, which the CPU runs.  Service demands come from
:mod:`repro_torch.core.analytical`; time units are ``1/alpha`` (one
message's processing time).  Every entry point that touches a device
takes ``device=None``, which means ``cuda``: without a card it raises
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from .analytical import DeploymentModel
from .device import resolve_device


def demand_vector(model: DeploymentModel, f_write: float = 1.0) -> np.ndarray:
    """Per-station service demand of one command (units of 1/alpha)."""
    return np.array([s.demand(f_write) for s in model.stations], dtype=np.float64)


def _device_demands(demands: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The [M, K] demand matrix rounded to float32 on the host (as the
    reference's float32 arrays hold it) and copied to ``dev`` once."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(demands, dtype=np.float64), dtype=np.float32)).to(dev)


def _mva_scan_batch(demands: torch.Tensor, think: float, n_max: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact single-class MVA over a [M, K] float32 demand matrix for
    N = 1..n_max: ``ops.mva_scan``, one launch of the hand-written kernel
    on the card and its plain loop on the CPU, bit for bit the same.

    Zero-demand columns are inert (they add nothing to residence time), so
    heterogeneous deployments padded to a common K evaluate exactly as their
    unpadded selves.  Returns (X[M, n_max], R[M, n_max]) float32."""
    return ops.mva_scan(demands, think, n_max)


def mva_curve(model: DeploymentModel, alpha: float, n_clients_max: int = 512,
              f_write: float = 1.0, think: float = 0.0, device=None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(clients, throughput cmds/s, median-ish latency seconds) curves."""
    d = demand_vector(model, f_write) / alpha
    clients, xs, rs = mva_curves_from_demands(d[None, :], n_clients_max,
                                              think=think, device=device)
    return clients, xs[0], rs[0]


def mva_curves_from_demands(demands: np.ndarray, n_clients_max: int = 512,
                            think: float = 0.0, device=None
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched MVA straight from a [M, K] demand matrix (units: seconds per
    command per station, i.e. already divided by alpha).  One kernel
    launch regardless of M - the engine the sweep drives with thousands of
    compiled configs at once.  Returns (clients, X[M, N], R[M, N])."""
    dev = resolve_device(device)
    xs, rs = _mva_scan_batch(_device_demands(demands, dev), think,
                             n_clients_max)
    return (np.arange(1, n_clients_max + 1), xs.cpu().numpy(),
            rs.cpu().numpy())


def _padded_demands(models: Sequence[DeploymentModel], alpha: float,
                    f_write: float) -> np.ndarray:
    """[M, K] demand matrix, padded to the widest station count."""
    ds = [demand_vector(m, f_write) / alpha for m in models]
    k = max(len(d) for d in ds)
    return np.stack([np.pad(d, (0, k - len(d))) for d in ds])


def mva_curves_batch(models: Sequence[DeploymentModel], alpha: float,
                     n_clients_max: int = 512, f_write: float = 1.0,
                     device=None
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched MVA over several deployments (padded to a common station
    count), one kernel launch.  Returns (clients, X[m, N], R[m, N])."""
    return mva_curves_from_demands(_padded_demands(models, alpha, f_write),
                                   n_clients_max, device=device)


# ---------------------------------------------------------------------------
# Fluid (slot-stepped) simulation
# ---------------------------------------------------------------------------


def _fluid_scan_batch(demands: torch.Tensor, n_clients: float, dt: float,
                      n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipeline fluid model over a [M, K] float32 demand matrix:
    ``ops.fluid_scan``, one launch of the hand-written kernel on the card
    and its plain loop on the CPU, bit for bit the same.

    State: q[M, K] work queued at each station (in commands), plus a pool
    of clients with one outstanding command each.  Commands flow client ->
    station 0 -> ... -> station K-1 -> client.  Each station drains at rate
    1/demand_k per unit time (aggregate, demand already per-server).
    Zero-demand stations serve at infinite rate, so canonical-slot padding
    is inert.  Returns (done[M], flows[M, n_steps])."""
    return ops.fluid_scan(demands, n_clients, dt, n_steps)


def fluid_throughput(model: DeploymentModel, alpha: float, n_clients: int,
                     f_write: float = 1.0, sim_time: float = 1.0,
                     n_steps: int = 2000, device=None) -> float:
    """Steady-state throughput (cmds/s) of the fluid pipeline."""
    d = demand_vector(model, f_write) / alpha
    return float(fluid_throughput_from_demands(
        d[None, :], n_clients, sim_time, n_steps, device=device)[0])


def fluid_throughput_from_demands(demands: np.ndarray, n_clients: int,
                                  sim_time: float = 1.0, n_steps: int = 2000,
                                  device=None) -> np.ndarray:
    """Batched fluid throughput (cmds/s) straight from a [M, K] demand
    matrix (seconds per command per station), one kernel launch.
    Returns X[M], measured over the second half (post-transient)."""
    dev = resolve_device(device)
    dt = sim_time / n_steps
    _, flows = _fluid_scan_batch(_device_demands(demands, dev),
                                 float(n_clients), dt, n_steps)
    half = n_steps // 2
    return flows.cpu().numpy()[:, half:].sum(axis=1) / (dt * (n_steps - half))


def fluid_throughput_batch(models: Sequence[DeploymentModel], alpha: float,
                           n_clients: int, f_write: float = 1.0,
                           sim_time: float = 1.0, n_steps: int = 2000,
                           device=None) -> np.ndarray:
    """Steady-state fluid throughput (cmds/s) of several deployments in one
    kernel launch.  Returns X[M]."""
    return fluid_throughput_from_demands(
        _padded_demands(models, alpha, f_write), n_clients, sim_time, n_steps,
        device=device)


# ---------------------------------------------------------------------------
# Discrete-event cross-validation (numpy; exact FIFO multi-server queues)
# ---------------------------------------------------------------------------


def des_throughput(model: DeploymentModel, alpha: float, n_clients: int,
                   f_write: float = 1.0, n_commands: int = 20_000,
                   seed: int = 0, deterministic_service: bool = True,
                   warmup_commands: Optional[int] = None
                   ) -> Tuple[float, float]:
    """Event-driven simulation of the closed network.  Returns
    (throughput cmds/s, mean latency s), both measured over a post-warmup
    window (the first ``warmup_commands`` completions - default 10% - are
    discarded, so the cold-start ramp where all N clients burst into
    station 0 at t=0 doesn't bias the steady-state estimate this function
    cross-validates against MVA/fluid and the transient engine)."""
    import heapq

    rng = np.random.default_rng(seed)
    if warmup_commands is None:
        warmup_commands = n_commands // 10
    demands = demand_vector(model, f_write) / alpha  # seconds per station
    k = len(demands)
    servers = np.array([s.servers for s in model.stations])
    # each station: per-server demand d means one server finishes a command
    # in d*servers... demands are already per-server shares of the command;
    # total work per command at station = d * servers, split across servers.
    work = demands * servers

    free_at = [np.zeros(s) for s in servers]  # next-free time per server
    events: List[Tuple[float, int, int, int]] = []  # (time, seq, cmd, stage)
    seq = 0
    for c in range(n_clients):
        heapq.heappush(events, (0.0, seq, c, 0))
        seq += 1
    start = np.zeros(n_clients)
    done = 0
    measured = 0
    total_latency = 0.0
    t = 0.0
    t_warm = 0.0
    while done < n_commands and events:
        t, _, cmd, stage = heapq.heappop(events)
        if stage == 0:
            start[cmd] = t
        if stage == k:
            done += 1
            if done <= warmup_commands:
                t_warm = t
            else:
                measured += 1
                total_latency += t - start[cmd]
            heapq.heappush(events, (t, seq, cmd, 0))
            seq += 1
            continue
        svc = work[stage]
        if not deterministic_service:
            svc = rng.exponential(svc)
        i = int(np.argmin(free_at[stage]))
        begin = max(t, free_at[stage][i])
        finish = begin + svc
        free_at[stage][i] = finish
        heapq.heappush(events, (finish, seq, cmd, stage + 1))
        seq += 1
    throughput = measured / (t - t_warm) if t > t_warm else 0.0
    return throughput, total_latency / max(measured, 1)

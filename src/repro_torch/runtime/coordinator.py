"""RSM-backed training coordinator: the paper's control plane driving the
data plane (port of ``runtime/coordinator.py``, copied whole with its
imports moved to the port's ``core``).

The coordinator is a *replicated state machine over training-control
commands*, ordered by compartmentalized MultiPaxos (repro_torch.core):

    ("step_commit", step, worker_digest)   - global step barrier record
    ("ckpt_commit", step, manifest_id)     - checkpoint becomes restorable
    ("join", worker) / ("leave", worker)   - elastic membership
    ("noop_fill", worker, step)            - Mencius-style straggler skip

Why an RSM?  At 1000+ nodes the coordinator must survive node failures and
partitions; commands are tiny (ids and digests - the S-Paxos control path),
while tensors move through collectives and the checkpoint grid (data path).
The log is the single source of truth for "which step/checkpoint is
committed", exactly like the paper's replicas executing a deterministic log.

Straggler policy (paper section 6, Mencius): each training step owns one
log slot per worker report; a worker lagging more than ``skip_after`` steps
behind the frontier gets its slots noop-filled - the step commits with a
``scale_factor`` recording the missing microbatch fraction (bounded
staleness, keeps the log hole-free so commits never stall on one slow
host).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from ..core.protocols import (
    CompartmentalizedMultiPaxos,
    DeploymentConfig,
)
from ..core.statemachine import StateMachine


@dataclass
class ClusterView:
    """Deterministic state produced by replaying the control log."""
    workers: List[str] = field(default_factory=list)
    committed_step: int = -1
    step_reports: Dict[int, Set[str]] = field(default_factory=dict)
    step_noops: Dict[int, Set[str]] = field(default_factory=dict)
    committed_ckpt: Optional[int] = None
    generation: int = 0  # bumps on membership change -> mesh rebuild


def apply_command(view: ClusterView, op: Tuple) -> Any:
    kind = op[0]
    if kind == "join":
        _, worker = op
        if worker not in view.workers:
            view.workers.append(worker)
            view.generation += 1
        return ("joined", view.generation)
    if kind == "leave":
        _, worker = op
        if worker in view.workers:
            view.workers.remove(worker)
            view.generation += 1
        return ("left", view.generation)
    if kind == "report":
        _, worker, step = op
        view.step_reports.setdefault(step, set()).add(worker)
        return _maybe_commit(view, step)
    if kind == "noop_fill":
        _, worker, step = op
        view.step_noops.setdefault(step, set()).add(worker)
        return _maybe_commit(view, step)
    if kind == "ckpt_commit":
        _, step = op
        view.committed_ckpt = step
        return ("ckpt", step)
    raise ValueError(f"unknown control op {op!r}")


def _maybe_commit(view: ClusterView, step: int):
    done = view.step_reports.get(step, set()) | view.step_noops.get(step, set())
    if set(view.workers) <= done and view.workers:
        if step == view.committed_step + 1:
            view.committed_step = step
            # roll forward through any already-complete successors
            nxt = step + 1
            while (set(view.workers)
                   <= (view.step_reports.get(nxt, set())
                       | view.step_noops.get(nxt, set()))):
                view.committed_step = nxt
                nxt += 1
        n_noop = len(view.step_noops.get(step, set()))
        scale = 1.0 - n_noop / max(len(view.workers), 1)
        return ("committed", view.committed_step, scale)
    return ("pending", view.committed_step, None)


class ControlStateMachine(StateMachine):
    """Adapter: the repro_torch.core replica state-machine interface."""

    def __init__(self) -> None:
        self.view = ClusterView()

    def apply(self, op: Tuple) -> Any:
        if op and op[0] == "put_control":  # client write wrapper
            op = op[1]
        return apply_command(self.view, op)

    def is_read(self, op: Tuple) -> bool:
        return op[0] == "read_view"

    def snapshot(self) -> Any:
        return json.dumps({
            "workers": self.view.workers,
            "committed_step": self.view.committed_step,
            "generation": self.view.generation,
            "committed_ckpt": self.view.committed_ckpt,
        })

    def restore(self, snap: Any) -> None:
        d = json.loads(snap)
        self.view = ClusterView(workers=list(d["workers"]),
                                committed_step=d["committed_step"],
                                generation=d["generation"],
                                committed_ckpt=d["committed_ckpt"])


class TrainingCoordinator:
    """Drives training-control commands through a compartmentalized RSM.

    ``skip_after``: a worker whose last report is more than this many steps
    behind the frontier gets noop-filled (straggler mitigation)."""

    def __init__(self, n_workers: int, skip_after: int = 2, seed: int = 0,
                 n_proxy_leaders: int = 3, grid: Tuple[int, int] = (2, 2)):
        cfg = DeploymentConfig(f=1, n_proxy_leaders=n_proxy_leaders, grid=grid,
                               n_replicas=2, state_machine="kv", seed=seed)
        # replace the KV state machine with the control state machine
        self.rsm = CompartmentalizedMultiPaxos(cfg, n_clients=1)
        for replica in self.rsm.replicas:
            replica.sm = ControlStateMachine()
        self.client = self.rsm.clients[0]
        self.skip_after = skip_after
        self.n_workers = n_workers
        self._submitted: List[Tuple] = []
        for w in range(n_workers):
            self.submit(("join", f"worker/{w}"))

    # -- command plumbing ------------------------------------------------------
    def submit(self, op: Tuple) -> Any:
        self.client.run_ops([("put_control", op)])
        # control ops are writes through the leader; KVStore semantics are
        # bypassed - replicas run ControlStateMachine.apply on the op payload
        self.rsm.run_to_quiescence()
        return self.client.results[-1]

    @property
    def view(self) -> ClusterView:
        return self.rsm.replicas[0].sm.view  # type: ignore[attr-defined]

    # -- training-facing API -------------------------------------------------------
    def report_step(self, worker: int, step: int) -> Any:
        return self.submit(("report", f"worker/{worker}", step))

    def commit_checkpoint(self, step: int) -> Any:
        return self.submit(("ckpt_commit", step))

    def join(self, worker: str) -> Any:
        return self.submit(("join", worker))

    def leave(self, worker: str) -> Any:
        return self.submit(("leave", worker))

    def mitigate_stragglers(self, frontier_step: int,
                            last_report: Dict[str, int]) -> List[str]:
        """Noop-fill every worker lagging more than ``skip_after`` behind."""
        skipped = []
        for w in list(self.view.workers):
            behind = frontier_step - last_report.get(w, -1)
            if behind > self.skip_after:
                for s in range(last_report.get(w, -1) + 1, frontier_step + 1):
                    self.submit(("noop_fill", w, s))
                skipped.append(w)
        return skipped

    def fail_over(self) -> None:
        """Kill the RSM leader; training control continues on the backup."""
        self.rsm.fail_over(to_leader=1)
        self.rsm.run_to_quiescence()
        self.client.leader = self.rsm.leader_addrs[1]

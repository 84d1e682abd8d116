"""End-to-end training loop: data pipeline -> train step -> coordinator ->
grid checkpoints, with failure recovery and elastic rescaling (port of
``runtime/train_loop.py``).

The same loop as the reference's, eager: the step is
:func:`~repro_torch.runtime.steps.make_train_step` on a model whose
parameters require grad, on ``device`` (``None`` means cuda; without a
card that raises unless ``device="cpu"``).  The parameters and the AdamW
moments are updated in place, so the trainer holds one copy of each; a
checkpoint is written from a copy on the host, and a restore reads onto
the host and writes the saved values back into the same tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from ..checkpoint.store import GridCheckpointStore
from ..configs.base import ModelConfig
from ..core.device import resolve_device
from ..data.pipeline import DataConfig, SyntheticLM
from ..models import init_params
from ..optim.adamw import AdamWConfig, init_opt_state
from .coordinator import TrainingCoordinator
from .steps import make_train_step


@dataclass
class TrainState:
    params: Any      # a Transformer whose parameters require grad
    opt_state: Any   # {"m": {name: tensor}, "v": {...}, "step": tensor}
    step: int = 0


def _host_like(tree):
    """``tree``'s dict structure with an empty host tensor at every leaf:
    a restore's ``like_tree`` that puts each restored leaf on the host."""
    if isinstance(tree, dict):
        return {k: _host_like(v) for k, v in tree.items()}
    return torch.empty(0)


class Trainer:
    """Single-host trainer with RSM coordination + grid checkpoints.

    ``n_virtual_workers`` simulates the DP group for the coordinator
    (per-worker step reports; straggler noop-fill)."""

    def __init__(self, cfg: ModelConfig, ckpt_dir: str,
                 opt_cfg: Optional[AdamWConfig] = None,
                 data_cfg: Optional[DataConfig] = None,
                 n_virtual_workers: int = 4, seed: int = 0,
                 ckpt_every: int = 5, device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or AdamWConfig(warmup_steps=5, total_steps=200)
        self.data_cfg = data_cfg or DataConfig(
            vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=seed)
        self.data = SyntheticLM(self.data_cfg)
        self.ckpt = GridCheckpointStore(ckpt_dir, rows=2, cols=2)
        self.coord = TrainingCoordinator(n_workers=n_virtual_workers, seed=seed)
        self.n_workers = n_virtual_workers
        self.ckpt_every = ckpt_every

        params = init_params(cfg, seed, device=self.device, trainable=True)
        self.state = TrainState(params=params,
                                opt_state=init_opt_state(params))
        self._step_fn = make_train_step(cfg, self.opt_cfg)
        self.metrics_log: List[Dict[str, float]] = []

    # -- steps ---------------------------------------------------------------
    def run_step(self, straggler: Optional[int] = None) -> Dict[str, float]:
        step = self.state.step
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.data.global_batch(step).items()}
        params, opt_state, metrics = self._step_fn(
            self.state.params, self.state.opt_state, batch)
        self.state = TrainState(params=params, opt_state=opt_state,
                                step=step + 1)
        # per-worker completion reports through the RSM; a straggler's
        # report is withheld and (if lagging) noop-filled
        last_report = {}
        for w in range(self.n_workers):
            if w == straggler:
                last_report[f"worker/{w}"] = step - self.coord.skip_after - 1
                continue
            self.coord.report_step(w, step)
            last_report[f"worker/{w}"] = step
        if straggler is not None:
            self.coord.mitigate_stragglers(step, last_report)
        m = {k: float(v) for k, v in metrics.items()}
        m["step"] = step
        self.metrics_log.append(m)
        if (step + 1) % self.ckpt_every == 0:
            self.checkpoint()
        return m

    def run(self, n_steps: int) -> List[Dict[str, float]]:
        return [self.run_step() for _ in range(n_steps)]

    # -- checkpoint / restore ----------------------------------------------------
    def _tree(self) -> Dict[str, Any]:
        return {"params": dict(self.state.params.named_parameters()),
                "opt": self.state.opt_state,
                "step": torch.tensor(self.state.step)}

    def checkpoint(self) -> None:
        self.ckpt.save(self.state.step, self._tree())
        self.coord.commit_checkpoint(self.state.step)

    @torch.no_grad()
    def restore_latest(self) -> int:
        step = self.coord.view.committed_ckpt
        if step is None:
            raise RuntimeError("no committed checkpoint")
        live = self._tree()
        # read onto the host, then copy leaf by leaf into the live tensors:
        # the device never holds a second copy of the params and moments
        tree = self.ckpt.restore(step, _host_like(live))
        for name, saved in tree["params"].items():
            live["params"][name].copy_(saved)
        for part in ("m", "v"):
            for name, saved in tree["opt"][part].items():
                live["opt"][part][name].copy_(saved)
        self.state.opt_state["step"] = tree["opt"]["step"].to(self.device)
        self.state.step = int(tree["step"])
        return self.state.step

    # -- failure / elasticity ---------------------------------------------------
    def crash_and_recover(self) -> int:
        """Simulate losing the training job: rebuild from the last
        *committed* checkpoint (the RSM knows which one that is)."""
        self.state = None  # the lost job's memory goes before the new one's
        params = init_params(self.cfg, 999, device=self.device,
                             trainable=True)  # garbage state
        self.state = TrainState(params=params,
                                opt_state=init_opt_state(params))
        return self.restore_latest()

    def scale_workers(self, new_n: int) -> None:
        """Elastic rescale: membership changes through the log; the
        deterministic data pipeline needs no state handoff."""
        for w in range(self.n_workers, new_n):
            self.coord.join(f"worker/{w}")
        for w in range(new_n, self.n_workers):
            self.coord.leave(f"worker/{w}")
        self.n_workers = new_n

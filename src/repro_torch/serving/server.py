"""Compartmentalized model serving: the paper's read/write decoupling with
*inference as the read operation* (port of ``serving/server.py``).

Mapping (paper section 3.4 / 4):
  * the replicated log orders **weight updates** (writes) - e.g. a trainer
    pushing fresh checkpoints into the serving fleet;
  * an **inference request is a leaderless read**: the client prereads a
    vote watermark from an acceptor row, then any single model replica that
    has applied the log up to that watermark runs the forward pass;
  * batchers group requests (one preread per read batch), unbatchers fan
    results back out.

Consistency menu: "linearizable", "sequential", "eventual" (paper section
3.6).  Weight payloads move via a side store keyed by id (the S-Paxos data
path); the log carries only ("update", version, ref).  The protocol plane
is the port's carried copy; the model runs on ``device`` (``None`` means
cuda, and raises without a card).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..core.device import resolve_device
from ..core.protocols import CompartmentalizedMultiPaxos, DeploymentConfig
from ..core.statemachine import StateMachine
from ..models import decode_step, prefill


class ParamStore:
    """Content-addressed weight payload store (data path)."""

    def __init__(self) -> None:
        self._store: Dict[int, Any] = {}
        self._next = 0

    def put(self, params) -> int:
        ref = self._next
        self._next += 1
        self._store[ref] = params
        return ref

    def get(self, ref: int):
        return self._store[ref]


class ModelServingSM(StateMachine):
    """State machine executed by every serving replica.

    Writes: ("update", version, ref) - install new weights.
    Reads:  ("infer", prompt_tokens, max_new) - greedy decode.
    """

    def __init__(self, cfg, store: ParamStore, device=None) -> None:
        self.cfg = cfg
        self.store = store
        self.device = resolve_device(device)
        self.params = None
        self.version = -1
        self.inferences = 0

    def apply(self, op: Tuple) -> Any:
        kind = op[0]
        if kind == "update":
            _, version, ref = op
            if version > self.version:
                self.params = self.store.get(ref)
                self.version = version
            return ("installed", self.version)
        if kind == "infer":
            _, prompt, max_new = op
            if self.params is None:
                raise RuntimeError("no weights installed")
            self.inferences += 1
            return ("v%d" % self.version, self._generate(prompt, max_new))
        raise ValueError(f"unknown op {op!r}")

    @torch.inference_mode()
    def _generate(self, prompt, max_new: int) -> Tuple[int, ...]:
        """Greedy tokens after ``prompt``, under
        ``torch.inference_mode()``: weights that require grad record no
        graph here."""
        tokens = torch.tensor([list(prompt)], dtype=torch.int32,
                              device=self.device)
        _, caches = prefill(self.cfg, self.params, tokens,
                            cache_len=tokens.shape[1] + max_new)
        tok = tokens[:, -1:]
        out: List[torch.Tensor] = []
        for _ in range(max_new):
            logits, caches = decode_step(self.cfg, self.params, caches, tok)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            out.append(tok[0, 0])
        # one wait on the device per request, not per token
        return tuple(torch.stack(out).tolist() if out else [])

    def is_read(self, op: Tuple) -> bool:
        return op[0] == "infer"

    def snapshot(self) -> Any:
        return (self.version,)

    def restore(self, snap: Any) -> None:
        self.version = snap[0]


class ServingDeployment:
    """Compartmentalized serving fleet over the in-process cluster."""

    def __init__(self, cfg, n_replicas: int = 3, n_proxy_leaders: int = 3,
                 grid: Tuple[int, int] = (2, 2), n_clients: int = 2,
                 consistency: str = "linearizable", n_batchers: int = 0,
                 n_unbatchers: int = 0, seed: int = 0, device=None) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.store = ParamStore()
        dep_cfg = DeploymentConfig(
            f=1, n_proxy_leaders=n_proxy_leaders, grid=grid,
            n_replicas=n_replicas, consistency=consistency,
            n_batchers=n_batchers, n_unbatchers=n_unbatchers,
            batch_size=4, seed=seed)
        self.rsm = CompartmentalizedMultiPaxos(dep_cfg, n_clients=n_clients)
        for replica in self.rsm.replicas:
            replica.sm = ModelServingSM(cfg, self.store, self.device)
        self.clients = self.rsm.clients
        self.version = 0

    # -- control plane ---------------------------------------------------------
    def push_weights(self, params, client: int = 0) -> int:
        """Trainer-side weight update (a write through the log).  The
        weights must live on the deployment's device."""
        if params.device.type != self.device.type:
            raise ValueError(f"weights on {params.device}, deployment on "
                             f"{self.device}")
        self.version += 1
        ref = self.store.put(params)
        self.clients[client].run_ops([("update", self.version, ref)])
        self.rsm.run_to_quiescence()
        return self.version

    # -- request plane ---------------------------------------------------------
    def infer(self, prompt: List[int], max_new: int = 4, client: int = 0
              ) -> Tuple[str, Tuple[int, ...]]:
        """Issue one inference request as a (leaderless) read."""
        self.clients[client].run_ops([("infer", tuple(prompt), max_new)])
        self.rsm.run_to_quiescence()
        return self.clients[client].results[-1]

    def submit_many(self, prompts: List[List[int]], max_new: int = 4) -> None:
        """Round-robin closed-loop submission across clients."""
        for i, p in enumerate(prompts):
            c = self.clients[i % len(self.clients)]
            c.run_ops([("infer", tuple(p), max_new)])
        self.rsm.run_to_quiescence()

    def replica_loads(self) -> List[int]:
        return [r.sm.inferences for r in self.rsm.replicas]  # type: ignore

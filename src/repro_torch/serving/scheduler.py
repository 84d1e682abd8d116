"""Continuous-batching scheduler for the decode loop (port of
``serving/scheduler.py``).

A model replica executes decode steps over a fixed number of batch *slots*;
sequences are admitted into free slots as requests arrive and evicted when
they emit EOS or hit their token budget (Orca-style iteration-level
scheduling [OSDI'22]).  The batcher role of compartmentalization 5 feeds
this queue; slots decouple batch *occupancy* from request boundaries.

Slot bookkeeping as in the reference; the decode step is the port's eager
``decode_step`` (one batched ``flash_decode`` launch per layer on the
card), and a step reads its B next tokens back to the host once.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..core.device import resolve_device
from ..models import decode_step, init_cache, prefill


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Fixed-slot continuous batching over a single model replica.

    ``device=None`` means cuda (raises without a card); the caches and
    tokens live there, and ``params`` must too."""

    def __init__(self, cfg, params, n_slots: int = 4, max_len: int = 128,
                 eos_id: Optional[int] = None, device=None) -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.caches = init_cache(cfg, n_slots, max_len, device=self.device)
        self.tokens = torch.zeros((n_slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.steps_executed = 0
        self.occupancy_sum = 0

    # -- admission -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        # slot caches share one absolute write position per layer, so all
        # prompts must be admitted at a common length (left-pad upstream in
        # the batcher; real fleets do the same for slot alignment)
        if any(s is not None for s in self.slots) or self.queue:
            ref = (self.queue[0].prompt if self.queue
                   else next(s for s in self.slots if s is not None).prompt)
            if len(req.prompt) != len(ref):
                raise ValueError("pad prompts to equal length")
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                # per-slot prefill: run the prompt through a fresh cache and
                # splice that slot's state into the batch cache
                toks = torch.tensor([req.prompt], dtype=torch.int32,
                                    device=self.device)
                _, cache1 = prefill(self.cfg, self.params, toks,
                                    cache_len=self.max_len)
                self.caches = _splice_slot(self.caches, cache1, i)
                self.tokens[i, 0] = req.prompt[-1]

    # -- decode loop -----------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> None:
        """Admit what fits, then one decode step over every slot; under
        ``torch.inference_mode()``, so weights that require grad (a model
        being trained) record no graph here."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        logits, self.caches = decode_step(self.cfg, self.params, self.caches,
                                          self.tokens)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self.tokens = next_tok[:, None]
        self.steps_executed += 1
        self.occupancy_sum += len(active)
        host = next_tok.tolist()  # the step's one wait on the device
        for i in active:
            req = self.slots[i]
            tok = host[i]
            req.out.append(tok)
            if len(req.out) >= req.max_new or tok == self.eos_id:
                req.done = True
                self.slots[i] = None

    def run_until_drained(self, max_steps: int = 10_000) -> None:
        steps = 0
        while (self.queue or any(self.slots)) and steps < max_steps:
            self.step()
            steps += 1

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.steps_executed, 1)


def _splice_slot(batch_cache: List[dict], single_cache: List[dict],
                 slot: int) -> List[dict]:
    """Copy a 1-sequence cache into batch position ``slot``, in place.

    The slot's rows of every per-sequence entry (K/V, a recurrent layer's
    "h" and "conv" state, an rwkv6 layer's nested "tm" and "cm" states)
    are overwritten; the per-layer "pos" is the maximum of the two (the
    reference's rule: all slots share absolute positions, and a shorter
    slot's rows are masked by cache_len at attention time)."""
    for b, s in zip(batch_cache, single_cache):
        _splice_entry(b, s, slot)
    return batch_cache


def _splice_entry(b: dict, s: dict, slot: int) -> None:
    for name, value in s.items():
        if isinstance(value, dict):
            _splice_entry(b[name], value, slot)
        elif name == "pos":
            b["pos"] = torch.maximum(b["pos"], value)
        else:
            b[name][slot:slot + 1] = value.to(b[name].dtype)

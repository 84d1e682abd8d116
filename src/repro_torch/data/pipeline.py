"""Deterministic synthetic LM data pipeline (port of ``data/pipeline.py``,
copied whole: numpy only, so both packages draw the same sequences bit for
bit).

Design rule (elasticity): a batch is a *pure function* of (step, sample
index) - no per-worker iterator state.  After a membership change the new
workers recompute exactly their shard of the same global batch, so elastic
rescaling (runtime/coordinator.py) needs no data-state handoff; this is the
data-plane analogue of the paper's "replicas execute a deterministic log".

The token stream is a seeded order-1 Markov chain (so a model can actually
reduce loss on it), generated with numpy on the host; document packing with
loss masks is provided for variable-length corpora.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_concentration: float = 0.3  # lower = more predictable stream


class SyntheticLM:
    """Order-1 Markov token source with a fixed random transition kernel."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = min(cfg.vocab_size, 512)  # kernel over a vocab subset
        self.v = v
        logits = rng.gumbel(size=(v, v)) / cfg.markov_concentration
        self.cum = np.cumsum(
            np.exp(logits - logits.max(-1, keepdims=True))
            / np.exp(logits - logits.max(-1, keepdims=True)).sum(-1, keepdims=True),
            axis=-1)

    def sample_sequence(self, step: int, index: int) -> np.ndarray:
        """Deterministic (step, index) -> tokens[seq_len + 1]."""
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 1_000_033 + index)
        n = self.cfg.seq_len + 1
        u = rng.random(n)
        toks = np.empty(n, np.int64)
        toks[0] = rng.integers(self.v)
        for t in range(1, n):
            toks[t] = np.searchsorted(self.cum[toks[t - 1]], u[t])
        return toks.astype(np.int32)

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        B, S = self.cfg.global_batch, self.cfg.seq_len
        seqs = np.stack([self.sample_sequence(step, i) for i in range(B)])
        return {"tokens": seqs[:, :S], "labels": seqs[:, 1:S + 1]}

    def shard_batch(self, step: int, rank: int, num_ranks: int
                    ) -> Dict[str, np.ndarray]:
        """The per-rank shard of the global batch (contiguous split)."""
        B = self.cfg.global_batch
        assert B % num_ranks == 0, (B, num_ranks)
        per = B // num_ranks
        lo = rank * per
        seqs = np.stack([self.sample_sequence(step, i)
                         for i in range(lo, lo + per)])
        S = self.cfg.seq_len
        return {"tokens": seqs[:, :S], "labels": seqs[:, 1:S + 1]}


# ---------------------------------------------------------------------------
# document packing
# ---------------------------------------------------------------------------


def pack_documents(docs: List[np.ndarray], seq_len: int, pad_id: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy-pack variable-length documents into fixed windows.

    Returns (tokens [N, seq_len], loss_mask [N, seq_len], segment_ids
    [N, seq_len]); loss is masked at padding; segment ids let attention
    masks avoid cross-document leakage."""
    rows: List[np.ndarray] = []
    masks: List[np.ndarray] = []
    segs: List[np.ndarray] = []
    cur: List[np.ndarray] = []
    cur_len = 0
    cur_seg: List[int] = []
    seg_id = 1

    def flush():
        nonlocal cur, cur_len, cur_seg
        if not cur:
            return
        toks = np.concatenate(cur)
        pad = seq_len - len(toks)
        rows.append(np.pad(toks, (0, pad), constant_values=pad_id))
        masks.append(np.pad(np.ones(len(toks)), (0, pad)))
        segs.append(np.pad(np.concatenate(
            [np.full(len(c), s) for c, s in zip(cur, cur_seg)]), (0, pad)))
        cur, cur_len, cur_seg = [], 0, []

    for doc in docs:
        doc = doc[:seq_len]
        if cur_len + len(doc) > seq_len:
            flush()
        cur.append(doc)
        cur_seg.append(seg_id)
        seg_id += 1
        cur_len += len(doc)
    flush()
    return (np.stack(rows).astype(np.int32),
            np.stack(masks).astype(np.float32),
            np.stack(segs).astype(np.int32))


# ---------------------------------------------------------------------------
# host prefetcher
# ---------------------------------------------------------------------------


class Prefetcher:
    """Background-thread batch prefetch (overlap host datagen with device
    compute; on a real pod this hides the host->HBM transfer)."""

    def __init__(self, source: SyntheticLM, rank: int, num_ranks: int,
                 depth: int = 2, start_step: int = 0) -> None:
        self.source = source
        self.rank, self.num_ranks = rank, num_ranks
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self) -> None:
        step = self.step
        while not self._stop.is_set():
            batch = self.source.shard_batch(step, self.rank, self.num_ranks)
            batch["step"] = step
            try:
                self.q.put(batch, timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self, timeout: float = 30.0) -> Dict[str, np.ndarray]:
        return self.q.get(timeout=timeout)

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2.0)

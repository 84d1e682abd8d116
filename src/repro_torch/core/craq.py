"""CRAQ and Chain Replication (the paper's section 8.4 comparison).

Chain Replication [van Renesse & Schneider, OSDI'04]: nodes form a chain;
writes flow head -> tail; acks flow tail -> head; the head replies to the
client.  Reads are served by the tail only.

CRAQ [Terrace & Freedman, ATC'09]: any node may serve a read of a *clean*
key immediately; a read of a *dirty* key (unacknowledged write in flight) is
forwarded to the tail, which serves it from the latest committed version.
This is what makes CRAQ skew-sensitive (paper Fig. 33): hot keys are dirty
more often, funnelling reads to the tail.
"""
from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .cluster import Network, Node
from .history import History
from .messages import (
    ChainAck,
    ChainRead,
    ChainWrite,
    ClientReply,
    ClientRequest,
    Command,
    ReadReply,
    Timer,
    VersionQuery,
)
from .protocols import BaseDeployment


class ChainNode(Node):
    def __init__(self, addr: str, index: int, chain: Sequence[str],
                 reads_anywhere: bool = True) -> None:
        super().__init__(addr)
        self.index = index
        self.chain = list(chain)
        self.reads_anywhere = reads_anywhere  # True: CRAQ; False: CR (tail reads)
        # key -> list of (version, value); committed = versions <= clean_upto[key]
        self.versions: Dict[Any, List[Tuple[int, Any]]] = {}
        self.clean_upto: Dict[Any, int] = {}
        self.next_version = 0
        # head only: version -> command (for the client reply)
        self.inflight: Dict[int, Command] = {}
        self.reads_served = 0
        self.tail_forwards = 0

    # -- helpers --------------------------------------------------------------
    @property
    def is_head(self) -> bool:
        return self.index == 0

    @property
    def is_tail(self) -> bool:
        return self.index == len(self.chain) - 1

    def _next(self) -> str:
        return self.chain[self.index + 1]

    def _prev(self) -> str:
        return self.chain[self.index - 1]

    def _dirty(self, key: Any) -> bool:
        vs = self.versions.get(key)
        if not vs:
            return False
        return vs[-1][0] > self.clean_upto.get(key, -1)

    def _committed_value(self, key: Any) -> Any:
        vs = self.versions.get(key)
        if not vs:
            return None
        upto = self.clean_upto.get(key, -1)
        committed = [v for ver, v in vs if ver <= upto]
        if committed:
            return committed[-1]
        return None

    def _latest_value(self, key: Any) -> Any:
        vs = self.versions.get(key)
        return vs[-1][1] if vs else None

    def _store(self, key: Any, version: int, value: Any) -> None:
        self.versions.setdefault(key, []).append((version, value))

    def _mark_clean(self, key: Any, version: int) -> None:
        if version > self.clean_upto.get(key, -1):
            self.clean_upto[key] = version
        # garbage-collect superseded versions
        vs = self.versions.get(key, [])
        upto = self.clean_upto[key]
        committed = [(ver, v) for ver, v in vs if ver <= upto]
        rest = [(ver, v) for ver, v in vs if ver > upto]
        if committed:
            self.versions[key] = [committed[-1]] + rest

    # -- protocol ---------------------------------------------------------------
    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, ClientRequest):
            # client write enters at the head
            cmd = msg.command
            assert cmd.op[0] == "put", "chain writes are puts"
            version = self.next_version
            self.next_version += 1
            self.inflight[version] = cmd
            _, key, value = cmd.op
            self._store(key, version, value)
            if self.is_tail:  # chain of length 1
                self._mark_clean(key, version)
                self.send(f"client/{cmd.client_id}",
                          ClientReply(command_uid=cmd.uid, result="ok", slot=version))
            else:
                self.send(self._next(), ChainWrite(command=cmd, version=version))
        elif isinstance(msg, ChainWrite):
            _, key, value = msg.command.op
            self._store(key, msg.version, value)
            if self.is_tail:
                self._mark_clean(key, msg.version)
                self.send(self._prev(), ChainAck(key=key, version=msg.version))
            else:
                self.send(self._next(), msg)
        elif isinstance(msg, ChainAck):
            self._mark_clean(msg.key, msg.version)
            if self.is_head:
                cmd = self.inflight.pop(msg.version, None)
                if cmd is not None:
                    self.send(f"client/{cmd.client_id}",
                              ClientReply(command_uid=cmd.uid, result="ok",
                                          slot=msg.version))
            else:
                self.send(self._prev(), msg)
        elif isinstance(msg, ChainRead):
            cmd = msg.command
            key = cmd.op[1]
            if self.is_tail or (self.reads_anywhere and not self._dirty(key)):
                # CRAQ fast path (or tail): serve the latest committed value
                value = (self._latest_value(key) if self.is_tail
                         else self._committed_value(key))
                self.reads_served += 1
                self.send(f"client/{cmd.client_id}",
                          ReadReply(command_uid=cmd.uid, result=value,
                                    executed_slot=self.clean_upto.get(key, -1)))
            else:
                # dirty (or CR non-tail): forward to the tail
                self.tail_forwards += 1
                self.send(self.chain[-1], msg)


class CraqClient(Node):
    """Closed-loop client for chain protocols."""

    def __init__(self, addr: str, client_id: int, chain: Sequence[str],
                 history: Optional[History] = None, seed: int = 0,
                 reads_anywhere: bool = True) -> None:
        super().__init__(addr)
        self.client_id = client_id
        self.chain = list(chain)
        self.history = history
        self.rng = random.Random(seed * 7 + client_id)
        self.reads_anywhere = reads_anywhere
        # CRAQ reads are uniformly addressed.  A shuffled balanced deck
        # realizes that exactly over every window of k reads (keeping
        # measured per-node read load parity-comparable at small op
        # counts) while staying aperiodic, so the deterministic write
        # pipeline's dirty windows still get sampled.
        self._read_deck: List[int] = []
        self.seq = 0
        self.ops: List[Tuple] = []
        self.op_index = 0
        self.outstanding: Optional[Tuple] = None
        self.results: List[Any] = []

    def run_ops(self, ops: Sequence[Tuple]) -> None:
        self.ops.extend(ops)
        if self.outstanding is None:
            self.set_timer("kick", 0.0)

    def _issue_next(self) -> None:
        if self.op_index >= len(self.ops):
            self.outstanding = None
            return
        op = self.ops[self.op_index]
        self.op_index += 1
        hist_id = (self.history.invoke(self.client_id, op, self.now)
                   if self.history is not None else None)
        cmd = Command(self.client_id, self.seq, op, is_read=(op[0] == "get"))
        self.seq += 1
        self.outstanding = (cmd, hist_id)
        if op[0] == "get":
            if self.reads_anywhere:
                if not self._read_deck:
                    self._read_deck = list(range(len(self.chain)))
                    self.rng.shuffle(self._read_deck)
                node = self.chain[self._read_deck.pop()]
            else:
                node = self.chain[-1]
            self.send(node, ChainRead(command=cmd))
        else:
            self.send(self.chain[0], ClientRequest(command=cmd))

    def _complete(self, result: Any) -> None:
        if self.outstanding is None:
            return
        _, hist_id = self.outstanding
        if self.history is not None and hist_id is not None:
            self.history.respond(hist_id, result, self.now)
        self.results.append(result)
        self.outstanding = None
        self._issue_next()

    def on_message(self, src: str, msg: Any) -> None:
        if isinstance(msg, (ClientReply, ReadReply)):
            if self.outstanding and msg.command_uid == self.outstanding[0].uid:
                result = msg.result if isinstance(msg, ReadReply) else msg.result
                self._complete(result)
        elif isinstance(msg, Timer) and msg.name == "kick":
            if self.outstanding is None:
                self._issue_next()

    @property
    def done(self) -> bool:
        return self.op_index >= len(self.ops) and self.outstanding is None


class CraqDeployment(BaseDeployment):
    def __init__(self, n_nodes: int = 3, n_clients: int = 2,
                 reads_anywhere: bool = True, seed: int = 0,
                 latency_fn: Optional[Callable[[str, str], float]] = None,
                 ) -> None:
        self.net = Network(seed=seed, latency_fn=latency_fn)
        self.history = History()
        self.chain_addrs = [f"chain/{i}" for i in range(n_nodes)]
        self.nodes = [ChainNode(a, i, self.chain_addrs, reads_anywhere)
                      for i, a in enumerate(self.chain_addrs)]
        self.clients = [
            CraqClient(f"client/{i}", i, self.chain_addrs, history=self.history,
                       seed=seed, reads_anywhere=reads_anywhere)
            for i in range(n_clients)
        ]
        self.net.add_nodes(self.nodes)
        self.net.add_nodes(self.clients)

    def tail_load_fraction(self) -> float:
        served = sum(n.reads_served for n in self.nodes)
        tail = self.nodes[-1].reads_served
        return tail / served if served else 0.0

"""Deterministic in-process network + node base class.

Every protocol in ``repro.core`` runs on this substrate: nodes are Python
objects registered under string addresses; messages are delivered through a
virtual-time priority queue.  Everything is seeded and deterministic, which is
what makes the hypothesis property tests (linearizability under reordering,
drops and failures) reproducible.

Fault injection:
  * ``crash(addr)`` / ``recover(addr)``  - crashed nodes receive nothing.
  * ``partition(a, b)``                  - drop messages between groups.
  * ``drop_rate``                        - iid message drops (seeded).
  * per-link latency function            - reordering across links.

Timers: a node can call ``self.set_timer(name, delay, payload)``; the network
delivers a ``Timer`` message back to it at ``now + delay`` (cancelled if the
node crashed).
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from .messages import Timer


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    dst: str = field(compare=False)
    src: str = field(compare=False)
    msg: Any = field(compare=False)


class Node:
    """Base class for protocol roles."""

    def __init__(self, addr: str) -> None:
        self.addr = addr
        self.net: Optional["Network"] = None
        self.now: float = 0.0
        # message accounting (used by message-count benchmarks)
        self.msgs_received: int = 0
        self.msgs_sent: int = 0

    # -- wiring -------------------------------------------------------------
    def bind(self, net: "Network") -> None:
        self.net = net

    # -- messaging ----------------------------------------------------------
    def send(self, dst: str, msg: Any) -> None:
        assert self.net is not None
        self.msgs_sent += 1
        self.net.send(self.addr, dst, msg)

    def broadcast(self, dsts, msg: Any) -> None:
        for d in dsts:
            self.send(d, msg)

    def set_timer(self, name: str, delay: float, payload: Any = None) -> None:
        assert self.net is not None
        self.net.send(self.addr, self.addr, Timer(name, payload), delay=delay)

    # -- to override ----------------------------------------------------------
    def on_message(self, src: str, msg: Any) -> None:
        raise NotImplementedError

    def on_crash(self) -> None:  # state wiped unless the role persists it
        pass

    def on_recover(self) -> None:
        pass


class Network:
    """Virtual-time message bus with deterministic fault injection."""

    def __init__(
        self,
        seed: int = 0,
        default_latency: float = 1.0,
        jitter: float = 0.0,
        drop_rate: float = 0.0,
        latency_fn: Optional[Callable[[str, str], float]] = None,
    ) -> None:
        self.rng = random.Random(seed)
        self.nodes: Dict[str, Node] = {}
        self.queue: List[_Event] = []
        self.now: float = 0.0
        self._seq = itertools.count()
        self.default_latency = default_latency
        self.jitter = jitter
        self.drop_rate = drop_rate
        self.crashed: Set[str] = set()
        self.partitions: List[Tuple[Set[str], Set[str]]] = []
        self.delivered: int = 0
        self.dropped: int = 0
        # optional per-(src,dst) latency override (e.g. a GeoSpec's WAN
        # matrix).  Only consulted when `send` gets no explicit delay, so
        # self-addressed Timer deliveries (set_timer passes delay=) stay
        # local; jitter stacks on top of the matrix delay, never replaces
        # it.
        self.latency_fn = latency_fn

    # -- topology -------------------------------------------------------------
    def add_node(self, node: Node) -> Node:
        if node.addr in self.nodes:
            raise ValueError(f"duplicate address {node.addr}")
        self.nodes[node.addr] = node
        node.bind(self)
        return node

    def add_nodes(self, nodes) -> None:
        for n in nodes:
            self.add_node(n)

    # -- fault injection --------------------------------------------------------
    def crash(self, addr: str) -> None:
        self.crashed.add(addr)
        self.nodes[addr].on_crash()

    def recover(self, addr: str) -> None:
        self.crashed.discard(addr)
        self.nodes[addr].on_recover()

    def partition(self, group_a, group_b) -> None:
        self.partitions.append((set(group_a), set(group_b)))

    def heal(self) -> None:
        self.partitions.clear()

    def _partitioned(self, src: str, dst: str) -> bool:
        for a, b in self.partitions:
            if (src in a and dst in b) or (src in b and dst in a):
                return True
        return False

    # -- send / deliver ---------------------------------------------------------
    def send(self, src: str, dst: str, msg: Any, delay: Optional[float] = None) -> None:
        if delay is None:
            if self.latency_fn is not None:
                delay = self.latency_fn(src, dst)
            else:
                delay = self.default_latency
            if self.jitter > 0:
                delay += self.rng.random() * self.jitter
        is_timer = isinstance(msg, Timer)
        if not is_timer:
            if self.drop_rate > 0 and self.rng.random() < self.drop_rate:
                self.dropped += 1
                return
            if self._partitioned(src, dst):
                self.dropped += 1
                return
        heapq.heappush(
            self.queue, _Event(self.now + delay, next(self._seq), dst, src, msg)
        )

    def step(self) -> bool:
        """Deliver the next message.  Returns False when the queue is empty."""
        while self.queue:
            ev = heapq.heappop(self.queue)
            self.now = ev.time
            if ev.dst in self.crashed or ev.dst not in self.nodes:
                self.dropped += 1
                continue
            if not isinstance(ev.msg, Timer) and self._partitioned(ev.src, ev.dst):
                self.dropped += 1
                continue
            node = self.nodes[ev.dst]
            node.now = ev.time
            # timers are local clock events, not network messages - keep
            # them out of the per-role message accounting the demand-table
            # parity checks are anchored on
            if not isinstance(ev.msg, Timer):
                node.msgs_received += 1
            node.on_message(ev.src, ev.msg)
            self.delivered += 1
            return True
        return False

    def run(self, max_steps: int = 1_000_000, until: Optional[float] = None) -> int:
        """Deliver messages until quiescence / step budget / time bound."""
        steps = 0
        while steps < max_steps:
            if until is not None and self.queue and self.queue[0].time > until:
                break
            if not self.step():
                break
            steps += 1
        return steps

    def pending(self) -> int:
        return len(self.queue)

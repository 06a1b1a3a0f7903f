"""A fake replicated message broker with injectable faults.

Plays the role of the upstream queue-suite targets (``rabbitmq/``,
``kafka/``) the way :mod:`.cluster` plays etcd: an
in-process system-under-test so the queue workload, nemesis, and the
``queue`` / ``total-queue`` checkers exercise end-to-end without SSH.

Reuses :class:`~jepsen_tpu_torch.fake.cluster.FakeCluster`'s node/link/fault
plumbing (and its exception types); the datum is a queue instead of a KV
map. Consistency modes:

- ``"safe"`` — one authoritative durable queue guarded by a lock; an op
  succeeds only if its coordinator can reach a majority of nodes.
  Every acknowledged enqueue is dequeued exactly once by a full drain.
- ``"lossy"`` — per-node replica queues with best-effort replication,
  and a RabbitMQ-autoheal-style reconciliation on :meth:`heal`: one
  partition side wins wholesale and the other side's divergent state is
  discarded. Messages acknowledged only on the losing side are LOST
  (caught by ``total-queue``); messages the losing side had consumed
  are resurrected and dequeued again (caught by ``queue`` as overdrawn).
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Optional, Sequence

from jepsen_tpu_torch.fake.cluster import FakeCluster, FakeTimeout, Unavailable

__all__ = ["FakeBroker", "Empty", "FakeTimeout", "Unavailable"]


class Empty(Exception):
    """Dequeue found no message (a definite, clean ``fail``)."""


class FakeBroker(FakeCluster):
    MODES = ("safe", "lossy")

    def __init__(self, nodes: Sequence[str] = ("n1", "n2", "n3", "n4", "n5"),
                 mode: str = "safe", seed: Optional[int] = None,
                 base_latency: float = 0.0):
        super().__init__(nodes, mode=mode, seed=seed,
                         base_latency=base_latency)
        self._queue: Deque[Any] = deque()        # authoritative (safe mode)
        for n in self.nodes.values():
            n.queue = deque()                    # local replica (lossy mode)

    # -- fault API overrides -------------------------------------------------
    def heal(self) -> None:
        super().heal()
        if not self.safe:
            self._autoheal()

    def _autoheal(self) -> None:
        """RabbitMQ-autoheal analogue: the first alive node's replica wins
        and overwrites everyone else's — the deliberate bug."""
        winner = next((self.nodes[n] for n in self.node_names
                       if self.nodes[n].alive), None)
        if winner is None:
            return
        with winner.lock:
            snapshot = list(winner.queue)
        for name in self.node_names:
            n = self.nodes[name]
            if n is winner or not n.alive:
                continue
            with n.lock:
                n.queue = deque(snapshot)

    def start_node(self, node: str) -> None:
        n = self.nodes[node]
        n.alive = True
        if not self.safe:
            # a restarted broker node rejoins empty and copies whichever
            # peer it reaches first (data loss is a feature here)
            n.queue = deque()
            for peer in self._reachable_from(node):
                if peer != node and self.nodes[peer].alive:
                    with self.nodes[peer].lock:
                        n.queue = deque(self.nodes[peer].queue)
                    break

    # -- client RPC ----------------------------------------------------------
    def enqueue(self, node: str, value: Any) -> None:
        n = self._enter(node)
        if self.safe:
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._glock:
                if not self._has_majority(node):
                    raise FakeTimeout(f"{node} lost quorum mid-enqueue")
                self._queue.append(value)
            return
        with n.lock:
            n.queue.append(value)
        for peer in self._reachable_from(n.name):
            p = self.nodes[peer]
            if p is n or p.pause.is_set():
                continue
            with p.lock:
                p.queue.append(value)

    def dequeue(self, node: str) -> Any:
        n = self._enter(node)
        if self.safe:
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._glock:
                if not self._queue:
                    raise Empty("queue empty")
                return self._queue.popleft()
        with n.lock:
            if not n.queue:
                raise Empty(f"queue empty on {node}")
            value = n.queue.popleft()
        # best-effort delete on reachable peers; unreachable replicas keep
        # the message and will serve it again (the duplicate-delivery bug)
        for peer in self._reachable_from(n.name):
            p = self.nodes[peer]
            if p is n or p.pause.is_set():
                continue
            with p.lock:
                try:
                    p.queue.remove(value)
                except ValueError:
                    pass
        return value

    def empty(self) -> bool:
        """True when no replica anywhere still holds a message (drives the
        drain phase's stop condition)."""
        if self.safe:
            with self._glock:
                return not self._queue
        return all(not self.nodes[n].queue for n in self.node_names
                   if self.nodes[n].alive)

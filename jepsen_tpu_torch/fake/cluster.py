"""A fake replicated KV cluster with injectable faults.

No direct upstream analogue — the upstream exercises its full stack
against a docker-compose cluster of real sshd/DB containers; this module
plays that role in-process so the E2E path (generator → client → nemesis
→ checker → store) runs anywhere, instantly.

Consistency modes:

- ``"linearizable"`` — one authoritative copy guarded by a lock; an op
  succeeds only if its coordinator can reach a majority of nodes.
  Histories are always linearizable (the checkers must agree).
- ``"sloppy"`` — per-node replicas; writes apply locally and replicate
  only to currently-reachable nodes; reads serve the local replica. Under
  a partition this yields stale reads and lost updates — real
  linearizability violations the checkers must catch. This is the
  deliberately buggy replicated register.

Fault API (driven by :class:`jepsen_tpu_torch.net.FakeNet` and the nemeses):
``drop_link / heal / set_latency / set_loss / kill_node / start_node /
pause_node / resume_node / bump_clock``.
"""
from __future__ import annotations

import random
import threading
import time as _time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from jepsen_tpu_torch.util import majority


class Unavailable(Exception):
    """Definite failure: the op did not and will not take effect."""


class FakeTimeout(Exception):
    """Indeterminate failure: the op may or may not have taken effect."""


class _Node:
    def __init__(self, name: str):
        self.name = name
        self.alive = True
        self.data: Dict[Any, Any] = {}           # local replica (sloppy mode)
        self.clock_skew: float = 0.0
        self.pause = threading.Event()           # set = paused
        self.lock = threading.Lock()


class FakeCluster:
    #: subclasses with different consistency vocabularies override this
    #: (first entry = the safe mode, second = the deliberately buggy one)
    MODES = ("linearizable", "sloppy")

    def __init__(self, nodes: Sequence[str] = ("n1", "n2", "n3", "n4", "n5"),
                 mode: str = "linearizable", seed: Optional[int] = None,
                 base_latency: float = 0.0):
        assert mode in self.MODES
        self.mode = mode
        #: subclass-proof branch selector: MODES[0] is always the safe mode
        self.safe = mode == self.MODES[0]
        self.node_names: List[str] = list(nodes)
        self.nodes: Dict[str, _Node] = {n: _Node(n) for n in nodes}
        self.dropped: Set[Tuple[str, str]] = set()     # (src, dst)
        self.latency = base_latency
        self.loss = 0.0
        self._rng = random.Random(seed)
        self._global: Dict[Any, Any] = {}              # authoritative copy
        self._glock = threading.Lock()

    # -- fault API (nemesis-facing) ------------------------------------------
    def drop_link(self, src: str, dst: str) -> None:
        self.dropped.add((src, dst))

    def heal(self) -> None:
        self.dropped.clear()

    def set_latency(self, seconds: float) -> None:
        self.latency = seconds

    def set_loss(self, prob: float) -> None:
        self.loss = prob

    def kill_node(self, node: str) -> None:
        self.nodes[node].alive = False

    def start_node(self, node: str) -> None:
        n = self.nodes[node]
        n.alive = True
        if not self.safe:
            # a restarted node rejoins empty and catches up from whoever it
            # can reach (deliberately naive — data loss is a feature here)
            for peer in self._reachable_from(node):
                if peer != node and self.nodes[peer].alive:
                    n.data = dict(self.nodes[peer].data)
                    break

    def pause_node(self, node: str) -> None:
        self.nodes[node].pause.set()

    def resume_node(self, node: str) -> None:
        self.nodes[node].pause.clear()

    def bump_clock(self, node: str, skew: Optional[float]) -> None:
        self.nodes[node].clock_skew = skew or 0.0

    # -- connectivity --------------------------------------------------------
    def _link_ok(self, src: str, dst: str) -> bool:
        return (src, dst) not in self.dropped

    def _reachable_from(self, src: str) -> List[str]:
        """Nodes that can hear from ``src`` (and answer back)."""
        return [d for d in self.node_names
                if self.nodes[d].alive and self._link_ok(src, d)
                and self._link_ok(d, src)]

    def _has_majority(self, coord: str) -> bool:
        return len(self._reachable_from(coord)) >= majority(
            len(self.node_names))

    # -- client RPC ----------------------------------------------------------
    def _enter(self, node: str) -> _Node:
        n = self.nodes.get(node)
        if n is None:
            raise Unavailable(f"no such node {node}")
        if not n.alive:
            raise Unavailable(f"node {node} is down")   # connection refused
        if self.latency:
            _time.sleep(self.latency)
        if self.loss and self._rng.random() < self.loss:
            raise FakeTimeout(f"packet loss to {node}")
        if n.pause.is_set():
            # a SIGSTOPped server accepts the connection but never answers:
            # wait for resume up to a small bound, then time out
            # (indeterminate — the op may still execute on resume)
            deadline = _time.monotonic() + 0.5
            while n.pause.is_set():
                if _time.monotonic() > deadline:
                    raise FakeTimeout(f"node {node} unresponsive")
                _time.sleep(0.005)
        return n

    def read(self, node: str, key: Any) -> Any:
        n = self._enter(node)
        if self.safe:
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._glock:
                return self._global.get(key)
        with n.lock:
            return n.data.get(key)

    def write(self, node: str, key: Any, value: Any) -> None:
        n = self._enter(node)
        if self.safe:
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._glock:
                if not self._has_majority(node):       # re-check inside
                    raise FakeTimeout(f"{node} lost quorum mid-write")
                self._global[key] = value
            return
        self._sloppy_apply(n, key, lambda _: value)

    def cas(self, node: str, key: Any, old: Any, new: Any) -> bool:
        n = self._enter(node)
        if self.safe:
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._glock:
                if self._global.get(key) != old:
                    return False
                self._global[key] = new
                return True
        with n.lock:
            if n.data.get(key) != old:
                return False
        self._sloppy_apply(n, key, lambda _: new)
        return True

    def sadd(self, node: str, key: Any, value: Any) -> None:
        """Add ``value`` to the set at ``key`` (grow-only-set workload)."""
        n = self._enter(node)
        if self.safe:
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._glock:
                self._global.setdefault(key, set()).add(value)
            return
        # the sloppy bug: the add replicates only to currently-reachable
        # peers, and replicas never merge — partitioned adds are lost to
        # any single node's final read
        self._sloppy_apply(n, key, lambda cur: (set(cur or ()) | {value}))

    def sread(self, node: str, key: Any) -> list:
        n = self._enter(node)
        if self.safe:
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._glock:
                return sorted(self._global.get(key) or (), key=repr)
        with n.lock:
            return sorted(n.data.get(key) or (), key=repr)

    def txn(self, node: str, micro_ops: Sequence[Sequence[Any]]) -> list:
        """Execute a list-append transaction — ``[["append", k, v],
        ["r", k, None], ...]`` — returning the completed micro-ops
        (reads filled with the observed list). Safe mode commits the
        WHOLE transaction atomically under the global lock (so
        histories are serializable by construction); sloppy mode
        applies each micro-op to the local replica and replicates
        last-writer-wins — concurrent/partitioned appends clobber
        whole lists, surfacing as genuine Elle anomalies
        (incompatible orders, lost appends) the txn checker must
        catch."""
        n = self._enter(node)
        out = []
        if self.safe:
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._glock:
                if not self._has_majority(node):       # re-check inside
                    raise FakeTimeout(f"{node} lost quorum mid-txn")
                for kind, key, v in micro_ops:
                    if kind == "append":
                        self._global.setdefault(("txn", key),
                                                []).append(v)
                        out.append(["append", key, v])
                    else:
                        out.append(["r", key, list(
                            self._global.get(("txn", key)) or ())])
            return out
        for kind, key, v in micro_ops:
            if kind == "append":
                self._sloppy_apply(n, ("txn", key),
                                   lambda cur, v=v: list(cur or ()) + [v])
                out.append(["append", key, v])
            else:
                with n.lock:
                    out.append(["r", key,
                                list(n.data.get(("txn", key)) or ())])
        return out

    def incr(self, node: str, key: Any, delta: Any) -> None:
        """Increment the counter at ``key`` by ``delta``."""
        n = self._enter(node)
        if self.safe:
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._glock:
                self._global[key] = (self._global.get(key) or 0) + delta
            return
        # the sloppy bug: the post-increment VALUE is replicated (last
        # writer wins), so concurrent/partitioned increments clobber each
        # other — reads drift below the definite sum
        self._sloppy_apply(n, key, lambda cur: (cur or 0) + delta)

    def _sloppy_apply(self, n: _Node, key: Any, f) -> None:
        """Apply locally, then best-effort replicate to reachable peers —
        the bug: unreachable peers keep stale data and keep serving it."""
        with n.lock:
            n.data[key] = f(n.data.get(key))
            value = n.data[key]
        for peer in self._reachable_from(n.name):
            p = self.nodes[peer]
            if p is n or p.pause.is_set():
                continue
            with p.lock:
                p.data[key] = value

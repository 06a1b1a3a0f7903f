"""A fake distributed lock service — plays the role upstream's
``zookeeper/`` suite's real ZooKeeper ensemble plays (the zookeeper
lock workload checked against the ``mutex`` model).

Modes mirror :class:`~jepsen_tpu_torch.fake.cluster.FakeCluster`:

- ``"linearizable"`` — one global lock; try-acquire requires the contacted
  node to reach a quorum. Histories always satisfy the mutex model.
- ``"sloppy"`` — each side of a partition keeps granting from its own
  local view: two holders at once — a mutex violation the checker must
  catch.
- ``"leases"`` — the classic lease-based lock whose safety DEPENDS ON
  CLOCKS: a grant carries a deadline, and expiry is judged by the
  *contacted node's* local clock (``monotonic + clock_skew``). With
  synchronized clocks and a lease longer than the test this is safe;
  bump one node's clock past the TTL (``nemesis.clock_nemesis`` /
  ``bump-time``) and that node hands the lock to a second holder while
  the first still holds it — the canonical clock-skew mutex violation
  (upstream: the Jepsen analyses of lease locks + ``nemesis.time``).
"""
from __future__ import annotations

import threading
import time as _time
from typing import Any, Dict, Optional, Sequence, Tuple

from jepsen_tpu_torch.fake.cluster import FakeCluster, Unavailable


class FakeLockService(FakeCluster):
    """Reuses FakeCluster's node/link/fault plumbing; the datum is one
    lock (per name) instead of a KV map."""

    MODES = ("linearizable", "sloppy", "leases")

    def __init__(self, nodes: Sequence[str] = ("n1", "n2", "n3", "n4", "n5"),
                 mode: str = "linearizable", seed: Optional[int] = None,
                 lease_ttl: float = 30.0):
        super().__init__(nodes, mode=mode, seed=seed)
        self._lock_holder: Dict[Any, Any] = {}          # global (linearizable)
        #: leases mode: name -> (holder, deadline on the granting
        #: node's clock). One global table — the fault modeled is clock
        #: skew, not replication lag.
        self._leases: Dict[Any, Tuple[Any, float]] = {}
        self.lease_ttl = lease_ttl
        self._llock = threading.Lock()
        for n in self.nodes.values():
            n.data = {}                                 # name -> holder

    def _node_now(self, node: str) -> float:
        """The contacted node's view of time — the lever clock faults
        pull (``bump_clock`` sets ``clock_skew``)."""
        return _time.monotonic() + self.nodes[node].clock_skew

    # -- lock RPC ------------------------------------------------------------
    def acquire(self, node: str, name: Any, holder: Any) -> bool:
        n = self._enter(node)
        if self.mode == "leases":
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            now = self._node_now(node)
            with self._llock:
                rec = self._leases.get(name)
                if rec is not None and now < rec[1]:
                    return False         # unexpired BY THIS NODE'S CLOCK
                self._leases[name] = (holder, now + self.lease_ttl)
                return True
        if self.safe:
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._llock:
                if self._lock_holder.get(name) is not None:
                    return False
                self._lock_holder[name] = holder
                return True
        with n.lock:
            if n.data.get(name) is not None:
                return False
        self._replicate(n, name, holder)
        return True

    def release(self, node: str, name: Any, holder: Any) -> bool:
        n = self._enter(node)
        if self.mode == "leases":
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._llock:
                rec = self._leases.get(name)
                if rec is None or rec[0] != holder:
                    return False
                del self._leases[name]
                return True
        if self.safe:
            if not self._has_majority(node):
                raise Unavailable(f"{node} lost quorum")
            with self._llock:
                if self._lock_holder.get(name) != holder:
                    return False
                self._lock_holder[name] = None
                return True
        with n.lock:
            if n.data.get(name) != holder:
                return False
        self._replicate(n, name, None)
        return True

    def _replicate(self, n, name: Any, holder: Any) -> None:
        with n.lock:
            n.data[name] = holder
        for peer in self._reachable_from(n.name):
            p = self.nodes[peer]
            if p is n or p.pause.is_set():
                continue
            with p.lock:
                p.data[name] = holder

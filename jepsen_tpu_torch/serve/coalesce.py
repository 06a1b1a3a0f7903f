"""Admission queue and coalescer: continuous multi-tenant batching (a
port of the reference package's ``jepsen_tpu/serve/coalesce.py``). Host
bookkeeping; nothing here touches the card.

- **Admission** (:meth:`AdmissionQueue.submit`): a bounded queue; past
  the bound :class:`Backpressure` (HTTP 429).
- **Coalescing** (:meth:`AdmissionQueue.next_batch`): a lane asks for
  one dispatch group at a time. Queued requests are grouped by model
  signature (one union prep a group), the oldest signature goes first,
  and its requests are bucketed by history length with
  :func:`reach_batch.plan_buckets`, the lockstep lane's own packer, so a
  10,000-op history does not drag 50-op co-tenants through its padded
  walk. One group is returned a call; the rest stay queued and coalesce
  with what arrives while the card walks.
- **Fairness**: inside a group tenants go oldest first (by each tenant's
  oldest queued request), and a per-tenant in-flight cap keeps one
  tenant from filling every group.
- **Deadlines**: a request whose deadline passes while queued finishes
  as ``timeout`` here and never takes a lane.
- **Lane placement** (``lanes > 1``): each selected group goes to the
  least-loaded lane, scanning from a round-robin pointer so that equal
  loads rotate. A group placed on a busy sibling is staged there; it is
  already counted in flight, so ``depth == 0`` and no in-flight tenant
  still means that nothing is pending.
- **Sessions**: a session's blocks form one group in order; the appends
  of many sessions that share a walk geometry form a mega group
  (sessions oldest tenant first, at most :data:`_MEGA_GROUP_CAP`). While
  a group is anywhere in flight, every session in it is kept out of the
  next selection: two lanes advancing one carried set would reorder it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.serve import request as rq

# sessions in one mega group: bounds one K10 launch's lanes and its
# stream buffer, not the throughput (the rest ride the next group)
_MEGA_GROUP_CAP = 1024


class Backpressure(RuntimeError):
    """The admission queue is at its bound; retry later (HTTP 429)."""


def plan_admission(requests: Sequence["rq.CheckRequest"], *,
                   group: int = 32) -> List[List[int]]:
    """Partition compatible requests into dispatch groups: length
    buckets by :func:`reach_batch.plan_buckets` (longest bucket first),
    then oldest tenant first inside each group. Returns index lists into
    ``requests``: tenants ranked by their oldest request's submit time,
    a tenant's requests by their own.

    Session blocks are not bucketed by length. One session's blocks are
    one group in seq order (a carried set cannot advance out of order).
    Blocks of many sessions (one mega signature) are ranked by session,
    oldest tenant first, then oldest session; chunked into groups of at
    most :data:`_MEGA_GROUP_CAP` sessions; each session's blocks stay
    together in seq order (the dispatcher advances one block of each
    session a launch)."""
    from jepsen_tpu_torch.checkers import reach_batch

    if not requests:
        return []
    if requests[0].session is not None:
        return _plan_sessions(requests)
    lens = [max(1, int(r.packed.n)) for r in requests]
    groups = reach_batch.plan_buckets(lens, group=group)
    oldest_of: Dict[str, float] = {}
    for r in requests:
        t = oldest_of.get(r.tenant)
        if t is None or r.t_submit < t:
            oldest_of[r.tenant] = r.t_submit
    return [sorted(g, key=lambda i: (oldest_of[requests[i].tenant],
                                     requests[i].tenant,
                                     requests[i].t_submit, i))
            for g in groups]


def _plan_sessions(requests: Sequence["rq.CheckRequest"]
                   ) -> List[List[int]]:
    def in_seq(ids: List[int]) -> List[int]:
        return sorted(ids, key=lambda i: (requests[i].seq,
                                          requests[i].t_submit, i))

    by_sess: Dict[str, List[int]] = {}
    for i, r in enumerate(requests):
        by_sess.setdefault(r.session.id, []).append(i)
    if len(by_sess) == 1:
        return [in_seq(list(range(len(requests))))]
    oldest_of: Dict[str, float] = {}
    sess_oldest: Dict[str, float] = {}
    sess_tenant: Dict[str, str] = {}
    for r in requests:
        oldest_of[r.tenant] = min(oldest_of.get(r.tenant, r.t_submit),
                                  r.t_submit)
        sid = r.session.id
        sess_oldest[sid] = min(sess_oldest.get(sid, r.t_submit), r.t_submit)
        sess_tenant[sid] = r.tenant
    ranked = sorted(by_sess, key=lambda sid: (
        oldest_of[sess_tenant[sid]], sess_tenant[sid], sess_oldest[sid],
        sid))
    return [[i for sid in ranked[lo:lo + _MEGA_GROUP_CAP]
             for i in in_seq(by_sess[sid])]
            for lo in range(0, len(ranked), _MEGA_GROUP_CAP)]


class AdmissionQueue:
    """Bounded multi-tenant admission queue feeding ``lanes`` lane
    threads. ``max_depth`` bounds the queued requests (dispatched ones
    do not count); ``max_inflight_per_tenant`` caps one tenant's
    requests in flight at once, the rest waiting for a later group.
    Every attribute below is touched under the condition's lock."""

    def __init__(self, max_depth: int = 256,
                 max_inflight_per_tenant: int = 8, group: int = 32,
                 lanes: int = 1) -> None:
        self.max_depth = int(max_depth)
        self.max_inflight_per_tenant = int(max_inflight_per_tenant)
        self.group = int(group)
        self.lanes = max(1, int(lanes))
        self._nonempty = threading.Condition(threading.Lock())
        self._queued: List[rq.CheckRequest] = []
        self._inflight: Dict[str, int] = {}     # tenant -> in flight
        # lane placement: each lane's staged groups (placed, not picked
        # up), its load (staged + dispatching groups), and the pointer
        self._staged: List["deque[List[rq.CheckRequest]]"] = \
            [deque() for _ in range(self.lanes)]
        self._lane_load: List[int] = [0] * self.lanes
        self._rr = 0
        # the sessions with a group in flight on any lane
        self._inflight_sessions: set = set()
        self.on_timeout: Optional[Callable[[rq.CheckRequest], None]] = None

    # -- admission ---------------------------------------------------------
    def submit(self, req: "rq.CheckRequest", force: bool = False) -> None:
        """Admit one request. ``force`` passes the bound: only for
        journal replay (the work was admitted before a restart) and
        hung-dispatch requeues."""
        with self._nonempty:
            if not force and len(self._queued) >= self.max_depth:
                obs.count("serve.rejected.backpressure")
                obs.engine_fallback("serve-admit", "Backpressure",
                                    tenant=req.tenant, ops=req.n_ops,
                                    depth=len(self._queued))
                raise Backpressure(
                    f"admission queue at bound ({self.max_depth})")
            self._queued.append(req)
            obs.count("serve.admitted")
            obs.gauge("serve.queue_depth", len(self._queued))
            self._nonempty.notify_all()

    def cancel(self, req_id: str) -> Optional["rq.CheckRequest"]:
        """Remove a queued request and return it, or None when it is not
        queued (a dispatched one is cancelled by its
        ``cancel_requested`` flag, which the group's abort hook reads)."""
        with self._nonempty:
            for i, r in enumerate(self._queued):
                if r.id == req_id:
                    del self._queued[i]
                    obs.gauge("serve.queue_depth", len(self._queued))
                    return r
        return None

    def depth(self) -> int:
        with self._nonempty:
            return len(self._queued)

    def inflight(self) -> Dict[str, int]:
        with self._nonempty:
            return {t: n for t, n in self._inflight.items() if n > 0}

    def lane_loads(self) -> List[int]:
        with self._nonempty:
            return list(self._lane_load)

    # -- the lanes' side -----------------------------------------------------
    def next_batch(self, timeout: Optional[float] = None,
                   lane: Optional[int] = None) -> List["rq.CheckRequest"]:
        """Wait for work (up to ``timeout``: then an empty list) and
        return one dispatch group, counted in flight; pair it with
        :meth:`mark_done`. Selection: expire dead requests, take the
        signature of the oldest queued request, its requests up to each
        tenant's allowance, and the :func:`plan_admission` group that
        holds the oldest. ``lane`` is the calling lane (None: one
        consumer, no placement). A lane first takes its own staged
        groups; a fresh group goes to the least-loaded lane, and when
        that is a sibling the caller selects again."""
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        with self._nonempty:
            while True:
                now = time.monotonic()
                for r in self._expire_queued_locked(now):
                    self._timeout_queued(r)
                if lane is not None and self._staged[lane]:
                    return self._staged[lane].popleft()
                batch = self._select_locked()
                if batch:
                    self._mark_selected_locked(batch, now)
                    if lane is None:
                        return batch
                    target = self._place_locked()
                    self._lane_load[target] += 1
                    for r in batch:
                        r.lane = target
                    if target == lane:
                        return batch
                    self._staged[target].append(batch)
                    self._nonempty.notify_all()
                    continue
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return []
                self._nonempty.wait(remaining)

    def _expire_queued_locked(self, now: float) -> List["rq.CheckRequest"]:
        expired = [r for r in self._queued if r.expired(now)]
        if expired:
            self._queued = [r for r in self._queued if not r.expired(now)]
        return expired

    def _mark_selected_locked(self, batch: List["rq.CheckRequest"],
                              now: float) -> None:
        """Count a selected group in flight at selection, not pickup, so
        the drain condition covers groups staged for a busy lane."""
        for r in batch:
            self._inflight[r.tenant] = self._inflight.get(r.tenant, 0) + 1
            r.t_coalesce = now
            r.status = rq.DISPATCHED
            if r.session is not None:
                # every member session of a mega group
                self._inflight_sessions.add(r.session.id)
        obs.gauge("serve.queue_depth", len(self._queued))
        if len(batch) > 1:
            obs.count("serve.coalesced", len(batch))

    def _place_locked(self) -> int:
        """The least-loaded lane, scanning from the round-robin pointer
        (equal loads rotate); the pointer moves past the winner."""
        best = self._rr
        for k in range(1, self.lanes):
            di = (self._rr + k) % self.lanes
            if self._lane_load[di] < self._lane_load[best]:
                best = di
        self._rr = (best + 1) % self.lanes
        return best

    def _select_locked(self) -> List["rq.CheckRequest"]:
        if not self._queued:
            return []
        allowance: Dict[str, int] = {}
        eligible: List[rq.CheckRequest] = []
        for r in sorted(self._queued, key=lambda r: r.t_submit):
            if r.session is not None \
                    and r.session.id in self._inflight_sessions:
                # its block k is still walking somewhere: k+1 waits
                continue
            a = allowance.get(r.tenant)
            if a is None:
                a = max(0, self.max_inflight_per_tenant
                        - self._inflight.get(r.tenant, 0))
            if a <= 0:
                allowance[r.tenant] = 0
                continue
            allowance[r.tenant] = a - 1
            eligible.append(r)
        if not eligible:
            return []
        # one signature a group, the oldest request's. A session's
        # signature is read once a pass: its cached geometry may flip
        # under a concurrent close, and two reads straddling the flip
        # could take block k+1 without block k
        sess_sig: Dict[str, tuple] = {}
        sigs: Dict[int, tuple] = {}
        for r in eligible:
            if r.session is not None:
                sid = r.session.id
                if sid not in sess_sig:
                    g = r.session.mega_sig()
                    sess_sig[sid] = (("session-mega",) + g
                                     if g is not None
                                     else ("session", sid))
                sigs[id(r)] = (sess_sig[sid] if r.kind == "session-append"
                               else ("session", sid))
            else:
                sigs[id(r)] = r.model_sig
        sig = sigs[id(eligible[0])]
        same = [r for r in eligible if sigs[id(r)] == sig]
        groups = plan_admission(same, group=self.group)
        # the group holding the oldest request goes first, not the
        # longest bucket: fresh long histories must not starve a short one
        pick = next(g for g in groups if 0 in g)
        batch = [same[i] for i in pick]
        chosen = {id(r) for r in batch}
        self._queued = [r for r in self._queued if id(r) not in chosen]
        return batch

    def mark_done(self, batch: Sequence["rq.CheckRequest"],
                  lane: Optional[int] = None) -> None:
        """Release the group's tenants' in-flight slots, its sessions and
        the lane's load, and wake the lanes."""
        with self._nonempty:
            for r in batch:
                n = self._inflight.get(r.tenant, 0) - 1
                if n > 0:
                    self._inflight[r.tenant] = n
                else:
                    self._inflight.pop(r.tenant, None)
                if r.session is not None:
                    self._inflight_sessions.discard(r.session.id)
            if lane is not None and batch:
                self._lane_load[lane] = max(0, self._lane_load[lane] - 1)
            self._nonempty.notify_all()

    def _timeout_queued(self, req: "rq.CheckRequest") -> None:
        obs.count("serve.timeout")
        obs.engine_fallback("serve-timeout", "DeadlineExpired",
                            tenant=req.tenant, ops=req.n_ops,
                            queued_s=round(time.monotonic() - req.t_submit,
                                           6))
        cb = self.on_timeout
        if cb is not None:
            cb(req)

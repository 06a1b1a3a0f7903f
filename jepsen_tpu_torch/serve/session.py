"""Streaming check sessions: the incremental engines of a long-lived
check, fed one append block at a time (a port of the engines of the
reference package's ``jepsen_tpu/serve/session.py``).

- **Register-family models** (:class:`DeviceFrontierEngine`): the
  settled-prefix / unsettled-tail discipline and the permanent
  fail-fast of :mod:`jepsen_tpu_torch.checkers.online`. It IS
  ``online.NativeStreamEngine`` (the C++ monitor core does slot
  assignment, settle-queue snapshots and wildcard interning) with one
  substitution: the settled returns are walked on the card through
  :class:`jepsen_tpu_torch.checkers.reach.FrontierCarry`, the
  reachable-config frontier kept on the device across appends. Each
  block ships only its ``(ret_slot, slot_ops)`` operands and reads back
  the dead index. The unsettled-tail alarm walks a bounded tail from
  the carried set without touching it.
- **``txn-list-append``** (:class:`TxnSessionEngine`): the inferred
  ww/wr/rw adjacency grows block by block
  (:class:`jepsen_tpu_torch.txn.infer.IncrementalInfer`: reads settle
  once every observed value has a known appender, so edges are
  monotone and an early cycle alarm is sound) and the closure re-closes
  only the dirty rows and columns of each block
  (:class:`jepsen_tpu_torch.txn.cycles.IncrementalClosure`, whose join
  is K9).

A capacity decline (dense overflow for the register family, the dense
txn cap) is a recorded route decision; any other fault propagates to
the caller. The session objects above these engines (the session and
its registry, the daemon's session endpoints and journal entries) are
not ported yet (``ROADMAP.md``, Queue 1 item 3(c)).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import online
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.op import Op


class SessionClosed(RuntimeError):
    """An append after the session closed (a client error, HTTP 409)."""


class AdvanceAborted(RuntimeError):
    """A session advance exceeded the dispatcher's wall-clock cap,
    raised from a ``should_abort`` hook between engine steps."""


class TenantSessionCap(RuntimeError):
    """One tenant hit its open-session cap (HTTP 429, cause
    ``tenant-cap``)."""


# -- register-family device engine ----------------------------------------

class DeviceFrontierEngine(online.NativeStreamEngine):
    """``online.NativeStreamEngine`` with the settled-returns walk on the
    card (``device``, default: the card): the feed and settle
    bookkeeping stays in the C++ monitor core (``jt_mon_feed``,
    ``jt_mon_drain``), the carried frontier lives on the device in a
    :class:`reach.FrontierCarry`. A geometry change (a memo rebuild on a
    fresh alphabet entry, slot growth) fetches the frontier to the host,
    re-encodes it exactly as the host engine does, and reseeds the
    carry: rare events that stop once the alphabet does."""

    def __init__(self, model: Model, *, device: _device.DeviceLike = None,
                 **kw: Any) -> None:
        super().__init__(model, **kw)
        self.device = _device.resolve(device)
        self._carry = None                  # reach.FrontierCarry

    # -- geometry-change sync (device to host first) ----------------------
    def _sync_host(self) -> None:
        if self._carry is not None and self.R is not None:
            self.R = self._carry.fetch()
            self._carry = None

    def _rebuild_memo(self) -> None:
        self._sync_host()
        super()._rebuild_memo()
        self._carry = None

    def _grow_W(self, W2: int) -> None:
        self._sync_host()
        super()._grow_W(W2)
        self._carry = None

    def _ensure_carry(self):
        if self._carry is None:
            from jepsen_tpu_torch.checkers import reach
            self._carry = reach.FrontierCarry(self.memo, self.W, self.R,
                                              device=self.device)
        return self._carry

    def host_set(self) -> Optional[np.ndarray]:
        """The carried set as bool ``[S, M]`` on the host (fetched from
        the card when a carry is seeded)."""
        return self._carry.fetch() if self._carry is not None else self.R

    # -- the walks (device) ----------------------------------------------
    def stage_advance(self, run_over: bool = False):
        """First half of :meth:`advance`: drain the monitor and return
        the staged walk operands ``(carry, ret_slot, slot_ops, binds)``,
        or None when there is nothing to walk."""
        if self.violation is not None:
            return None
        self._drain()
        if run_over:
            # stragglers resolve as crashed: the final verdict is exact
            self._resolve_stragglers()
        if self.memo is None:
            return None
        _s, queued, _l, _w, front_ok = self._mon.stats()
        if queued == 0 or not front_ok:
            return None
        rows, slots, binds = self._mon.drain(queued, self.W)
        if len(slots) == 0:
            return None
        return (self._ensure_carry(), slots, rows, binds)

    def commit_advance(self, staged, dead: int) -> Optional[Dict[str, Any]]:
        """Second half of :meth:`advance`: account the walked block and
        turn the exact death index into a violation."""
        _carry, slots, _rows, binds = staged
        n = len(slots) if dead < 0 else dead + 1
        self.settled_returns += n
        self.walked_events += n
        if dead >= 0:
            self.violation = self._violation_at(int(binds[dead]))
        return self.violation

    def advance(self, run_over: bool = False) -> Optional[Dict[str, Any]]:
        if self.violation is not None:
            return self.violation
        staged = self.stage_advance(run_over)
        if staged is None:
            return None
        carry, slots, rows, _binds = staged
        return self.commit_advance(staged, carry.advance(slots, rows))

    def tail_alarm(self) -> Optional[Dict[str, Any]]:
        if self.violation is not None or self.memo is None:
            return None
        self._drain()
        _s, queued, _l, _w, _f = self._mon.stats()
        if queued == 0:
            return None         # nothing unsettled: nothing to alarm on
        rows, slots, binds = self._mon.tail(self._TAIL_CAP, self.W)
        if len(slots) == 0:
            return None
        dead = self._ensure_carry().probe(slots, rows)
        if dead >= 0:
            self.violation = self._violation_at(int(binds[dead]))
            self.violation["tail-alarm"] = True
        return self.violation


# -- txn incremental engine -----------------------------------------------

class TxnSessionEngine:
    """Incremental Elle-style anomaly detection for one session: host
    inference block by block and the closure on ``device`` (default:
    the card). Direct anomalies (non-prefix reads, duplicate appends,
    G1a) fail the session the moment they are proven, as a frontier
    death fails a register session. With ``consistency`` (a level or
    levels of the lattice) the closure carries the K = 4 lane stack and
    every block reports each level's ``holds``; validity gates on the
    requested levels, as in the post-hoc check."""

    def __init__(self, *, max_dense_txns: Optional[int] = None,
                 consistency: Optional[Any] = None,
                 device: _device.DeviceLike = None) -> None:
        from jepsen_tpu_torch.txn import cycles, lattice
        from jepsen_tpu_torch.txn.infer import IncrementalInfer
        self.levels: Optional[List[str]] = (
            None if consistency is None
            else list(lattice.canon_levels(consistency)))
        self.infer = IncrementalInfer()
        self.closure = cycles.IncrementalClosure(
            max_dense_txns=max_dense_txns,
            lattice=self.levels is not None, device=device)
        self.host_mode = False              # permanent after a decline
        self.violation: Optional[Dict[str, Any]] = None
        if self.levels is not None:
            self.booleans = {k: False for k in cycles.LATTICE_KEYS}
            self.holds: Optional[Dict[str, bool]] = \
                lattice.holds_from(self.booleans)
        else:
            self.booleans = {
                "cyc_ww": False, "cyc_wwwr": False,
                "cyc_full": False, "gsingle": False}
            self.holds = None

    def _classify(self) -> Optional[Dict[str, Any]]:
        from jepsen_tpu_torch.txn import host_ref, lattice
        if self.levels is not None:
            # the session-guarantee prefix scans are host work; holds are
            # monotone under extension, so the sticky first violation is
            # sound
            scans = lattice.session_scans(self.infer.txns)
            self.holds = lattice.holds_from(
                self.booleans, session_violated=bool(scans))
            if all(self.holds[lvl] for lvl in self.levels):
                return None
            graph = self.infer.graph()
            starts, ends = self.infer.intervals()
            gsia = host_ref.gsia_scan(graph, starts, ends) is not None
            present = lattice._class_presence(self.booleans, scans, gsia)
            anomalies = [c for lvl in lattice.LEVELS
                         for c in lattice.LEVEL_ANOMALIES[lvl]
                         if present.get(c)]
            out = {"valid": False, "engine": "session-txn",
                   "consistency": list(self.levels),
                   "holds": dict(self.holds),
                   "weakest-violated": lattice.weakest_violated(self.holds),
                   "anomalies": anomalies,
                   "booleans": dict(self.booleans)}
            if anomalies:
                out["anomaly"] = anomalies[0]
            if scans:
                out["session-violations"] = scans[:8]
            return out
        anomalies = host_ref.derive_anomalies(self.booleans)
        if anomalies:
            return {"valid": False, "engine": "session-txn",
                    "anomalies": anomalies, "anomaly": anomalies[0],
                    "booleans": dict(self.booleans)}
        return None

    def advance_block(self, ops: Sequence[Op]) -> Optional[Dict]:
        """Feed one append block; returns the violation (sticky) or
        None. A fault of the closure propagates."""
        from jepsen_tpu_torch.txn import cycles
        from jepsen_tpu_torch.txn.infer import CM
        if self.violation is not None:
            return self.violation
        self.infer.feed_block(ops)
        if self.infer.direct:
            kinds = sorted({d["type"] for d in self.infer.direct})
            self.violation = {
                "valid": False, "engine": "session-txn-infer",
                "anomalies": kinds, "anomaly": kinds[0],
                "direct": [dict(d) for d in self.infer.direct[:32]]}
            return self.violation
        src, dst, et = self.infer.drain_new_edges()
        if self.levels is not None:
            # the commit-order lane rides the same dirty-block feed:
            # completion-ordered arrival means cm edges only ever point
            # INTO the new txns, so the drain is a delta too
            csrc, cdst = self.infer.drain_new_cm()
            if csrc.size:
                src = np.concatenate([src.astype(np.int64),
                                      csrc.astype(np.int64)])
                dst = np.concatenate([dst.astype(np.int64),
                                      cdst.astype(np.int64)])
                et = np.concatenate([et.astype(np.int64),
                                     np.full(csrc.size, CM, np.int64)])
        if self.host_mode:
            self.booleans = self._host_booleans()
        else:
            try:
                self.booleans = self.closure.add_block(
                    max(self.infer.n, 1), src, dst, et)
            except cycles.ClosureOverflow as e:
                # a capacity decline, not a fault: a recorded route, the
                # host booleans from here on
                obs.decision("session-advance", "route",
                             cause=f"txn-overflow:{e}")
                self.host_mode = True
                self.booleans = self._host_booleans()
        self.violation = self._classify()
        return self.violation

    def _host_booleans(self) -> Dict[str, bool]:
        from jepsen_tpu_torch.txn import host_ref
        g = self.infer.graph()
        booleans = dict(host_ref.classify_booleans(g))
        if self.levels is not None:
            starts, ends = self.infer.intervals()
            booleans.update(host_ref.lattice_classify_booleans(
                g, starts, ends))
        return booleans

    def to_host(self) -> None:
        """Continue on the host SCC booleans for good (the caller's
        decision after a fault of the closure)."""
        self.host_mode = True

    def close_incremental(self) -> Dict[str, Any]:
        """Resolve stragglers and return the final incremental verdict.
        The classification after resolution is :meth:`advance_block`
        with an empty feed, so the close path cannot drift from the
        append path."""
        if self.violation is None:
            self.infer.resolve_stragglers()
            self.advance_block([])
        if self.violation is not None:
            return dict(self.violation)
        out = {"valid": True, "engine": "session-txn",
               "txns": self.infer.n,
               "booleans": dict(self.booleans)}
        if self.levels is not None:
            out["consistency"] = list(self.levels)
            out["holds"] = dict(self.holds)
        return out

    def in_flight(self) -> int:
        return len(self.infer._live) + self.infer.pending_reads()

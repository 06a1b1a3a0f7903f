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
txn cap) is a recorded route decision of the engine.

Above the engines, a :class:`Session` is one long-lived check of the
daemon's (``POST /session``, ``.../append``, ``.../close``): it carries
its engine's state, the accumulated op stream and the sticky first
violation, and its close returns the exact verdict of
``facade.auto_check_packed`` (``auto_check_txn``) on the whole history.
:class:`SessionRegistry` looks sessions up, bounds the open ones (per
tenant too) and counts them for ``/stats`` and the results browser.
:func:`advance_group` advances one block of each session of a
same-geometry group in one launch of K10
(:mod:`jepsen_tpu_torch.checkers.reach_word`).

The fault rule (the reference falls back to the host monitor on every
error; the port would then hide a fault of K10 behind K1's answers):

- a device fault (:func:`.recovery.is_device_fault`) in an advance, in
  K10's launch or in its collect ends every session it touched: status
  ``error``, a result with ``cause: "device-fault"``, no re-advance and
  no host monitor; the daemon counts it (``serve.device_faults``,
  ``/healthz`` 503);
- only an injected :class:`.faults.InjectedFault` or a capacity
  decline takes the reference's exactly-one ``session-advance`` fallback
  to the host monitor (at a group's launch or collect: one
  ``session-mega`` record and every staged member re-advanced alone);
- the dispatcher's deadline abort (:class:`AdvanceAborted`) ends the
  session ``error`` with ``cause: "deadline"`` and keeps no host
  monitor, so a slow kernel is not hidden behind host answers;
- any other exception ends the session ``error`` with ``cause:
  "fault"``.
"""
from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import online, reach_word
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.op import Op
from jepsen_tpu_torch.serve import faults, recovery

log = logging.getLogger("jepsen.serve.session")

# engine options a session passes to its engines and to the close's
# exact check (the daemon allow-lists the client's options)
_ENG_KW = ("max_states", "max_slots", "max_dense")

# the result causes of a session a fault ended (status "error"), as the
# dispatcher's for a one-shot group
DEVICE_FAULT = "device-fault"
ENGINE_FAULT = "fault"
DEADLINE = "deadline"
FAULT_CAUSES = (DEVICE_FAULT, ENGINE_FAULT, DEADLINE)


def new_session_id() -> str:
    import uuid
    return "s" + uuid.uuid4().hex[:15]


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
        # the self-nemesis hook, fired just before the closure: after
        # inference took the block, so a fallback resumes with an empty
        # feed (the host booleans read the whole accumulated graph)
        self.fire_hook = lambda: None
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
                self.fire_hook()
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


# -- the session ----------------------------------------------------------

def _fallback_takes(e: BaseException) -> bool:
    """Whether a failed advance takes the host monitor (the reference's
    exactly-one fallback): an injected fault or a capacity decline. A
    device fault, a deadline abort or any other error ends the session
    instead (:meth:`Session._fail`)."""
    return recovery.ladder_takes(e)


class Session:
    """One long-lived check: the engine's carried state, the accumulated
    op stream (for the close and for a host fallback's replay) and the
    sticky first violation. Every method that touches that state holds
    ``self.lock`` (the dispatcher already runs a session's blocks in
    order; the lock covers journal replay and HTTP status reads too).
    ``device`` is where the engines and the close's exact check run;
    ``use_device=False`` sends the register family to the host monitor
    from the start (the daemon's ``session_device`` keyword)."""

    def __init__(self, sid: str, tenant: str, model_name: str,
                 model: Model, opts: Optional[Dict[str, Any]] = None, *,
                 device: _device.DeviceLike = None,
                 use_device: bool = True) -> None:
        from jepsen_tpu_torch.txn.ops import ListAppend
        self.id = sid
        self.tenant = tenant
        self.model_name = model_name
        self.model = model
        self.opts = dict(opts or {})
        self.device = _device.resolve(device)
        self.created_wall = time.time()
        self.created_mono = time.monotonic()
        # the idle clock: every append (and replayed append) moves it; an
        # open session idle past the registry's TTL is closed by the
        # daemon's sweeper
        self.last_active_mono = self.created_mono
        self.lock = threading.RLock()
        self.seq = 0                        # admitted append blocks
        self.ops: List[Op] = []
        self.ops_total = 0                  # survives the close's drop
        self.closed = False
        self.closing = False
        self.faulted = False                # a fault ended it (error)
        self.result: Optional[Dict[str, Any]] = None
        self.violation: Optional[Dict[str, Any]] = None
        self.fallbacks = 0
        self.appends = 0
        self.replayed = 0
        self.is_txn = isinstance(model, ListAppend)
        self._host: Optional[online.OnlineLinearizable] = None
        self._eng: Any = None
        self.engine_name = "session-host"
        # the cached mega-group geometry (None: the session joins no
        # group). Written under the lock at the end of every transition,
        # read without it by the coalescer: a stale read costs grouping,
        # never correctness, since advance_group checks it again under
        # the lock
        self._mega_sig: Optional[tuple] = None
        self._route(use_device)

    # -- the route -------------------------------------------------------
    def _eng_kw(self) -> Dict[str, Any]:
        return {k: v for k, v in self.opts.items() if k in _ENG_KW}

    def _route(self, use_device: bool) -> None:
        if self.is_txn:
            self._eng = TxnSessionEngine(
                max_dense_txns=self.opts.get("max_dense_txns"),
                consistency=self.opts.get("consistency"),
                device=self.device)
            self._eng.fire_hook = (
                lambda: faults.fire("session-advance",
                                    tenants=[self.tenant]))
            self.engine_name = "session-txn-mxu"
            return
        if not use_device:
            obs.decision("session-advance", "route", cause="opt-out",
                         session=self.id)
            self._to_host_monitor(record_fallback=False)
            return
        self._eng = DeviceFrontierEngine(self.model, device=self.device,
                                         **self._eng_kw())
        self.engine_name = "session-frontier-device"

    def _to_host_monitor(self, record_fallback: bool,
                         exc: Optional[BaseException] = None) -> None:
        """Move to the host for good: the register family replays the
        accumulated stream into :class:`online.OnlineLinearizable` (its
        own engine re-derives the state), a txn session keeps its
        inference and takes the host booleans."""
        if record_fallback:
            self.fallbacks += 1
            obs.engine_fallback("session-advance",
                                type(exc).__name__ if exc else "error",
                                session=self.id, ops=len(self.ops))
            obs.count("serve.session.fallback")
            log.warning("session %s: %r; host monitor from here on",
                        self.id, exc)
        if self.is_txn:
            self._eng.to_host()
            self.engine_name = "session-txn-host"
            return
        mon = online.OnlineLinearizable(self.model, device=self.device,
                                        **self._eng_kw())
        for op in self.ops:
            mon.observe(op)
        mon.flush()
        self._host = mon
        self._eng = None
        self.engine_name = "session-host-monitor"
        if mon.violation is not None and self.violation is None:
            self.violation = dict(mon.violation)
        self._update_mega_sig()

    def _fail(self, e: BaseException, block_ops: int = 0,
              seq: Optional[int] = None) -> Dict[str, Any]:
        """A fault that no fallback takes ends the session: status
        ``error``, the result ``{"valid": "unknown", "cause", "error"}``
        (cause ``device-fault``, ``deadline`` or ``fault``), the engine's
        state dropped. Returns the block's verdict, which carries the
        cause."""
        cause = (DEVICE_FAULT if recovery.is_device_fault(e) else
                 DEADLINE if isinstance(e, AdvanceAborted) else ENGINE_FAULT)
        text = f"{type(e).__name__}: {e}"
        log.error("session %s ended on a %s: %s", self.id, cause, text,
                  exc_info=e)
        obs.decision("session-advance", "fault", cause=cause,
                     session=self.id, error=text[:500])
        obs.count("serve.session.faults")
        self.faulted = True
        self.closed = True
        self.result = {"valid": "unknown", "cause": cause, "error": text,
                       "session": self.id, "appends": self.appends,
                       "session-ops": len(self.ops)}
        self.ops_total = len(self.ops)
        self.ops = []
        self._eng = None
        self._host = None
        self._update_mega_sig()
        out = dict(self.result)
        out.update({"seq": self.seq if seq is None else seq,
                    "block-ops": block_ops, "valid-so-far": None})
        return out

    # -- mega-group eligibility ------------------------------------------
    def mega_sig(self) -> Optional[tuple]:
        """The session's mega-group geometry, or None when it cannot join
        a group: txn, on the host, closed or closing, violated, a carry
        on the torch walk, or no carry seeded yet (its first advance runs
        alone and seeds it). A cached read without the lock."""
        return self._mega_sig

    def _update_mega_sig(self) -> None:
        sig = None
        if not (self.closed or self.closing or self.is_txn
                or self._host is not None or self.violation is not None):
            carry = getattr(self._eng, "_carry", None)
            if carry is not None:
                sig = reach_word.mega_geometry(carry)
        self._mega_sig = sig

    # -- appends ---------------------------------------------------------
    def _take_block(self, ops: Sequence[Op]) -> None:
        self.last_active_mono = time.monotonic()
        self.appends += 1
        self.ops.extend(ops)
        self.ops_total = len(self.ops)
        obs.count("serve.session.appends")
        obs.count("serve.session.append_ops", len(ops))

    def _route_overflow(self, e: BaseException, **kw: Any) -> None:
        # a capacity decline is a route decision, never a fallback
        obs.decision("session-advance", "route",
                     cause=f"overflow:{type(e).__name__}", session=self.id,
                     **kw)
        self._to_host_monitor(record_fallback=False)

    def advance_block(self, ops: Sequence[Op], seq: Optional[int] = None,
                      should_abort: Optional[Any] = None) -> Dict[str, Any]:
        """Feed one block and return its incremental verdict with the
        tail alarm's. Fail-fast is permanent: once a violation is proven,
        every later append returns it (linearizability and
        serializability are prefix-closed). ``should_abort`` (the
        dispatcher's deadline) is polled between the engine's steps; when
        it fires the session ends ``error`` (cause ``deadline``)."""
        with self.lock:
            if self.closed:
                raise SessionClosed(f"session {self.id} is closed")
            self._take_block(ops)
            tail_hit = False
            if self.violation is None:
                try:
                    # the self-nemesis point (register family; the txn
                    # engine fires its own after inference): the host
                    # monitor replays the whole stream, so firing before
                    # the feed loses nothing
                    if not self.is_txn:
                        faults.fire("session-advance",
                                    tenants=[self.tenant])
                    v = self._advance_engine(ops, should_abort)
                except online._Overflow as e:
                    self._route_overflow(e)
                    v = self.violation
                except Exception as e:                  # noqa: BLE001
                    if not _fallback_takes(e):
                        return self._fail(e, len(ops), seq)
                    v = self._fall_back(e)
                if v is not None and self.violation is None:
                    self.violation = dict(v)
                tail_hit = bool((v or {}).get("tail-alarm"))
            self._update_mega_sig()
            return self._append_verdict(len(ops), tail_hit, seq)

    def _fall_back(self, e: BaseException) -> Optional[Dict[str, Any]]:
        """The exactly-one ``session-advance`` fallback; the verdict of
        the block from the host."""
        if self.is_txn:
            obs.engine_fallback("session-advance", type(e).__name__,
                                session=self.id, ops=len(self.ops))
            obs.count("serve.session.fallback")
            self.fallbacks += 1
            self._eng.to_host()
            self.engine_name = "session-txn-host"
            return self._eng.advance_block([])
        self._to_host_monitor(record_fallback=True, exc=e)
        return self.violation

    def _advance_engine(self, ops: Sequence[Op],
                        should_abort: Optional[Any] = None
                        ) -> Optional[Dict[str, Any]]:
        def _check_abort() -> None:
            if should_abort is not None and should_abort():
                raise AdvanceAborted("session advance aborted past the "
                                     "dispatch deadline")
        if self._host is not None:
            # the fallback's target never aborts: it would leave the
            # block without a verdict
            for op in ops:
                self._host.observe(op)
            self._host.flush()
            return self._host.violation
        if self.is_txn:
            _check_abort()
            return self._eng.advance_block(ops)
        self._eng.feed_many(list(ops))
        _check_abort()
        v = self._eng.advance()
        _check_abort()
        if v is None:
            v = self._eng.tail_alarm()
        return v

    def _append_verdict(self, block_ops: int, tail_hit: bool,
                        seq: Optional[int] = None) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "session": self.id,
            "seq": self.seq if seq is None else seq,
            "block-ops": block_ops, "ops": len(self.ops),
            "valid-so-far": self.violation is None,
            "tail-alarm": tail_hit,
            "engine": self.engine_name,
        }
        if self._host is not None:
            out["in-flight"] = (self._host._engine.in_flight()
                                if self._host._engine is not None else None)
        elif self.is_txn:
            out["txns"] = self._eng.infer.n
            out["in-flight"] = self._eng.in_flight()
            if self._eng.holds is not None:
                out["holds"] = dict(self._eng.holds)
        else:
            out["settled-returns"] = self._eng.settled_returns
            out["in-flight"] = self._eng.in_flight()
        if self.violation is not None:
            out["violation"] = dict(self.violation)
        return out

    # -- a mega-group member ---------------------------------------------
    def _stage_block(self, ops: Sequence[Op], seq: Optional[int],
                     should_abort: Optional[Any], geom: tuple):
        """The first half of :meth:`advance_block` for a member of a
        group (its lock held by :func:`advance_group`): feed the block
        and stage the walk. ``("staged", st)`` when the member joins the
        launch, else ``("done", verdict)``: sticky, txn or host sessions,
        nothing to walk, a capacity decline, a fallback, a fault, or a
        feed that regrew the geometry (the member then advances alone on
        its staged operands). Each branch is the solo ladder's."""
        if self.closed:
            raise SessionClosed(f"session {self.id} is closed")
        if self.violation is not None or self.is_txn \
                or self._host is not None:
            return ("done", self.advance_block(ops, seq, should_abort))
        self._take_block(ops)
        try:
            faults.fire("session-advance", tenants=[self.tenant])
            if should_abort is not None and should_abort():
                raise AdvanceAborted("session advance aborted past the "
                                     "dispatch deadline")
            self._eng.feed_many(list(ops))
            st = self._eng.stage_advance()
            v = None
            if st is not None \
                    and reach_word.mega_geometry(st[0]) != geom:
                obs.decision("session-mega", "regrow", session=self.id)
                v = self._eng.commit_advance(st, st[0].advance(st[1], st[2]))
                st = None
            if st is None:
                return ("done", self._finish_block(len(ops), seq, v))
            return ("staged", st)
        except online._Overflow as e:
            self._route_overflow(e)
            return ("done", self._finish_block(len(ops), seq,
                                               self.violation))
        except Exception as e:                          # noqa: BLE001
            if not _fallback_takes(e):
                return ("done", self._fail(e, len(ops), seq))
            self._to_host_monitor(record_fallback=True, exc=e)
            return ("done", self._finish_block(len(ops), seq,
                                               self.violation))

    def _finish_block(self, block_ops: int, seq: Optional[int],
                      v: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        """The second half: the walk's verdict is in; the tail alarm
        (device members) and the block's verdict, with the solo ladder's
        fallback and fault rule."""
        try:
            if v is None and self._host is None and not self.is_txn \
                    and self._eng is not None:
                v = self._eng.tail_alarm()
        except Exception as e:                          # noqa: BLE001
            if not _fallback_takes(e):
                return self._fail(e, block_ops, seq)
            self._to_host_monitor(record_fallback=True, exc=e)
            v = self.violation
        if v is not None and self.violation is None:
            self.violation = dict(v)
        tail_hit = bool((v or {}).get("tail-alarm"))
        self._update_mega_sig()
        return self._append_verdict(block_ops, tail_hit, seq)

    # -- close -----------------------------------------------------------
    def close(self) -> Dict[str, Any]:
        """Resolve the unsettled tail (the incremental verdict becomes the
        whole history's) and return the exact verdict and witness:
        ``facade.auto_check_packed`` (``auto_check_txn``) on the
        concatenated history, the protocol's differential identity, held
        against the incremental verdict (a divergence is counted and
        flagged, never silent). A fault in either ends the session
        ``error`` (:meth:`_fail`)."""
        with self.lock:
            if self.closed:
                return dict(self.result or {})
            try:
                inc = self._close_incremental()
                final = self._exact_final()
            except Exception as e:                      # noqa: BLE001
                self._fail(e)
                return dict(self.result)
            inc_valid = inc.get("valid")
            if inc_valid in (True, False) \
                    and final.get("valid") in (True, False) \
                    and inc_valid is not final["valid"]:
                obs.count("serve.session.divergence")
                log.error("session %s incremental/exact divergence: %r vs "
                          "%r", self.id, inc_valid, final.get("valid"))
                final["incremental-divergence"] = True
            # a lattice session promises its per-level holds too
            if isinstance(inc.get("holds"), dict) \
                    and isinstance(final.get("holds"), dict) \
                    and inc["holds"] != final["holds"]:
                obs.count("serve.session.divergence")
                log.error("session %s lattice holds divergence: %r vs %r",
                          self.id, inc["holds"], final["holds"])
                final["incremental-divergence"] = True
            final["session"] = self.id
            final["appends"] = self.appends
            final["session-ops"] = len(self.ops)
            final["session-engine"] = self.engine_name
            final["incremental"] = {
                k: inc.get(k) for k in
                ("valid", "engine", "settled-returns", "ops-checked",
                 "txns", "anomalies", "holds", "weakest-violated")
                if inc.get(k) is not None}
            self.closed = True
            self.result = final
            # a closed session keeps its verdict, not its stream or the
            # engine's state on the card
            self.ops_total = len(self.ops)
            self.ops = []
            self._eng = None
            self._host = None
            self._update_mega_sig()
            obs.count("serve.session.closed")
            return dict(final)

    def _close_incremental(self) -> Dict[str, Any]:
        try:
            if self._host is not None:
                return self._host.stop()
            if self.is_txn:
                return self._eng.close_incremental()
            v = self._eng.advance(run_over=True)
            if v is not None:
                return dict(v)
            return {"valid": True, "engine": self.engine_name,
                    "settled-returns": self._eng.settled_returns}
        except online._Overflow as e:
            self._route_overflow(e, close=True)
            return self._host.stop()
        except Exception as e:                          # noqa: BLE001
            if not _fallback_takes(e):
                raise
            if self.violation is not None:
                return dict(self.violation)
            if self.is_txn:
                obs.engine_fallback("session-advance", type(e).__name__,
                                    session=self.id, close=True)
                obs.count("serve.session.fallback")
                self.fallbacks += 1
                self._eng.to_host()
                return self._eng.close_incremental()
            self._to_host_monitor(record_fallback=True, exc=e)
            return self._host.stop()

    def _exact_final(self) -> Dict[str, Any]:
        from jepsen_tpu_torch.checkers import facade
        if not self.ops:
            return {"valid": True, "engine": "session-empty", "ops": 0}
        # indexed in arrival order: blocks may carry indices of their
        # own (each from 0), and a pack would re-sort them across blocks
        ops = h.index(list(self.ops))
        kw = dict(self.opts)
        kw["device"] = self.device
        try:
            if self.is_txn:
                return facade.auto_check_txn(ops, kw)
            return facade.auto_check_packed(self.model, h.pack(ops), kw)
        except facade._capacity_declines() as e:
            return {"valid": "unknown", "error": f"{type(e).__name__}: {e}"}

    # -- views -----------------------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self.lock:
            out = {
                "session": self.id, "tenant": self.tenant,
                "model": self.model_name,
                "status": ("error" if self.faulted else
                           "closed" if self.closed else "open"),
                "seq": self.seq, "appends": self.appends,
                "ops": self.ops_total,
                "age-s": round(time.monotonic() - self.created_mono, 3),
                "engine": self.engine_name,
                "valid-so-far": self.violation is None,
                "replayed-appends": self.replayed,
            }
            if self.violation is not None:
                out["violation"] = dict(self.violation)
            if self.result is not None:
                out["result"] = dict(self.result)
            return out


# -- the mega-group advance -----------------------------------------------

# the group width below which sessions advance alone: one staged member
# gains nothing from a group launch (the reference's default)
_MEGA_CROSSOVER_DEFAULT = 2


def mega_crossover() -> int:
    """The width from which a group advances in one launch of K10: the
    recorded ``session-mega`` ``crossover`` winner of the autotune table,
    else the reference's default, 2."""
    from jepsen_tpu_torch.checkers import autotune

    w = autotune.winner("session-mega", "crossover")
    if w is not None and str(w).isdigit():
        return max(1, int(w))
    return _MEGA_CROSSOVER_DEFAULT


def advance_group(entries: Sequence[tuple],
                  should_abort: Optional[Any] = None) -> List[Dict[str, Any]]:
    """Advance one block of each member of a same-geometry group through
    one launch of K10. ``entries`` are ``(session, ops, seq)``, one block
    a session; returns the members' verdicts in order (a member that
    raced a close gets the ``closed`` verdict, so a straggler cannot
    abort the group).

    Members are isolated: one member's stage or commit falls back or
    fails (the module's fault rule) alone. A launch or collect that
    fails on an injected fault or a capacity decline records one
    ``session-mega`` fallback and re-advances every staged member alone
    on its staged operands (its monitor drain is spent: re-walking them
    is the only sound retry); one that fails on a device fault or any
    other error ends every staged member ``error``, with no re-advance
    and no host monitor.

    Lock order: member locks are taken in list order and held across
    stage, launch and commit; the coalescer keeps a session in at most
    one group in flight and nothing else takes two session locks."""
    results: List[Optional[Dict[str, Any]]] = [None] * len(entries)
    if not entries:
        return []
    geom = entries[0][0].mega_sig()
    if geom is None or len(entries) < mega_crossover():
        return [s.advance_block(o, seq=q, should_abort=should_abort)
                for s, o, q in entries]
    with contextlib.ExitStack() as stack:
        for s, _o, _q in entries:
            stack.enter_context(s.lock)
        staged: List[tuple] = []                # (index, session, staged)
        for k, (sess, ops, seq) in enumerate(entries):
            try:
                if sess.mega_sig() != geom:
                    # the cached geometry moved since selection
                    results[k] = sess.advance_block(
                        ops, seq=seq, should_abort=should_abort)
                    continue
                kind, payload = sess._stage_block(ops, seq, should_abort,
                                                  geom)
            except SessionClosed as e:
                results[k] = {"valid": "unknown", "cause": "closed",
                              "error": str(e)}
                continue
            if kind == "done":
                results[k] = payload
            else:
                staged.append((k, sess, payload))
        if staged:
            _advance_staged(entries, staged, results)
    return results


def _advance_staged(entries, staged, results) -> None:
    """The staged members' launch, collect and commits."""
    t0 = time.monotonic()
    obs.count("serve.session.mega.groups")
    obs.count("serve.session.mega.lanes", len(staged))
    deads = None
    failure: Optional[BaseException] = None
    inf = None
    try:
        faults.fire("session-mega",
                    tenants=sorted({s.tenant for _k, s, _st in staged}))
        inf = reach_word.launch_frontiers_mega(
            [st[0] for _k, _s, st in staged],
            [(st[1], st[2]) for _k, _s, st in staged])
    except Exception as e:                              # noqa: BLE001
        failure = e
    if inf is not None:
        try:
            deads = reach_word.collect_frontiers_mega(inf)
        except Exception as e:                          # noqa: BLE001
            failure = e
    if failure is not None:
        obs.engine_fallback("session-mega", type(failure).__name__,
                            lanes=len(staged), collect=inf is not None)
    for j, (k, sess, st) in enumerate(staged):
        ops_k, seq_k = entries[k][1], entries[k][2]
        if failure is not None and not _fallback_takes(failure):
            results[k] = sess._fail(failure, len(ops_k), seq_k)
            continue
        try:
            dead = deads[j] if deads is not None \
                else st[0].advance(st[1], st[2])
            v = sess._eng.commit_advance(st, dead)
            results[k] = sess._finish_block(len(ops_k), seq_k, v)
        except Exception as e:                          # noqa: BLE001
            if not _fallback_takes(e):
                results[k] = sess._fail(e, len(ops_k), seq_k)
                continue
            sess._to_host_monitor(record_fallback=True, exc=e)
            results[k] = sess._finish_block(len(ops_k), seq_k,
                                            sess.violation)
    obs.count("serve.session.mega.scatter_s", time.monotonic() - t0)


# -- the registry ---------------------------------------------------------

class SessionRegistry:
    """id → session, and the open-session census of ``/stats`` and the
    results browser's ``/engine`` page. Closed sessions are kept
    FIFO-bounded (their result stays readable, a long-lived daemon does
    not grow one session at a time); opens past ``max_open``, or past
    ``tenant_max_open`` for one tenant, are refused. ``_by_id`` and
    ``_closed_order`` are touched under ``self._lock``."""

    def __init__(self, max_open: int = 1024, keep_closed: int = 256,
                 tenant_max_open: int = 64,
                 idle_ttl_s: Optional[float] = None) -> None:
        self._lock = threading.Lock()
        self._by_id: "OrderedDict[str, Session]" = OrderedDict()
        self._closed_order: "deque[str]" = deque()
        self._max_open = max_open
        self._keep_closed = keep_closed
        self.tenant_max_open = tenant_max_open
        self.idle_ttl_s = idle_ttl_s

    def add(self, sess: Session) -> None:
        with self._lock:
            n_open = n_tenant = 0
            for s in self._by_id.values():
                if not s.closed:
                    n_open += 1
                    n_tenant += s.tenant == sess.tenant
            if n_open >= self._max_open:
                raise RuntimeError(
                    f"open-session bound reached ({self._max_open})")
            if self.tenant_max_open and n_tenant >= self.tenant_max_open:
                # one tenant must not take the global bound from the rest
                obs.count("serve.session.tenant_cap")
                raise TenantSessionCap(
                    f"tenant {sess.tenant!r} open-session cap reached "
                    f"({self.tenant_max_open})")
            self._by_id[sess.id] = sess
        obs.count("serve.session.opened")
        self._gauge()

    def idle_open(self, ttl_s: float) -> List[Session]:
        """Open sessions whose last append is more than ``ttl_s`` seconds
        ago (the daemon's sweeper closes them)."""
        now = time.monotonic()
        with self._lock:
            return [s for s in self._by_id.values()
                    if not s.closed and now - s.last_active_mono > ttl_s]

    def get(self, sid: str) -> Optional[Session]:
        with self._lock:
            return self._by_id.get(sid)

    def mark_closed(self, sess: Session) -> None:
        with self._lock:
            self._closed_order.append(sess.id)
            while len(self._closed_order) > self._keep_closed:
                old = self._closed_order.popleft()
                s = self._by_id.get(old)
                if s is not None and s.closed:
                    self._by_id.pop(old, None)
        self._gauge()

    def _gauge(self) -> None:
        obs.gauge("serve.session.open", self.open_count())

    def open_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._by_id.values() if not s.closed)

    def census(self) -> Dict[str, Any]:
        """Open count, oldest open age, open sessions a tenant, and the
        appends and ops the open sessions carry."""
        now = time.monotonic()
        with self._lock:
            open_s = [s for s in self._by_id.values() if not s.closed]
            per_tenant: Dict[str, int] = {}
            for s in open_s:
                per_tenant[s.tenant] = per_tenant.get(s.tenant, 0) + 1
            return {
                "open": len(open_s),
                "closed": len(self._closed_order),
                "oldest-age-s": (round(max(now - s.created_mono
                                           for s in open_s), 3)
                                 if open_s else None),
                "per-tenant": per_tenant,
                "appends": sum(s.appends for s in open_s),
                "ops": sum(s.ops_total for s in open_s),
                "tenant-cap": self.tenant_max_open,
                "idle-ttl-s": self.idle_ttl_s,
                "oldest-idle-s": (round(max(now - s.last_active_mono
                                            for s in open_s), 3)
                                  if open_s else None),
            }

"""Request objects and the daemon-wide registry (a port of the
reference package's ``jepsen_tpu/serve/request.py``).

A :class:`CheckRequest` is one client-submitted check: the packed
history, the resolved model, per-request options, its tenant and an
optional deadline. Its states::

    queued -> dispatched -> done
       |          |-> timeout      (deadline passed; verdict "unknown")
       |          |-> error        (a device fault or another engine
       |                            fault: no retry, no host rescue)
       |          |-> quarantined  (the poison member of a group that an
       |                            injected fault or a capacity decline
       |                            failed, cornered by bisection)
       |-> timeout                 (deadline passed while queued)
    queued -> cancelled            (client DELETE before dispatch)

A request refused by backpressure is a 429 at admission and never
enters the registry. The :class:`Registry` looks requests up by id
(``GET /check/<id>``), keeps per-tenant serve ledgers and status
counts, and retains terminal requests FIFO-bounded, so a long-lived
daemon does not grow one verdict at a time.
"""
from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.op import Op
from jepsen_tpu_torch.serve import faults

QUEUED = "queued"
DISPATCHED = "dispatched"
DONE = "done"
TIMEOUT = "timeout"
CANCELLED = "cancelled"
QUARANTINED = "quarantined"
ERROR = "error"

_TERMINAL = (DONE, TIMEOUT, CANCELLED, QUARANTINED, ERROR)

# a request's stitched trace is bounded, so a retained terminal request
# costs a verdict's bytes, never a dispatch's whole ledger
_TRACE_CAP = 64


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass
class CheckRequest:
    """One admitted check. Mutable fields are written under the
    registry's or the queue's lock, or by the lane thread that owns the
    request's dispatch group."""
    id: str
    tenant: str
    model_name: str
    model: Model
    packed: Optional[h.PackedHistory]
    history: Sequence[Op]
    n_ops: int = 0                          # survives the payload drop
    opts: Dict[str, Any] = field(default_factory=dict)
    deadline: Optional[float] = None        # a time.monotonic() instant
    idem_key: Optional[str] = None          # client idempotency key
    requeues: int = 0                       # hung-dispatch requeues
    journaled: bool = False                 # has a journal entry
    # a session's block rides the same queue as a one-shot check: kind
    # "session-append" or "session-close", its session and its place in
    # the session's order; its journal entry is the session's
    kind: str = "check"
    session: Optional[Any] = None           # serve.session.Session
    seq: int = 0
    lane: Optional[int] = None              # the dispatch lane it rode
    # stage stamps (time.monotonic): admit -> coalesce (selected into a
    # group) -> dispatch (engine call) -> collect (engine returned) ->
    # done (published); t_submit_wall anchors them to the wall clock
    t_submit: float = field(default_factory=time.monotonic)
    t_submit_wall: float = field(default_factory=time.time)
    t_coalesce: Optional[float] = None
    t_dispatch: Optional[float] = None
    t_collect: Optional[float] = None
    t_done: Optional[float] = None
    status: str = QUEUED
    result: Optional[Dict[str, Any]] = None
    run_dir: Optional[str] = None
    done_event: threading.Event = field(default_factory=threading.Event)
    cancel_requested: bool = False
    device_s: Optional[float] = None        # attributed device seconds
    # the lane thread's records of this request's dispatch, tagged with
    # its id, so GET /check/<id> shows what its dispatch did
    trace: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def model_sig(self) -> tuple:
        """Coalescing key: requests with one signature may share a
        dispatch group (one model, for the union prep; the same engine
        options, since a group walks once). List options (the canonical
        ``consistency`` levels) are tupled to stay hashable.

        A session's blocks key on the session, so that they advance its
        carried state in order and never mix with one-shot checks; the
        appends of sessions whose carries share a walk geometry share
        ``("session-mega",) + geometry``, so that one K10 launch can
        advance them all. The geometry is the session's cached read
        (:meth:`.session.Session.mega_sig`): a stale one costs grouping,
        never order, since a close queues after its appends and the
        group is checked again under each session's lock."""
        if self.session is not None:
            if self.kind == "session-append":
                g = self.session.mega_sig()
                if g is not None:
                    return ("session-mega",) + g
            return ("session", self.session.id)
        return (type(self.model).__name__, repr(self.model),
                tuple(sorted((k, tuple(v) if isinstance(v, list) else v)
                             for k, v in self.opts.items())))

    def expired(self, now: Optional[float] = None) -> bool:
        """The deadline has passed, on the deadline clock: monotonic time
        plus the self-nemesis clock jump (:func:`faults.clock_skew`, 0
        unless armed), so the queue's scan and the dispatch's abort hook
        see one clock."""
        if self.deadline is None:
            return False
        return (now if now is not None else time.monotonic()) \
            + faults.clock_skew() >= self.deadline

    @property
    def terminal(self) -> bool:
        return self.status in _TERMINAL

    def stitch(self, recs: List[Dict[str, Any]]) -> None:
        """Append lane-thread records to this request's trace, tagged
        with its id (bounded at ``_TRACE_CAP``; the overflow is
        counted)."""
        room = _TRACE_CAP - len(self.trace)
        for r in recs[:max(0, room)]:
            rec = dict(r)
            rec["id"] = self.id
            self.trace.append(rec)
        if len(recs) > room:
            obs.count("serve.trace_truncated", len(recs) - room)

    def waterfall(self) -> List[Dict[str, Any]]:
        """The request's life as stages relative to submit: ``queued``,
        ``coalesce``, ``walk``, ``publish``; a stage appears when both
        its stamps exist (a queued timeout shows its queue time only)."""
        out: List[Dict[str, Any]] = []

        def add(stage: str, start: Optional[float],
                end: Optional[float]) -> None:
            if start is None or end is None:
                return
            out.append({"stage": stage,
                        "start-s": round(start - self.t_submit, 6),
                        "dur-s": round(max(0.0, end - start), 6)})

        add("queued", self.t_submit, self.t_coalesce or self.t_done)
        add("coalesce", self.t_coalesce, self.t_dispatch)
        add("walk", self.t_dispatch, self.t_collect)
        add("publish", self.t_collect, self.t_done)
        return out

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "id": self.id, "tenant": self.tenant,
            "model": self.model_name, "status": self.status,
            "ops": int(self.n_ops),
            "submitted-at": round(self.t_submit_wall, 3),
        }
        if self.t_coalesce is not None:
            out["queue-wait-s"] = round(self.t_coalesce - self.t_submit, 6)
        if self.t_done is not None and self.t_coalesce is not None:
            out["service-s"] = round(self.t_done - self.t_coalesce, 6)
        if self.t_done is not None:
            out["latency-s"] = round(self.t_done - self.t_submit, 6)
        if self.device_s is not None:
            out["device-s"] = round(self.device_s, 9)
        if self.lane is not None:
            out["lane"] = int(self.lane)
        wf = self.waterfall()
        if wf:
            out["waterfall"] = wf
        if self.trace:
            out["trace"] = [dict(r) for r in self.trace]
        if self.result is not None:
            out["result"] = self.result
        if self.run_dir is not None:
            out["run-dir"] = self.run_dir
        return out


class Registry:
    """id → request lookup and per-tenant serve ledgers.

    Terminal requests are retained FIFO-bounded (``keep_done``). Tenant
    ledgers are bounded deques of records (admitted, dispatched, done,
    timeout, cancelled, rejected, ...), and past ``max_tenants`` tenants
    new names share one ``(overflow)`` bucket: tenant names come from
    clients. Every attribute below is touched under ``self._lock``."""

    def __init__(self, keep_done: int = 4096, ledger_depth: int = 512,
                 max_tenants: int = 1024) -> None:
        self._lock = threading.Lock()
        # the terminal-transition hook (the daemon's journal marker):
        # called outside the lock, once a request
        self.on_terminal: Optional[Any] = None
        self._by_id: "OrderedDict[str, CheckRequest]" = OrderedDict()
        self._done_order: "deque[str]" = deque()
        self._keep_done = keep_done
        self._ledger_depth = ledger_depth
        self._max_tenants = max_tenants
        self._tenant_ledgers: Dict[str, deque] = {}
        # nested, not "tenant.event" keys: a tenant name may hold dots
        self._event_counts: Dict[str, Dict[str, int]] = {}
        self._device_s: Dict[str, float] = {}

    def add(self, req: CheckRequest) -> None:
        with self._lock:
            self._by_id[req.id] = req

    def get(self, req_id: str) -> Optional[CheckRequest]:
        with self._lock:
            return self._by_id.get(req_id)

    def remove(self, req_id: str) -> None:
        """Retract a request whose admission failed after the add."""
        with self._lock:
            self._by_id.pop(req_id, None)

    def finish(self, req: CheckRequest, status: str,
               result: Optional[Dict[str, Any]] = None) -> None:
        """Move a request to a terminal state. The first terminal
        transition wins (a deadline firing while a verdict publishes does
        not flap the status). The packed history and ops are dropped:
        from here on only the verdict is served."""
        with self._lock:
            if req.terminal:
                return
            req.status = status
            if result is not None:
                req.result = result
            req.t_done = time.monotonic()
            req.packed = None
            req.history = ()
            self._done_order.append(req.id)
            while len(self._done_order) > self._keep_done:
                self._by_id.pop(self._done_order.popleft(), None)
        cb = self.on_terminal
        if cb is not None:
            try:
                cb(req)
            except Exception as e:                      # noqa: BLE001
                # durability bookkeeping: its failure must not lose the
                # terminal transition, and is recorded
                obs.engine_fallback("serve-journal", type(e).__name__,
                                    id=req.id)
                logging.getLogger("jepsen.serve").warning(
                    "on_terminal hook failed for %s: %s", req.id, e)
        req.done_event.set()

    def bucket_tenant(self, tenant: str) -> str:
        """The tenant's ledger key: its name, or ``(overflow)`` past
        ``max_tenants`` known tenants."""
        with self._lock:
            return self._bucket_tenant_locked(tenant)

    def _bucket_tenant_locked(self, tenant: str) -> str:
        if tenant in self._tenant_ledgers \
                or len(self._tenant_ledgers) < self._max_tenants:
            return tenant
        return "(overflow)"

    def ledger_record(self, tenant: str, event: str, **fields: Any) -> None:
        rec = {"ts": round(time.time(), 6), "event": event}
        rec.update(fields)
        with self._lock:
            bucketed = self._bucket_tenant_locked(tenant)
            # one overflow count a request: admission happens once
            overflowed = bucketed != tenant and event == "admitted"
            led = self._tenant_ledgers.get(bucketed)
            if led is None:
                led = self._tenant_ledgers[bucketed] = deque(
                    maxlen=self._ledger_depth)
            led.append(rec)
            ev = self._event_counts.setdefault(bucketed, {})
            ev[event] = ev.get(event, 0) + 1
        if overflowed:
            obs.count("serve.tenant_overflow")

    def add_device_time(self, tenant: str, seconds: float) -> None:
        """Add a request's attributed device seconds to its tenant."""
        with self._lock:
            b = self._bucket_tenant_locked(tenant)
            self._device_s[b] = self._device_s.get(b, 0.0) + seconds

    def tenant_ledger(self, tenant: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._tenant_ledgers.get(tenant, ())]

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(self._tenant_ledgers)

    def stats(self) -> Dict[str, Any]:
        """Per-tenant event counts, the live status census and each
        tenant's device seconds."""
        with self._lock:
            census: Dict[str, int] = {}
            for req in self._by_id.values():
                census[req.status] = census.get(req.status, 0) + 1
            return {"requests": census,
                    "tenants": {t: dict(ev)
                                for t, ev in self._event_counts.items()},
                    "device-seconds": {t: round(v, 6)
                                       for t, v in self._device_s.items()}}

"""Online (live) linearizability monitoring — no upstream analogue.

Upstream Jepsen is strictly post-hoc: the history is analyzed after the
run ends (``jepsen.core/run!`` → ``checker/check-safe``), so a test that
violated linearizability in its first second still runs to completion
before anyone finds out. This monitor verifies the history WHILE it
streams, failing fast the moment a violation appears. It is a port of
the reference package's ``jepsen_tpu/checkers/online.py``.

Two flush strategies:

- ``mode="incremental"`` (default): the monitor carries the dense
  reachability config set ``R[S, M]`` (the state of
  :mod:`jepsen_tpu_torch.checkers.reach`'s walk) across flushes and
  advances it only through NEW return events, so the whole run's
  monitoring work is O(n), not the O(n²) of re-checking every prefix.
  The carried advance is restricted to the *settled* prefix — return
  events whose entire pending map is resolved (completed with a known
  value, failed, or crashed) — because an op's transition is not known
  until its value is. The unsettled tail is usually the in-flight
  window, and a bounded prefix of it is checked each flush from a copy
  of the carried set with unresolved ops treated as crashed: an
  over-approximation, so a tail alarm is sound. The bookkeeping and the
  walk are C++ (:class:`NativeStreamEngine` over
  ``preproc_native.Monitor``, ``native/preproc.cpp``); the card is not
  involved. On what the dense representation cannot hold (slot
  overflow, state explosion) the monitor moves for good to the
  re-check strategy below, a recorded route decision.
- ``mode="recheck"``: re-check the entire recorded prefix on each
  cadence tick through the facade (by default the C++ WGL search with a
  time limit; ``algorithm=`` picks another, on the monitor's
  ``device``). Simple and exact, but total work grows quadratically
  with history length.

Soundness (both modes):

- *No false alarms.* Still-running invocations enter the analysis as
  crashed ops and unresolved read values as wildcards: both
  over-approximate the constraints the finished history will impose, so
  a prefix reported invalid is genuinely invalid.
- *Fail-fast is permanent.* Linearizability is prefix-closed: the
  monitor stops after the first violation and the runner may abort the
  test.
- *Eventually exact.* At :meth:`OnlineLinearizable.stop` every op has
  resolved (run over: still pending means crashed), so the incremental
  verdict is the exact full-history verdict.

Faults: a capacity decline (:class:`_Overflow`) moves the monitor to
re-checking; any other exception in a flush stops the monitor, which
keeps it, and :meth:`OnlineLinearizable.stop` raises it.
"""
from __future__ import annotations

import contextvars
import heapq
import logging
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import preproc_native
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.models.memo import StateExplosion, memo_ops
from jepsen_tpu_torch.op import FAIL, INFO, INVOKE, OK, Op
from jepsen_tpu_torch.op import invoke as mk_invoke
from jepsen_tpu_torch.util import hashable

log = logging.getLogger("jepsen.online")


class _Binding:
    """One invocation's lifetime: its slot, invoke op (for reporting),
    and resolution status. The op's transition id is internable only
    once its value is known (reads carry the value on the completion)."""

    __slots__ = ("slot", "inv", "status", "value", "oid")

    def __init__(self, slot: int, inv: Op):
        self.slot = slot
        self.inv = inv
        self.status = "pending"         # pending | ok | fail | crashed
        self.value = inv.value          # the completion's value wins
        self.oid = -1                   # interned op id once resolved

    def resolve(self, kind: str, value: Any) -> None:
        self.status = kind
        if kind == "ok" and value is not None:
            self.value = value

    @property
    def resolved(self) -> bool:
        return self.status != "pending"


class _Overflow(Exception):
    """The dense representation cannot hold this run: the monitor moves
    for good to re-checking."""


def _walk_return(R: np.ndarray, rows: np.ndarray, jr: int,
                 P: np.ndarray) -> np.ndarray:
    """One return event on the dense config set in numpy, fire to the
    fixpoint then project: ``R`` bool[S, M]; ``rows[j]`` the pending op
    in slot j (or -1); ``jr`` the returning slot; ``P`` bool[O, S, S].
    The plain version of :func:`preproc_native.walk_dense`."""
    M = R.shape[1]
    m = np.arange(M)
    while True:
        new = R.copy()
        for j, o in enumerate(rows):
            if o < 0:
                continue
            bit = 1 << j
            clear = np.nonzero((m & bit) == 0)[0]
            img = P[o].T @ R[:, clear]          # fired images of bit-clear
            new[:, clear | bit] |= img
        if (new == R).all():
            break
        R = new
    bit = 1 << jr
    kept = np.nonzero((m & bit) != 0)[0]
    out = np.zeros_like(R)
    out[:, kept ^ bit] = R[:, kept]
    return out


def _reencode(model_states, old_memo, old_R: Optional[np.ndarray], S: int,
              W: int) -> np.ndarray:
    """The carried set in a rebuilt memo's state coding: the seed
    ``R[0, 0]`` on the first build, else each old state's row moved to
    its new id (the wider alphabet's search reaches a superset of the
    old states)."""
    R = np.zeros((S, 1 << W), bool)
    if old_R is None:
        R[0, 0] = True
        return R
    new_id = {st: i for i, st in enumerate(model_states)}
    for sid in np.nonzero(old_R.any(axis=1))[0]:
        R[new_id[old_memo.states[sid]]] |= old_R[sid]
    return R


class IncrementalEngine:
    """O(n) streaming linearizability state in Python: the dense config
    set carried across flushes, advanced through settled return events
    only (module docstring). A flush's settleable returns are walked in
    one call of the bit-packed C++ walk (:func:`_walk_batch`). The
    monitor runs :class:`NativeStreamEngine`, the same semantics with
    the bookkeeping in C++; this engine is its differential oracle in
    the tests, and :func:`_walk_return` the walk's."""

    def __init__(self, model: Model, *, max_states: int = 100_000,
                 max_slots: int = 20, max_dense: int = 1 << 22):
        self.model = model
        self.max_states = max_states
        self.max_slots = max_slots
        self.max_dense = max_dense
        self.alphabet: Dict[Tuple[Any, Any], int] = {}
        self.alpha_ops: List[Op] = []
        self.memo = None
        self.W = 1
        self.R: Optional[np.ndarray] = None      # bool [S, 2^W]
        self._free: List[int] = []
        self._hi = 0
        self._proc: Dict[Any, _Binding] = {}     # live invocations
        self._crashed: List[_Binding] = []       # forever-pending
        # FIFO of return events awaiting settlement, in real-time order:
        # (returning binding, pending-map snapshot, crashed-list length)
        self._queue: deque = deque()
        self.settled_returns = 0
        self.walked_events = 0
        self.violation: Optional[Dict[str, Any]] = None

    # -- alphabet / memo ------------------------------------------------------

    def _intern_batch(self, keys) -> None:
        """Add every unseen ``(f, value)`` to the alphabet with one memo
        rebuild and state re-encode for the whole batch."""
        fresh = []
        seen = set()
        for f, v in keys:
            k = (f, hashable(v))
            if k not in self.alphabet and k not in seen:
                seen.add(k)
                fresh.append((k, f, v))
        if not fresh:
            return
        for k, f, v in fresh:
            self.alphabet[k] = len(self.alpha_ops)
            self.alpha_ops.append(mk_invoke(0, f, v))
        old_memo, old_R = self.memo, self.R
        try:
            self.memo = memo_ops(self.model, tuple(self.alpha_ops),
                                 max_states=self.max_states)
        except StateExplosion as e:
            raise _Overflow(str(e)) from e
        S = self.memo.n_states
        if S * (1 << self.W) > self.max_dense:
            raise _Overflow(f"dense config space {S}x{1 << self.W}")
        self.R = _reencode(self.memo.states, old_memo, old_R, S, self.W)

    def _intern_rows(self, b: _Binding, snap: List[_Binding],
                     n_crashed: int) -> np.ndarray:
        """A return event's pending map as op-id rows, called once every
        binding in it is resolved (or, for the tail alarm, with
        unresolved ops as crashed wildcards). ``n_crashed`` is the
        crashed-list length when the return was fed: later crashes were
        invoked later and are not in its pending map."""
        members = snap + self._crashed[:n_crashed] + [b]
        self._intern_batch([(x.inv.f, x.value)
                            for x in members
                            if x.status != "fail" and x.oid < 0])
        rows = np.full(self.W, -1, np.int64)
        for x in members:
            if x.status == "fail":
                continue            # stripped, exactly like post-hoc
            if x.oid >= 0:
                rows[x.slot] = x.oid
                continue
            oid = self.alphabet[(x.inv.f, hashable(x.value))]
            if x.resolved:
                # ids are append-only, so a resolved binding's id is
                # final; unresolved tail-alarm wildcards stay uncached
                x.oid = oid
            rows[x.slot] = oid
        return rows

    def _grow_slots(self, slot: int) -> None:
        if slot < self.W:
            return
        if slot >= self.max_slots:
            raise _Overflow(f"history needs > {self.max_slots} slots")
        W2 = slot + 1
        S = self.R.shape[0] if self.R is not None else 2
        if S * (1 << W2) > self.max_dense:
            raise _Overflow(f"dense config space {S}x{1 << W2}")
        if self.R is not None:
            # zero-embed: new slots are free, their bits 0 in every config
            R2 = np.zeros((self.R.shape[0], 1 << W2), bool)
            R2[:, :self.R.shape[1]] = self.R
            self.R = R2
        self.W = W2

    # -- ingestion ------------------------------------------------------------

    def feed(self, op: Op) -> None:
        if op.process == "nemesis":
            return
        if op.type == INVOKE:
            if op.process in self._proc:
                raise _Overflow(f"double invoke by {op.process}")
            slot = heapq.heappop(self._free) if self._free else self._hi
            if slot == self._hi:
                self._hi += 1
            self._grow_slots(slot)
            self._proc[op.process] = _Binding(slot, op)
            return
        b = self._proc.pop(op.process, None)
        if b is None:
            return                      # completion without invoke: ignore
        if op.type == OK:
            b.resolve("ok", op.value)
            # pending at this return: live invocations and the crashed
            # ops so far (the crashed list only appends, so its length
            # is the snapshot). The slot frees now: a reused slot's new
            # op cannot fire before this return is walked
            self._queue.append((b, list(self._proc.values()),
                                len(self._crashed)))
            heapq.heappush(self._free, b.slot)
        elif op.type == FAIL:
            # no effect: stripped. No walked return saw it pending
            # (settlement waits for every snapshot binding); queued ones
            # skip it at settlement, exactly the post-hoc strip
            b.resolve("fail", None)
            heapq.heappush(self._free, b.slot)
        elif op.type == INFO:
            # crashed: fires anytime or never, holds its slot forever
            b.resolve("crashed", op.value)
            self._crashed.append(b)

    # -- the walk -------------------------------------------------------------

    def _intern_items(self, items) -> List[np.ndarray]:
        """Intern every member of every queued item in one batch (one
        memo rebuild at most), then each item's pending-op rows."""
        keys = []
        for b, snap, n_crashed in items:
            keys.extend((x.inv.f, x.value)
                        for x in snap + self._crashed[:n_crashed] + [b]
                        if x.status != "fail" and x.oid < 0)
        self._intern_batch(keys)
        return [self._intern_rows(b, snap, n_crashed)
                for b, snap, n_crashed in items]

    def _walk_batch(self, R0: np.ndarray, rows_list, slots
                    ) -> Tuple[np.ndarray, int]:
        """Walk a batch of return events through the bit-packed C++ walk
        from ``R0`` (untouched). Returns ``(R_final, dead_idx)``,
        ``dead_idx = -1`` when the set survived."""
        L = len(rows_list)
        W, M = self.W, 1 << self.W
        R_words = _pack_words(R0, M)
        rows_arr = np.asarray(rows_list, np.int32).reshape(L, W)
        dead = preproc_native.walk_dense(self.memo.table, R_words, W,
                                         np.asarray(slots, np.int32),
                                         rows_arr)
        return _unpack_words(R_words, M), dead

    def advance(self, run_over: bool = False) -> Optional[Dict[str, Any]]:
        """Walk the settled prefix of queued returns; with ``run_over``
        every still-pending op resolves as crashed first (the verdict
        becomes the exact full-history one). Returns the violation, if
        one is found."""
        if self.violation is not None:
            return self.violation
        if run_over:
            for p, b in list(self._proc.items()):
                b.resolve("crashed", b.inv.value)
                del self._proc[p]
                self._crashed.append(b)
        items = []
        while self._queue:
            b, snap, n_crashed = self._queue[0]
            if not all(x.resolved for x in snap):
                break
            self._queue.popleft()
            items.append((b, snap, n_crashed))
        if not items:
            return None
        rows_list = self._intern_items(items)
        slots = np.fromiter((b.slot for b, _, _ in items), np.int32,
                            count=len(items))
        R_final, dead = self._walk_batch(self.R, rows_list, slots)
        self.R = R_final
        n = len(items) if dead < 0 else dead + 1
        self.settled_returns += n
        self.walked_events += n
        if dead >= 0:
            # items past the death were dequeued but never walked: a
            # violation is terminal for this engine
            self.violation = self._violation_at(items[dead][0])
        return self.violation

    # per-flush cap on the tail walk: one long-pending op blocks every
    # later return, and re-walking the whole queue each flush would be
    # the O(n²) this engine exists to avoid
    _TAIL_CAP = 512

    def tail_alarm(self) -> Optional[Dict[str, Any]]:
        """Check a bounded prefix of the unsettled tail from a copy of
        the carried set, unresolved ops as crashed (a sound
        over-approximation: an alarm is a real violation). The carried
        state is untouched."""
        if self.violation is not None or not self._queue:
            return None
        items = list(self._queue)[:self._TAIL_CAP]
        # intern everything first: interning may re-encode self.R
        rows_list = self._intern_items(items)
        slots = np.fromiter((b.slot for b, _, _ in items), np.int32,
                            count=len(items))
        _R, dead = self._walk_batch(self.R, rows_list, slots)
        if dead >= 0:
            self.violation = self._violation_at(items[dead][0])
        return self.violation

    def _violation_at(self, b: _Binding) -> Dict[str, Any]:
        op = b.inv.with_(type=OK, value=b.value)
        return {"valid": False, "engine": "online-incremental",
                "op": op.to_dict(),
                "settled-returns": self.settled_returns}

    def in_flight(self) -> int:
        """Returns not yet conclusively walked + live invocations."""
        return len(self._queue) + len(self._proc)


def _pack_words(R: np.ndarray, M: int) -> np.ndarray:
    """Bit-pack the mask axis of a bool [S, M] set into u64 words."""
    packed8 = np.packbits(R, axis=1, bitorder="little")
    n_words = max(1, -(-M // 64))
    buf = np.zeros((R.shape[0], n_words * 8), np.uint8)
    buf[:, :packed8.shape[1]] = packed8
    return np.ascontiguousarray(buf).view(np.uint64)


def _unpack_words(words: np.ndarray, M: int) -> np.ndarray:
    return np.unpackbits(words.view(np.uint8), axis=1,
                         bitorder="little")[:, :M].astype(bool)


_TCODE = {INVOKE: 0, OK: 1, FAIL: 2, INFO: 3}
_SCALAR_T = (int, str, bool, float)


class NativeStreamEngine:
    """The incremental monitor with its per-op bookkeeping in C++
    (``native/preproc.cpp`` ``jt_mon_*``, through
    :class:`~jepsen_tpu_torch.checkers.preproc_native.Monitor`):
    ``feed`` buffers; ``advance`` turns the buffer into three int
    arrays, makes one native feed call (slot assignment, settle queue,
    snapshots) and one native advance call (the settled-returns walk),
    leaving Python only value interning (model-dependent) and the
    carried set ``R`` (re-encoded on the rare memo or W growth). Same
    soundness and verdicts as :class:`IncrementalEngine`."""

    _TAIL_CAP = 512

    def __init__(self, model: Model, *, max_states: int = 100_000,
                 max_slots: int = 20, max_dense: int = 1 << 22):
        self.model = model
        self.max_states = max_states
        self.max_slots = max_slots
        self.max_dense = max_dense
        self._mon = preproc_native.Monitor(max_slots)
        self.alphabet: Dict[Tuple[Any, Any], int] = {}
        self.alpha_ops: List[Op] = []
        self.memo = None
        self.W = 1
        self.R: Optional[np.ndarray] = None      # bool [S, 2^W]
        self._buf: List[Op] = []
        self._live_inv: Dict[Any, Tuple[int, Op]] = {}
        self._bind_ops: List[Op] = []            # bind id -> invoke op
        self._bind_val: Dict[int, Any] = {}      # bind id -> final value
        self._procmap: Dict[Any, int] = {}       # non-int process ids
        self._memo_dirty = False
        self.settled_returns = 0
        self.walked_events = 0
        self.violation: Optional[Dict[str, Any]] = None

    # -- interning ------------------------------------------------------------

    def _pkey(self, p) -> int:
        # disjoint encodings: int processes on evens, interned non-int
        # processes on odds, so "a" and -1 never collide natively
        if isinstance(p, int):
            return p * 2
        v = self._procmap.get(p)
        if v is None:
            v = len(self._procmap) * 2 + 1
            self._procmap[p] = v
        return v

    def _oid(self, f: str, v: Any) -> int:
        # scalar values (and tuples of scalars: cas pairs) are their own
        # hashable form
        tv = type(v)
        if v is None or tv in _SCALAR_T:
            k = (f, v)
        elif tv is tuple and all(
                x is None or type(x) in _SCALAR_T for x in v):
            k = (f, v)
        else:
            k = (f, hashable(v))
        o = self.alphabet.get(k)
        if o is None:
            o = len(self.alpha_ops)
            self.alphabet[k] = o
            self.alpha_ops.append(mk_invoke(0, f, v))
            self._memo_dirty = True
        return o

    # -- memo / geometry growth ----------------------------------------------

    def _rebuild_memo(self) -> None:
        old_memo, old_R = self.memo, self.R
        try:
            self.memo = memo_ops(self.model, tuple(self.alpha_ops),
                                 max_states=self.max_states)
        except StateExplosion as e:
            raise _Overflow(str(e)) from e
        S = self.memo.n_states
        if S * (1 << self.W) > self.max_dense:
            raise _Overflow(f"dense config space {S}x{1 << self.W}")
        self.R = _reencode(self.memo.states, old_memo, old_R, S, self.W)
        self._memo_dirty = False

    def _grow_W(self, W2: int) -> None:
        S = self.R.shape[0] if self.R is not None else 2
        if S * (1 << W2) > self.max_dense:
            raise _Overflow(f"dense config space {S}x{1 << W2}")
        if self.R is not None:
            R2 = np.zeros((self.R.shape[0], 1 << W2), bool)
            R2[:, :self.R.shape[1]] = self.R
            self.R = R2
        self.W = W2

    def _feed_native(self, types, procs, oids) -> None:
        W_new = self._mon.feed(types, procs, oids)
        if W_new == -1:
            raise _Overflow("double invoke")
        if W_new == -2:
            raise _Overflow(f"history needs > {self.max_slots} slots")
        if self.memo is None or self._memo_dirty:
            self._rebuild_memo()
        if W_new > self.W:
            self._grow_W(int(W_new))

    # -- ingestion ------------------------------------------------------------

    def feed(self, op: Op) -> None:
        self._buf.append(op)

    def feed_many(self, ops: List[Op]) -> None:
        self._buf.extend(ops)

    def _drain(self) -> None:
        if not self._buf:
            return
        ops, self._buf = self._buf, []
        n = len(ops)
        types = np.empty(n, np.int32)
        procs = np.empty(n, np.int64)
        oids = np.full(n, -1, np.int32)
        # locals: this loop runs once per fed op
        tcode_get = _TCODE.get
        oid = self._oid
        pkey = self._pkey
        live_inv = self._live_inv
        live_pop = live_inv.pop
        bind_ops = self._bind_ops
        bind_val = self._bind_val
        m = 0
        for op in ops:
            p = op.process
            if p == "nemesis":
                continue
            t = tcode_get(op.type)
            if t is None:
                continue
            if t == 0:
                # this op's crashed-at-invoke id, used only by the
                # unsettled-tail alarm
                oids[m] = oid(op.f, op.value)
                live_inv[p] = (len(bind_ops), op)
                bind_ops.append(op)
            else:
                entry = live_pop(p, None)
                if entry is None:
                    continue            # completion without invoke
                bid, inv = entry
                if t == 1:              # ok: the completion's value wins
                    val = op.value if op.value is not None else inv.value
                    oids[m] = oid(inv.f, val)
                    bind_val[bid] = val
                elif t == 3:            # crashed: the invoke's value stands
                    oids[m] = oid(inv.f, inv.value)
                    bind_val[bid] = inv.value
            types[m] = t
            procs[m] = pkey(p)
            m += 1
        if m:
            self._feed_native(types[:m], procs[:m], oids[:m])

    # -- the walk -------------------------------------------------------------

    def _resolve_stragglers(self) -> None:
        """The run is over: every still-pending invocation resolves as
        crashed, making the final verdict the exact full-history one.
        Shared with :class:`jepsen_tpu_torch.serve.session
        .DeviceFrontierEngine`, so the two advance paths cannot drift."""
        if not self._live_inv:
            return
        items = list(self._live_inv.items())
        self._live_inv.clear()
        k = len(items)
        types = np.full(k, 3, np.int32)
        procs = np.empty(k, np.int64)
        oids = np.empty(k, np.int32)
        for i, (p, (bid, inv)) in enumerate(items):
            procs[i] = self._pkey(p)
            oids[i] = self._oid(inv.f, inv.value)
            self._bind_val[bid] = inv.value
        self._feed_native(types, procs, oids)

    def advance(self, run_over: bool = False) -> Optional[Dict[str, Any]]:
        if self.violation is not None:
            return self.violation
        self._drain()
        if run_over:
            self._resolve_stragglers()
        if self.memo is None:
            return None
        # one long-pending op blocks the whole settle queue: skip the
        # pack/unpack round trip when advance would walk nothing
        _s, queued, _l, _w, front_ok = self._mon.stats()
        if queued == 0 or not front_ok:
            return None
        M = 1 << self.W
        words = _pack_words(self.R, M)
        walked, dead_bind = self._mon.advance(self.memo.table, words)
        self.R = _unpack_words(words, M)
        self.settled_returns += walked
        self.walked_events += walked
        if dead_bind >= 0:
            self.violation = self._violation_at(dead_bind)
        return self.violation

    def tail_alarm(self) -> Optional[Dict[str, Any]]:
        """A bounded unsettled-tail check from a copy of the carried set,
        unresolved ops as crashed-at-invoke wildcards (a sound
        over-approximation: an alarm is a real violation)."""
        if self.violation is not None or self.memo is None:
            return None
        self._drain()
        rows, slots, binds = self._mon.tail(self._TAIL_CAP, self.W)
        if len(slots) == 0:
            return None
        words = _pack_words(self.R, 1 << self.W)   # a copy by packing
        dead = preproc_native.walk_dense(self.memo.table, words, self.W,
                                         slots, rows)
        if dead >= 0:
            self.violation = self._violation_at(int(binds[dead]))
        return self.violation

    def _violation_at(self, bid: int) -> Dict[str, Any]:
        inv = self._bind_ops[bid]
        op = inv.with_(type=OK, value=self._bind_val.get(bid, inv.value))
        return {"valid": False, "engine": "online-native",
                "op": op.to_dict(),
                "settled-returns": self.settled_returns}

    def in_flight(self) -> int:
        _settled, queued, live, _w, _f = self._mon.stats()
        return queued + live + len(self._buf)


class OnlineLinearizable:
    """Background monitor of a run's history. Wire :meth:`observe` as the
    history observer (``core.History(observer=...)``), :meth:`start` and
    :meth:`stop` around the run, and pass ``on_violation`` to abort the
    test early (the runner sets its stop flag there).

    ``device`` names where ``mode="recheck"`` runs the facade's device
    engines (default: the card; ``"cpu"`` never touches it). The
    incremental mode is host work."""

    def __init__(self, model: Model, *,
                 interval_s: float = 1.0,
                 min_new_ops: int = 128,
                 mode: str = "incremental",
                 on_violation: Optional[Callable[[Dict[str, Any]], None]]
                 = None,
                 device: Optional[str] = None,
                 **checker_kw: Any):
        if mode not in ("incremental", "recheck"):
            raise ValueError(f"unknown online mode {mode!r}")
        self.model = model
        self.interval_s = interval_s
        self.min_new_ops = min_new_ops
        self.mode = mode
        self.on_violation = on_violation
        self.device = device
        self.checker_kw = checker_kw
        self._ops: List[Op] = []
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._checked_upto = 0          # longest conclusively checked prefix
        self._inconclusive_tail = 0
        self._flushes = 0
        self._run_over = False
        self.violation: Optional[Dict[str, Any]] = None
        #: the exception that stopped the monitor thread, raised by stop()
        self.error: Optional[BaseException] = None
        self._engine = None
        self._engine_cursor = 0
        if mode == "incremental":
            eng_kw = {k: checker_kw[k] for k in
                      ("max_states", "max_slots", "max_dense")
                      if k in checker_kw}
            self._engine = NativeStreamEngine(model, **eng_kw)

    # -- producer side (worker threads, via the History observer) -----------

    def observe(self, op: Op) -> None:
        with self._lock:
            self._ops.append(op)
            due = len(self._ops) - self._checked_upto >= self.min_new_ops
        if due:
            self._wake.set()

    # -- checking ------------------------------------------------------------

    def flush(self) -> Optional[Dict[str, Any]]:
        """Check the current prefix; returns the violation once one is
        found (then sticky). Serialized: the monitor thread and a
        caller's stop() may both land here. A fault propagates."""
        with self._flush_lock:
            return self._flush_locked()

    def _flush_locked(self) -> Optional[Dict[str, Any]]:
        if self.violation is not None:
            return self.violation
        if self._engine is not None:
            try:
                return self._flush_incremental()
            except _Overflow as e:
                # a capacity decline, recorded as a route decision: the
                # re-check below verifies everything from scratch
                obs.decision("online-incremental", "route",
                             cause=f"overflow:{type(e).__name__}")
                log.info("online check: dense state overflowed (%s); "
                         "falling back to prefix re-checking", e)
            self._engine = None
            self._checked_upto = 0
            self._inconclusive_tail = 0
        with self._lock:
            prefix = list(self._ops)
        if (len(prefix) <= self._checked_upto
                and not self._inconclusive_tail):
            return None
        from jepsen_tpu_torch.checkers.facade import (Linearizable,
                                                      check_declining)

        kw = dict(self.checker_kw)
        algorithm = kw.pop("algorithm", None)
        if algorithm is None:
            # low latency: the C++ WGL search has no per-shape cost; a
            # time limit bounds its worst case ("unknown" flushes are
            # retried at the next tick)
            algorithm = "wgl-native"
            kw.setdefault("time_limit", max(5.0, 5 * self.interval_s))
        checker = Linearizable(model=self.model, algorithm=algorithm,
                               opts=kw, device=self.device)
        res = check_declining(checker, None, prefix)
        self._flushes += 1
        if res.get("valid") is True:
            self._checked_upto = len(prefix)
            self._inconclusive_tail = 0
        elif res.get("valid") is False:
            self._checked_upto = len(prefix)
            self._inconclusive_tail = 0
            res["prefix-ops"] = len(prefix)
            res["detected-at-flush"] = self._flushes
            self._found(res, len(prefix))
        else:
            # inconclusive (time limit, capacity): not advanced, so these
            # ops are re-checked next flush and result() does not claim
            # them verified
            self._inconclusive_tail = len(prefix) - self._checked_upto
        return self.violation

    def _found(self, v: Dict[str, Any], n_ops: int) -> None:
        self.violation = v
        log.warning("online check: violation after %d ops (%s)", n_ops,
                    v.get("op"))
        if self.on_violation is not None:
            self.on_violation(v)

    def _flush_incremental(self) -> Optional[Dict[str, Any]]:
        eng = self._engine
        with self._lock:
            new = self._ops[self._engine_cursor:]
            self._engine_cursor = len(self._ops)
        eng.feed_many(new)
        self._flushes += 1
        v = eng.advance(run_over=self._run_over)
        if v is None and not self._run_over:
            v = eng.tail_alarm()
        unsettled = eng.in_flight()
        self._checked_upto = max(0, self._engine_cursor - 2 * unsettled)
        if v is not None:
            v = dict(v)
            v["prefix-ops"] = self._engine_cursor
            v["detected-at-flush"] = self._flushes
            self._found(v, self._engine_cursor)
        return self.violation

    # -- thread lifecycle ----------------------------------------------------

    def start(self) -> "OnlineLinearizable":
        # run under a copy of the starter's context so obs records from
        # monitor flushes reach the enclosing run's capture scope
        ctx = contextvars.copy_context()
        self._thread = threading.Thread(target=lambda: ctx.run(self._loop),
                                        daemon=True,
                                        name="jepsen-online-check")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set() and self.violation is None:
            self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                break
            try:
                self.flush()
            except Exception as e:                      # noqa: BLE001
                # the monitor stops; stop() raises it in the run's thread
                self.error = e
                log.error("online check flush failed: %r", e)
                return

    def halt(self) -> None:
        """Stop the monitor thread and wait for it (no final flush)."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join()

    def stop(self) -> Dict[str, Any]:
        """:meth:`halt`, then one final flush (every straggler resolved
        as crashed: the incremental verdict becomes the exact
        full-history one), and return :meth:`result`. Raises the fault
        that stopped the monitor thread, or one of the final flush."""
        self.halt()
        if self.error is not None:
            raise self.error
        self._run_over = True
        self.flush()
        return self.result()

    def result(self) -> Dict[str, Any]:
        if self.violation is not None:
            out = dict(self.violation)
            out["valid"] = False
            return out
        if self._engine is not None:
            out = {"valid": True, "mode": "incremental",
                   "ops-checked": self._engine_cursor,
                   "settled-returns": self._engine.settled_returns,
                   "flushes": self._flushes}
            if not self._run_over:
                unsettled = self._engine.in_flight()
                if unsettled:
                    out["in-flight-ops"] = unsettled
            return out
        out: Dict[str, Any] = {"valid": True,
                               "ops-checked": self._checked_upto,
                               "flushes": self._flushes}
        if self._inconclusive_tail:
            # the last flushes were inconclusive: only "no violation
            # seen", not a clean bill
            out["valid"] = "unknown"
            out["unchecked-tail-ops"] = self._inconclusive_tail
        return out

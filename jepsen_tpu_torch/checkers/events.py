"""Event-stream preprocessing for the device reachability engine.

Upstream analogue: ``knossos/src/knossos/linear.clj``'s per-event walk and
``knossos/src/knossos/linear/config.clj``'s packed config sets (SURVEY.md
§2.2). Where the upstream advances an explicit *set of configuration
objects* per history event, the device engine (:mod:`.reach`) advances a dense
boolean reachability tensor indexed by ⟨model-state, linearized-pending
bitmask⟩. This module builds the static, int-only event stream that tensor
program consumes:

- Each analysis entry contributes an ``invoke`` event and (unless crashed)
  a ``return`` event, ordered by their history ranks.
- Pending operations are assigned **slots** (lowest free slot at invoke,
  freed at return). The slot count ``W`` bounds concurrency; the device
  bitmask axis has size ``2**W``. Crashed ops hold their slot forever —
  they may linearize at any later time — except crashed ops whose
  transition is a no-op in every model state (e.g. a crashed blind read),
  which are provably irrelevant and dropped here.

Everything produced is a NumPy int array; only these (plus the memoized
transition table) cross to the device.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Optional

import numpy as np

from jepsen_tpu_torch.history import PackedHistory
from jepsen_tpu_torch.models.memo import Memo

KIND_INVOKE = 0
KIND_RETURN = 1
KIND_PAD = 2


class ConcurrencyOverflow(RuntimeError):
    """Raised when the history needs more pending-op slots than ``max_slots``
    — the dense ``2**W`` bitmask axis would not fit on device. Callers fall
    back to the CPU search (upstream behaviour: knossos.linear dies on
    config-set explosion and the competition falls back to WGL)."""


@dataclass(frozen=True)
class EventStream:
    """Static event stream for one history.

    ``kind``/``slot``/``opid``/``entry`` are parallel ``i32[E]`` arrays;
    ``opid`` is -1 for returns. ``W`` is the slot count (bitmask width).
    ``n_events`` may be < len(kind) when padded for batching.
    """
    kind: np.ndarray
    slot: np.ndarray
    opid: np.ndarray
    entry: np.ndarray
    W: int
    n_events: int
    n_entries: int          # entries surviving preprocessing (incl. crashed)
    n_dropped_crashed: int  # crashed no-op entries dropped

    @property
    def E(self) -> int:
        return len(self.kind)


def build(packed: PackedHistory, memo: Memo, *,
          max_slots: int = 20,
          drop_noop_crashed: bool = True) -> EventStream:
    """Assign slots and linearize the (invoke, return) events of ``packed``
    into a flat stream. Raises :class:`ConcurrencyOverflow` if more than
    ``max_slots`` ops are ever pending at once.

    Event-array construction is vectorized NumPy; the inherently
    sequential lowest-free-slot assignment is a Python heap scan."""
    n = packed.n
    crashed = np.asarray(packed.crashed, bool)
    if drop_noop_crashed and n:
        tbl = memo.table
        states = np.arange(tbl.shape[0], dtype=tbl.dtype)[:, None]
        noop_op = np.all((tbl == states) | (tbl == -1), axis=0)
        drop = crashed & noop_op[packed.op_id]
    else:
        drop = np.zeros(n, bool)
    dropped = int(drop.sum())
    idx = np.nonzero(~drop)[0].astype(np.int32)
    ridx = idx[~crashed[idx]]
    # ranks are distinct history indices, so returns order unambiguously
    ranks = np.concatenate([packed.inv_ev[idx], packed.ret_ev[ridx]])
    kinds = np.concatenate([
        np.full(len(idx), KIND_INVOKE, np.int32),
        np.full(len(ridx), KIND_RETURN, np.int32)])
    entries = np.concatenate([idx, ridx]).astype(np.int32)
    order = np.argsort(ranks, kind="stable")
    kind = kinds[order]
    entry = entries[order]
    E = len(kind)
    opid = np.where(kind == KIND_INVOKE,
                    packed.op_id[entry].astype(np.int32),
                    np.int32(-1)).astype(np.int32)
    slot = np.zeros(E, np.int32)
    free: list = []             # min-heap: reuse lowest slots first
    hi = 0                      # next never-used slot
    slot_of = {}
    for e in range(E):
        i = int(entry[e])
        if kind[e] == KIND_INVOKE:
            s = heapq.heappop(free) if free else hi
            if s == hi:
                hi += 1
                if hi > max_slots:
                    raise ConcurrencyOverflow(
                        f"history needs >{max_slots} pending-op slots")
            slot_of[i] = s
            slot[e] = s
        else:
            s = slot_of.pop(i)
            slot[e] = s
            heapq.heappush(free, s)
    return EventStream(kind=kind, slot=slot, opid=opid, entry=entry,
                       W=int(hi), n_events=E, n_entries=n - dropped,
                       n_dropped_crashed=dropped)


def pad(stream: EventStream, E: int, W: Optional[int] = None) -> EventStream:
    """Pad a stream to ``E`` events (kind=PAD) and widen to ``W`` slots, for
    batching several keys' streams into one vmapped device call."""
    W = stream.W if W is None else W
    if W < stream.W or E < stream.n_events:
        raise ValueError("cannot shrink a stream")
    ext = E - stream.E

    def _p(a: np.ndarray, fill: int) -> np.ndarray:
        return np.concatenate([a, np.full(ext, fill, a.dtype)])

    return EventStream(
        kind=_p(stream.kind, KIND_PAD), slot=_p(stream.slot, 0),
        opid=_p(stream.opid, -1), entry=_p(stream.entry, 0),
        W=W, n_events=stream.n_events, n_entries=stream.n_entries,
        n_dropped_crashed=stream.n_dropped_crashed)


@dataclass(frozen=True)
class ReturnStream:
    """Returns-only view of an :class:`EventStream` for the fast device
    walk (:func:`jepsen_tpu_torch.checkers.reach._walk_returns`).

    Invoke events never change the reachable set — they only update the
    slot→op map, which is statically known — so the device loop need only
    execute return events: for return ``r``, ``slot_ops[r]`` is the full
    pending map (including the returning op) and ``ret_slot[r]`` the slot
    being returned/freed. ``ret_slot = -1`` marks padding (identity).
    ``ret_event[r]`` / ``ret_entry[r]`` map back to the original event
    index / analysis entry for failure reporting.
    """
    ret_slot: np.ndarray    # i32[R]
    slot_ops: np.ndarray    # i32[R, W]
    ret_event: np.ndarray   # i32[R]
    ret_entry: np.ndarray   # i32[R]
    W: int
    n_returns: int

    @property
    def R(self) -> int:
        return len(self.ret_slot)


def returns_view(stream: EventStream) -> ReturnStream:
    """Project an event stream to its return events with per-return
    pending-op snapshots."""
    W = max(stream.W, 1)
    n_ret = int(np.sum(stream.kind[:stream.n_events] == KIND_RETURN))
    ret_slot = np.full(n_ret, -1, np.int32)
    slot_ops = np.full((n_ret, W), -1, np.int32)
    ret_event = np.zeros(n_ret, np.int32)
    ret_entry = np.zeros(n_ret, np.int32)
    cur = np.full(W, -1, np.int32)
    r = 0
    for e in range(stream.n_events):
        k = stream.kind[e]
        if k == KIND_INVOKE:
            cur[stream.slot[e]] = stream.opid[e]
        elif k == KIND_RETURN:
            s = stream.slot[e]
            slot_ops[r] = cur
            ret_slot[r] = s
            ret_event[r] = e
            ret_entry[r] = stream.entry[e]
            cur[s] = -1
            r += 1
    return ReturnStream(ret_slot=ret_slot, slot_ops=slot_ops,
                        ret_event=ret_event, ret_entry=ret_entry,
                        W=W, n_returns=n_ret)


def pad_returns(rs: ReturnStream, R: int, W: Optional[int] = None
                ) -> ReturnStream:
    """Pad to ``R`` returns (identity rows) / widen to ``W`` slots.
    Direct allocation, not ``np.pad`` — per-key batch preps call this
    thousands of times and np.pad's Python plumbing was ~0.4 s of a
    4096-key check.

    When no padding or widening is needed the INPUT stream is returned
    as-is (aliased arrays): treat the result as read-only."""
    W = rs.W if W is None else W
    if W < rs.W or R < rs.n_returns:
        raise ValueError("cannot shrink a return stream")
    R0, W0 = rs.R, rs.slot_ops.shape[1]
    if R == R0 and W == W0:
        return rs
    slot_ops = np.full((R, W), -1, rs.slot_ops.dtype)
    slot_ops[:R0, :W0] = rs.slot_ops
    ret_slot = np.full(R, -1, rs.ret_slot.dtype)
    ret_slot[:R0] = rs.ret_slot
    ret_event = np.zeros(R, rs.ret_event.dtype)
    ret_event[:R0] = rs.ret_event
    ret_entry = np.zeros(R, rs.ret_entry.dtype)
    ret_entry[:R0] = rs.ret_entry
    return ReturnStream(
        ret_slot=ret_slot, slot_ops=slot_ops, ret_event=ret_event,
        ret_entry=ret_entry, W=W, n_returns=rs.n_returns)

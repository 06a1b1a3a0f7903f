"""ctypes bridge to ``native/preproc.cpp``, the C++ host prep: slot
assignment, the returns view, the keyed union prep, the
benchmark-history generator, and the online monitor's streaming core
(:class:`Monitor`) with its bit-packed returns walk (:func:`walk_dense`).

:mod:`.events` runs its scans here on every path; its Python scans stay
beside them as plain versions for the tests. The library is built at
first use (:mod:`jepsen_tpu_torch._native`); a failed build raises.

Every function takes only caller-owned buffers and keeps no state but
the library handle; a :class:`Monitor` owns its native handle and frees
it when collected.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from jepsen_tpu_torch import _native

# every array parameter is a void* that receives a raw buffer address
# (_p): the call sites allocate exact-dtype contiguous arrays
_PTR = ctypes.c_void_p
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _native.load()
        lib.jt_assign_slots.restype = ctypes.c_int64
        lib.jt_assign_slots.argtypes = [
            ctypes.c_int64, _PTR, _PTR, ctypes.c_int64, ctypes.c_int32,
            _PTR]
        lib.jt_returns_view.restype = ctypes.c_int64
        lib.jt_returns_view.argtypes = [
            ctypes.c_int64, _PTR, _PTR, _PTR, _PTR, ctypes.c_int32, _PTR,
            _PTR, _PTR, _PTR]
        lib.jt_build_keyed.restype = ctypes.c_int64
        lib.jt_build_keyed.argtypes = [
            ctypes.c_int64, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
            ctypes.c_int32, ctypes.c_int32, _PTR, _PTR, _PTR, _PTR, _PTR,
            _PTR]
        lib.jt_gen_history.restype = ctypes.c_int64
        lib.jt_gen_history.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, _PTR, _PTR, _PTR, _PTR]
        lib.jt_walk_dense.restype = ctypes.c_int64
        lib.jt_walk_dense.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, _PTR,
            ctypes.c_int32, _PTR, ctypes.c_int64, _PTR, _PTR]
        lib.jt_mon_new.restype = ctypes.c_void_p
        lib.jt_mon_new.argtypes = [ctypes.c_int32]
        lib.jt_mon_free.restype = None
        lib.jt_mon_free.argtypes = [ctypes.c_void_p]
        lib.jt_mon_feed.restype = ctypes.c_int64
        lib.jt_mon_feed.argtypes = [ctypes.c_void_p, ctypes.c_int64, _PTR,
                                    _PTR, _PTR]
        lib.jt_mon_advance.restype = ctypes.c_int64
        lib.jt_mon_advance.argtypes = [ctypes.c_void_p, _PTR, ctypes.c_int32,
                                       ctypes.c_int32, _PTR, ctypes.c_int64,
                                       _PTR]
        lib.jt_mon_tail.restype = ctypes.c_int64
        lib.jt_mon_tail.argtypes = [ctypes.c_void_p, ctypes.c_int64, _PTR,
                                    _PTR, _PTR]
        lib.jt_mon_drain.restype = ctypes.c_int64
        lib.jt_mon_drain.argtypes = [ctypes.c_void_p, ctypes.c_int64, _PTR,
                                     _PTR, _PTR]
        lib.jt_mon_stats.restype = ctypes.c_int64
        lib.jt_mon_stats.argtypes = [ctypes.c_void_p, _PTR]
        lib.jt_mon_live.restype = ctypes.c_int64
        lib.jt_mon_live.argtypes = [ctypes.c_void_p, ctypes.c_int64, _PTR,
                                    _PTR]
        _LIB = lib
    return _LIB


def _p(a: np.ndarray) -> int:
    """Raw buffer address of a contiguous array."""
    return a.__array_interface__["data"][0]


def assign_slots(kind: np.ndarray, entry: np.ndarray, n_entries: int,
                 max_slots: int) -> Tuple[np.ndarray, int]:
    """Lowest-free-slot assignment over a rank-sorted event stream
    (``kind`` 0 invoke, 1 return; ``entry`` each event's analysis entry,
    below ``n_entries``). Returns ``(slot[E], W)``, ``W = -1`` when more
    than ``max_slots`` ops would be pending at once."""
    kind = np.ascontiguousarray(kind, np.int32)
    entry = np.ascontiguousarray(entry, np.int32)
    if len(entry) and (int(entry.min()) < 0
                       or int(entry.max()) >= n_entries):
        raise ValueError("assign_slots: entry index out of range")
    out = np.empty(len(kind), np.int32)
    W = int(_lib().jt_assign_slots(len(kind), _p(kind), _p(entry),
                                   int(n_entries), int(max_slots), _p(out)))
    return out, W


def returns_view(kind: np.ndarray, slot: np.ndarray, opid: np.ndarray,
                 entry: np.ndarray, W: int, n_events: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                            int]:
    """The return events of the first ``n_events`` events, each with the
    pending map at it: ``(ret_slot, slot_ops [R, W], ret_event,
    ret_entry, R)``. Slots must be below ``W``."""
    W = max(int(W), 1)
    kind, slot, opid, entry = (np.ascontiguousarray(a[:n_events], np.int32)
                               for a in (kind, slot, opid, entry))
    if len(slot) and (int(slot.min()) < 0 or int(slot.max()) >= W):
        raise ValueError("returns_view: slot out of range")
    n_ret = int(np.sum(kind == 1))
    ret_slot = np.empty(n_ret, np.int32)
    slot_ops = np.empty((n_ret, W), np.int32)
    ret_event = np.empty(n_ret, np.int32)
    ret_entry = np.empty(n_ret, np.int32)
    R = int(_lib().jt_returns_view(
        len(kind), _p(kind), _p(slot), _p(opid), _p(entry), W,
        _p(ret_slot), _p(slot_ops), _p(ret_event), _p(ret_entry)))
    return ret_slot, slot_ops, ret_event, ret_entry, R


def build_keyed(entry_off: np.ndarray, inv_rank: np.ndarray,
                ret_rank: np.ndarray, opid: np.ndarray,
                crashed: np.ndarray, noop_op: np.ndarray, max_slots: int,
                w_cap: int):
    """Every key's slotted return stream in one call: the keys' packed
    entries concatenated (``entry_off[K+1]`` offsets), op ids in the
    union alphabet, crashed entries whose op is a no-op in every union
    state (``noop_op``) dropped. Returns ``(ret_slot, slot_ops[:, :w_cap],
    pend, key_W, key_R, ret_entry, R_total)``; ``key_W[k] = -1`` (and
    ``key_R[k] = 0``) where key k would need more than ``max_slots``
    slots."""
    K = len(entry_off) - 1
    N = int(entry_off[-1])
    entry_off = np.ascontiguousarray(entry_off, np.int64)
    inv_rank = np.ascontiguousarray(inv_rank, np.int32)
    ret_rank = np.ascontiguousarray(ret_rank, np.int32)
    opid = np.ascontiguousarray(opid, np.int32)
    crashed = np.ascontiguousarray(crashed, np.uint8)
    noop_op = np.ascontiguousarray(noop_op, np.uint8)
    if not (len(inv_rank) == len(ret_rank) == len(opid) == len(crashed)
            == N) or (N and (int(opid.min()) < 0
                             or int(opid.max()) >= len(noop_op))):
        raise ValueError("build_keyed: inconsistent operands")
    w_cap = max(int(w_cap), 1)
    ret_slot = np.empty(N, np.int32)
    slot_ops = np.empty((N, w_cap), np.int32)
    pend = np.empty(N, np.int32)
    key_W = np.empty(K, np.int32)
    key_R = np.empty(K, np.int32)
    ret_entry = np.empty(N, np.int32)
    R = int(_lib().jt_build_keyed(
        K, _p(entry_off), _p(inv_rank), _p(ret_rank), _p(opid),
        _p(crashed), _p(noop_op), int(max_slots), w_cap, _p(ret_slot),
        _p(slot_ops), _p(pend), _p(key_W), _p(key_R), _p(ret_entry)))
    return (ret_slot[:R], slot_ops[:R], pend[:R], key_W, key_R,
            ret_entry[:R], R)


def gen_history(seed: int, n_ops: int, processes: int, values: int,
                kind: int):
    """The benchmark-history simulation (``kind`` 0 register, 1 cas):
    ``(inv_ev, ret_ev, opid, proc, count)`` per surviving entry, in
    return order."""
    inv_ev = np.empty(n_ops, np.int32)
    ret_ev = np.empty(n_ops, np.int32)
    opid = np.empty(n_ops, np.int32)
    proc = np.empty(n_ops, np.int32)
    count = int(_lib().jt_gen_history(
        int(seed), int(n_ops), int(processes), int(values), int(kind),
        _p(inv_ev), _p(ret_ev), _p(opid), _p(proc)))
    return (inv_ev[:count], ret_ev[:count], opid[:count], proc[:count],
            count)


class Monitor:
    """Handle to the C++ streaming-monitor core (``jt_mon_*``): the
    per-op bookkeeping of the incremental linearizability monitor
    (slot assignment, settle-queue snapshots, the settled-returns walk),
    fed in per-flush batches. Owned by
    :class:`jepsen_tpu_torch.checkers.online.NativeStreamEngine`, which
    serializes every call on one handle."""

    def __init__(self, max_slots: int):
        self._lib = _lib()
        self._h = ctypes.c_void_p(self._lib.jt_mon_new(int(max_slots)))
        # stats() runs several times a flush: one out-buffer, reused
        self._stats_out = np.zeros(5, np.int64)
        self._stats_ptr = _p(self._stats_out)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.jt_mon_free(h)

    def feed(self, types: np.ndarray, procs: np.ndarray,
             oids: np.ndarray) -> int:
        """Feed a batch of ops (type codes 0 invoke, 1 ok, 2 fail, 3
        info; process keys; op ids). Returns the (possibly grown) W; -1
        a double invoke, -2 more than ``max_slots`` slots."""
        types = np.ascontiguousarray(types, np.int32)
        procs = np.ascontiguousarray(procs, np.int64)
        oids = np.ascontiguousarray(oids, np.int32)
        if not len(types) == len(procs) == len(oids):
            raise ValueError("Monitor.feed: operands differ in length")
        return int(self._lib.jt_mon_feed(self._h, len(types), _p(types),
                                         _p(procs), _p(oids)))

    def advance(self, T: np.ndarray, R_words: np.ndarray
                ) -> Tuple[int, int]:
        """Walk every settleable queued return through the transition
        table ``T`` i32[S, O]; ``R_words`` u64[S, n_words] is mutated in
        place. Returns ``(walked, dead_bind)``, ``dead_bind = -1`` when
        the set survived."""
        S, n_ops = T.shape
        T = np.ascontiguousarray(T, np.int32)
        _check_words(R_words, S)
        dead = np.full(1, -1, np.int32)
        walked = int(self._lib.jt_mon_advance(
            self._h, _p(T), S, n_ops, _p(R_words), R_words.shape[1],
            _p(dead)))
        return walked, int(dead[0])

    def drain(self, cap: int, W: int):
        """Pop every currently settleable queued return (at most
        ``cap``) without walking it: ``(rows[n, W], slots[n],
        binds[n])``. The caller walks the block and owns the death; the
        native settled counter advances by the drain itself."""
        rows = np.empty((max(cap, 1), max(W, 1)), np.int32)
        slots = np.empty(max(cap, 1), np.int32)
        binds = np.empty(max(cap, 1), np.int32)
        n = int(self._lib.jt_mon_drain(self._h, cap, _p(rows), _p(slots),
                                       _p(binds)))
        return rows[:n], slots[:n], binds[:n]

    def tail(self, K: int, W: int):
        """The first ``K`` or fewer unsettled items as ``(rows[n, W],
        slots, binds)``, unresolved members as crashed-at-invoke
        wildcards."""
        rows = np.empty((K, max(W, 1)), np.int32)
        slots = np.empty(K, np.int32)
        binds = np.empty(K, np.int32)
        n = int(self._lib.jt_mon_tail(self._h, K, _p(rows), _p(slots),
                                      _p(binds)))
        return rows[:n], slots[:n], binds[:n]

    def stats(self) -> Tuple[int, int, int, int, int]:
        """``(settled_returns, queued_returns, live_invocations, W,
        front_settleable)``."""
        out = self._stats_out
        self._lib.jt_mon_stats(self._h, self._stats_ptr)
        return (int(out[0]), int(out[1]), int(out[2]), int(out[3]),
                int(out[4]))

    def live(self, cap: int):
        """``(procs, bind_indices)`` of the still-pending invocations."""
        procs = np.empty(cap, np.int64)
        binds = np.empty(cap, np.int32)
        n = int(self._lib.jt_mon_live(self._h, cap, _p(procs), _p(binds)))
        return procs[:n], binds[:n]


def _check_words(R_words: np.ndarray, S: int) -> None:
    if R_words.dtype != np.uint64 or not R_words.flags.c_contiguous \
            or R_words.ndim != 2 or R_words.shape[0] != S:
        raise ValueError(f"R_words must be a contiguous uint64 [{S}, "
                         f"n_words] array")


def walk_dense(T: np.ndarray, R_words: np.ndarray, W: int,
               ret_slot: np.ndarray, rows: np.ndarray) -> int:
    """The bit-packed dense returns walk (``jt_walk_dense``): ``T``
    i32[S, O] the transition table, ``R_words`` u64[S, n_words] the
    bit-packed config set (mutated in place), ``rows`` i32[L, W] the
    pending ops of each return. Returns the first dead return index, or
    -1 when the set survived."""
    S, n_ops = T.shape
    L = len(ret_slot)
    T = np.ascontiguousarray(T, np.int32)
    ret_slot = np.ascontiguousarray(ret_slot, np.int32)
    rows = np.ascontiguousarray(rows, np.int32).reshape(L, int(W))
    _check_words(R_words, S)
    if R_words.shape[1] * 64 < 1 << int(W):
        raise ValueError(f"walk_dense: {R_words.shape[1]} words cannot "
                         f"hold 2^{W} masks")
    return int(_lib().jt_walk_dense(S, int(W), R_words.shape[1], _p(T),
                                    n_ops, _p(R_words), L, _p(ret_slot),
                                    _p(rows)))

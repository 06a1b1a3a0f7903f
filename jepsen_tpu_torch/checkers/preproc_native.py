"""ctypes bridge to ``native/preproc.cpp``, the C++ host prep: slot
assignment, the returns view, the keyed union prep and the
benchmark-history generator.

:mod:`.events` runs its scans here on every path; its Python scans stay
beside them as plain versions for the tests. The library is built at
first use (:mod:`jepsen_tpu_torch._native`); a failed build raises.

Every entry point takes only caller-owned buffers and keeps no state
but the library handle.
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

"""ctypes bridge to the C++ WGL search (``native/wgl.cpp``), the CPU
engine of the ``auto`` chain after the dense engine (upstream's
knossos.wgl ran on the JVM; here the hot loop is C++, built at first use
by :mod:`jepsen_tpu_torch._native`; a failed build raises).

Result dicts mirror :mod:`jepsen_tpu_torch.checkers.wgl_ref`, so the
facade can route to either. An :class:`AbortFlag` lets another thread
stop the search (upstream ``knossos.search/abort!``).
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Sequence

import numpy as np

from jepsen_tpu_torch import _native
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.models.memo import memo as build_memo
from jepsen_tpu_torch.op import Op

_CAUSES = {0: None, 1: "timeout", 2: "config-set-explosion", 3: "aborted"}
# failure evidence: up to this many deepest dead-end configurations
_CFG_CAP = 16
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _native.load("wgl")
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.wgl_check.restype = ctypes.c_int64
        lib.wgl_check.argtypes = [
            i32p, ctypes.c_int32, ctypes.c_int32, i32p,
            ctypes.POINTER(ctypes.c_int64), i32p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int64,
            ctypes.c_double, i32p, i32p, ctypes.c_int32, i32p,
            ctypes.POINTER(ctypes.c_uint64), i32p]
        _LIB = lib
    return _LIB


class AbortFlag:
    """Shared abort flag the search polls (upstream
    ``knossos.search/abort!``)."""

    def __init__(self) -> None:
        self._flag = ctypes.c_int32(0)

    def abort(self) -> None:
        self._flag.value = 1

    @property
    def pointer(self):
        return ctypes.byref(self._flag)


def check(model: Model, history: Sequence[Op], *,
          time_limit: Optional[float] = None,
          max_configs: int = 50_000_000,
          max_states: int = 1_000_000,
          abort_flag: Optional[AbortFlag] = None) -> Dict[str, Any]:
    return check_packed(model, h.pack(history), time_limit=time_limit,
                        max_configs=max_configs, max_states=max_states,
                        abort_flag=abort_flag)


def check_packed(model: Model, packed: h.PackedHistory, *,
                 time_limit: Optional[float] = None,
                 max_configs: int = 50_000_000,
                 max_states: int = 1_000_000,
                 abort_flag: Optional[AbortFlag] = None) -> Dict[str, Any]:
    """Search ``packed`` for a linearization. Raises
    :class:`~jepsen_tpu_torch.models.memo.StateExplosion` past
    ``max_states``; ``unknown`` with ``cause`` ``timeout``,
    ``config-set-explosion`` (past ``max_configs``) or ``aborted``."""
    lib = _lib()
    n = packed.n
    if n == 0 or packed.n_ok == 0:
        return {"valid": True, "engine": "wgl-native",
                "configs-explored": 0}
    memo = build_memo(model, packed, max_states=max_states)

    table = np.ascontiguousarray(memo.table, np.int32)
    inv_ev = np.ascontiguousarray(packed.inv_ev, np.int32)
    ret_ev = np.ascontiguousarray(packed.ret_ev, np.int64)
    op_id = np.ascontiguousarray(packed.op_id, np.int32)
    crashed = np.ascontiguousarray(packed.crashed, np.uint8)
    out = np.zeros(4, np.int32)
    # failure evidence: the deepest dead-end configurations as (state
    # id, linearized-mask words), knossos's :final-paths
    words = (n + 63) // 64 + 1
    cfg_sid = np.zeros(_CFG_CAP, np.int32)
    cfg_mask = np.zeros((_CFG_CAP, words), np.uint64)
    n_cfg = np.zeros(1, np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    explored = lib.wgl_check(
        ptr(table, ctypes.c_int32), memo.n_states, memo.n_ops,
        ptr(inv_ev, ctypes.c_int32), ptr(ret_ev, ctypes.c_int64),
        ptr(op_id, ctypes.c_int32), ptr(crashed, ctypes.c_uint8),
        n, max_configs, -1.0 if time_limit is None else float(time_limit),
        abort_flag.pointer if abort_flag is not None else None,
        ptr(out, ctypes.c_int32),
        _CFG_CAP, ptr(cfg_sid, ctypes.c_int32),
        ptr(cfg_mask, ctypes.c_uint64), ptr(n_cfg, ctypes.c_int32))

    verdict, stuck, cover, cause = (int(x) for x in out)
    if verdict == 1:
        return {"valid": True, "engine": "wgl-native",
                "configs-explored": int(explored),
                "states-materialized": memo.n_states}
    if verdict == 0:
        res = {"valid": False, "engine": "wgl-native",
               "op": packed.entries[stuck].op.to_dict(),
               "max-linearized": cover,
               "configs-explored": int(explored)}
        res["final-configs"] = _decode_configs(
            memo, packed, cfg_sid, cfg_mask, int(n_cfg[0]))
        return res
    return {"valid": "unknown", "engine": "wgl-native",
            "cause": _CAUSES.get(cause, cause),
            "configs-explored": int(explored)}


def _decode_configs(memo, packed: h.PackedHistory, cfg_sid: np.ndarray,
                    cfg_mask: np.ndarray, n_cfg: int):
    """Decode the search's (state id, linearized-mask) dead-end
    configurations into the witness shape every other engine reports:
    model state plus the linearized ops concurrent with that
    configuration's own stuck op (the pending-window scope of
    :mod:`jepsen_tpu_torch.checkers.wgl_ref`)."""
    n = packed.n
    ok_idx = np.nonzero(~packed.crashed)[0]
    final = []
    for c in range(n_cfg):
        bits = np.unpackbits(cfg_mask[c].view(np.uint8),
                             bitorder="little")[:n].astype(bool)
        not_lin_ok = ok_idx[~bits[ok_idx]]
        stuck2 = int(not_lin_ok[0]) if len(not_lin_ok) else -1
        lin_idx = np.nonzero(bits)[0]
        if stuck2 >= 0:
            lin = [str(packed.entries[i].op) for i in lin_idx
                   if i != stuck2
                   and int(packed.ret_ev[i]) > int(packed.inv_ev[stuck2])]
        else:
            lin = []
        if not lin:             # a fully sequential window: the tail
            lin = [str(packed.entries[i].op) for i in lin_idx][-8:]
        final.append({"model": str(memo.states[int(cfg_sid[c])]),
                      "linearized-pending": lin})
    return final

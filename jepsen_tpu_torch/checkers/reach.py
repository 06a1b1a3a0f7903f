"""Dense-reachability linearizability engine on the card.

Upstream analogue: ``knossos/src/knossos/linear.clj`` (Lowe's just-in-time
linearization) raced against ``knossos/src/knossos/wgl.clj``. Where the
upstream keeps an explicit set of configurations ⟨model-state,
linearized-pending-ops⟩, this engine notes that the config space is the
product ``states × 2**W`` (W = most concurrently pending ops) and keeps
the whole reachable set as one dense boolean tensor ``R[state, mask]``:

- **fire** (linearize a pending op): one transition applied to every
  config at once, landing in the bit-set half of the mask axis. Fire
  passes run to a fixpoint between events (monotone, so at most W+1
  passes), which covers every interleaving.
- **invoke**: records the op in its slot; the set is unchanged.
- **return**: configs that never linearized the returning op are killed,
  and its slot bit is cleared. An empty ``R`` is a linearizability
  violation at exactly that event.

Closure passes are needed only just before returns, so the fast path
walks return events alone with each return's pending ops known up front
(:func:`_walk_returns`); on the card that walk is one kernel launch
(:mod:`.reach_lane`, or :mod:`.reach_pallas` above 32 states). Exact,
not probabilistic: the dense set cannot produce false verdicts.

Routing in :func:`check_packed`, chosen from the geometry before anything
launches: chunk-lockstep (:mod:`.reach_chunklock`, the lockstep kernel
over the stream's chunks) when the fast path applies, the history has
at least :data:`reach_chunklock.MIN_RETURNS` returns and the walk
kernels take it; else the lane kernel when R and P fit one block's
shared memory (:func:`reach_lane.lane_fits`); else the wide kernel K4,
whose sets span words, when its set fits (:func:`reach_pallas.fits`);
else the torch returns walk; else, when the per-return matrix form does
not fit, the torch event walk (:func:`_walk`). :func:`check_many`
checks many histories (the ``independent`` checker's keys) with one
launch of a keyed kernel: K3, or K5 above 32 states.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import events as ev
from jepsen_tpu_torch.checkers import (
    reach_chunklock, reach_lane, reach_pallas)
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.models.memo import (
    Memo, StateExplosion, memo as build_memo, memo_ops)
from jepsen_tpu_torch.op import Op

class DenseOverflow(RuntimeError):
    """The dense config tensor would exceed the configured budget; callers
    should fall back to another engine."""


def _host(x) -> list:
    """A 1-D index array (list, numpy or tensor) as a Python list."""
    return x.tolist() if hasattr(x, "tolist") else list(x)


# -- event walk ---------------------------------------------------------------

def _fire_pass(R, slot_op: Sequence[int], T):
    """One pass of 'linearize one more pending op' over every config: for
    each slot j in turn, configs with bit j clear fire the slot's op
    through the transition table into the bit-set half. ``R`` bool
    [S, M]; ``slot_op`` the slot → op map (host ints, -1 = free); ``T``
    int [S, O+1] with -1 for an illegal transition."""
    S, M = R.shape
    for j, o in enumerate(slot_op):
        if o < 0:                       # free slot: the sentinel column
            continue
        col = T[:, o]
        tgt = torch.where(col < 0, S, col).long()       # row S = discard
        Rr = R.reshape(S, M >> (j + 1), 2, 1 << j)
        lo = Rr[:, :, 0, :]
        fired = torch.zeros((S + 1,) + lo.shape[1:], dtype=torch.float32,
                            device=R.device)
        fired.index_add_(0, tgt, lo.float())
        hi = Rr[:, :, 1, :] | (fired[:S] > 0)
        R = torch.stack([lo, hi], dim=2).reshape(S, M)
    return R


def _closure(R, slot_op: Sequence[int], T):
    """Fixpoint of :func:`_fire_pass` — covers every linearization order
    of any subset of pending ops."""
    prev, cur = R, _fire_pass(R, slot_op, T)
    while not torch.equal(prev, cur):
        prev, cur = cur, _fire_pass(cur, slot_op, T)
    return cur


def _project_return(R, j: int):
    """Return of the op in slot ``j``: keep configs that fired it,
    clearing bit j so the slot can be reused."""
    S, M = R.shape
    taken = R.reshape(S, M >> (j + 1), 2, 1 << j)[:, :, 1, :]
    return torch.stack([taken, torch.zeros_like(taken)],
                       dim=2).reshape(S, M)


def _walk(T, kind, slot, opid, R0, slot_op0):
    """Drive the event stream over the dense config set. Returns
    ``(ptr, R, alive)``; ``alive=False`` means the set emptied at event
    ``ptr-1`` (a violation witness)."""
    kind, slot, opid = _host(kind), _host(slot), _host(opid)
    slot_op = list(_host(slot_op0))
    R, ptr, alive = R0, 0, bool(R0.any())
    while ptr < len(kind) and alive:
        k, j = kind[ptr], slot[ptr]
        if k == ev.KIND_INVOKE:
            slot_op[j] = opid[ptr]
        elif k == ev.KIND_RETURN:
            R = _project_return(_closure(R, slot_op, T), j)
            slot_op[j] = -1
            alive = bool(R.any())
        ptr += 1
    return ptr, R, alive


# -- fast path: returns-only walk with matrix transitions ---------------------
#
# Invoke events never change the reachable set — they only update the
# slot→op map, which is known host-side — so the walk executes return
# events only, with the pending map of each return precomputed. Firing
# is a contraction against per-op boolean transition matrices
# P[o][s, s'] = (T[s, o] == s'): Rx gathers the bit-clear partner of
# every slot's mask axis at once (a static XOR column permutation), one
# einsum applies all W slot transitions, and W fire passes (at most W
# pending ops can linearize between returns) replace the fixpoint.

def _ret_step(P, xor_cols, bitmask, R, j: int, ops_row):
    """One return event: W fire passes, then projection on the returning
    slot ``j``; ``j < 0`` = padding (identity)."""
    W, M = xor_cols.shape
    n_ops_pad = P.shape[0] - 1
    G = P[torch.where(ops_row < 0, n_ops_pad, ops_row).long()]  # [W,S,S]
    for _ in range(W):
        Rx = R[:, xor_cols]                                     # [S,W,M]
        contrib = torch.einsum("sjm,jst->tjm", Rx.float(), G)
        add = ((contrib > 0.5) & bitmask[None]).any(dim=1)
        R = R | add
    return R if j < 0 else _project_return(R, j)


def _walk_returns(P, xor_cols, bitmask, ret_slot, slot_ops, R0,
                  unroll: int = 8):
    """Drive return events over the dense config set. ``P`` f32[O+1,S,S]
    (row O = sentinel, all-zero); ``xor_cols`` int[W,M] = m^(1<<j);
    ``bitmask`` bool[W,M] = bit j set in m; ``ret_slot`` int[R];
    ``slot_ops`` int[R, W]; ``R0`` bool[S, M]. Processes ``unroll``
    returns between emptiness checks. Returns ``(ptr, R, alive,
    R_block)``: when dead, the set emptied at some return in
    ``[ptr-unroll, ptr)``, and ``R_block`` is the set before it."""
    js = _host(ret_slot)
    xor_cols = xor_cols.long()
    R, R_block, alive, i = R0, R0, bool(R0.any()), 0
    while i < len(js) and alive:
        R_block = R
        for r in range(i, min(i + unroll, len(js))):
            R = _ret_step(P, xor_cols, bitmask, R, js[r], slot_ops[r])
        i += unroll
        alive = bool(R.any())
    return i, R, alive, R_block


def _build_P(memo: Memo, S_pad: int, O_pad: Optional[int] = None
             ) -> np.ndarray:
    """Per-op transition matrices P[o][s, s'] = (table[s, o] == s'), f32,
    with an all-zero sentinel row at index O_pad."""
    O = memo.n_ops if O_pad is None else O_pad
    P = np.zeros((O + 1, S_pad, S_pad), np.float32)
    s = np.arange(memo.n_states)
    for o in range(memo.n_ops):
        col = memo.table[:, o]
        ok = col >= 0
        P[o, s[ok], col[ok]] = 1.0
    return P


def _xor_bitmask(W: int, M: int):
    j = np.arange(W)[:, None]
    m = np.arange(M)[None, :]
    return ((m ^ (1 << j)).astype(np.int32),
            ((m >> j) & 1).astype(bool))


_UNROLL = 8


def _refine_dead(P, xor_cols, bitmask, rs: "ev.ReturnStream",
                 ptr: int, R_block) -> int:
    """Exact dead event index: the unrolled walk died somewhere in
    ``[ptr-unroll, ptr)``; re-walk that block one return at a time from
    the carried block-start config set."""
    start = max(0, int(ptr) - _UNROLL)
    stop = min(int(ptr), rs.R)
    ptr1, _, alive, _ = _walk_returns(
        P, xor_cols, bitmask, rs.ret_slot[start:stop],
        torch.as_tensor(rs.slot_ops[start:stop], device=P.device),
        R_block, unroll=1)
    if alive:                           # shouldn't happen; be conservative
        return int(rs.ret_event[min(int(ptr), rs.n_returns) - 1])
    return int(rs.ret_event[start + ptr1 - 1])


# fast path applies while the fire-pass intermediate [S, W, M] AND the
# per-op transition-matrix tensor [O+1, S, S] stay small; state-rich /
# op-rich histories keep the event walk (gather through the flat table)
_FAST_MAX_ELEMS = 1 << 22
_FAST_MAX_P = 1 << 24


def _fast_ok(S_pad: int, W: int, M: int, n_ops: int) -> bool:
    return (S_pad * max(W, 1) * M <= _FAST_MAX_ELEMS
            and (n_ops + 1) * S_pad * S_pad <= _FAST_MAX_P)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def _bucket(x: int, grain: int = 8) -> int:
    """Round up to ``m·2^e`` with 8 mantissa steps per octave (≤12.5%
    padding), then to a multiple of ``grain``."""
    x = max(int(x), 1)
    if x <= 8 * grain:
        return -(-x // grain) * grain
    e = x.bit_length() - 4              # mantissa in [8, 16]
    m = -(-x >> e)
    return -(-(m << e) // grain) * grain


# memo tables depend only on (model, alphabet-as-a-SET, cap). The cache
# is keyed by the SORTED alphabet and built on it, so the state
# numbering is that of a cold build whatever the history's occurrence
# order; on every hit the table's columns are permuted back to the
# history's local op-id order. Bounded by entry count, bytes and states.
_MEMO_CACHE: "Dict[Any, Memo]" = {}
_MEMO_CACHE_LOCK = threading.Lock()
_MEMO_CACHE_MAX = 512
_MEMO_CACHE_MAX_ENTRY_BYTES = 1 << 20
_MEMO_CACHE_MAX_ENTRY_STATES = 4096


def _op_sort_key(t):
    return (repr(t[0]), repr(t[1]))


def _cache_put(sig, m: Memo) -> None:
    if (m.table.nbytes > _MEMO_CACHE_MAX_ENTRY_BYTES
            or m.n_states > _MEMO_CACHE_MAX_ENTRY_STATES):
        return
    with _MEMO_CACHE_LOCK:
        if len(_MEMO_CACHE) >= _MEMO_CACHE_MAX:
            _MEMO_CACHE.pop(next(iter(_MEMO_CACHE)), None)
            obs.count("memo_cache.evict")
        _MEMO_CACHE[sig] = m


def _cached_memo(model: Model, packed: h.PackedHistory,
                 max_states: int) -> Memo:
    """Memo for ``packed``'s alphabet, cached across histories in this
    process; its ``distinct_ops`` are this history's ops."""
    keys = list(h.op_keys_of(packed))
    try:
        order = sorted(range(len(keys)), key=lambda i: _op_sort_key(keys[i]))
        sig = (model, max_states, tuple(keys[i] for i in order))
        hash(sig)
    except TypeError:                   # unhashable model/values: no cache
        return build_memo(model, packed, max_states=max_states)
    with _MEMO_CACHE_LOCK:
        m = _MEMO_CACHE.pop(sig, None)
        if m is not None:
            _MEMO_CACHE[sig] = m        # LRU: a hit moves to the MRU end
    if m is None:
        obs.count("memo_cache.miss")
        m = memo_ops(model, tuple(packed.distinct_ops[i] for i in order),
                     max_states=max_states)
        _cache_put(sig, m)
    else:
        obs.count("memo_cache.hit")
    # local op id i lives in canonical column lut[i]
    lut = np.empty(len(keys), np.int32)
    for col, i in enumerate(order):
        lut[i] = col
    return Memo(table=np.ascontiguousarray(m.table[:, lut]),
                states=m.states, distinct_ops=packed.distinct_ops,
                initial=m.initial)


def _pad_table(memo: Memo, S_pad: int, O_pad: int) -> np.ndarray:
    """Transition table padded to [S_pad, O_pad+1]; everything outside the
    real region (including the sentinel last column for opid=-1) is -1."""
    S, O = memo.table.shape
    T = np.full((S_pad, O_pad + 1), -1, np.int32)
    T[:S, :O] = memo.table
    return T


def _prep(model: Model, packed: h.PackedHistory, *,
          max_states: int, max_slots: int, max_dense: int,
          e_bucket: int = 64, memo: Optional[Memo] = None):
    """Host-side pipeline: memo table + slotted event stream, with the
    event axis padded to :func:`_bucket` sizes."""
    if memo is None:
        memo = _cached_memo(model, packed, max_states)
    stream = ev.build(packed, memo, max_slots=max_slots)
    S = memo.n_states
    S_pad = max(2, _next_pow2(S))
    M = 1 << stream.W
    if S_pad * M > max_dense:
        raise DenseOverflow(
            f"dense config space {S_pad}x{M} exceeds budget {max_dense}")
    O_pad = max(2, _next_pow2(memo.n_ops))
    E_pad = max(e_bucket, _bucket(stream.E, e_bucket))
    stream = ev.pad(stream, E_pad)
    T = _pad_table(memo, S_pad, O_pad)
    return memo, stream, T, S_pad, M


def _result_valid(engine: str, stream: ev.EventStream, memo: Memo,
                  elapsed: float) -> Dict[str, Any]:
    return {"valid": True, "engine": engine, "events": stream.n_events,
            "slots": stream.W, "states": memo.n_states,
            "dropped-crashed-noops": stream.n_dropped_crashed,
            "time-s": elapsed}


def _result_invalid(engine: str, stream: ev.EventStream, memo: Memo,
                    packed: h.PackedHistory, dead_event: int,
                    elapsed: float) -> Dict[str, Any]:
    entry = packed.entries[int(stream.entry[dead_event])]
    linearized = int(np.sum(
        stream.kind[:dead_event] == ev.KIND_RETURN))
    return {"valid": False, "engine": engine, "op": entry.op.to_dict(),
            "max-linearized": linearized, "events": stream.n_events,
            "slots": stream.W, "states": memo.n_states,
            "dead-event": int(dead_event), "time-s": elapsed}


def _seed(S_pad: int, M: int, dev) -> torch.Tensor:
    R0 = torch.zeros((S_pad, M), dtype=torch.bool, device=dev)
    R0[0, 0] = True
    return R0


def _final_configs(memo: Memo, rs: "ev.ReturnStream", P: np.ndarray,
                   S_pad: int, M: int, W: int, dead_ret: int,
                   limit: int = 16, device=None) -> List[Dict[str, Any]]:
    """Decode the configurations that survived up to (but not through)
    the dead return — the analogue of knossos's ``:final-paths``: each
    entry is a reachable model state plus the pending ops it has already
    linearized. The prefix is re-walked exactly on ``device``, by the
    walk the geometry allows: the lane kernel K1 (one launch on the
    card), else the wide kernel K4 (one launch), else the torch returns
    walk."""
    R0 = np.zeros((S_pad, M), bool)
    R0[0, 0] = True
    if reach_lane.lane_fits(S_pad, M, memo.n_ops):
        R = reach_lane.prefix_set(P, rs.ret_slot, rs.slot_ops, R0,
                                  dead_ret, device=device)
    elif reach_pallas.fits(S_pad, M, memo.n_ops):
        _, R = reach_pallas.walk_returns(
            P, rs.ret_slot[:dead_ret], rs.slot_ops[:dead_ret], R0,
            device=device)
    else:
        dev = _device.resolve(device)
        xc, bm = _xor_bitmask(W, M)
        _, R_t, _, _ = _walk_returns(
            torch.as_tensor(P, device=dev), torch.as_tensor(xc, device=dev),
            torch.as_tensor(bm, device=dev), rs.ret_slot[:dead_ret],
            torch.as_tensor(rs.slot_ops[:dead_ret], device=dev),
            _seed(S_pad, M, dev))
        R = R_t.cpu().numpy()
    alive = np.argwhere(R)
    pending = rs.slot_ops[dead_ret]
    out = []
    for s, mask in alive[:limit]:
        lin = [str(memo.distinct_ops[pending[j]])
               for j in range(W)
               if (mask >> j) & 1 and pending[j] >= 0]
        out.append({"model": str(memo.states[s]),
                    "linearized-pending": lin})
    return out


def _attach_witness(out: Dict[str, Any], memo: Memo, rs, P, S_pad, M,
                    W, dead_ret: int, packed: h.PackedHistory,
                    device=None) -> None:
    """Enrich an invalid verdict with knossos-style failure evidence:
    ``final-configs`` (:func:`_final_configs`) and ``previous-ok`` (the
    last successfully linearized return before the failing one).
    Evidence is best-effort garnish, but a failure is never hidden: a
    kernel, build or device error (``RuntimeError``) propagates, and
    any other is recorded as a ``reach.witness`` fallback."""
    try:
        with obs.span("reach.witness", returns=dead_ret):
            out["final-configs"] = _final_configs(
                memo, rs, P, S_pad, M, W, dead_ret, device=device)
        if dead_ret > 0:
            prev = packed.entries[int(rs.ret_entry[dead_ret - 1])]
            out["previous-ok"] = prev.op.to_dict()
    except RuntimeError:
        raise
    except Exception as e:                              # noqa: BLE001
        obs.engine_fallback("reach.witness", type(e).__name__)


def _attach_witness_slow(out: Dict[str, Any], memo: Memo,
                         stream: ev.EventStream, T, S_pad: int, M: int,
                         W: int, dead_event: int,
                         packed: h.PackedHistory,
                         limit: int = 16) -> None:
    """Witness evidence for the event-walk path: re-walk the event prefix
    up to the failing event, decode the surviving configs
    (``final-configs``), and name the last successfully linearized return
    (``previous-ok``)."""
    try:
        _, R_prev, _ = _walk(
            T, stream.kind[:dead_event], stream.slot[:dead_event],
            stream.opid[:dead_event], _seed(S_pad, M, T.device), [-1] * W)
        # pending map at the failing event, replayed host-side
        pending = np.full(W, -1, np.int64)
        for e in range(dead_event):
            if stream.kind[e] == ev.KIND_INVOKE:
                pending[stream.slot[e]] = stream.opid[e]
            elif stream.kind[e] == ev.KIND_RETURN:
                pending[stream.slot[e]] = -1
        alive = np.argwhere(R_prev.cpu().numpy())
        configs = []
        for s, mask in alive[:limit]:
            lin = [str(memo.distinct_ops[pending[j]])
                   for j in range(W)
                   if (int(mask) >> j) & 1 and pending[j] >= 0]
            configs.append({"model": str(memo.states[s]),
                            "linearized-pending": lin})
        out["final-configs"] = configs
        rets = np.nonzero(
            stream.kind[:dead_event] == ev.KIND_RETURN)[0]
        if len(rets):
            prev = packed.entries[int(stream.entry[int(rets[-1])])]
            out["previous-ok"] = prev.op.to_dict()
    except RuntimeError:
        raise
    except Exception as e:                              # noqa: BLE001
        obs.engine_fallback("reach.witness", type(e).__name__)


def check(model: Model, history: Sequence[Op], *,
          max_states: int = 100_000, max_slots: int = 20,
          max_dense: int = 1 << 22, should_abort=None,
          device=None) -> Dict[str, Any]:
    """Check one history on ``device`` (default: the card). Raises
    :class:`DenseOverflow`,
    :class:`~jepsen_tpu_torch.checkers.events.ConcurrencyOverflow`, or
    :class:`~jepsen_tpu_torch.models.memo.StateExplosion` when the history
    does not fit this engine. With ``should_abort`` the walk runs in
    bounded segments and yields ``valid == "unknown"`` when the hook
    fires."""
    return check_packed(model, h.pack(history), max_states=max_states,
                        max_slots=max_slots, max_dense=max_dense,
                        should_abort=should_abort, device=device)


# torch-walk segment size under an abort hook (the lane walk has its
# own, reach_lane._ABORT_SEG)
_ABORT_SEG = 32768

_ABORTED = {"valid": "unknown", "cause": "aborted", "engine": "reach"}


def _chunklock_skip(S_pad: int, M: int, W: int, n_returns: int,
                    lane_ok: bool, should_abort) -> Optional[str]:
    """Why chunk-lockstep does not take this history, or None when it
    does: it runs as one piece (no abort hook), from
    :data:`reach_chunklock.MIN_RETURNS` returns, up to the exact
    ladder's cap on slots, and in the walk kernels' envelope (K1 carries
    its rescues and its death location)."""
    if should_abort is not None:
        return "should-abort"
    if n_returns < reach_chunklock.MIN_RETURNS:
        return "below-min-returns"
    if W > reach_chunklock._FAST_PASSES:
        return "slots"
    if not (lane_ok and reach_chunklock.admits(S_pad, M, W, n_returns)):
        return "geometry"
    return None


def _lane_verdict(engine: str, dead: int, elapsed: float,
                  stream: ev.EventStream, memo: Memo,
                  packed: h.PackedHistory, rs: "ev.ReturnStream",
                  P_np: np.ndarray, S_pad: int, M: int, W: int,
                  device) -> Dict[str, Any]:
    """The verdict of a walk that reports its dead return index (-1:
    linearizable), with the witness re-walked on ``device`` by the walk
    the geometry allows (:func:`_final_configs`)."""
    if dead < 0:
        return _result_valid(engine, stream, memo, elapsed)
    out = _result_invalid(engine, stream, memo, packed,
                          int(rs.ret_event[dead]), elapsed)
    _attach_witness(out, memo, rs, P_np, S_pad, M, W, int(dead), packed,
                    device=device)
    return out


def check_packed(model: Model, packed: h.PackedHistory, *,
                 max_states: int = 100_000, max_slots: int = 20,
                 max_dense: int = 1 << 22,
                 should_abort=None,
                 memo: Optional[Memo] = None,
                 device=None) -> Dict[str, Any]:
    dev = _device.resolve(device)
    t0 = _time.monotonic()
    if packed.n == 0 or packed.n_ok == 0:
        return {"valid": True, "engine": "reach", "events": 0,
                "time-s": 0.0}
    with obs.span("reach.prep", ops=packed.n):
        memo, stream, T, S_pad, M = _prep(
            model, packed, max_states=max_states, max_slots=max_slots,
            max_dense=max_dense, memo=memo)
    W = max(stream.W, 1)
    geom = {"states": S_pad, "slots": W, "ops": memo.n_ops}
    if not _fast_ok(S_pad, W, M, memo.n_ops):
        obs.decision("reach", "route", engine="reach-events", **geom)
        T_t = torch.as_tensor(T, device=dev)
        with obs.span("reach.walk", engine="reach-events",
                      events=int(stream.n_events)):
            ptr, _, alive = _walk(T_t, stream.kind, stream.slot,
                                  stream.opid, _seed(S_pad, M, dev),
                                  [-1] * W)
        elapsed = _time.monotonic() - t0
        if alive:
            return _result_valid("reach", stream, memo, elapsed)
        out = _result_invalid("reach", stream, memo, packed, ptr - 1,
                              elapsed)
        _attach_witness_slow(out, memo, stream, T_t, S_pad, M, W, ptr - 1,
                             packed)
        return out

    with obs.span("reach.returns-view", events=int(stream.n_events)):
        rs = ev.returns_view(stream)
    # the reference's word-packed body comes first on its accelerator;
    # it is not ported
    obs.decision("reach-word", "skipped", cause="not-ported", **geom)
    P_np = _build_P(memo, S_pad)
    lane_ok = reach_lane.lane_fits(S_pad, M, memo.n_ops)
    skip = _chunklock_skip(S_pad, M, W, rs.n_returns, lane_ok, should_abort)
    if skip is None:
        # chunk-lockstep: K2 walks the stream's chunks together, K1
        # carries the rescues and the death location. An error here is
        # a fault of the engine and propagates: no other walk hides it
        obs.decision("reach", "route", engine="reach-chunklock", **geom)
        with obs.span("reach.walk", engine="reach-chunklock",
                      returns=int(rs.n_returns)):
            dead, diag = reach_chunklock.walk_chunklock(
                P_np, rs.ret_slot, rs.slot_ops, M, device=dev)
        out = _lane_verdict("reach-chunklock", dead, _time.monotonic() - t0,
                            stream, memo, packed, rs, P_np, S_pad, M, W, dev)
        out.update(diag)
        return out
    obs.decision("reach-chunklock", "skipped", cause=skip, **geom)
    # the lane kernel K1 up to 32 states, else the wide kernel K4: both
    # walk the whole stream in one launch and report the dead return
    if lane_ok:
        engine, walker = "reach-lane", reach_lane
    elif reach_pallas.fits(S_pad, M, memo.n_ops):
        engine, walker = "reach-pallas", reach_pallas
    else:
        walker = None
    if walker is not None:
        obs.decision("reach", "route", engine=engine, **geom)
        R0_np = np.zeros((S_pad, M), bool)
        R0_np[0, 0] = True
        try:
            with obs.span("reach.walk", engine=engine,
                          returns=int(rs.n_returns)):
                dead, _ = walker.walk_returns(
                    P_np, rs.ret_slot, rs.slot_ops, R0_np, device=dev,
                    fetch_R=False, should_abort=should_abort)
        except reach_lane.Aborted:
            return dict(_ABORTED)
        return _lane_verdict(engine, dead, _time.monotonic() - t0, stream,
                             memo, packed, rs, P_np, S_pad, M, W, dev)

    obs.decision("reach", "route", engine="reach", **geom)
    P = torch.as_tensor(P_np, device=dev)
    rs = ev.pad_returns(rs, max(64, _bucket(rs.n_returns, _UNROLL)))
    xc, bm = _xor_bitmask(W, M)
    xc = torch.as_tensor(xc, device=dev)
    bm = torch.as_tensor(bm, device=dev)
    ops_t = torch.as_tensor(rs.slot_ops, device=dev)
    R_cur = _seed(S_pad, M, dev)
    seg = _ABORT_SEG if should_abort is not None else rs.R
    base = 0
    with obs.span("reach.walk", engine="reach", returns=int(rs.n_returns)):
        while True:
            if should_abort is not None and should_abort():
                return dict(_ABORTED)
            ptr, R_cur, alive, R_block = _walk_returns(
                P, xc, bm, rs.ret_slot[base:base + seg],
                ops_t[base:base + seg], R_cur)
            if not alive:
                ptr += base
                break
            base += seg
            if base >= rs.R:
                break
    elapsed = _time.monotonic() - t0
    if alive:
        return _result_valid("reach", stream, memo, elapsed)
    dead_event = _refine_dead(P, xc, bm, rs, ptr, R_block)
    out = _result_invalid("reach", stream, memo, packed, dead_event,
                          elapsed)
    dead_ret = int(np.searchsorted(rs.ret_event[:rs.n_returns],
                                   dead_event))
    _attach_witness(out, memo, rs, P_np, S_pad, M, W, dead_ret, packed,
                    device=dev)
    return out


# -- many histories: the `independent` checker's batch ----------------------

def _union_alphabet(model: Model, packed_list, live, max_states: int):
    """One memo over the union of the keys' op alphabets, plus a per-key
    LUT from local op ids to union ids (the last entry maps -1 → -1, so
    free slots survive fancy-indexing). The union table is what lets
    every key share one transition tensor P."""
    union: Dict[Any, int] = {}          # (f, hashable(value)) -> union id
    union_ops: List[Op] = []
    for i in live:
        p = packed_list[i]
        for key, op in zip(h.op_keys_of(p), p.distinct_ops):
            if key not in union:
                union[key] = len(union_ops)
                union_ops.append(op)
    memo_u = memo_ops(model, tuple(union_ops), max_states=max_states)
    luts = {}
    for i in live:
        keys_i = h.op_keys_of(packed_list[i])
        lut = np.fromiter((union[k] for k in keys_i), np.int32,
                          count=len(keys_i))
        luts[i] = np.append(lut, np.int32(-1))
    return memo_u, luts


def _keyed_kernel(S_pad: int, M: int, n_ops: int) -> Optional[str]:
    """The keyed kernel that takes this union geometry, as the route's
    cause: ``"keyed"`` (K3, up to 32 states), ``"keyed-wide"`` (K5, sets
    of several words), or None."""
    if reach_lane.keyed_fits(S_pad, M, n_ops):
        return "keyed"
    if reach_pallas.fits(S_pad, M, n_ops):
        return "keyed-wide"
    return None


def _keyed_operands(model, packed_list, rss, live, W: int,
                    max_states: int):
    """The keyed kernels' flat operands: the union transition tensor P
    plus all keys' real returns concatenated into one stream tagged with
    key ids. Returns ``(P, ret_flat, ops_flat, key_flat, offsets)``;
    raises :class:`StateExplosion`/:class:`DenseOverflow` when
    the union alphabet does not fit the fast path or a keyed kernel."""
    memo_u, luts = _union_alphabet(model, packed_list, live, max_states)
    S_pad = max(2, _next_pow2(memo_u.n_states))
    M = 1 << W
    if not (_fast_ok(S_pad, W, M, memo_u.n_ops)
            and _keyed_kernel(S_pad, M, memo_u.n_ops)):
        raise DenseOverflow("union alphabet exceeds keyed-kernel budgets")
    P = _build_P(memo_u, S_pad)
    wide = [ev.pad_returns(r, r.n_returns, W) for r in rss]
    counts = [r.n_returns for r in wide]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    ret_flat = np.concatenate(
        [r.ret_slot[:n] for r, n in zip(wide, counts)] or
        [np.zeros(0, np.int32)])
    ops_flat = np.concatenate(
        [luts[i][r.slot_ops[:n]] for i, r, n in zip(live, wide, counts)] or
        [np.zeros((0, W), np.int32)])
    key_flat = np.repeat(np.arange(len(wide), dtype=np.int32), counts)
    return P, ret_flat, ops_flat, key_flat, offsets


def _check_many_keyed(operands, rss, preps, live, results, packed_list,
                      M: int, device, t0: float,
                      walker) -> List[Dict[str, Any]]:
    """All keys' returns in one flat stream, one launch of the keyed
    kernel of ``walker`` (K3 in :mod:`.reach_lane`, K5 in
    :mod:`.reach_pallas`), exact per-key death indices; a failed key's
    witness is decoded in its own memo and geometry (the flat stream
    carries union op ids)."""
    P, ret_flat, ops_flat, key_flat, offsets = operands
    with obs.span("reach.walk", engine="reach-keyed",
                  returns=int(ret_flat.shape[0]), keys=len(live)):
        dead = walker.walk_returns_keyed(
            P, ret_flat, ops_flat, key_flat, len(live), M, device=device)
    elapsed = _time.monotonic() - t0
    for k, i in enumerate(live):
        memo, stream, _T, S_k, M_k = preps[i]
        if int(dead[k]) < 0:
            results[i] = _result_valid("reach-keyed", stream, memo,
                                       elapsed)
            continue
        results[i] = _lane_verdict(
            "reach-keyed", int(dead[k]) - int(offsets[k]), elapsed, stream,
            memo, packed_list[i], rss[k], _build_P(memo, S_k), S_k, M_k,
            max(stream.W, 1), device)
    return results


def check_many(model: Model, packed_list: Sequence[h.PackedHistory], *,
               max_states: int = 100_000, max_slots: int = 20,
               max_dense: int = 1 << 22, should_abort=None,
               device=None) -> List[Dict[str, Any]]:
    """Batched per-key checking on ``device`` (default: the card), the
    ``independent`` checker's hot path; results align with
    ``packed_list``. Route order: the reference's lockstep and native
    keyed lanes (recorded as not ported: both need its native union
    prep); a keyed kernel over all keys at once, K3 when the union
    alphabet fits it, else K5 (:func:`reach_pallas.fits`); else each
    history through :func:`check_packed`
    (the reference's vmapped batch is not ported). ``should_abort`` is
    consulted once, before the dispatch; when it fires every history
    reports ``valid == "unknown"``. Raises :class:`DenseOverflow`,
    :class:`~jepsen_tpu_torch.checkers.events.ConcurrencyOverflow` or
    :class:`~jepsen_tpu_torch.models.memo.StateExplosion` when a
    history does not fit the dense engine."""
    dev = _device.resolve(device)
    t0 = _time.monotonic()
    n = len(packed_list)
    if should_abort is not None and should_abort():
        return [{"valid": "unknown", "cause": "aborted",
                 "engine": "reach-batch"} for _ in packed_list]
    for stage in ("reach-lockstep", "reach-native-keyed"):
        obs.decision(stage, "skipped", cause="not-ported", histories=n)
    with obs.span("reach.prep", histories=n):
        preps = [None if p.n == 0 or p.n_ok == 0 else
                 _prep(model, p, max_states=max_states,
                       max_slots=max_slots, max_dense=max_dense)
                 for p in packed_list]
    live = [i for i, p in enumerate(preps) if p is not None]
    results: List[Optional[Dict[str, Any]]] = [
        None if p is not None else
        {"valid": True, "engine": "reach-batch", "events": 0, "time-s": 0.0}
        for p in preps]
    if not live:
        return results  # type: ignore[return-value]
    S_pad = max(preps[i][3] for i in live)
    W = max(max(preps[i][1].W, 1) for i in live)
    M = 1 << W
    if S_pad * M > max_dense:
        # padding every key to the common (S_pad, W) can overflow even
        # when each key fits individually
        raise DenseOverflow(f"batched dense config space {S_pad}x{M} "
                            f"exceeds budget {max_dense}")
    with obs.span("reach.returns-view", histories=len(live)):
        rss = [ev.returns_view(preps[i][1]) for i in live]
    try:
        with obs.span("reach.keyed-operands", histories=len(live)):
            operands = _keyed_operands(model, packed_list, rss, live, W,
                                       max_states)
    except (StateExplosion, DenseOverflow) as e:
        obs.decision("reach-keyed", "skipped", cause=type(e).__name__,
                     histories=n)
    else:
        P = operands[0]
        cause = _keyed_kernel(P.shape[1], M, P.shape[0] - 1)
        obs.decision("reach-many", "route", cause=cause, histories=n)
        return _check_many_keyed(
            operands, rss, preps, live, results, packed_list, M, dev, t0,
            reach_lane if cause == "keyed" else reach_pallas)
    obs.decision("reach-vmapped", "skipped", cause="not-ported",
                 histories=n)
    obs.decision("reach-many", "route", cause="per-history", histories=n)
    for i in live:
        results[i] = check_packed(model, packed_list[i],
                                  max_states=max_states,
                                  max_slots=max_slots, max_dense=max_dense,
                                  memo=preps[i][0], device=dev)
    return results  # type: ignore[return-value]

"""Sparse frontier linearizability engine: the device search for histories
with many concurrently pending ops, as torch ops on the card.

Upstream analogue: ``knossos/src/knossos/linear.clj`` / ``wgl.clj``'s
explicit configuration sets. The dense engine (:mod:`.reach`) holds the
reachable set as a boolean tensor over ``states × 2**W`` and declines
(``DenseOverflow`` / ``ConcurrencyOverflow``) once ``W``, which grows
with every crashed ``info`` op, passes ~20. This engine keeps the sparse
set of reachable configurations ⟨model state, linearized-pending bitset⟩
as rows, so ``W`` may reach :data:`MAX_SLOTS` (128) while memory scales
with the reachable configurations:

- a configuration is one row of an ``int64[F, K+1]`` tensor: ``K =
  ceil(W/32)`` 32-bit mask words, then the state id; an empty row holds
  ``0xFFFFFFFF`` in every column, which sorts last and which no real
  row's state column holds;
- **fire** expands every row by every pending slot at once, one gather
  through the flattened transition table; the union is deduplicated by
  a lexicographic sort and an adjacent-unique compact, and passes repeat
  to the fixpoint (detected by the unique count);
- **return** keeps the rows whose bitset linearized the returning op and
  clears that bit: every survivor has the bit set, so clearing it keeps
  the rows sorted and the compact needs no re-sort;
- an empty frontier at a return is a violation at exactly that event.

**Crashed-op quotient.** Two pending crashed ops with the same op id are
interchangeable, so a row only needs the count of fired ops per group:
the canonical form packs each group's fired bits into its lowest-ranked
slots, collapsing ``2**k`` to ``∏ (group_size+1)``. Before the rows,
:mod:`.reach_q` walks the quotient's product space (dense, or sparse
over live masks) when it fits its budgets; ``quotient=False`` goes
straight to the rows.

The capacity ``F`` starts at ``frontier0``; on overflow the walk grows
it 4× and resumes exactly at the failing return, from that return's
entry frontier, up to ``max_frontier`` (then :class:`FrontierOverflow`).
Rows are compared in full, no fingerprints. The host drives the walk
one return at a time: a fixpoint pass reads one small tensor (its unique
count and overflow flag), and the abort hook is consulted before every
return. Each read is counted as ``frontier.syncs``, each
return walked as ``frontier.returns`` (:mod:`jepsen_tpu_torch.obs`).
"""
from __future__ import annotations

import time as _time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import events as ev
from jepsen_tpu_torch.checkers import reach, reach_q
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.models.memo import Memo
from jepsen_tpu_torch.op import Op

MAX_SLOTS = 128                 # the bitset in at most 4 words

_SENT = 0xFFFFFFFF              # every column of an empty row
_INT64_MAX = (1 << 63) - 1

_STATUS_RUNNING = 0
_STATUS_DEAD = 1
_STATUS_ABORT = 3

# pending slots expanded per dedup round, at least; _round_blk widens a
# round to the whole slot axis while F·W fits the candidate budget
_BLOCK = 8
_CAND_BUDGET = 1 << 21


class FrontierOverflow(RuntimeError):
    """The reachable configuration set exceeds ``max_frontier`` rows;
    callers fall back to another engine (upstream: knossos.linear dies
    on config-set explosion)."""


def _read(t: torch.Tensor) -> list:
    """One host read of a small device tensor, counted."""
    obs.count("frontier.syncs")
    return t.tolist()


# -- device steps ------------------------------------------------------------

def _lex_order(U) -> torch.Tensor:
    """Row order of ``U: int64[N, K+1]`` sorted lexicographically,
    column 0 most significant: stable sorts from the least significant
    key, the last two columns (a word and the state, each below 2^32,
    the state of a real row below 2^31) packed into one key."""
    K1 = U.shape[1]
    key = torch.where(U[:, K1 - 1] == _SENT, _INT64_MAX,
                      (U[:, K1 - 2] << 31) | U[:, K1 - 1])
    order = torch.sort(key, stable=True).indices
    for c in range(K1 - 3, -1, -1):
        order = order[torch.sort(U[order, c], stable=True).indices]
    return order


def _sort_unique_compact(U, F: int, pack_bits: int = 0):
    """Dedup candidate rows ``U: int64[N, K+1]`` (empty rows all
    ``_SENT``): sort, adjacent-unique, compact the first ``F`` unique
    rows to the front. Returns ``(C: int64[F, K+1], count)``; ``count >
    F`` means rows were dropped (the caller re-runs at a larger ``F``).

    With ``pack_bits`` (``K == 1`` and the state fits ``32 - W`` bits,
    the reference's gate), rows sort by state, then word, as the
    reference's packed single-key sort orders them; otherwise
    lexicographically by the words, then the state. The order decides
    which rows a witness lists first."""
    N, K1 = U.shape
    valid = U[:, K1 - 1] != _SENT
    if pack_bits and K1 == 2:
        key = torch.where(valid, (U[:, 1] << 32) | U[:, 0], _INT64_MAX)
        order = torch.sort(key).indices
    else:
        order = _lex_order(U)
    Us = U[order]
    valid = valid[order]
    differs = torch.ones(N, dtype=torch.bool, device=U.device)
    if N > 1:
        differs[1:] = (Us[1:] != Us[:-1]).any(dim=1)
    unique = valid & differs
    count = unique.sum()
    pos = torch.cumsum(unique.long(), 0) - 1
    pos = torch.where(unique & (pos < F), pos, F)      # row F: dropped
    C = torch.full((F + 1, K1), _SENT, dtype=U.dtype, device=U.device)
    C[pos] = Us
    return C[:F], count


def _extract_bits(U, word_idx, shift):
    """Per-slot fired bits of each row: ``bool[N, W]``."""
    return ((U[:, word_idx] >> shift) & 1) > 0


def _pack_bits(bits, bitmat):
    """Inverse of :func:`_extract_bits`: ``int64[N, K]`` mask words."""
    W, K = bitmat.shape
    words = []
    for k in range(K):
        lo, hi = k * 32, min((k + 1) * 32, W)
        words.append((bits[:, lo:hi].long() * bitmat[lo:hi, k][None, :])
                     .sum(dim=1))
    return torch.stack(words, dim=1)


def _slot_groups(ops_row, crashed_row):
    """Interchangeability at one return, from the pending map:
    ``grouped[w]`` (crashed slots), ``same[w, w']`` (both crashed, same
    op id), ``rank[w]`` (w's index within its group, by slot)."""
    W = ops_row.shape[0]
    grouped = crashed_row & (ops_row >= 0)
    same = (grouped[:, None] & grouped[None, :]
            & (ops_row[:, None] == ops_row[None, :]))
    ar = torch.arange(W, device=ops_row.device)
    rank = (same & (ar[None, :] < ar[:, None])).sum(dim=1)
    return grouped, same, rank


def _canonicalize(U, grouped, same, rank, word_idx, shift, bitmat):
    """Quotient rows by crashed-op interchangeability: within each group,
    repack the fired bits into the group's lowest-ranked slots. Live
    slots are untouched. Applied once a return: a slot freed by a live
    return may later host a lower-numbered member of a crashed group,
    shifting ranks."""
    K = U.shape[1] - 1
    valid = U[:, K] != _SENT
    bits = _extract_bits(U, word_idx, shift)
    counts = bits.float() @ same.float()       # exact: counts <= W
    canon = torch.where(grouped[None, :], rank[None, :].float() < counts,
                        bits)
    out = torch.cat([_pack_bits(canon, bitmat), U[:, K:]], dim=1)
    return torch.where(valid[:, None], out, _SENT)


def _round_blk(F: int, W: int) -> int:
    return max(_BLOCK, min(W, _CAND_BUDGET // max(F, 1)))


def _expand_block(C, pending, grouped, same, rank, T_flat, bitmat,
                  word_idx, shift, n_cols: int, lo: int, canon: bool,
                  blk_size: int):
    """Canonical single-fire successors of every row through pending
    slots ``[lo, lo+blk_size)``: ``int64[F*b, K+1]`` (illegal ones
    empty). Live slots fire when their bit is clear; crashed slots only
    through the group's next canonical member (``rank == fired count``
    over the whole slot axis), so successors of canonical rows are
    canonical."""
    F, K1 = C.shape
    K = K1 - 1
    pend_b = pending[lo:lo + blk_size]
    state = C[:, K]
    cvalid = state != _SENT
    op_ok = pend_b >= 0
    o = torch.where(op_ok, pend_b, 0)
    flat = torch.where(cvalid, state, 0)[:, None] * n_cols + o[None, :]
    tgt = T_flat[flat]                                  # [F, b]
    bits = _extract_bits(C, word_idx, shift)            # [F, W]
    fireable = ~bits[:, lo:lo + blk_size]
    if canon:
        counts = bits.float() @ same.float()
        next_member = counts[:, lo:lo + blk_size] == \
            rank[lo:lo + blk_size][None, :].float()
        fireable = torch.where(grouped[lo:lo + blk_size][None, :],
                               next_member, fireable)
    legal = cvalid[:, None] & op_ok[None, :] & fireable & (tgt >= 0)
    words = C[:, None, :K] | bitmat[None, lo:lo + blk_size, :]
    cand = torch.cat([words, tgt[:, :, None]], dim=2)
    cand = torch.where(legal[:, :, None], cand, _SENT)
    return cand.reshape(F * pend_b.shape[0], K1)


def _closure(C, n_rows: int, pending, grouped, same, rank, T_flat, bitmat,
             word_idx, shift, n_cols: int, canon: bool, F: int,
             pack_bits: int):
    """Fixpoint of fire-expansion ∪ dedup: the unique count is stationary
    exactly at the fixpoint (the union is monotone); the first pass's
    count is compared with the second's, never with the entering set's
    (canonicalization can merge rows without a dedup). Only the first
    ``n_rows`` rows of ``C`` can be non-empty, and a pass expands only
    those. Returns ``(C, count, overflow, entry_empty)``, one read a
    pass."""
    W = pending.shape[0]
    blk = _round_blk(F, W)
    prev = None
    passes = 0
    while True:
        Cs = C[:max(1, n_rows)]
        C2, count2 = Cs, None
        overflow = torch.zeros((), dtype=torch.bool, device=C.device)
        for lo in range(0, W, blk):
            cand = _expand_block(Cs, pending, grouped, same, rank, T_flat,
                                 bitmat, word_idx, shift, n_cols, lo,
                                 canon, blk)
            C2, count2 = _sort_unique_compact(torch.cat([C2, cand]), F,
                                              pack_bits)
            overflow = overflow | (count2 > F)
        count, ov = _read(torch.stack([count2, overflow.long()]))
        passes += 1
        C = C2
        if ov:
            return C, count, True, False
        if passes == 1 and count == 0:
            return C, 0, False, True
        if count == prev:
            return C, count, False, False
        prev, n_rows = count, count


def _project(C, j: int):
    """Return of the op in slot ``j``: keep the rows that linearized it,
    clearing its bit; clearing one bit in every survivor keeps the rows
    sorted, so the compact needs no re-sort."""
    F, K1 = C.shape
    K = K1 - 1
    wi, bit = j >> 5, 1 << (j & 31)
    valid = C[:, K] != _SENT
    sel = C[:, wi]
    keep = valid & ((sel & bit) != 0)
    C = C.clone()
    C[:, wi] = sel & ~bit
    C = torch.where(keep[:, None], C, _SENT)
    pos = torch.cumsum(keep.long(), 0) - 1
    pos = torch.where(keep, pos, F)
    out = torch.full((F + 1, K1), _SENT, dtype=C.dtype, device=C.device)
    out[pos] = C
    return out[:F], keep.sum()


# -- host loop ---------------------------------------------------------------

def _slot_geometry(W: int):
    K = (W + 31) // 32
    w = np.arange(W, dtype=np.int64)
    word_idx = w >> 5
    shift = w & 31
    bitmat = np.zeros((W, K), np.int64)
    bitmat[w, word_idx] = np.int64(1) << shift
    return K, word_idx, shift, bitmat


def _initial_frontier(F: int, K: int, initial_state: int, dev):
    C0 = torch.full((F, K + 1), _SENT, dtype=torch.long, device=dev)
    C0[0, :K] = 0
    C0[0, K] = initial_state
    return C0


def _crashed_slots_ref(stream: ev.EventStream, packed: h.PackedHistory,
                       W: int) -> np.ndarray:
    """Per-event scan of :func:`_crashed_slots`, its plain version."""
    crashed = np.asarray(packed.crashed, bool)
    n_ret = int(np.sum(stream.kind[:stream.n_events] == ev.KIND_RETURN))
    out = np.zeros((n_ret, W), bool)
    cur = np.full(W, -1, np.int64)
    r = 0
    for e in range(stream.n_events):
        k = stream.kind[e]
        if k == ev.KIND_INVOKE:
            cur[stream.slot[e]] = stream.entry[e]
        elif k == ev.KIND_RETURN:
            active = cur >= 0
            out[r, active] = crashed[cur[active]]
            cur[stream.slot[e]] = -1
            r += 1
    return out


def _crashed_slots(stream: ev.EventStream, packed: h.PackedHistory,
                   W: int) -> np.ndarray:
    """``bool[R, W]`` aligned with :func:`events.returns_view`: whether
    the op pending in slot ``w`` at return ``r`` crashed. Vectorized: a
    slot's occupant at a return is found by a searchsorted over that
    slot's own events; the slot is occupied when its last event at or
    before the return is an invoke, or is that return itself."""
    crashed = np.asarray(packed.crashed, bool)
    E = stream.n_events
    kind = stream.kind[:E]
    slot = stream.slot[:E]
    entry = stream.entry[:E]
    ret_pos = np.nonzero(kind == ev.KIND_RETURN)[0]
    out = np.zeros((len(ret_pos), W), bool)
    for w in range(W):
        pos_w = np.nonzero(slot == w)[0]
        if len(pos_w) == 0:
            continue
        j = np.searchsorted(pos_w, ret_pos, side="right") - 1
        valid = j >= 0
        jc = np.clip(j, 0, None)
        last = pos_w[jc]
        occupied = valid & ((kind[last] == ev.KIND_INVOKE)
                            | (last == ret_pos))
        out[:, w] = occupied & crashed[entry[last]]
    return out


def _seg_arrays(rs: ev.ReturnStream, crashed_slot: np.ndarray, dev):
    """The walk's per-return operands on the device: the pending map
    ``int64[R, W]`` and the crashed-slot map ``bool[R, W]``."""
    n = rs.n_returns
    return (torch.as_tensor(rs.slot_ops[:n], dtype=torch.long, device=dev),
            torch.as_tensor(crashed_slot[:n], device=dev))


def _run_walk(memo: Memo, rs: ev.ReturnStream, crashed_slot: np.ndarray,
              F: int, max_frontier: int, should_abort=None, device=None):
    """Drive the return stream, one return at a time, carrying the
    frontier. On capacity overflow the walk grows ``F`` 4× and resumes
    exactly at the failing return from its entry frontier. Returns
    ``(dead_ret, status, C, count, F)``; on a dead status ``C`` is the
    entry frontier of the dead return (the configurations alive before
    it). Raises :class:`FrontierOverflow` past ``max_frontier``."""
    dev = _device.resolve(device)
    W = rs.W
    K, word_idx, shift, bitmat = _slot_geometry(W)
    word_idx = torch.as_tensor(word_idx, device=dev)
    shift = torch.as_tensor(shift, device=dev)
    bitmat = torch.as_tensor(bitmat, device=dev)
    S, O = memo.table.shape
    T_flat = torch.as_tensor(memo.table.reshape(-1), dtype=torch.long,
                             device=dev)
    canon = bool(crashed_slot[:rs.n_returns].any())
    # the reference's single-key packed sort when a row fits 32 bits
    pack_bits = W if (K == 1 and S <= (1 << (32 - W)) - 1) else 0
    ops_d, crashed_d = _seg_arrays(rs, crashed_slot, dev)
    ret_slot = [int(j) for j in rs.ret_slot[:rs.n_returns]]
    C = _initial_frontier(F, K, memo.initial, dev)
    n_rows = 1                      # rows at or past this one are empty
    prev_C = C
    r = 0
    while r < rs.n_returns:
        if should_abort is not None and should_abort():
            return -1, _STATUS_ABORT, C, None, F
        obs.count("frontier.returns")
        ops_row = ops_d[r]
        if canon:
            grouped, same, rank = _slot_groups(ops_row, crashed_d[r])
            Cc = _canonicalize(C[:max(1, n_rows)], grouped, same, rank,
                               word_idx, shift, bitmat)
        else:
            grouped = same = rank = None
            Cc = C
        C1, count1, overflow, entry_empty = _closure(
            Cc, n_rows, ops_row, grouped, same, rank, T_flat, bitmat,
            word_idx, shift, O, canon, F, pack_bits)
        if entry_empty:             # emptied by return r-1's projection
            return r - 1, _STATUS_DEAD, prev_C, 0, F
        if overflow:
            F *= 4
            if F > max_frontier:
                raise FrontierOverflow(
                    f"reachable config set exceeds {max_frontier} rows")
            obs.count("frontier.escalations")
            C = torch.cat([C, torch.full((F - C.shape[0], K + 1), _SENT,
                                         dtype=C.dtype, device=dev)])
            continue                # resume at the failing return
        prev_C = C
        C, count2 = _project(C1, ret_slot[r])
        n_rows = count1
        r += 1
    if rs.n_returns:
        count = _read(count2)
        if count == 0:
            return rs.n_returns - 1, _STATUS_DEAD, prev_C, 0, F
        return rs.n_returns, _STATUS_RUNNING, C, count, F
    return 0, _STATUS_RUNNING, C, 1, F


def _final_configs(memo: Memo, rs: ev.ReturnStream, C, dead_ret: int,
                   limit: int = 16) -> List[Dict[str, Any]]:
    """Decode the configurations alive just before the dead return (the
    knossos ``:final-paths`` analogue, in the shape of
    :func:`jepsen_tpu_torch.checkers.reach._final_configs`)."""
    C_np = C.cpu().numpy()
    pending = rs.slot_ops[dead_ret]
    K = (rs.W + 31) // 32
    out = []
    for row in C_np[:limit]:
        s = int(row[K])
        if s == _SENT:
            break
        lin = [str(memo.distinct_ops[pending[w]])
               for w in range(rs.W)
               if (int(row[w >> 5]) >> (w & 31)) & 1 and pending[w] >= 0]
        out.append({"model": str(memo.states[s]),
                    "linearized-pending": lin})
    return out


def check(model: Model, history: Sequence[Op], *,
          max_states: int = 100_000, max_slots: int = MAX_SLOTS,
          frontier0: int = 1 << 10, max_frontier: int = 1 << 17,
          time_limit: Optional[float] = None, should_abort=None,
          quotient: bool = True, device=None) -> Dict[str, Any]:
    """Check one history with the sparse frontier engine on ``device``
    (default: the card). Raises :class:`FrontierOverflow`,
    :class:`~jepsen_tpu_torch.checkers.events.ConcurrencyOverflow` (more
    than ``max_slots`` ≤ 128 pending slots), or
    :class:`~jepsen_tpu_torch.models.memo.StateExplosion`; the facade
    takes these as declines. Past ``time_limit``, or when
    ``should_abort()`` is true at a check point, the verdict is
    ``"unknown"``. ``quotient=False`` skips the product-space walk of
    :mod:`.reach_q`."""
    return check_packed(model, h.pack(history), max_states=max_states,
                        max_slots=max_slots, frontier0=frontier0,
                        max_frontier=max_frontier, time_limit=time_limit,
                        should_abort=should_abort, quotient=quotient,
                        device=device)


def check_packed(model: Model, packed: h.PackedHistory, *,
                 max_states: int = 100_000, max_slots: int = MAX_SLOTS,
                 frontier0: int = 1 << 10, max_frontier: int = 1 << 17,
                 time_limit: Optional[float] = None, should_abort=None,
                 quotient: bool = True, device=None) -> Dict[str, Any]:
    if isinstance(device, (list, tuple)):
        if len(device) > 1:
            raise NotImplementedError(
                "the mesh-sharded frontier walk is not ported "
                "(ROADMAP.md, Queue 1 item 13)")
        device = device[0] if device else None
    dev = _device.resolve(device)
    t0 = _time.monotonic()
    if packed.n == 0 or packed.n_ok == 0:
        return {"valid": True, "engine": "frontier", "events": 0,
                "time-s": 0.0}
    deadline = t0 + time_limit if time_limit else None

    def aborted():
        if should_abort is not None and should_abort():
            return True
        return deadline is not None and _time.monotonic() > deadline

    def unknown():
        cause = ("timeout" if deadline is not None
                 and _time.monotonic() > deadline else "aborted")
        return {"valid": "unknown", "cause": cause, "engine": "frontier",
                "time-s": _time.monotonic() - t0}

    max_slots = min(max_slots, MAX_SLOTS)
    memo = reach._cached_memo(model, packed, max_states)
    stream = ev.build(packed, memo, max_slots=max_slots)
    if quotient:
        # the crashed-op quotient's product space first, when it fits;
        # only its capacity decline moves on to the rows
        try:
            with obs.span("frontier.quotient", ops=packed.n):
                q = reach_q.check_quotient(memo, stream, packed,
                                           should_abort=aborted,
                                           device=dev)
        except reach_q.QuotientOverflow:
            obs.decision("frontier-quotient", "route",
                         cause="quotient-overflow")
        except reach_q.Aborted:
            return unknown()
        else:
            elapsed = _time.monotonic() - t0
            if q["valid"] is True:
                out = reach._result_valid("frontier", stream, memo, elapsed)
            else:
                out = reach._result_invalid("frontier", stream, memo,
                                            packed, q["dead-event"],
                                            elapsed)
                for k in ("final-configs", "previous-ok"):
                    if k in q:
                        out[k] = q[k]
            out["quotient"] = "dense-product"
            out["product-space"] = q["product-space"]
            return out
    rs = ev.returns_view(stream)
    crashed_slot = _crashed_slots(stream, packed, rs.W)
    # the reference's slot-axis bucket (4 sizes an octave): it sets the
    # row's word count and the sort's key layout
    W_pad = min(max(reach._bucket(rs.W, 4), 4), MAX_SLOTS)
    rs = ev.pad_returns(rs, rs.n_returns, W_pad)
    crashed_slot = np.pad(crashed_slot,
                          ((0, 0), (0, W_pad - crashed_slot.shape[1])))
    F = max(64, frontier0)
    with obs.span("frontier.walk", returns=rs.n_returns, slots=W_pad):
        dead_ret, status, C, _, F = _run_walk(
            memo, rs, crashed_slot, F, max_frontier, should_abort=aborted,
            device=dev)
    if status == _STATUS_ABORT:
        return unknown()
    elapsed = _time.monotonic() - t0
    if status == _STATUS_RUNNING:
        out = reach._result_valid("frontier", stream, memo, elapsed)
        out["frontier-cap"] = F
        return out
    out = reach._result_invalid(
        "frontier", stream, memo, packed, int(rs.ret_event[dead_ret]),
        elapsed)
    out["frontier-cap"] = F
    try:
        with obs.span("frontier.witness", returns=dead_ret):
            out["final-configs"] = _final_configs(memo, rs, C, dead_ret)
        if dead_ret > 0:
            prev = packed.entries[int(rs.ret_entry[dead_ret - 1])]
            out["previous-ok"] = prev.op.to_dict()
    except RuntimeError:
        raise
    except Exception as e:                              # noqa: BLE001
        obs.engine_fallback("frontier.witness", type(e).__name__)
    return out

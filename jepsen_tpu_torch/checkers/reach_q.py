"""Product-space walk with the crashed-op quotient: the frontier engine's
fast path for histories with crashed ops, as torch ops on the card.

Upstream knossos explores crashed (``info``) ops exactly, paying the
``2^k`` "info ops are expensive" blowup. Two pending crashed ops with
the same op id are interchangeable (neither returns; firing either steps
the model identically) and a crashed op never needs a live slot (no
projection ever targets it), so the reachable configuration space is the
product

    state × 2^L × Π_g (k_g + 1)

where ``L`` counts only concurrently pending returning ops and ``k_g``
is the size of crashed group ``g`` (one group per op id).

Per return (fire passes run to a monotone fixpoint):

- live fires: the dense engine's mask-axis update (:mod:`.reach`),
  batched over the flat count axis;
- group fires: configurations with ``count_g < cap_g(r)`` step the model
  through the group's op and increment the count, a gather along the
  mixed-radix flat count axis. ``cap_g(r)`` is the number of group
  members invoked before return ``r``;
- projection on the returning live slot.

The quotient map (forget which group members fired, keep the count) is a
bisimulation on the dense engine's configuration graph, so emptiness at
each return is preserved exactly.

Two walks share the quotient:

- **dense**: the whole ``2^L`` mask axis in one ``bool[S, 2^L, C]``
  tensor, for ``L <= 16`` and ``S·2^L·C <= max_dense``;
- **sparse-live**: one row per reachable live mask (``L <= 31``), each
  with a dense ``[S, C]`` count payload, capacity escalating through
  :data:`_SQ_CAPS`. Live pending ops that share an op id and an
  invocation window are interchangeable too (:func:`_live_epochs`), and
  their fired bits are repacked into their earliest-returning members.

The host drives both walks one return at a time; a fixpoint pass reads
one small tensor (its change and the set's emptiness), and the caller's
``should_abort`` is consulted before every return. Each read is
counted as ``reach_q.syncs``, each return walked as ``reach_q.returns``
(:mod:`jepsen_tpu_torch.obs`). Histories beyond every budget raise
:class:`QuotientOverflow`; the frontier's sparse rows take them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import events as ev
from jepsen_tpu_torch.checkers import preproc_native
from jepsen_tpu_torch.models.memo import Memo

_MAX_GROUPS = 16
# live-slot caps: the dense walk holds the whole 2^L mask axis, the
# sparse-live walk keys rows by mask
_MAX_LIVE_DENSE = 16
_MAX_LIVE_SPARSE = 31
# the reference's segment length: its identity-padded tail rows show in
# a witness (_pad_steps)
_SEG = 32768
# sparse-live row capacities (distinct live masks a frontier), tried in
# turn before overflowing to the frontier's sparse rows
_SQ_CAPS = (256, 1024, 4096, 16384)
# budgets of the sparse-live walk: payload bools a frontier, and entries
# of the candidate product [F, W, S, C] of one pass
_SQ_PAYLOAD_MAX = 1 << 25
_SQ_EINSUM_MAX = 1 << 26
# an empty sparse-live row: above every mask of at most 31 bits
_SQ_SENT = 0xFFFFFFFF


class QuotientOverflow(RuntimeError):
    """The product space exceeds the budget; callers fall back to the
    sparse frontier rows."""


class Aborted(RuntimeError):
    """The caller's ``should_abort`` fired."""


class _SqOverflow(RuntimeError):
    """Row capacity exceeded at the current rung."""


def _read(t: torch.Tensor) -> list:
    """One host read of a small device tensor, counted."""
    obs.count("reach_q.syncs")
    return t.tolist()


# -- host geometry -----------------------------------------------------------

def _mixed_radix(sizes: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    """For count-axis sizes ``k_g + 1``: per-group digit table
    ``digit[G, C]`` and shift-source table ``src[G, C]`` (the flat index
    whose count_g is one lower, -1 where digit_g == 0)."""
    C = int(np.prod(sizes)) if sizes else 1
    G = len(sizes)
    digit = np.zeros((max(G, 1), C), np.int32)
    src = np.full((max(G, 1), C), -1, np.int32)
    flat = np.arange(C)
    stride = 1
    for g in range(G):
        digit[g] = (flat // stride) % sizes[g]
        src[g] = np.where(digit[g] > 0, flat - stride, -1)
        stride *= sizes[g]
    return digit, src


def _prep_quotient(memo: Memo, stream: ev.EventStream,
                   packed: h.PackedHistory,
                   max_live: int = _MAX_LIVE_DENSE):
    """Split the event stream into live events (slotted over returning
    ops only) and crashed groups, and build the walk's operands."""
    crashed = np.asarray(packed.crashed, bool)
    E = stream.n_events
    kind = stream.kind[:E]
    entry = stream.entry[:E]
    opid = stream.opid[:E]
    is_crash_ev = (kind == ev.KIND_INVOKE) & crashed[entry]
    live_pos = np.nonzero(~is_crash_ev)[0].astype(np.int32)
    lkind = np.ascontiguousarray(kind[live_pos])
    lentry = np.ascontiguousarray(entry[live_pos])
    lslot, L = preproc_native.assign_slots(lkind, lentry, packed.n,
                                           max_live)
    if L < 0:
        raise QuotientOverflow(f"live concurrency > {max_live}")
    L = max(L, 1)
    lopid = np.ascontiguousarray(opid[live_pos])
    ret_slot, slot_ops, ret_event_l, ret_entry, R = \
        preproc_native.returns_view(lkind, lslot, lopid, lentry, L,
                                    len(lkind))
    # ret_event_l indexes the live stream; map back to stream events
    ret_event = live_pos[ret_event_l]

    def epochs() -> Tuple[np.ndarray, np.ndarray]:
        # only the sparse-live walk reads the epoch tables
        return _live_epochs(lkind, lslot, lentry, lopid, packed, L, R)
    # crashed groups by op id (crashed no-ops were dropped by events.build)
    crash_pos = np.nonzero(is_crash_ev)[0]
    crash_ops = opid[crash_pos]
    gids, ginv = np.unique(crash_ops, return_inverse=True)
    G = len(gids)
    if G > _MAX_GROUPS:
        raise QuotientOverflow(f"{G} crashed groups > {_MAX_GROUPS}")
    sizes = [int((ginv == g).sum()) + 1 for g in range(G)]
    C = int(np.prod(sizes)) if sizes else 1
    # cap_g(r): group members invoked before return r's event
    caps = np.zeros((max(R, 1), max(G, 1)), np.int32)
    for g in range(G):
        inv_ranks = np.sort(crash_pos[ginv == g])
        caps[:R, g] = np.searchsorted(inv_ranks, ret_event[:R])
    digit, src = _mixed_radix(sizes)
    return (L, ret_slot, slot_ops, ret_event, ret_entry, R,
            gids.astype(np.int32), sizes, C, caps, digit, src, epochs)


def _live_epochs(lkind: np.ndarray, lslot: np.ndarray,
                 lentry: np.ndarray, lopid: np.ndarray,
                 packed: h.PackedHistory, L: int, R: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Live epoch groups for the sparse walk's rank canonicalization:
    two live pending ops are interchangeable when they share an op id
    and were invoked within the same inter-return window (every fire
    opportunity postdates both invokes; ops straddling a return are not
    collapsed). Returns per-return tables over live slots: ``ep_gid[R,
    L]`` int8, the min-slot representative of the slot's group (-1 for
    an empty slot), and ``ep_rank[R, L]`` int8, the slot's rank within
    its group by return order, so the returning slot is rank 0 and
    canonical masks survive its projection."""
    E = len(lkind)
    occ_entry = np.full(L, -1, np.int64)
    inv_code = np.zeros(L, np.int64)        # epoch code of the occupant
    n_rets_seen = 0
    code = np.full((max(R, 1), L), -1, np.int64)
    occ_ret = np.full((max(R, 1), L), 0, np.int64)
    r = 0
    ret_ev_arr = np.asarray(packed.ret_ev, np.int64)
    for e in range(E):
        s = lslot[e]
        if lkind[e] == ev.KIND_INVOKE:
            occ_entry[s] = lentry[e]
            inv_code[s] = (np.int64(lopid[e]) << np.int64(32)
                           | np.int64(n_rets_seen))
        else:                               # return
            n_rets_seen += 1
            if r < R:
                live = occ_entry >= 0
                code[r, live] = inv_code[live]
                occ_ret[r, live] = ret_ev_arr[occ_entry[live]]
                r += 1
            occ_entry[s] = -1
    # rank within equal-code groups by (occupant return event, slot),
    # chunked over R so the [chunk, L, L] broadcasts stay small
    Rr = max(R, 1)
    rank = np.zeros((Rr, L), np.int8)
    gid = np.full((Rr, L), -1, np.int8)
    slots = np.arange(L)
    chunk = max(1, (1 << 22) // max(L * L, 1))
    for lo in range(0, Rr, chunk):
        hi = min(lo + chunk, Rr)
        c = code[lo:hi]
        o = occ_ret[lo:hi]
        same = (c[:, :, None] == c[:, None, :]) & (c[:, :, None] >= 0)
        earlier = (o[:, :, None] > o[:, None, :]) | (
            (o[:, :, None] == o[:, None, :])
            & (slots[None, :, None] > slots[None, None, :]))
        rank[lo:hi] = (same & earlier).sum(axis=2).astype(np.int8)
        gid[lo:hi] = np.where(c >= 0,
                              np.argmax(same, axis=2).astype(np.int8),
                              np.int8(-1))
    return gid, rank


def _pad_steps(n: int) -> bool:
    """Whether the reference's last segment of an ``n``-return walk
    carries identity-padded rows: each runs the crashed-group fires
    under the last real return's caps (a closure the reference's
    witness shows)."""
    from jepsen_tpu_torch.checkers import reach

    if n == 0:
        return False
    last = n - _SEG * ((n - 1) // _SEG)
    return max(64, reach._bucket(last, 8)) > last


class _Ops:
    """The walk's operands on the device."""

    def __init__(self, P_np, digit, src, gids, ret_slot, slot_ops, caps,
                 dev):
        self.P = torch.as_tensor(P_np, device=dev)
        self.O_pad = self.P.shape[0] - 1
        self.digit = torch.as_tensor(digit, dtype=torch.long, device=dev)
        src_t = torch.as_tensor(src, dtype=torch.long, device=dev)
        self.src_ok = src_t >= 0
        self.src_c = src_t.clamp(min=0)
        self.gids = [int(g) for g in gids]
        self.ret_slot = [int(j) for j in ret_slot]
        self.slot_ops = torch.as_tensor(np.ascontiguousarray(slot_ops),
                                        dtype=torch.long, device=dev)
        self.caps = torch.as_tensor(np.ascontiguousarray(caps),
                                    dtype=torch.long, device=dev)

    def live(self, i: int) -> torch.Tensor:
        """Return ``i``'s live transition matrices [L, S, S] (a free slot
        reads P's all-zero sentinel)."""
        row = self.slot_ops[i]
        return self.P[torch.where(row < 0, self.O_pad, row)]

    def gate(self, i: int) -> torch.Tensor:
        """``digit_g <= cap_g(i)``: bool[G, C]."""
        return self.digit <= self.caps[i][:, None]


def _group_fires(X, ops: _Ops, gate, spec: str):
    """Crashed-group fires on ``X`` (count axis last): step the model
    through each group's op and advance its count digit, gated on the
    invoked-availability cap."""
    for g, o in enumerate(ops.gids):
        fired = torch.einsum(spec, X.float(), ops.P[o]) > 0.5
        shifted = fired[..., ops.src_c[g]] & ops.src_ok[g]
        X = X | (shifted & gate[g])
    return X


# -- dense walk --------------------------------------------------------------

def _q_fire_once(R, ops: _Ops, xor_cols, bitmask, Glive, gate):
    """One monotone fire pass on ``R`` bool[S, M, C]: every live slot,
    then every crashed group."""
    Rx = R[:, xor_cols]                                 # [S, W, M, C]
    contrib = torch.einsum("sjmc,jst->tjmc", Rx.float(), Glive)
    add = ((contrib > 0.5) & bitmask[None, :, :, None]).any(dim=1)
    return _group_fires(R | add, ops, gate, "smc,st->tmc")


def _q_closure(R, ops: _Ops, xor_cols, bitmask, Glive, gate):
    """Fire passes to the fixpoint; returns ``(R, nonempty)``, one read
    a pass."""
    while True:
        nxt = _q_fire_once(R, ops, xor_cols, bitmask, Glive, gate)
        changed, nonempty = _read(torch.stack([(nxt != R).any(),
                                               nxt.any()]))
        R = nxt
        if not changed:
            return R, nonempty


def _q_project(R, j: int):
    """Keep configurations that fired live slot ``j``, clearing its
    bit."""
    M = R.shape[1]
    idx = torch.arange(M, device=R.device)
    bit = 1 << j
    clear = (idx & bit) == 0
    return R[:, idx | bit] & clear[None, :, None]


def _q_walk(ops: _Ops, xor_cols, bitmask, R0, R_n: int, should_abort):
    """Drive returns ``[0, R_n)``. Returns ``(dead_ret, R_prev)``:
    ``dead_ret = -1`` when the set never empties, else the return whose
    projection emptied it and the set before that return."""
    R, prev_entry, entry = R0, R0, R0
    for i in range(R_n):
        if should_abort is not None and should_abort():
            raise Aborted()
        obs.count("reach_q.returns")
        prev_entry, entry = entry, R
        R, nonempty = _q_closure(R, ops, xor_cols, bitmask, ops.live(i),
                                 ops.gate(i))
        if not nonempty:            # emptied by return i-1's projection
            return i - 1, prev_entry
        R = _q_project(R, ops.ret_slot[i])
    if R_n and not _read(R.any()):
        return R_n - 1, entry
    return -1, R


def _q_pad_closure(R, ops: _Ops, xor_cols, bitmask, n: int):
    """The reference's identity-padded tail of an ``n``-return walk: the
    group fires under return ``n - 1``'s caps, to the fixpoint."""
    if not _pad_steps(n):
        return R
    L, S = ops.slot_ops.shape[1], ops.P.shape[1]
    Gz = ops.P[ops.O_pad].expand(L, S, S)
    R, _ = _q_closure(R, ops, xor_cols, bitmask, Gz, ops.gate(n - 1))
    return R


# -- sparse-live walk: rows keyed by live mask, dense count payload ----------
#
# Rows hold one reachable live mask each (sorted ascending, empty rows
# _SQ_SENT at the end) with a bool[S, C] payload: group fires never
# create rows, only live fires spawn candidates. Rows merge by OR-ing
# payloads (set union). Capacity overflow restarts the walk at the next
# rung and past the last raises QuotientOverflow: an overflowed walk's
# rows over-approximate and are discarded.

def _sq_dedup(masks, payload, Fcap: int):
    """Sort rows by mask, OR the payloads of equal masks, compact to the
    first ``min(Fcap, N)`` rows (no more than ``N`` can be unique).
    Returns ``(masks, payload, n_unique)``; ``n_unique > Fcap`` means
    rows were clipped."""
    masks_s, order = torch.sort(masks)
    N, S, C = payload.shape
    F_out = min(Fcap, N)
    valid = masks_s != _SQ_SENT
    newseg = torch.cat([valid[:1],
                        (masks_s[1:] != masks_s[:-1]) & valid[1:]])
    seg = torch.cumsum(newseg.long(), 0) - 1
    segc = seg.clamp(0, F_out - 1)
    fill = torch.where(valid, masks_s, torch.full_like(masks_s, _SQ_SENT))
    m_out = torch.full((F_out,), _SQ_SENT, dtype=masks.dtype,
                       device=masks.device).scatter_reduce(
        0, segc, fill, "amin")
    src = (payload[order] & valid[:, None, None]).reshape(N, S * C)
    p_out = torch.zeros((F_out, S * C), dtype=torch.float32,
                        device=payload.device).index_add_(0, segc,
                                                          src.float())
    return m_out, (p_out > 0).reshape(F_out, S, C), newseg.sum()


def _sq_canon(masks, gid_row, rank_row, W: int):
    """Live epoch-rank canonicalization: repack each epoch group's fired
    bits into its earliest-returning members. Sentinel rows pass
    through."""
    valid = masks != _SQ_SENT
    sh = torch.arange(W, device=masks.device)
    bits = (masks[:, None] >> sh[None, :]) & 1                 # [F, W]
    grouped = gid_row >= 0
    same = ((gid_row[:, None] == gid_row[None, :])
            & grouped[:, None] & grouped[None, :])            # [W, W]
    cnt = bits.float() @ same.float()                         # [F, W]
    newbit = torch.where(grouped[None, :],
                         (rank_row[None, :] < cnt).long(), bits)
    m2 = (newbit << sh[None, :]).sum(dim=1)
    return torch.where(valid, m2, masks)


def _sq_one(masks, payload, ops: _Ops, Gl, gate, live_ok, code_row,
            rank_row, Fcap: int, W: int):
    """One fire pass on the sparse rows: group fires in place, live
    fires spawning candidate rows, canonicalization, dedup."""
    payload = _group_fires(payload, ops, gate, "fsc,st->ftc")
    bits = 1 << torch.arange(W, device=masks.device)
    cand_ok = ((masks != _SQ_SENT)[:, None]
               & ((masks[:, None] & bits[None, :]) == 0) & live_ok[None, :])
    stepped = torch.einsum("fsc,wst->fwtc", payload.float(), Gl) > 0.5
    cand_masks = torch.where(cand_ok, masks[:, None] | bits[None, :],
                             torch.full_like(cand_ok, _SQ_SENT,
                                             dtype=masks.dtype))
    S, C = payload.shape[1], payload.shape[2]
    cand_payload = (stepped.reshape(-1, S, C)
                    & cand_ok.reshape(-1)[:, None, None])
    all_masks = _sq_canon(torch.cat([masks, cand_masks.reshape(-1)]),
                          code_row, rank_row, W)
    return _sq_dedup(all_masks, torch.cat([payload, cand_payload]), Fcap)


def _sq_closure(masks, payload, over, ops: _Ops, Gl, gate, live_ok,
                code_row, rank_row, Fcap: int, W: int):
    """Fire passes until a pass leaves the payload's bit count unchanged
    (the reference's test) or the rows overflow. Returns ``(masks,
    payload, over, entry_nonempty, overflowed)``, one read a pass (the
    first also reads the entry payload's count). Each pass expands only
    the rows the last one left unique (the rest are empty)."""
    before = None
    entry = payload.sum()
    while True:
        masks, payload, n = _sq_one(masks, payload, ops, Gl, gate, live_ok,
                                    code_row, rank_row, Fcap, W)
        over = over | (n > Fcap)
        cur = payload.sum()
        if before is None:
            before, after, ov, n_rows = _read(torch.stack(
                [entry, cur, over.long(), n]))
            entry_nonempty = before > 0
        else:
            after, ov, n_rows = _read(torch.stack([cur, over.long(), n]))
        if after == before or ov:
            return masks, payload, over, entry_nonempty, bool(ov)
        before = after
        keep = max(1, min(n_rows, len(masks)))
        masks, payload = masks[:keep], payload[:keep]


def _sq_project(masks, payload, j: int, Fcap: int):
    bit = 1 << j
    has = (masks != _SQ_SENT) & ((masks & bit) != 0)
    masks_p = torch.where(has, masks & ~bit, torch.full_like(masks,
                                                             _SQ_SENT))
    return _sq_dedup(masks_p, payload & has[:, None, None], Fcap)


def _sq_walk(ops: _Ops, ep_gid, ep_rank, S_pad: int, C: int, L: int,
             R_n: int, Fcap: int, should_abort, dev):
    """The sparse-live walk at one capacity rung over returns ``[0,
    R_n)``; raises :class:`_SqOverflow`. Returns ``(dead_ret, rows)``
    as :func:`_q_walk` does, ``rows = (masks, payload)``."""
    # one row: the initial configuration (rows grow up to Fcap)
    masks = torch.zeros(1, dtype=torch.long, device=dev)
    payload = torch.zeros((1, S_pad, C), dtype=torch.bool, device=dev)
    payload[0, 0, 0] = True
    over = torch.zeros((), dtype=torch.bool, device=dev)
    code = torch.as_tensor(ep_gid, dtype=torch.long, device=dev)
    rank = torch.as_tensor(ep_rank, dtype=torch.long, device=dev)
    cur = prev_entry = entry = (masks, payload)
    for i in range(R_n):
        if should_abort is not None and should_abort():
            raise Aborted()
        obs.count("reach_q.returns")
        prev_entry, entry = entry, cur
        masks, payload, over, nonempty, ov = _sq_closure(
            masks, payload, over, ops, ops.live(i), ops.gate(i),
            ops.slot_ops[i] >= 0, code[i], rank[i], Fcap, L)
        if ov:
            raise _SqOverflow(f"> {Fcap} live-mask rows")
        if not nonempty:
            return i - 1, prev_entry
        masks, payload, n = _sq_project(masks, payload, ops.ret_slot[i],
                                        Fcap)
        over = over | (n > Fcap)
        cur = (masks, payload)
    if R_n:
        ov, nonempty = _read(torch.stack([over, payload.any()]))
        if ov:
            raise _SqOverflow(f"> {Fcap} live-mask rows")
        if not nonempty:
            return R_n - 1, entry
    return -1, cur


def _sq_pad_closure(rows, ops: _Ops, L: int, n: int, Fcap: int):
    """The sparse walk's identity-padded tail (:func:`_q_pad_closure`):
    group fires only, no live candidates, no epoch groups."""
    if not _pad_steps(n):
        return rows
    masks, payload = rows
    dev = masks.device
    S = ops.P.shape[1]
    Gz = ops.P[ops.O_pad].expand(L, S, S)
    none = torch.zeros(L, dtype=torch.bool, device=dev)
    masks, payload, _, _, _ = _sq_closure(
        masks, payload, torch.zeros((), dtype=torch.bool, device=dev), ops,
        Gz, ops.gate(n - 1), none,
        torch.full((L,), -1, dtype=torch.long, device=dev),
        torch.zeros(L, dtype=torch.long, device=dev), Fcap, L)
    return masks, payload


def check_quotient(memo: Memo, stream: ev.EventStream,
                   packed: h.PackedHistory, *,
                   max_dense: int = 1 << 22,
                   should_abort=None, device=None) -> Dict[str, Any]:
    """Run the product-space walk on ``device`` (default: the card):
    dense when ``2^L`` fits the budget, else the sparse-live walk (rows
    per reachable mask, L ≤ 31). Raises :class:`QuotientOverflow` when
    neither fits, or :class:`Aborted` when ``should_abort`` fires before a
    return. Returns the verdict dict of the reference's
    ``check_quotient``, witness included (the caller names the
    engine)."""
    from jepsen_tpu_torch.checkers import reach

    dev = _device.resolve(device)
    (L, ret_slot, slot_ops, ret_event, ret_entry, R_n, gids, sizes, C,
     caps, digit, src, epochs) = _prep_quotient(
         memo, stream, packed, max_live=_MAX_LIVE_SPARSE)
    S = memo.n_states
    S_pad = max(2, reach._next_pow2(S))
    dense_ok = (L <= _MAX_LIVE_DENSE
                and S_pad * (1 << L) * C <= max_dense)
    sparse_ok = (S_pad * C * _SQ_CAPS[0] <= _SQ_PAYLOAD_MAX
                 and _SQ_CAPS[0] * L * S_pad * C <= _SQ_EINSUM_MAX)
    if not dense_ok and not sparse_ok:
        raise QuotientOverflow(
            f"product space {S_pad}x2^{L}x{C} exceeds budgets")
    geom = {"product-space": [S_pad, 1 << L, C], "live-slots": L,
            "crash-groups": len(sizes)}
    if R_n == 0:
        return {"valid": True, **geom}
    ops = _Ops(reach._build_P(memo, S_pad), digit, src, gids, ret_slot,
               slot_ops, caps[:R_n], dev)
    if dense_ok:
        walk_kind = "dense"
        M = 1 << L
        xc, bm = reach._xor_bitmask(L, M)
        xor_cols = torch.as_tensor(xc, dtype=torch.long, device=dev)
        bitmask = torch.as_tensor(bm, device=dev)
        R0 = torch.zeros((S_pad, M, C), dtype=torch.bool, device=dev)
        R0[0, 0, 0] = True
        with obs.span("reach_q.walk", walk=walk_kind, returns=R_n):
            dead_ret, R_prev = _q_walk(ops, xor_cols, bitmask, R0, R_n,
                                       should_abort)
        Fcap = 0
    else:
        walk_kind = "sparse-live"
        ep_gid, ep_rank = epochs()
        for Fcap in _SQ_CAPS:
            if (S_pad * C * Fcap > _SQ_PAYLOAD_MAX
                    or Fcap * L * S_pad * C > _SQ_EINSUM_MAX):
                raise QuotientOverflow(f"sparse-live rows past {Fcap} "
                                       f"exceed the budgets")
            try:
                with obs.span("reach_q.walk", walk=walk_kind, rows=Fcap,
                              returns=R_n):
                    dead_ret, R_prev = _sq_walk(
                        ops, ep_gid, ep_rank, S_pad, C, L, R_n, Fcap,
                        should_abort, dev)
                break
            except _SqOverflow:
                obs.count("reach_q.sparse-live.escalations")
        else:
            raise QuotientOverflow(f"> {_SQ_CAPS[-1]} live-mask rows")
    if dead_ret < 0:
        return {"valid": True, **geom, "walk": walk_kind}
    out = {"valid": False, **geom, "walk": walk_kind,
           "op": packed.entries[int(ret_entry[dead_ret])].op.to_dict(),
           "dead-event": int(ret_event[dead_ret]),
           "max-linearized": dead_ret}
    if dead_ret > 0:
        out["previous-ok"] = packed.entries[
            int(ret_entry[dead_ret - 1])].op.to_dict()
    _attach_witness(out, memo, ops, R_prev, walk_kind, dead_ret,
                    slot_ops[dead_ret], gids, sizes, digit, L, Fcap,
                    xor_cols if dense_ok else None,
                    bitmask if dense_ok else None)
    return out


def _attach_witness(out, memo, ops, R_prev, walk_kind, dead_ret,
                    pending_row, gids, sizes, digit, L, Fcap, xor_cols,
                    bitmask) -> None:
    """``final-configs``: the configurations alive before the dead
    return, as the reference's re-walk of the prefix leaves them. A
    device error (``RuntimeError``) propagates; any other failure drops
    the witness with a ``reach_q.witness`` ledger record."""
    try:
        with obs.span("reach_q.witness", returns=dead_ret):
            if walk_kind == "dense":
                R = _q_pad_closure(R_prev, ops, xor_cols, bitmask, dead_ret)
                out["final-configs"] = _decode(
                    memo, R.cpu().numpy(), pending_row, gids, sizes, digit)
            else:
                m, p = _sq_pad_closure(R_prev, ops, L, dead_ret, Fcap)
                out["final-configs"] = _decode_sparse(
                    memo, m.cpu().numpy(), p.cpu().numpy(), pending_row,
                    gids, sizes, digit)
    except RuntimeError:
        raise
    except Exception as e:                              # noqa: BLE001
        obs.engine_fallback("reach_q.witness", type(e).__name__)


def _decode_sparse(memo: Memo, masks: np.ndarray, payload: np.ndarray,
                   pending_row, gids, sizes, digit,
                   limit: int = 16) -> List[Dict[str, Any]]:
    out = []
    for f in np.nonzero(masks != _SQ_SENT)[0]:
        m = int(masks[f])
        for s, c in np.argwhere(payload[f]):
            if len(out) >= limit:
                return out
            lin = [str(memo.distinct_ops[pending_row[j]])
                   for j in range(len(pending_row))
                   if (m >> j) & 1 and pending_row[j] >= 0]
            for g in range(len(sizes)):
                cnt = int(digit[g, c])
                if cnt:
                    lin.append(f"{cnt}x crashed "
                               f"{memo.distinct_ops[int(gids[g])]}")
            out.append({"model": str(memo.states[s]),
                        "linearized-pending": lin})
    return out


def _decode(memo: Memo, R: np.ndarray, pending_row, gids, sizes,
            digit, limit: int = 16) -> List[Dict[str, Any]]:
    alive = np.argwhere(R)
    out = []
    for s, m, c in alive[:limit]:
        lin = [str(memo.distinct_ops[pending_row[j]])
               for j in range(len(pending_row))
               if (int(m) >> j) & 1 and pending_row[j] >= 0]
        for g in range(len(sizes)):
            cnt = int(digit[g, c])
            if cnt:
                lin.append(f"{cnt}x crashed "
                           f"{memo.distinct_ops[int(gids[g])]}")
        out.append({"model": str(memo.states[s]),
                    "linearized-pending": lin})
    return out

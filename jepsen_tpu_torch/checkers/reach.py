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
launches: the word-packed walk K11 (:func:`reach_word.walk_returns_words`)
when :func:`_posthoc_body` picks it (the ``body`` keyword, else a
recorded ``walk`` winner of :mod:`.autotune`; never under an abort
hook); chunk-lockstep (:mod:`.reach_chunklock`, the lockstep kernel
over the stream's chunks) when the fast path applies, the history has
at least :data:`reach_chunklock.MIN_RETURNS` returns and the walk
kernels take it; else the lane kernel when R and P fit one block's
shared memory (:func:`reach_lane.lane_fits`); else the wide kernel K4,
whose sets span words, when its set fits (:func:`reach_pallas.fits`);
else the torch returns walk; else, when the per-return matrix form does
not fit, the torch event walk (:func:`_walk`).

Many histories share one union prep (one memo over the union of their
op alphabets, and one native call that builds every history's return
stream): :func:`check_many` (the ``independent`` checker's keys) takes
the lockstep lane on K2 (length-bucketed groups of up to 32 histories,
each one K2 launch staged while the one before it walks; a group whose
body is ``word``, by keyword or recorded ``lockstep`` winner, is one K11
launch instead: :func:`reach_batch._lockstep_body`), else the
native keyed lane (one launch of K3, or K5 above 32 states), else the
keyed kernels over each key's own prep, else each history through
:func:`check_packed`. :func:`check_batch` runs several whole histories
through the lockstep lane.

:func:`check_chunked` (the ``reach-chunked`` algorithm) parallelises one
history over its length: each chunk's transfer matrix from a walk of
every basis config on K2, after a forward pass on K1 (or K4, chained)
that restricts each chunk's basis to the configs that can enter it, then
a fold on the host.
"""
from __future__ import annotations

import os
import threading
import time as _time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import events as ev
from jepsen_tpu_torch.checkers import (
    autotune, dispatch_core, preproc_native, reach_batch, reach_chunklock,
    reach_lane, reach_pallas, reach_word)
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.models.memo import (
    Memo, StateExplosion, memo as build_memo, memo_ops)
from jepsen_tpu_torch.op import Op
from jepsen_tpu_torch.util import hashable

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
# Below it: projections from the superset seeds, then the disk tier, then
# the BFS (the reference's order).
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
    """Memo for ``packed``'s alphabet, cached across histories: an exact
    hit; else a projection from a superset seed (also put in the exact
    cache, in canonical order); else the disk tier; else the BFS. Its
    ``distinct_ops`` are this history's ops."""
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
        canonical_ops = tuple(packed.distinct_ops[i] for i in order)
        m2 = _project_from_seeds(model, keys, max_states,
                                 packed.distinct_ops)
        if m2 is not None:
            _cache_put(sig, Memo(
                table=np.ascontiguousarray(m2.table[:, order]),
                states=m2.states, distinct_ops=canonical_ops,
                initial=m2.initial))
            return m2
        m = _disk_memo_get(sig, canonical_ops)
        if m is None:
            m = memo_ops(model, canonical_ops, max_states=max_states)
            _disk_memo_put(sig, m)
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


# -- the disk tier below _MEMO_CACHE ------------------------------------------
#
# The canonical-order memo persisted under ``store.persist_root()``,
# keyed by a digest of the model's module, qualified name and repr, the
# cap and the sorted alphabet: a changed model signature never serves a
# stale table, and a port model's entry is never a reference model's
# file. Best-effort cache I/O: an unreadable entry is a rebuild.

_DISK_MEMO_VERSION = 1
# entry-count cap for the memo dir: past it the oldest entries go, down
# to this share of the cap, so a directory is dated once every tenth of
# the cap's stores and not at every store
_DISK_MEMO_MAX_ENTRIES = 512
_DISK_MEMO_KEEP = 0.9
# memo dir -> its entries as this process counts them: the directory's
# length at its first store here, plus the stores since
_DISK_MEMO_COUNTS: Dict[str, int] = {}
_DISK_MEMO_LOCK = threading.Lock()


def _disk_memo_path(sig) -> Optional[Tuple[str, str]]:
    """(path, signature repr) of ``sig``'s disk entry, or None when
    persistence is off or the model's repr is the default
    address-stamped one (no stable signature across processes)."""
    import hashlib

    from jepsen_tpu_torch import store
    root = store.persist_root()
    if root is None:
        return None
    model, max_states, keys = sig
    model_rep = repr(model)
    if model_rep.endswith(f"at {hex(id(model))}>"):
        return None
    rep = repr((_DISK_MEMO_VERSION, type(model).__module__,
                type(model).__qualname__, model_rep, max_states, keys))
    name = hashlib.sha256(rep.encode()).hexdigest()[:40] + ".memo.pkl"
    return os.path.join(root, "memo", name), rep


def _disk_memo_get(sig, canonical_ops: Tuple[Op, ...]) -> Optional[Memo]:
    """``sig``'s memo from the disk tier, in canonical order, with this
    history's ops as its ``distinct_ops``; None on a miss. The stored
    signature repr and the stored model (by type and equality) must both
    match, so a repr collision cannot serve a stale table; a corrupt or
    mismatched entry is deleted (``memo_cache.disk.invalid``)."""
    import pickle
    pr = _disk_memo_path(sig)
    if pr is None:
        return None
    path, rep = pr
    try:
        with open(path, "rb") as f:
            payload = pickle.load(f)
        if (payload.get("sig") != rep
                or type(payload.get("model")) is not type(sig[0])
                or payload.get("model") != sig[0]):
            raise ValueError("memo signature mismatch")
        m = payload["memo"]
        m = Memo(table=m.table, states=m.states,
                 distinct_ops=canonical_ops, initial=m.initial)
    except FileNotFoundError:
        obs.count("memo_cache.disk.miss")
        return None
    except Exception:                                   # noqa: BLE001
        obs.count("memo_cache.disk.invalid")
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
    obs.count("memo_cache.disk.hit")
    return m


def _disk_memo_put(sig, m: Memo) -> None:
    """Best-effort insert into the disk tier (a temporary of this
    thread's, then ``os.replace``), with the exact cache's size gates; past
    :data:`_DISK_MEMO_MAX_ENTRIES` the oldest entries are evicted
    (:func:`_disk_memo_evict`)."""
    import pickle
    if (m.table.nbytes > _MEMO_CACHE_MAX_ENTRY_BYTES
            or m.n_states > _MEMO_CACHE_MAX_ENTRY_STATES):
        return
    pr = _disk_memo_path(sig)
    if pr is None:
        return
    path, rep = pr
    try:
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            pickle.dump({"sig": rep, "model": sig[0], "memo": m}, f)
        os.replace(tmp, path)
        obs.count("memo_cache.disk.store")
        _disk_memo_evict(d)
    except Exception:                                   # noqa: BLE001
        pass                            # a full or read-only disk


def _disk_memo_entries(d: str) -> List[str]:
    return [n for n in os.listdir(d) if n.endswith(".memo.pkl")]


def _disk_memo_evict(d: str) -> None:
    """Count a store into ``d``; once this process's count passes
    :data:`_DISK_MEMO_MAX_ENTRIES`, list the directory and, if it is
    past the cap, delete its oldest entries (by mtime, as the reference)
    down to :data:`_DISK_MEMO_KEEP` of the cap. A store overwriting an
    entry counts too: that only brings the next listing forward."""
    with _DISK_MEMO_LOCK:
        n = _DISK_MEMO_COUNTS.get(d)
        n = len(_disk_memo_entries(d)) if n is None else n + 1
        _DISK_MEMO_COUNTS[d] = n
        if n <= _DISK_MEMO_MAX_ENTRIES:
            return
        names = _disk_memo_entries(d)
        n = len(names)
        if n > _DISK_MEMO_MAX_ENTRIES:
            keep = int(_DISK_MEMO_MAX_ENTRIES * _DISK_MEMO_KEEP)
            by_age = sorted(
                names, key=lambda e: os.path.getmtime(os.path.join(d, e)))
            for name in by_age[:n - keep]:
                try:
                    os.unlink(os.path.join(d, name))
                    obs.count("memo_cache.disk.evict")
                    n -= 1
                except OSError:
                    pass
        _DISK_MEMO_COUNTS[d] = n


# -- superset seeds ------------------------------------------------------
#
# A few union-alphabet memos with their key -> column maps, consulted on
# exact-cache misses: a key's alphabet is usually a subset of its batch's
# union. Bounded in count and state size; failed unions are remembered.
_SUPERSET_SEEDS: Dict[Any, Any] = {}
_SUPERSET_SEEDS_FAILED: set = set()
_SUPERSET_SEEDS_MAX = 8
_SUPERSET_MAX_STATES = 1024


def _project_from_seeds(model: Model, keys: Sequence[Any],
                        max_states: int,
                        distinct_ops: Tuple[Op, ...]) -> Optional[Memo]:
    """A memo for ``keys`` (local op order) from a seeded superset memo:
    its columns for these ops, restricted to the states reachable under
    them and renumbered in the seed's order. The same table as a fresh
    BFS up to the states' numbering, so ``S_pad`` and the kernels'
    envelopes are unchanged."""
    with _MEMO_CACHE_LOCK:
        seeds = list(_SUPERSET_SEEDS.values())
    for m2, model2, max2, col_of in seeds:
        if (model2 == model and max2 == max_states
                and all(k in col_of for k in keys)):
            lut = np.fromiter((col_of[k] for k in keys), np.int32,
                              len(keys))
            T = m2.table[:, lut]
            reach_mask = np.zeros(m2.n_states, bool)
            reach_mask[m2.initial] = True
            frontier = np.array([m2.initial])
            while frontier.size:
                nxt = np.unique(T[frontier])
                nxt = nxt[nxt >= 0]
                fresh = nxt[~reach_mask[nxt]]
                reach_mask[fresh] = True
                frontier = fresh
            keep = np.nonzero(reach_mask)[0]
            new_id = np.full(m2.n_states + 1, -1, np.int32)
            new_id[keep] = np.arange(len(keep), dtype=np.int32)
            Tk = T[keep]
            Tk = np.where(Tk >= 0, new_id[Tk], -1)
            return Memo(table=np.ascontiguousarray(Tk),
                        states=tuple(m2.states[i] for i in keep),
                        distinct_ops=distinct_ops,
                        initial=int(new_id[m2.initial]))
    return None


def _memo_for_ops(model: Model, ops: Tuple[Op, ...],
                  max_states: int) -> Memo:
    """Memo over an explicit op tuple, projected from a superset seed
    when one covers it, else built."""
    try:
        keys = [(op.f, hashable(op.value)) for op in ops]
        m = _project_from_seeds(model, keys, max_states, ops)
        if m is not None:
            return m
    except TypeError:                   # unhashable values: build it
        pass
    return memo_ops(model, ops, max_states=max_states)


def _seed_union_memo(model: Model,
                     packed_list: Sequence[h.PackedHistory],
                     max_states: int) -> None:
    """Seed ONE memo over the union of the histories' alphabets, so each
    history's :func:`_cached_memo` projects from it instead of running a
    BFS of its own. The BFS is capped at :data:`_SUPERSET_MAX_STATES`;
    a union past it (or unhashable) seeds nothing and the per-history
    path decides."""
    union: Dict[Any, Op] = {}
    try:
        for packed in packed_list:
            for key, op in zip(h.op_keys_of(packed), packed.distinct_ops):
                union.setdefault(key, op)
        keys = list(union)
        order = sorted(range(len(keys)), key=lambda i: _op_sort_key(keys[i]))
        sig = (model, max_states, tuple(keys[i] for i in order))
        hash(sig)
        with _MEMO_CACHE_LOCK:
            if sig in _SUPERSET_SEEDS or sig in _SUPERSET_SEEDS_FAILED:
                return
        ops = tuple(union[keys[i]] for i in order)
        m = memo_ops(model, ops,
                     max_states=min(max_states, _SUPERSET_MAX_STATES))
    except StateExplosion:
        with _MEMO_CACHE_LOCK:
            if len(_SUPERSET_SEEDS_FAILED) < 64:
                _SUPERSET_SEEDS_FAILED.add(sig)
        return
    except TypeError:
        return
    col_of = {k: i for i, k in enumerate(keys[i] for i in order)}
    with _MEMO_CACHE_LOCK:
        if len(_SUPERSET_SEEDS) >= _SUPERSET_SEEDS_MAX:
            _SUPERSET_SEEDS.pop(next(iter(_SUPERSET_SEEDS)), None)
        _SUPERSET_SEEDS[sig] = (m, model, max_states, col_of)


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
          device=None, body: Optional[str] = None) -> Dict[str, Any]:
    """Check one history on ``device`` (default: the card). Raises
    :class:`DenseOverflow`,
    :class:`~jepsen_tpu_torch.checkers.events.ConcurrencyOverflow`, or
    :class:`~jepsen_tpu_torch.models.memo.StateExplosion` when the history
    does not fit this engine. With ``should_abort`` the walk runs in
    bounded segments and yields ``valid == "unknown"`` when the hook
    fires."""
    return check_packed(model, h.pack(history), max_states=max_states,
                        max_slots=max_slots, max_dense=max_dense,
                        should_abort=should_abort, device=device, body=body)


# torch-walk segment size under an abort hook (the lane walk has its
# own, reach_lane._ABORT_SEG)
_ABORT_SEG = 32768

_ABORTED = {"valid": "unknown", "cause": "aborted", "engine": "reach"}


def _chunklock_skip(S_pad: int, M: int, W: int, n_returns: int,
                    lane_ok: bool) -> Optional[str]:
    """Why chunk-lockstep does not take this history, or None when it
    does: from :data:`reach_chunklock.MIN_RETURNS` returns, up to the
    exact ladder's cap on slots, and in the walk kernels' envelope (K1
    carries its rescues and its death location). An abort hook does not
    keep it out, as it does in the reference: the walk polls the hook
    between its phases (:func:`reach_chunklock.walk_chunklock`)."""
    if n_returns < reach_chunklock.MIN_RETURNS:
        return "below-min-returns"
    if W > reach_chunklock._FAST_PASSES:
        return "slots"
    if not (lane_ok and reach_chunklock.admits(S_pad, M, W, n_returns)):
        return "geometry"
    return None


BODIES = ("word", "dense")


def _check_body(body: Optional[str]) -> None:
    if body is not None and body not in BODIES:
        raise ValueError(f"body={body!r}: want one of {BODIES} or None")


def _posthoc_body(S: int, W: int, M: int, n_returns: int,
                  body: Optional[str], should_abort, dev) -> Tuple[str, str]:
    """The single history's walk body, ``("word" | "dense", cause)``: the
    word walk K11 only where :func:`reach_word.admits` the geometry and no
    abort hook is given (the daemon's checks never take it); then the
    ``body`` keyword; then the recorded ``walk`` winner for this
    geometry on ``dev``'s backend (:func:`autotune.walk_key`); else the
    dense chain, cause ``no-winner``."""
    if not reach_word.admits(S, W, M):
        return "dense", "past-envelope"
    if should_abort is not None:
        return "dense", "abort-hook"
    if body is not None:
        return body, "keyword"
    w = autotune.winner("walk", autotune.walk_key(S, W, M, n_returns),
                        backend_name=dev.type)
    if w in BODIES:
        return w, "winner"
    return "dense", "no-winner"


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
                 device=None, body: Optional[str] = None) -> Dict[str, Any]:
    """Check one packed history on ``device`` (default: the card); see
    :func:`check`. ``body`` (``"word"`` or ``"dense"``) picks the walk
    body where the word walk admits the geometry (:func:`_posthoc_body`);
    None consults the autotune table, else the dense chain."""
    _check_body(body)
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
    choice, why = _posthoc_body(memo.n_states, W, M, rs.n_returns, body,
                                should_abort, dev)
    if choice == "word":
        # the word-packed walk K11: one launch, the exact dead return. A
        # fault in it propagates: no other walk hides it
        obs.decision("reach", "route", engine="reach-word", cause=why,
                     **geom)
        with obs.span("reach.walk", engine="reach-word",
                      returns=int(rs.n_returns)):
            dead, _ = reach_word.walk_returns_words(
                memo.table, rs.ret_slot[:rs.n_returns],
                rs.slot_ops[:rs.n_returns], M, device=dev)
        elapsed = _time.monotonic() - t0
        return _lane_verdict("reach-word", dead, elapsed, stream, memo,
                             packed, rs,
                             _build_P(memo, S_pad) if dead >= 0 else None,
                             S_pad, M, W, dev)
    obs.decision("reach-word", "skipped", cause=why, **geom)
    P_np = _build_P(memo, S_pad)
    lane_ok = reach_lane.lane_fits(S_pad, M, memo.n_ops)
    skip = _chunklock_skip(S_pad, M, W, rs.n_returns, lane_ok)
    if skip is None:
        # chunk-lockstep: K2 walks the stream's chunks together, K1
        # carries the rescues and the death location. An error here is
        # a fault of the engine and propagates: no other walk hides it
        obs.decision("reach", "route", engine="reach-chunklock", **geom)
        try:
            with obs.span("reach.walk", engine="reach-chunklock",
                          returns=int(rs.n_returns)):
                dead, diag = reach_chunklock.walk_chunklock(
                    P_np, rs.ret_slot, rs.slot_ops, M,
                    should_abort=should_abort, device=dev)
        except reach_lane.Aborted:
            return dict(_ABORTED)
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


# -- the carried frontier of a streaming session ----------------------------

def _pad_pow2(n: int, floor: int = 64) -> int:
    return max(floor, 1 << max(0, (n - 1)).bit_length())


class FrontierCarry:
    """The reachable-config frontier of one streaming session, kept on
    the device across append blocks for one geometry ``(S, M = 2^W)``:
    the carried set ``R`` f32 ``[M, S_pad]``, the transition operand
    ``P`` (:func:`_build_P`, ``S_pad`` the states padded as
    :func:`check_packed` pads them) and P's nibble image tables ``T``,
    built once at the seed (P never changes after it). P's op axis is
    padded to the reference's bucket ``O1 = _pad_pow2(O + 1, 8)`` with
    all-zero rows (the last is the slot -1 sentinel), so sessions whose
    alphabets grow at different rates share one geometry,
    :attr:`mega_sig` ``(engine, S_pad, W, O1)``, and a mega-group walks
    them in one launch of K10 (:mod:`.reach_word`). A geometry change
    (memo rebuild, slot growth) discards the carry; the session engine
    re-encodes on the host and seeds a fresh one from a host bool
    ``[S, M]`` set.

    The walk is chosen by geometry when the carry is seeded and recorded
    as a ``frontier-carry`` route: one K1 launch a block where
    :func:`reach_lane.lane_fits` holds at the padded op count
    (``n_pass = W``, exact, with K1's fixpoint exit, one checkpoint
    block the size of the append block), else one K4 launch where
    :func:`reach_pallas.fits` holds, else the torch returns walk
    (:func:`_walk_returns`, its death refined return by return; such a
    carry has no tables and joins no group). Each gives the exact dead
    return; the host reads only that index. Any error propagates."""

    def __init__(self, memo: Memo, W: int, R0_host: np.ndarray, *,
                 device=None) -> None:
        dev = _device.resolve(device)
        self.W, self.M = int(W), 1 << int(W)
        self.S = int(R0_host.shape[0])
        if R0_host.shape != (self.S, self.M) or self.S != memo.n_states:
            raise ValueError(f"FrontierCarry: seed {R0_host.shape} is not "
                             f"[{memo.n_states}, {self.M}]")
        self.advanced_returns = 0
        S_pad = max(2, _next_pow2(self.S))
        self.O1 = _pad_pow2(memo.n_ops + 1, 8)
        geom = {"states": S_pad, "slots": self.W, "ops": memo.n_ops}
        if reach_lane.lane_fits(S_pad, self.M, self.O1 - 1):
            self.engine = "reach-lane"
        elif reach_pallas.fits(S_pad, self.M, self.O1 - 1):
            self.engine = "reach-pallas"
        else:
            self.engine = "reach"
        obs.decision("frontier-carry", "route", engine=self.engine, **geom)
        self._P = torch.as_tensor(_build_P(memo, S_pad, self.O1 - 1),
                                  device=dev)
        R0 = np.zeros((self.M, S_pad), np.float32)
        R0[:, :self.S] = R0_host.T
        R = torch.as_tensor(R0, device=dev)
        self._T = None
        #: K10's operands (:class:`.reach_word.MegaLane`: the tables, the
        #: set and its out buffer, checked once, here), or None: the
        #: torch walk joins no group
        self.lane: Optional[reach_word.MegaLane] = None
        #: the mega-group geometry, or None
        self.mega_sig: Optional[tuple] = None
        if self.engine == "reach":
            xc, bm = _xor_bitmask(self.W, self.M)
            self._xc = torch.as_tensor(xc, device=dev)
            self._bm = torch.as_tensor(bm, device=dev)
            self._R_torch = R
        else:
            self._T = reach_pallas.image_tables(self._P)
            self.mega_sig = (self.engine, S_pad, self.W, self.O1)
            self.lane = reach_word.MegaLane(
                self._P, self._T, R, memo.n_ops,
                narrow=self.engine == "reach-lane")

    @property
    def _R(self) -> torch.Tensor:
        """The carried set f32 ``[M, S_pad]`` (a mega-group member's is its
        lane's: setting it rebinds the lane)."""
        return self._R_torch if self.lane is None else self.lane.R

    @_R.setter
    def _R(self, R: torch.Tensor) -> None:
        if self.lane is None:
            self._R_torch = R
        else:
            self.lane.rebind(R)

    def _walk(self, ret_slot: np.ndarray, slot_ops: np.ndarray
              ) -> Tuple[int, torch.Tensor]:
        """One walk of the block from the carried set into a fresh set:
        ``(dead, R)``."""
        n = len(ret_slot)
        dev = self._R.device
        rs = torch.as_tensor(np.ascontiguousarray(ret_slot, np.int32),
                             device=dev)
        so = torch.as_tensor(np.ascontiguousarray(
            slot_ops, np.int32).reshape(n, self.W), device=dev)
        if self.engine == "reach-lane":
            _, R, dead = reach_lane.lane_walk(self._P, rs, so, self._R, n,
                                              self.W)
            return int(dead[0]), R
        if self.engine == "reach-pallas":
            dead, R = reach_pallas.walk(self._P, rs, so, self._R, n)
            return int(dead[0]), R
        R0 = self._R.T > 0.5
        ptr, R, alive, R_block = _walk_returns(self._P, self._xc, self._bm,
                                               ret_slot, so, R0)
        if alive:
            return -1, R.T.float().contiguous()
        start = max(0, ptr - _UNROLL)
        ptr1, _, _, _ = _walk_returns(self._P, self._xc, self._bm,
                                      ret_slot[start:ptr], so[start:ptr],
                                      R_block, unroll=1)
        return start + ptr1 - 1, torch.zeros_like(self._R)

    def advance(self, ret_slot: np.ndarray, slot_ops: np.ndarray) -> int:
        """Advance the carried set through one settled block (``ret_slot``
        int[n], ``slot_ops`` int[n, W]). Returns the exact index of the
        first dead return, or -1 when the set survived; on death the
        carry is the empty set (death is terminal for a session)."""
        n = len(ret_slot)
        if n == 0:
            return -1
        dead, R = self._walk(ret_slot, slot_ops)
        self._R = R if dead < 0 else torch.zeros_like(self._R)
        self.advanced_returns += n if dead < 0 else dead + 1
        return dead

    def probe(self, ret_slot: np.ndarray, slot_ops: np.ndarray) -> int:
        """The tail alarm's walk from the carried set, into a fresh set,
        so the carry is untouched: the exact dead index or -1 (the caller
        passes unresolved ops as crashed wildcards)."""
        if len(ret_slot) == 0:
            return -1
        return self._walk(ret_slot, slot_ops)[0]

    def fetch(self) -> np.ndarray:
        """The carried set on the host as bool ``[S, M]`` (the re-encode
        before a memo rebuild or slot growth)."""
        obs.count("fetch.eager")
        return (self._R.cpu().numpy() > 0.5).T[:self.S].copy()


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
    memo_u = _memo_for_ops(model, tuple(union_ops), max_states=max_states)
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


# -- many histories: the union prep and the lockstep lane --------------------

class _UnionPrepA:
    """Stage A of the union prep, built once per batch: the memo over the
    union of the live histories' op alphabets, its no-op classification
    and ``S_pad``, and each live history's packed arrays with op ids in
    the union alphabet, which stage B (:func:`_union_pack_group`) packs."""
    __slots__ = ("memo_u", "S_pad", "noop_op", "opids", "invs", "rets",
                 "crs", "_P", "pack_s")

    def __init__(self, memo_u, S_pad, noop_op, opids, invs, rets, crs):
        self.memo_u = memo_u
        self.S_pad = S_pad
        self.noop_op = noop_op
        self.opids = opids
        self.invs = invs
        self.rets = rets
        self.crs = crs
        self._P = None
        # stage B's wall seconds over this batch, the scheduler's prep
        # base
        self.pack_s = 0.0

    def P(self) -> np.ndarray:
        """The union transition tensor, built on first use."""
        if self._P is None:
            self._P = _build_P(self.memo_u, self.S_pad)
        return self._P

    def drop_per_key(self) -> np.ndarray:
        """Each live history's crashed entries dropped as union no-ops."""
        return np.array([int((c & self.noop_op[o]).sum())
                         for o, c in zip(self.opids, self.crs)], np.int64)


def _union_stage_a(model: Model, packed_list: Sequence[h.PackedHistory],
                   live: Sequence[int],
                   max_states: int) -> Optional[_UnionPrepA]:
    """Stage A, or None when the union alphabet explodes or an op is
    unhashable."""
    try:
        memo_u, luts = _union_alphabet(model, packed_list, live, max_states)
    except (StateExplosion, TypeError):
        return None
    tbl = memo_u.table
    states = np.arange(tbl.shape[0], dtype=tbl.dtype)[:, None]
    noop_op = np.all((tbl == states) | (tbl == -1), axis=0)
    ps = [packed_list[i] for i in live]
    return _UnionPrepA(memo_u, max(2, _next_pow2(memo_u.n_states)),
                       noop_op, [luts[i][p.op_id] for i, p in zip(live, ps)],
                       [p.inv_ev for p in ps], [p.ret_ev for p in ps],
                       [np.asarray(p.crashed, bool) for p in ps])


def _union_pack_group(sa: _UnionPrepA, sel: Sequence[int], max_slots: int):
    """Stage B: the native packing (:func:`preproc_native.build_keyed`)
    of the live histories at positions ``sel``. Returns
    ``(ret_flat, ops_flat, key_W, key_R, offsets, W)``, or None when a
    history needs more than ``max_slots`` slots under the union memo's
    coarser no-op classification (union no-ops are per-history no-ops,
    not always the reverse, so a history can overflow here and fit its
    own prep, which raises on a genuine overflow)."""
    t0 = _time.monotonic()
    offs = np.zeros(len(sel) + 1, np.int64)
    np.cumsum([len(sa.opids[k]) for k in sel], out=offs[1:])
    built = preproc_native.build_keyed(
        offs, np.concatenate([sa.invs[k] for k in sel]),
        np.concatenate([sa.rets[k] for k in sel]),
        np.concatenate([sa.opids[k] for k in sel]),
        np.concatenate([sa.crs[k] for k in sel]), sa.noop_op, max_slots,
        max_slots)
    sa.pack_s += _time.monotonic() - t0
    ret_flat, ops_wide, _pend, key_W, key_R, _ret_entry, _R = built
    if (key_W < 0).any():
        return None
    W = max(int(key_W.max()), 1)
    offsets = np.concatenate([[0], np.cumsum(key_R)])
    return (ret_flat, np.ascontiguousarray(ops_wide[:, :W]), key_W, key_R,
            offsets, W)


def _union_prep(sa: _UnionPrepA, max_slots: int):
    """Stage B over every live history at once, with the union tensor P:
    ``(P, W, M, ret_flat, ops_flat, key_W, key_R, offsets)``, or None
    (:func:`_union_pack_group`)."""
    g = _union_pack_group(sa, range(len(sa.opids)), max_slots)
    if g is None:
        return None
    ret_flat, ops_flat, key_W, key_R, offsets, W = g
    return sa.P(), W, 1 << W, ret_flat, ops_flat, key_W, key_R, offsets


def _union_stage_a_shared(model: Model, packed_list, live, max_states: int,
                          u_box: Optional[dict]) -> Optional[_UnionPrepA]:
    """One :func:`_union_stage_a` a ``check_many`` call, shared by the
    lockstep and native keyed lanes through ``u_box`` (a failed one
    too)."""
    if u_box is not None and "sa" in u_box:
        return u_box["sa"]
    with obs.span("reach.prep", histories=len(live), union=True):
        sa = _union_stage_a(model, packed_list, live, max_states)
    if u_box is not None:
        u_box["sa"] = sa
    return sa


def _union_prep_shared(sa: _UnionPrepA, max_slots: int,
                       u_box: Optional[dict]):
    """One :func:`_union_prep` a ``check_many`` call, shared as
    :func:`_union_stage_a_shared` is."""
    if u_box is not None and "u" in u_box:
        return u_box["u"]
    with obs.span("reach.prep", histories=len(sa.opids), union=True,
                  stage="B"):
        u = _union_prep(sa, max_slots)
    if u_box is not None:
        u_box["u"] = u
    return u


def _union_skip(sa: _UnionPrepA, W: int, max_dense: int,
                fits) -> Optional[str]:
    """Why a union lane does not take the union geometry at ``W`` slots
    (None: it does): the dense budget, the fast path's budgets, or
    ``fits(S_pad, M, n_ops)``, the lane's kernel envelope."""
    M = 1 << W
    if sa.S_pad * M > max_dense:
        return "max-dense"
    if not (_fast_ok(sa.S_pad, W, M, sa.memo_u.n_ops)
            and fits(sa.S_pad, M, sa.memo_u.n_ops)):
        return "geometry"
    return None


def _union_valid_result(engine: str, p: h.PackedHistory, dropped: int,
                        key_R_k: int, key_W_k: int, n_states: int,
                        elapsed: float) -> Dict[str, Any]:
    """A valid verdict in the union geometry: the union's states, the
    history's own slots and events under the union's no-op drops."""
    return {"valid": True, "engine": engine,
            "events": (p.n - dropped) + key_R_k,
            "slots": key_W_k, "states": n_states,
            "dropped-crashed-noops": dropped, "time-s": elapsed}


def _union_results_parts(engine: str, model: Model,
                         packed_list: Sequence[h.PackedHistory],
                         live: Sequence[int], dead_local: np.ndarray,
                         memo_u: Memo, key_W, key_R,
                         drop_per_key: np.ndarray, elapsed: float,
                         max_states: int, max_slots: int, max_dense: int,
                         device) -> List[Dict[str, Any]]:
    """Per-history results from union-geometry verdicts: ``dead_local[k]``
    is live history k's dead return index (-1: linearizable). A valid
    history is answered from the union accounting; a failed one is
    decoded in its own geometry, with the witness re-walked on
    ``device`` (:func:`_lane_verdict`)."""
    results: List[Optional[Dict[str, Any]]] = [
        {"valid": True, "engine": engine, "events": 0, "time-s": 0.0}
        if (p.n == 0 or p.n_ok == 0) else None for p in packed_list]
    for k, i in enumerate(live):
        p = packed_list[i]
        if int(dead_local[k]) < 0:
            results[i] = _union_valid_result(
                engine, p, int(drop_per_key[k]), int(key_R[k]),
                int(key_W[k]), memo_u.n_states, elapsed)
            continue
        memo_k, stream_k, _T, S_k, M_k = _prep(
            model, p, max_states=max_states, max_slots=max_slots,
            max_dense=max_dense)
        rs_k = ev.returns_view(stream_k)
        results[i] = _lane_verdict(
            engine, int(dead_local[k]), elapsed, stream_k, memo_k, p, rs_k,
            _build_P(memo_k, S_k), S_k, M_k, max(stream_k.W, 1), device)
    return results  # type: ignore[return-value]


def _union_results(engine: str, model: Model, packed_list, live,
                   dead_local: np.ndarray, sa: _UnionPrepA, key_W, key_R,
                   t0: float, max_states: int, max_slots: int,
                   max_dense: int, device) -> List[Dict[str, Any]]:
    """:func:`_union_results_parts` from stage A's accounting."""
    return _union_results_parts(
        engine, model, packed_list, live, dead_local, sa.memo_u, key_W,
        key_R, sa.drop_per_key(), _time.monotonic() - t0, max_states,
        max_slots, max_dense, device)


def _lockstep_accounting(gdiags: List[dict], prep_s: float,
                         dispatch_s: float, fetch_s: float,
                         diag: Optional[dict]) -> None:
    """The scheduler's tail: the groups' packing (real against padded
    returns) into the ``obs`` counters, and with ``diag`` the groups and
    the prep, dispatch and fetch wall."""
    real = sum(d["real_returns"] for d in gdiags)
    padded = sum(d["padded_returns"] for d in gdiags)
    obs.count("lockstep.groups", len(gdiags))
    obs.count("lockstep.real_returns", real)
    obs.count("lockstep.padded_returns", padded)
    if diag is not None:
        diag.update(
            groups=gdiags, real_returns=real, padded_returns=padded,
            pack_efficiency=round(real / max(padded, 1), 4),
            prep_s=round(prep_s, 6), dispatch_s=round(dispatch_s, 6),
            fetch_s=round(fetch_s, 6))


def _flat_lanes(flat: np.ndarray, offsets, keys):
    """The rows of ``keys`` in a flat keyed array, one array a key."""
    return [flat[offsets[k]:offsets[k + 1]] for k in keys]


def _dispatch_lockstep_groups(P, ret_flat, ops_flat, offsets, groups,
                              M: int, n_live: int,
                              diag: Optional[dict] = None,
                              prep_base_s: float = 0.0,
                              device=None,
                              body: Optional[str] = None) -> np.ndarray:
    """The lockstep scheduler: each group of ``groups`` (positions on the
    live axis, :func:`reach_batch.plan_buckets`) is marshalled, staged on
    the card and collected in order, with group g+1 staged before group
    g is collected, so the host marshals a group while the card walks
    the one before. ``body`` pins every group's walk body (None: each
    group's :func:`reach_batch._lockstep_body`). Returns each live
    history's dead return index (-1: linearizable)."""
    dead = np.full(n_live, -1, np.int64)
    st = dispatch_core.DispatchState(dead, device, P)
    prep_s, dispatch_s = prep_base_s, 0.0
    gdiags: List[dict] = []
    for g in groups:
        t0 = _time.monotonic()
        with obs.span("lockstep.prep", lanes=len(g)):
            prep = reach_batch.prepare_returns_batch(
                P, _flat_lanes(ret_flat, offsets, g),
                _flat_lanes(ops_flat, offsets, g), M, body=body)
        t1 = _time.monotonic()
        prep_s += t1 - t0
        gdiags.append(st.stage(g, prep))
        dispatch_s += _time.monotonic() - t1
        st.collect(st.depth)
    st.collect(0)
    _lockstep_accounting(gdiags, prep_s, dispatch_s, st.fetch_s, diag)
    return dead


# histories a lockstep group: one K2 launch walks up to 32 lanes
_BATCH_GROUP = 32


def _lockstep_plan(model: Model, packed_list: Sequence[h.PackedHistory],
                   live: Sequence[int], *, max_states: int, max_slots: int,
                   max_dense: int, u_box: Optional[dict],
                   group: Optional[int] = None):
    """The lockstep lane's prep: one union prep and its length buckets
    (:func:`reach_batch.plan_buckets`) of at most ``group`` lanes
    (default :data:`_BATCH_GROUP`). Returns ``(sa, u, groups)``, or a string, the cause of the
    lane's decline: fewer than two live histories, a union alphabet
    that explodes or is unhashable, a history over ``max_slots`` under
    the union's no-op classification, or a union geometry outside K2's
    envelope or the budgets."""
    if len(live) < 2:
        return "histories"
    sa = _union_stage_a_shared(model, packed_list, live, max_states, u_box)
    if sa is None:
        return "union"
    u = _union_prep_shared(sa, max_slots, u_box)
    if u is None:
        return "slots"
    cause = _union_skip(sa, u[1], max_dense, reach_batch.fits)
    if cause is not None:
        return cause
    return sa, u, reach_batch.plan_buckets(
        u[6], group=_BATCH_GROUP if group is None else max(1, int(group)))


def _check_many_lockstep(model: Model,
                         packed_list: Sequence[h.PackedHistory],
                         live: Sequence[int], *, max_states: int,
                         max_slots: int, max_dense: int, t0: float,
                         diag: Optional[dict], u_box: Optional[dict],
                         device, group: Optional[int] = None,
                         body: Optional[str] = None
                         ) -> Optional[List[Dict[str, Any]]]:
    """The lockstep lane on K2: :func:`_lockstep_plan`, then each group
    one K2 launch (K11 for a group whose body is ``word``) staged while
    the one before it walks (:func:`_dispatch_lockstep_groups`). Returns
    the results, or None when the lane declines, with the cause
    recorded. A fault in the lane propagates."""
    plan = _lockstep_plan(model, packed_list, live, max_states=max_states,
                          max_slots=max_slots, max_dense=max_dense,
                          u_box=u_box, group=group)
    if isinstance(plan, str):
        obs.decision("reach-lockstep", "skipped", cause=plan,
                     histories=len(packed_list))
        return None
    sa, (P, W, M, ret_flat, ops_flat, key_W, key_R, offsets), groups = plan
    with obs.span("reach.walk", engine="reach-lockstep",
                  histories=len(live)):
        dead = _dispatch_lockstep_groups(P, ret_flat, ops_flat, offsets,
                                         groups, M, len(live), diag,
                                         sa.pack_s, device, body)
    return _union_results("reach-lockstep", model, packed_list, live, dead,
                          sa, key_W, key_R, t0, max_states, max_slots,
                          max_dense, device)


class StagedMany:
    """A :func:`check_many` batch on the lockstep lane, staged and not
    collected: the union prep ran and every group's K2 walk is queued on
    the card (:meth:`dispatch_core.DispatchState.stage`), nothing
    fetched. Made by :func:`stage_check_many`; a lane of the check
    daemon keeps several in flight, so that it stages batch k+1 while
    the card walks batch k. :meth:`collect` gives exactly the results
    the lane's synchronous scheduler gives (the same kernels, the same
    assembly); a fault in it propagates."""

    __slots__ = ("model", "packed_list", "live", "sa", "key_W", "key_R",
                 "st", "gdiags", "prep_s", "dispatch_s", "t0",
                 "max_states", "max_slots", "max_dense", "device")

    def __init__(self, model, packed_list, live, sa, key_W, key_R, st,
                 gdiags, prep_s, dispatch_s, t0, max_states, max_slots,
                 max_dense, device):
        self.model = model
        self.packed_list = packed_list
        self.live = live
        self.sa = sa
        self.key_W = key_W
        self.key_R = key_R
        self.st = st
        self.gdiags = gdiags
        self.prep_s = prep_s
        self.dispatch_s = dispatch_s
        self.t0 = t0
        self.max_states = max_states
        self.max_slots = max_slots
        self.max_dense = max_dense
        self.device = device

    def ready(self) -> bool:
        """True when every group has walked (its event has completed)."""
        return self.st.ready()

    def collect(self) -> List[Dict[str, Any]]:
        """Fetch every group's verdicts, in order, and assemble the
        results, aligned with the batch."""
        with obs.span("reach.walk", engine="reach-lockstep",
                      histories=len(self.live), staged=True):
            self.st.collect(0)
        _lockstep_accounting(self.gdiags, self.prep_s, self.dispatch_s,
                             self.st.fetch_s, None)
        obs.decision("reach-many", "route", cause="lockstep",
                     histories=len(self.packed_list))
        # the collect's two parts, read by the serve metrics: the fetch
        # (the wait on the card, the dead lanes' location) and the
        # results' assembly (the witnesses' re-walks included)
        obs.count("lockstep.fetch_s", self.st.fetch_s)
        t_res = _time.monotonic()
        out = _union_results("reach-lockstep", self.model,
                             self.packed_list, self.live, self.st.dead,
                             self.sa, self.key_W, self.key_R, self.t0,
                             self.max_states, self.max_slots,
                             self.max_dense, self.device)
        obs.count("lockstep.results_s", _time.monotonic() - t_res)
        return out


def stage_check_many(model: Model, packed_list: Sequence[h.PackedHistory],
                     *, max_states: int = 100_000, max_slots: int = 20,
                     max_dense: int = 1 << 22, should_abort=None,
                     device=None, group: Optional[int] = None,
                     body: Optional[str] = None) -> Optional[StagedMany]:
    """The staging half of :func:`check_many`'s lockstep lane on
    ``device`` (default: the card): :func:`_lockstep_plan`, then every
    group marshalled and its K2 walk (K11 for a ``word`` group) queued,
    nothing fetched. ``group`` and ``body`` as in :func:`check_many`. Returns a
    :class:`StagedMany`, or None where :func:`check_many` would not take
    the lane (``should_abort`` already fired, or the lane declines);
    the caller then runs :func:`check_many`. There is no vmapped stage
    (``reach-vmapped`` is not ported). A fault propagates."""
    _check_body(body)
    dev = _device.resolve(device)
    if should_abort is not None and should_abort():
        return None
    t0 = _time.monotonic()
    live = [i for i, p in enumerate(packed_list) if p.n and p.n_ok]
    plan = _lockstep_plan(model, packed_list, live, max_states=max_states,
                          max_slots=max_slots, max_dense=max_dense,
                          u_box=None, group=group)
    # the stage's two parts, read by the serve metrics: the union prep
    # (here) and the groups' marshalling and launches (below)
    obs.count("lockstep.union_prep_s", _time.monotonic() - t0)
    if isinstance(plan, str):
        return None
    sa, (P, W, M, ret_flat, ops_flat, key_W, key_R, offsets), groups = plan
    st = dispatch_core.DispatchState(np.full(len(live), -1, np.int64), dev,
                                     P)
    gdiags: List[dict] = []
    prep_s, dispatch_s = sa.pack_s, 0.0
    for g in groups:
        ta = _time.monotonic()
        with obs.span("lockstep.prep", lanes=len(g)):
            prep = reach_batch.prepare_returns_batch(
                P, _flat_lanes(ret_flat, offsets, g),
                _flat_lanes(ops_flat, offsets, g), M, body=body)
        tb = _time.monotonic()
        prep_s += tb - ta
        gdiags.append(st.stage(g, prep))
        dispatch_s += _time.monotonic() - tb
    obs.count("lockstep.marshal_s", prep_s - sa.pack_s + dispatch_s)
    return StagedMany(model, packed_list, live, sa, key_W, key_R, st,
                      gdiags, prep_s, dispatch_s, t0, max_states,
                      max_slots, max_dense, dev)


def _check_many_native(model: Model, packed_list: Sequence[h.PackedHistory],
                       live: Sequence[int], *, max_states: int,
                       max_slots: int, max_dense: int, t0: float,
                       u_box: Optional[dict], device):
    """The native keyed lane: one union prep (shared with the lockstep
    lane through ``u_box``), then one keyed launch over every key's
    stream: K3 when the union geometry fits
    :func:`reach_lane.keyed_fits`, else K5 when it fits
    :func:`reach_pallas.fits`. Returns ``(results, cause)``, the cause
    ``"keyed"`` or ``"keyed-wide"``, or None when the lane declines
    (cause recorded, as the lockstep lane's). A fault propagates."""
    def skip(cause: str) -> None:
        obs.decision("reach-native-keyed", "skipped", cause=cause,
                     histories=len(packed_list))

    sa = _union_stage_a_shared(model, packed_list, live, max_states, u_box)
    if sa is None:
        return skip("union")
    u = _union_prep_shared(sa, max_slots, u_box)
    if u is None:
        return skip("slots")
    P, W, M, ret_flat, ops_flat, key_W, key_R, offsets = u
    cause = _union_skip(sa, W, max_dense,
                        lambda *g: _keyed_kernel(*g) is not None)
    if cause is not None:
        return skip(cause)
    cause = _keyed_kernel(sa.S_pad, M, sa.memo_u.n_ops)
    walker = reach_lane if cause == "keyed" else reach_pallas
    key_flat = np.repeat(np.arange(len(live), dtype=np.int32), key_R)
    with obs.span("reach.walk", engine="reach-keyed",
                  returns=int(ret_flat.shape[0]), keys=len(live)):
        dead = walker.walk_returns_keyed(P, ret_flat, ops_flat, key_flat,
                                         len(live), M, device=device)
    dead_local = np.where(dead >= 0, dead - offsets[:-1], -1)
    return _union_results("reach-keyed", model, packed_list, live,
                          dead_local, sa, key_W, key_R, t0, max_states,
                          max_slots, max_dense, device), cause


def check_batch(model: Model, packed_list: Sequence[h.PackedHistory], *,
                max_states: int = 100_000, max_slots: int = 20,
                max_dense: int = 1 << 22, diag: Optional[dict] = None,
                device=None, group: Optional[int] = None,
                body: Optional[str] = None) -> List[Dict[str, Any]]:
    """Check several whole histories at once on ``device`` (default: the
    card) through the lockstep lane on K2 (:func:`_check_many_lockstep`):
    up to 32 histories advance together, one return index a step.
    For a run that produced several histories (several test iterations,
    or a history per node). When the lane declines, each history goes
    through :func:`check_packed`, recorded as the
    ``reach-lockstep``/``no-union-prep`` fallback. Verdicts and witnesses
    are those of :func:`check_packed`; a valid history reports the union
    geometry's ``states``. ``diag`` (a dict) receives the groups, their
    packing and the scheduler's wall times. ``group`` and ``body`` as in
    :func:`check_many`."""
    _check_body(body)
    dev = _device.resolve(device)
    t0 = _time.monotonic()
    results: List[Optional[Dict[str, Any]]] = [
        {"valid": True, "engine": "reach-lockstep", "events": 0,
         "time-s": 0.0} if (p.n == 0 or p.n_ok == 0) else None
        for p in packed_list]
    live = [i for i, r in enumerate(results) if r is None]
    if not live:
        return results  # type: ignore[return-value]
    out = _check_many_lockstep(
        model, packed_list, live, max_states=max_states,
        max_slots=max_slots, max_dense=max_dense, t0=t0, diag=diag,
        u_box=None, device=dev, group=group, body=body)
    if out is not None:
        return out
    obs.engine_fallback("reach-lockstep", "no-union-prep",
                        histories=len(live))
    for i in live:
        results[i] = check_packed(model, packed_list[i],
                                  max_states=max_states,
                                  max_slots=max_slots, max_dense=max_dense,
                                  device=dev, body=body)
    return results  # type: ignore[return-value]


def check_many(model: Model, packed_list: Sequence[h.PackedHistory], *,
               max_states: int = 100_000, max_slots: int = 20,
               max_dense: int = 1 << 22, should_abort=None,
               diag: Optional[dict] = None,
               device=None, group: Optional[int] = None,
               body: Optional[str] = None) -> List[Dict[str, Any]]:
    """Batched per-key checking on ``device`` (default: the card), the
    ``independent`` checker's hot path; results align with
    ``packed_list``. Route order, each lane chosen from the geometry
    before it launches, and each recording why it declines: the lockstep
    lane on K2 (:func:`_check_many_lockstep`, route cause ``lockstep``:
    groups of at most ``group`` keys, default 32; ``diag``, a dict,
    receives the groups, their packing and the scheduler's wall times;
    ``body``, ``"word"`` or ``"dense"``, pins every group's walk body,
    which is otherwise :func:`reach_batch._lockstep_body`'s); the native
    keyed lane (:func:`_check_many_native`, one
    union prep and one launch of K3, cause ``keyed``, or K5,
    ``keyed-wide``); the keyed kernels over each key's own prep
    (:func:`_keyed_operands`, for a key that overflows ``max_slots``
    only under the union's no-op classification); else each history
    through :func:`check_packed` (the reference's vmapped batch is not
    ported). A fault in a lane propagates. ``should_abort`` is consulted
    once, before anything runs; when it fires every history reports
    ``valid == "unknown"``. Raises :class:`DenseOverflow`,
    :class:`~jepsen_tpu_torch.checkers.events.ConcurrencyOverflow` or
    :class:`~jepsen_tpu_torch.models.memo.StateExplosion` when a
    history does not fit the dense engine."""
    _check_body(body)
    dev = _device.resolve(device)
    t0 = _time.monotonic()
    n = len(packed_list)
    if should_abort is not None and should_abort():
        return [{"valid": "unknown", "cause": "aborted",
                 "engine": "reach-batch"} for _ in packed_list]
    live = [i for i, p in enumerate(packed_list) if p.n and p.n_ok]
    lane_kw = dict(max_states=max_states, max_slots=max_slots,
                   max_dense=max_dense, t0=t0, device=dev)
    u_box: dict = {}            # one union prep shared by both lanes
    if live:
        out = _check_many_lockstep(model, packed_list, live, diag=diag,
                                   u_box=u_box, group=group, body=body,
                                   **lane_kw)
        if out is not None:
            obs.decision("reach-many", "route", cause="lockstep",
                         histories=n)
            return out
        native = _check_many_native(model, packed_list, live, u_box=u_box,
                                    **lane_kw)
        if native is not None:
            out, cause = native
            obs.decision("reach-many", "route", cause=cause, histories=n)
            return out
    # one union BFS for every key's memo (each projects from the seed)
    _seed_union_memo(model, [packed_list[i] for i in live], max_states)
    with obs.span("reach.prep", histories=n):
        preps = [None if p.n == 0 or p.n_ok == 0 else
                 _prep(model, p, max_states=max_states,
                       max_slots=max_slots, max_dense=max_dense)
                 for p in packed_list]
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
                                  memo=preps[i][0], device=dev, body=body)
    return results  # type: ignore[return-value]


# -- history-length parallelism: chunk transfer matrices --------------------

def _basis_returns_torch(P, xor_cols, bitmask, ret_slot_c, slot_ops_c,
                         basis):
    """The reference's basis walk (``_walk_returns_scan`` over every
    (chunk, basis config), no early exit) as batched torch ops: ``P``
    f32[O+1, S, S], ``ret_slot_c`` int[H, L], ``slot_ops_c`` int[H, L, W],
    ``basis`` bool[H, E, S, M]. Returns each config's image after its
    chunk, bool[H, E, S, M]: W fire passes and the projection a return,
    as :func:`_ret_step`."""
    H, E, S, M = basis.shape
    W = xor_cols.shape[0]
    dev = basis.device
    n_ops_pad = P.shape[0] - 1
    ops = torch.as_tensor(slot_ops_c, device=dev).long()
    ops = torch.where(ops < 0, n_ops_pad, ops)
    js = torch.as_tensor(ret_slot_c, device=dev).long()
    idx = torch.arange(M, device=dev)
    xor_cols = xor_cols.long()
    R = basis
    for r in range(ops.shape[1]):
        G = P[ops[:, r]]                                    # [H, W, S, S]
        for _ in range(W):
            Rx = R[..., xor_cols].float()                   # [H,E,S,W,M]
            contrib = torch.einsum("hesjm,hjst->hetjm", Rx, G)
            R = R | ((contrib > 0.5) & bitmask).any(dim=3)
        j = js[:, r]
        bit = torch.where(j >= 0, torch.ones_like(j) << j.clamp(min=0),
                          0)[:, None]                       # [H, 1]
        src = (idx[None, :] | bit)[:, None, None, :].expand(H, E, S, M)
        keep = ((idx[None, :] & bit) == 0)[:, None, None, :]
        R = R.gather(3, src) & keep
    return R


def _basis_returns_k2(P_np, ret_slot_c, slot_ops_c, basis, W: int, dev):
    """The basis walk on K2 (:func:`reach_batch.batch_walk`): one lane a
    chunk (``ret_slot_rh`` the chunks' streams side by side), one seed
    group a basis config (``R0[e·M + m, c·S + s]`` one-hot), ``W`` passes,
    and K2's block the whole chunk, so its checkpoint buffer holds one set
    a lane. Groups past the grid's second axis go in several launches.
    ``basis`` bool[H, E, S, M]; returns the images, bool[H, E, S, M]."""
    H, E, S, M = basis.shape
    L = ret_slot_c.shape[1]
    P_t = torch.as_tensor(np.ascontiguousarray(P_np, np.float32), device=dev)
    rs_rh = torch.as_tensor(np.ascontiguousarray(ret_slot_c.T, np.int32),
                            device=dev)
    ops = torch.as_tensor(np.ascontiguousarray(
        slot_ops_c.transpose(1, 0, 2), np.int32).reshape(-1), device=dev)
    out = []
    for e0 in range(0, E, _K2_MAX_GROUPS):
        b = basis[:, e0:e0 + _K2_MAX_GROUPS]                # [H, e, S, M]
        R0 = torch.as_tensor(np.ascontiguousarray(
            b.transpose(1, 3, 0, 2).reshape(-1, H * S), np.float32),
            device=dev)                                     # [e·M, H·S]
        _, final = reach_batch.batch_walk(P_t, ops, rs_rh, R0, L, W)
        out.append((final.view(b.shape[1], M, H, S) > 0.5).permute(2, 0, 3, 1)
                   .cpu().numpy())
    return np.concatenate(out, axis=1)


# K2's grid is (lanes, seed groups); its second axis takes at most 65,535
_K2_MAX_GROUPS = 1 << 15


def _prefix_dead_event(P_np, rs, n: int, S_pad: int, M: int, W: int,
                       n_ops: int, dev) -> Tuple[str, int]:
    """Walk the first ``n`` returns exactly from the seed, by geometry
    (K1, else K4, else the torch returns walk), and return the walk's
    engine and the event at which the set empties (-1: it does not)."""
    R0 = np.zeros((S_pad, M), bool)
    R0[0, 0] = True
    for engine, walker in (("reach-lane", reach_lane),
                           ("reach-pallas", reach_pallas)):
        fits = (reach_lane.lane_fits if walker is reach_lane
                else reach_pallas.fits)
        if fits(S_pad, M, n_ops):
            dead, _ = walker.walk_returns(P_np, rs.ret_slot[:n],
                                          rs.slot_ops[:n], R0, device=dev,
                                          fetch_R=False)
            return engine, (-1 if dead < 0 else int(rs.ret_event[dead]))
    L = max(_UNROLL, -(-n // _UNROLL) * _UNROLL)
    rs_l = ev.pad_returns(ev.ReturnStream(
        ret_slot=rs.ret_slot[:n], slot_ops=rs.slot_ops[:n],
        ret_event=rs.ret_event[:n], ret_entry=rs.ret_entry[:n], W=W,
        n_returns=min(n, rs.n_returns)), L)
    P = torch.as_tensor(P_np, device=dev)
    xc, bm = (torch.as_tensor(a, device=dev) for a in _xor_bitmask(W, M))
    ptr, _, alive, R_block = _walk_returns(
        P, xc, bm, rs_l.ret_slot, torch.as_tensor(rs_l.slot_ops, device=dev),
        _seed(S_pad, M, dev))
    if alive:
        return "reach", -1
    return "reach", _refine_dead(P, xc, bm, rs_l, ptr, R_block)


def check_chunked(model: Model, history: Sequence[Op] = (), *,
                  packed: Optional[h.PackedHistory] = None,
                  n_chunks: int = 8, max_states: int = 100_000,
                  max_slots: int = 20, max_dense: int = 1 << 22,
                  max_matrix: int = 1 << 26, device=None,
                  should_abort=None) -> Dict[str, Any]:
    """History-length-parallel check on ``device`` (default: the card):
    split the return stream into ``n_chunks`` chunks, compute each
    chunk's D×D boolean transfer matrix by walking the chunk from every
    basis config, then fold the matrices on the host.

    Where ``Rn·D >= 2^20`` a forward pass first records the reachable set
    at every chunk's left edge, so each chunk's matrix is computed over
    only the B ≤ D configs that can enter it: one K1 launch with its
    block checkpoints where the lane kernel takes the geometry and W ≤
    :data:`reach_lane._FAST_PASSES` (chunks then align to its 1,024-
    return blocks), else the chunks chained on K4 (one launch a chunk),
    else on the torch returns walk. The basis walk runs on K2 (one launch
    a basis group, narrow ≤ 8 configs and wide) within its envelope,
    else as batched torch ops. A death the forward pass finds is its
    dead return; one the fold finds is located by walking the failing
    prefix (K1, K4 or torch, by geometry). Each choice is recorded with
    ``obs.decision("reach-chunked", "route", ...)``. Raises
    :class:`DenseOverflow` when ``D**2 > max_matrix`` or the fast path
    does not apply; ``should_abort`` is consulted before the forward
    pass and between its segments."""
    dev = _device.resolve(device)
    t0 = _time.monotonic()
    if packed is None:
        packed = h.pack(history)
    if packed.n == 0 or packed.n_ok == 0:
        return {"valid": True, "engine": "reach-chunked", "events": 0,
                "time-s": 0.0}
    with obs.span("reach.prep", ops=packed.n):
        memo, stream, _T, S_pad, M = _prep(
            model, packed, max_states=max_states, max_slots=max_slots,
            max_dense=max_dense)
    D = S_pad * M
    if D * D > max_matrix:
        raise DenseOverflow(
            f"chunk transfer matrix {D}x{D} exceeds budget {max_matrix}")
    W = max(stream.W, 1)
    if not _fast_ok(S_pad, W, M, memo.n_ops):
        raise DenseOverflow("chunked basis walk exceeds fast-path budget")
    geom = {"states": S_pad, "slots": W, "ops": memo.n_ops}
    with obs.span("reach.returns-view", events=int(stream.n_events)):
        rs = ev.returns_view(stream)
    Rn = rs.n_returns
    n_chunks = max(1, min(n_chunks, max(Rn, 1)))
    per = -(-max(Rn, 1) // n_chunks)
    P_np = _build_P(memo, S_pad)
    # the forward pass and the restricted bases pay off only when the
    # full-basis walk's work, Rn returns × D configs, is substantial
    restrict = Rn * D >= 1 << 20
    lane_ok = reach_lane.lane_fits(S_pad, M, memo.n_ops)
    if not restrict:
        forward = None
    elif lane_ok and W <= reach_lane._FAST_PASSES:   # checkpoints exact
        forward = "reach-lane"
        per = -(-per // reach_lane._BLOCK) * reach_lane._BLOCK
        n_chunks = -(-Rn // per)
    elif reach_pallas.fits(S_pad, M, memo.n_ops):
        forward = "reach-pallas"
    else:
        forward = "reach"
    rs_p = ev.pad_returns(rs, n_chunks * per)
    ret_slot_c = rs_p.ret_slot.reshape(n_chunks, per)
    slot_ops_c = rs_p.slot_ops.reshape(n_chunks, per, W)
    if should_abort is not None and should_abort():
        return dict(_ABORTED, engine="reach-chunked")
    R0 = np.zeros((S_pad, M), bool)
    R0[0, 0] = True
    # forward pass → the chunks' boundary sets [n_chunks, S, M] and the
    # dead return it finds (-1: alive)
    dead_ret = -1
    obs.decision("reach-chunked", "route", phase="forward",
                 engine=forward or "none", chunks=n_chunks, **geom)
    try:
        with obs.span("reach.walk", engine="reach-chunked", stage="forward",
                      returns=int(Rn)):
            if forward is None:
                # full basis: every config can enter every chunk; the
                # fold itself detects death
                bounds = np.ones((n_chunks, S_pad, M), bool)
            elif forward == "reach-lane":
                ckpt, dead_ret = reach_lane.walk_checkpoints(
                    P_np, rs_p.ret_slot, rs_p.slot_ops, R0, device=dev,
                    should_abort=should_abort)
                bounds = ckpt[(np.arange(n_chunks) * per)
                              // reach_lane._BLOCK]
            elif forward == "reach-pallas":
                bounds = np.zeros((n_chunks, S_pad, M), bool)
                R_cur = R0
                for c in range(n_chunks):
                    bounds[c] = R_cur
                    d, R_cur = reach_pallas.walk_returns(
                        P_np, ret_slot_c[c], slot_ops_c[c], R_cur,
                        device=dev, should_abort=should_abort)
                    if d >= 0:
                        dead_ret = c * per + d
                        break
            else:
                bounds = np.zeros((n_chunks, S_pad, M), bool)
                P_t = torch.as_tensor(P_np, device=dev)
                xc, bm = (torch.as_tensor(a, device=dev)
                          for a in _xor_bitmask(W, M))
                R_cur = _seed(S_pad, M, dev)
                for c in range(n_chunks):
                    if should_abort is not None and should_abort():
                        raise reach_lane.Aborted()
                    bounds[c] = R_cur.cpu().numpy()
                    _, R_cur, alive, _ = _walk_returns(
                        P_t, xc, bm, ret_slot_c[c],
                        torch.as_tensor(slot_ops_c[c], device=dev), R_cur)
                    if not alive:
                        dead_ret = -2           # located below
                        break
    except reach_lane.Aborted:
        return dict(_ABORTED, engine="reach-chunked")
    dead_event = -1
    if dead_ret >= 0:
        dead_event = int(rs_p.ret_event[dead_ret])
    elif dead_ret == -2:
        nonempty = bounds.reshape(n_chunks, -1).any(axis=1)
        dead_chunk = int(np.nonzero(nonempty)[0][-1])
        _, dead_event = _prefix_dead_event(
            P_np, rs_p, min((dead_chunk + 1) * per, rs_p.R), S_pad, M, W,
            memo.n_ops, dev)
    else:
        dead_chunk = _fold_chunks(P_np, ret_slot_c, slot_ops_c, bounds,
                                  S_pad, M, W, memo.n_ops, geom, dev)
        if dead_chunk >= 0:
            # exact localization: the failing prefix, dead_chunk + 1
            # chunks of returns
            engine, dead_event = _prefix_dead_event(
                P_np, rs_p, min((dead_chunk + 1) * per, rs_p.R), S_pad, M,
                W, memo.n_ops, dev)
            obs.decision("reach-chunked", "route", phase="localize",
                         engine=engine, chunk=dead_chunk, **geom)
            if dead_event < 0:
                raise RuntimeError(f"reach-chunked: the fold empties at "
                                   f"chunk {dead_chunk}, the prefix walk "
                                   f"does not")
    elapsed = _time.monotonic() - t0
    if dead_event < 0:
        out = _result_valid("reach-chunked", stream, memo, elapsed)
    else:
        out = _result_invalid("reach-chunked", stream, memo, packed,
                              dead_event, elapsed)
    out["chunks"] = n_chunks
    return out


def _fold_chunks(P_np, ret_slot_c, slot_ops_c, bounds, S_pad: int, M: int,
                 W: int, n_ops: int, geom, dev) -> int:
    """Each chunk's transfer matrix over its boundary set's configs (its
    restricted basis), then the host fold of the seed through them.
    Chunks go in a narrow (≤ 8 configs) and a wide basis group, each
    padded to ``max(8, next_pow2)`` configs and walked at once: on K2
    where it takes the geometry, else as batched torch ops. Returns the
    first chunk after which the folded set is empty, or -1."""
    n_chunks = bounds.shape[0]
    D = S_pad * M
    flat = bounds.reshape(n_chunks, -1)
    counts = flat.sum(axis=1)
    k2 = reach_batch.fits(S_pad, M, n_ops)
    groups = []
    mats: List[Optional[np.ndarray]] = [None] * n_chunks
    for cs in (np.nonzero(counts <= 8)[0], np.nonzero(counts > 8)[0]):
        if not len(cs):
            continue
        B_pad = max(8, _next_pow2(int(counts[cs].max())))
        groups.append([int(len(cs)), B_pad])
        basis = np.zeros((len(cs), B_pad, S_pad, M), bool)
        for j, c in enumerate(cs):
            on = np.nonzero(flat[c])[0]
            basis[j, np.arange(len(on)), on // M, on % M] = True
        with obs.span("reach.walk", engine="reach-chunked", stage="basis",
                      chunks=int(len(cs)), basis=B_pad):
            if k2:
                R = _basis_returns_k2(P_np, ret_slot_c[cs], slot_ops_c[cs],
                                      basis, W, dev)
            else:
                xc, bm = (torch.as_tensor(a, device=dev)
                          for a in _xor_bitmask(W, M))
                R = _basis_returns_torch(
                    torch.as_tensor(P_np, device=dev), xc, bm,
                    ret_slot_c[cs], slot_ops_c[cs],
                    torch.as_tensor(basis, device=dev)).cpu().numpy()
        R = R.reshape(len(cs), B_pad, D)
        for j, c in enumerate(cs):
            mats[c] = R[j]
    obs.decision("reach-chunked", "route", phase="basis",
                 engine="batch_walk" if k2 else "torch", groups=groups,
                 **geom)
    v = np.zeros(D, bool)
    v[0] = True                              # state 0, mask 0
    for c in range(n_chunks):
        on = np.nonzero(flat[c])[0]
        rows = mats[c][:len(on)][v[on]]
        v = rows.any(axis=0) if len(rows) else np.zeros(D, bool)
        if not v.any():
            return c
    return -1

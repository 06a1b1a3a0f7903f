"""Host-side dependency inference for list-append histories — Elle's
traceability trick (VLDB 2020 §4): because every append is unique and
reads return the WHOLE list, any read of key ``k`` reveals a prefix of
``k``'s total append order. The longest observed read per key is the
recovered order; from it the three dependency edge families fall out:

- ``ww``  — writer of ``order[i]`` → writer of ``order[i+1]``
  (consecutive appends in the recovered order);
- ``wr``  — writer of a read version's LAST element → the reader
  (earlier elements are implied through ww);
- ``rw``  — the reader of a length-``L`` prefix → writer of
  ``order[L]`` (the append the read missed), the anti-dependency.

Appends never observed by any read have no recoverable position:
their edges are NOT emitted (documented-weaker inference, counted as
``txn.infer.ambiguous_appends`` in obs — never silent). Reads that are
not prefix-compatible with the recovered order, reads of values never
appended, and duplicate appends of one value are DIRECT anomalies
(``incompatible-order`` / ``duplicate-append``); a read observing a
``fail`` txn's append is a G1a aborted read. Crashed (``info``) txns'
appends count only when some read proves they took effect
(``txn.infer.crashed_recovered``); unproven ones stay out
(``txn.infer.crashed_unresolved``).

The output is a COO edge tensor (:class:`DepGraph`) in the narrow
:func:`~jepsen_tpu_torch.txn.ops.idx_dtype` dtypes — the operand
:mod:`jepsen_tpu_torch.txn.cycles` turns into bit-packed adjacency for
the device closure.

A copy of the reference's inference (``jepsen_tpu/txn/infer.py``): the
post-hoc :func:`infer`, and :class:`IncrementalInfer`, the same edges
block by block for a streaming session
(:class:`jepsen_tpu_torch.serve.session.TxnSessionEngine`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.txn import ops as txn_ops
from jepsen_tpu_torch.util import hashable, hashable_seq

# edge-type codes, also the COO ``et`` values
WW, WR, RW = 0, 1, 2
EDGE_NAMES = ("ww", "wr", "rw")

# commit-order pseudo-edge code — NOT a DepGraph edge type (post-hoc
# inference never stores it; it is derived from txn intervals): the
# label of the lattice closure's fourth lane
CM = 3


@dataclass(frozen=True)
class DepGraph:
    """Transaction dependency graph in COO form. ``src``/``dst`` index
    the kept txns (``txns[tid]``), ``et`` is the edge type code."""
    n: int
    src: np.ndarray          # idx[e]
    dst: np.ndarray          # idx[e]
    et: np.ndarray           # i8[e]
    txns: Tuple[txn_ops.Txn, ...]
    direct: Tuple[Dict[str, Any], ...] = ()   # inference-time anomalies
    counters: Dict[str, int] = field(default_factory=dict)

    @property
    def e(self) -> int:
        return int(len(self.src))

    def edge_counts(self) -> Dict[str, int]:
        return {EDGE_NAMES[t]: int((self.et == t).sum())
                for t in (WW, WR, RW)}


def _bump(counters: Dict[str, int], name: str, n: int = 1) -> None:
    if n:
        counters[name] = counters.get(name, 0) + n
        obs.count(f"txn.infer.{name}", n)


def infer(txns: Sequence[txn_ops.Txn],
          fails: Sequence[txn_ops.FailedTxn] = ()) -> DepGraph:
    """Recover per-key append orders and emit the wr/ww/rw COO edges."""
    counters: Dict[str, int] = {}
    direct: List[Dict[str, Any]] = []

    # list-append keys/values are almost always flat str/int — skip
    # the deep-freeze isinstance cascade for them; ``hashable`` is the
    # identity on both
    def _h(x, _hashable=hashable):
        return x if type(x) is str or type(x) is int else _hashable(x)

    # per-key value -> appender tid; duplicates are a direct anomaly
    # (Elle's uniqueness precondition — without it traceability dies)
    appenders: Dict[Any, Dict[Any, int]] = {}
    crashed_append: Set[Tuple[Any, Any]] = set()
    for t in txns:
        for kind, k, v in t.micros:
            if kind != txn_ops.APPEND:
                continue
            hk, hv = _h(k), _h(v)
            per_key = appenders.setdefault(hk, {})
            if hv in per_key:
                direct.append({"type": "duplicate-append", "key": k,
                               "value": v,
                               "txns": [per_key[hv], t.tid]})
                _bump(counters, "duplicate_append")
                continue
            per_key[hv] = t.tid
            if t.crashed:
                crashed_append.add((hk, hv))
    failed_append: Dict[Tuple[Any, Any], int] = {}
    for f in fails:
        for kind, k, v in f.micros:
            if kind == txn_ops.APPEND:
                failed_append.setdefault((_h(k), _h(v)),
                                         f.op.index)

    # reads per key (crashed txns' reads were blanked in collect())
    reads: Dict[Any, List[Tuple[int, Tuple[Any, ...]]]] = {}
    keys_seen: List[Any] = []
    for t in txns:
        for kind, k, v in t.micros:
            hk = _h(k)
            if hk not in reads:
                reads[hk] = []
                keys_seen.append(hk)
            if kind == txn_ops.READ and v is not None:
                # hashable_seq: flat reads skip the deep-freeze per
                # element, the costliest step of inference
                reads[hk].append((t.tid, hashable_seq(v)))

    edges: Set[Tuple[int, int, int]] = set()

    def _edge(u: int, v: int, et: int) -> None:
        if u != v:                      # self-deps carry no cycle info
            edges.add((u, v, et))

    n_ambiguous = 0
    n_crash_recovered = 0
    for hk in keys_seen:
        rds = reads[hk]
        # recovered order: the longest observed version of this key
        order: Tuple[Any, ...] = ()
        for _tid, vs in rds:
            if len(vs) > len(order):
                order = vs
        ok_order = True
        if len(set(order)) != len(order):
            direct.append({"type": "incompatible-order", "key": hk,
                           "cause": "duplicate value in one read",
                           "version": list(order)})
            _bump(counters, "incompatible_order")
            ok_order = False
        for tid_r, vs in rds:
            if vs != order[:len(vs)]:
                direct.append({"type": "incompatible-order", "key": hk,
                               "cause": "read is not a prefix of the "
                                        "recovered order",
                               "txn": tid_r, "version": list(vs),
                               "order": list(order)})
                _bump(counters, "incompatible_order")
                ok_order = False
        writers: List[Optional[int]] = []
        per_key = appenders.get(hk, {})
        for v in order:
            w = per_key.get(v)
            if w is None:
                if (hk, v) in failed_append:
                    direct.append({"type": "G1a", "key": hk, "value": v,
                                   "failed-op-index":
                                       failed_append[(hk, v)]})
                    _bump(counters, "aborted_read")
                else:
                    direct.append({"type": "incompatible-order",
                                   "key": hk, "value": v,
                                   "cause": "read observed a value "
                                            "never appended"})
                    _bump(counters, "phantom_value")
                ok_order = False
                writers.append(None)
            else:
                if (hk, v) in crashed_append:
                    n_crash_recovered += 1
                writers.append(w)
        # appends with no recovered position: weaker inference, counted
        observed = set(order)
        n_ambiguous += sum(1 for v2 in per_key if v2 not in observed)
        if not ok_order:
            # the recovered order is untrustworthy: emitting edges from
            # it could fabricate cycles — the direct anomalies above
            # carry the verdict for this key
            continue
        for i in range(len(writers) - 1):
            a, b = writers[i], writers[i + 1]
            if a is not None and b is not None:
                _edge(a, b, WW)
        for tid_r, vs in rds:
            if vs:
                w = writers[len(vs) - 1]
                if w is not None:
                    _edge(w, tid_r, WR)
            if len(vs) < len(writers):
                w = writers[len(vs)]
                if w is not None:
                    _edge(tid_r, w, RW)

    observed_by_key: Dict[Any, Set[Any]] = {
        hk: {v for _t, vs in reads[hk] for v in vs} for hk in keys_seen}
    _bump(counters, "ambiguous_appends", n_ambiguous)
    _bump(counters, "crashed_recovered", n_crash_recovered)
    _bump(counters, "crashed_unresolved",
          sum(1 for (hk, hv) in crashed_append
              if hv not in observed_by_key.get(hk, ())))

    n = len(txns)
    dt = txn_ops.idx_dtype(max(n, 1))
    if edges:
        es = np.array(sorted(edges), np.int64)     # one pass, [E, 3]
        src = es[:, 0].astype(dt)
        dst = es[:, 1].astype(dt)
        et = es[:, 2].astype(np.int8)
    else:
        src = np.zeros(0, dt)
        dst = np.zeros(0, dt)
        et = np.zeros(0, np.int8)
    for t in (WW, WR, RW):
        obs.count(f"txn.edges.{EDGE_NAMES[t]}", int((et == t).sum()))
    return DepGraph(n=n, src=src, dst=dst, et=et, txns=tuple(txns),
                    direct=tuple(direct), counters=counters)


# -- incremental inference (streaming sessions) ----------------------------
#
# A read settles only once every value it observed has a KNOWN appender
# (or is proven aborted, a G1a). Until then it waits: trusting it earlier
# could brand an in-flight append's value a phantom (a false alarm the
# post-hoc path can never produce, because post-hoc everything has
# completed). Under this rule the emitted edge set only ever grows in
# well-formed histories — recovered orders are append-only and
# prefix-validated, so an edge once emitted is never retracted — which
# is what makes a sound early cycle alarm possible. At close,
# :meth:`IncrementalInfer.resolve_stragglers` resolves still-pending
# invocations as crashed and finalizes pending reads (a value still
# unattributed then IS a phantom), after which the edge set equals the
# post-hoc :func:`infer` edge set.


class _KeyState:
    """Per-key incremental traceability state."""

    __slots__ = ("order", "writers", "appenders", "crashed_vals",
                 "failed_vals", "readers_by_len", "pending", "poisoned")

    def __init__(self) -> None:
        self.order: List[Any] = []          # recovered append order
        self.writers: List[int] = []        # appender tid per position
        self.appenders: Dict[Any, int] = {}
        self.crashed_vals: Set[Any] = set()
        self.failed_vals: Dict[Any, int] = {}
        self.readers_by_len: Dict[int, List[int]] = {}
        self.pending: List[Tuple[int, Tuple[Any, ...]]] = []
        self.poisoned = False               # direct anomaly on this key


class IncrementalInfer:
    """Stateful list-append dependency inference for one session.

    Feed blocks of ops with :meth:`feed_block`; the COO edges emitted
    since the last drain come from :meth:`drain_new_edges` (the device
    closure's per-block delta) and the commit-order edges from
    :meth:`drain_new_cm`; :meth:`graph` materializes the whole
    accumulated :class:`DepGraph`. Direct anomalies land in
    :attr:`direct` as they are proven."""

    def __init__(self) -> None:
        self.txns: List[txn_ops.Txn] = []
        self.fails: List[txn_ops.FailedTxn] = []
        self._live: Dict[Any, Any] = {}     # proc -> invoke op
        self._keys: Dict[Any, _KeyState] = {}
        self.direct: List[Dict[str, Any]] = []
        self.counters: Dict[str, int] = {}
        self._edges: Set[Tuple[int, int, int]] = set()
        self._fresh: List[Tuple[int, int, int]] = []
        # stream positions drive the commit order: every fed op advances
        # _pos (txn or not), so relative start/commit order matches what
        # post-hoc indexing would assign the same stream
        self._pos = 0
        self._live_start: Dict[Any, int] = {}   # proc -> invoke pos
        self.starts: List[int] = []             # per tid
        self.ends: List[int] = []               # per tid; -1 = crashed
        self._cm_fresh: List[Tuple[int, int]] = []

    # -- ingestion -------------------------------------------------------
    def feed_block(self, ops: Sequence[Any]) -> None:
        """Pair txn invocations and completions across block boundaries
        and run settled inference over the completions."""
        for op in ops:
            pos = self._pos
            self._pos += 1
            if op.process == "nemesis" or op.f != "txn":
                continue
            if op.type == "invoke":
                self._live[op.process] = op
                self._live_start[op.process] = pos
                continue
            inv = self._live.pop(op.process, None)
            if inv is None:
                continue                    # completion without invoke
            start = self._live_start.pop(op.process, pos)
            if op.type == "fail":
                self.fails.append(txn_ops.FailedTxn(
                    op=inv, micros=tuple(txn_ops.micro_ops(inv.value))))
                self._register_fail(self.fails[-1])
            elif op.type == "ok":
                value = op.value if op.value is not None else inv.value
                self._add_txn(inv.with_(value=value),
                              tuple(txn_ops.micro_ops(value)),
                              crashed=False, start=start, end=pos)
            elif op.type == "info":
                self._add_txn(inv, _blank_reads(inv.value), crashed=True,
                              start=start)

    def resolve_stragglers(self) -> None:
        """The stream is over: still-pending invocations resolve as
        crashed (reads blanked, as post-hoc ``collect`` does), then
        still-pending reads finalize — a value with no appender now is
        a phantom or an aborted read."""
        for p, inv in sorted(self._live.items(),
                             key=lambda kv: kv[1].index):
            self._add_txn(inv, _blank_reads(inv.value), crashed=True,
                          start=self._live_start.get(p, self._pos))
        self._live.clear()
        self._live_start.clear()
        for hk, ks in self._keys.items():
            still = ks.pending
            ks.pending = []
            for tid_r, vs in still:
                self._finalize_read(hk, ks, tid_r, vs, final=True)

    # -- internals -------------------------------------------------------
    def _bump(self, name: str, n: int = 1) -> None:
        _bump(self.counters, name, n)

    def _key(self, k: Any) -> _KeyState:
        hk = hashable(k)
        ks = self._keys.get(hk)
        if ks is None:
            ks = self._keys[hk] = _KeyState()
        return ks

    def _register_fail(self, f: txn_ops.FailedTxn) -> None:
        for kind, k, v in f.micros:
            if kind == txn_ops.APPEND:
                ks = self._key(k)
                ks.failed_vals.setdefault(hashable(v), f.op.index)

    def _add_txn(self, op: Any, micros: Tuple, crashed: bool,
                 start: int = -1, end: int = -1) -> None:
        tid = len(self.txns)
        self.txns.append(txn_ops.Txn(tid=tid, op=op, micros=micros,
                                     crashed=crashed, end=end))
        # commit-order in-edges: every txn added earlier committed (if
        # at all) at a smaller stream position, so the only new cm edges
        # a txn brings are into itself, u -> tid whenever u's commit
        # precedes this txn's start
        if tid and start >= 0:
            ends = np.asarray(self.ends, np.int64)
            for u in np.nonzero((ends >= 0) & (ends < start))[0]:
                self._cm_fresh.append((int(u), tid))
        self.starts.append(start)
        self.ends.append(end)
        touched: List[Any] = []
        for kind, k, v in micros:
            hk = hashable(k)
            ks = self._key(k)
            if kind == txn_ops.APPEND:
                hv = hashable(v)
                if hv in ks.appenders:
                    self.direct.append(
                        {"type": "duplicate-append", "key": k,
                         "value": v, "txns": [ks.appenders[hv], tid]})
                    self._bump("duplicate_append")
                    ks.poisoned = True
                    continue
                ks.appenders[hv] = tid
                if crashed:
                    ks.crashed_vals.add(hv)
                touched.append(hk)
            elif kind == txn_ops.READ and v is not None:
                ks.pending.append((tid, hashable_seq(v)))
                touched.append(hk)
        # settlement: new appends may unblock reads queued on this key
        for hk in dict.fromkeys(touched):
            self._settle_key(hk, self._keys[hk])

    def _settle_key(self, hk: Any, ks: _KeyState) -> None:
        progressed = True
        while progressed:
            progressed = False
            still: List[Tuple[int, Tuple[Any, ...]]] = []
            for tid_r, vs in ks.pending:
                if all(v in ks.appenders for v in vs):
                    self._process_read(hk, ks, tid_r, vs)
                    progressed = True
                elif any(v in ks.failed_vals
                         and v not in ks.appenders for v in vs):
                    # a value only a FAILED txn ever appended: G1a
                    self._finalize_read(hk, ks, tid_r, vs)
                    progressed = True
                else:
                    still.append((tid_r, vs))
            ks.pending = still

    def _finalize_read(self, hk: Any, ks: _KeyState, tid_r: int,
                       vs: Tuple[Any, ...],
                       final: bool = False) -> None:
        """A read that can never settle cleanly: each unknown value is a
        G1a when a failed txn appended it, a phantom when the stream is
        over and nobody did. Mid-stream (``final=False``) only the
        proven-aborted values are attributed: an unknown value may be an
        in-flight append. The key poisons either way."""
        if all(v in ks.appenders for v in vs):
            self._process_read(hk, ks, tid_r, vs)
            return
        for v in vs:
            if v in ks.appenders:
                continue
            if v in ks.failed_vals:
                self.direct.append({"type": "G1a", "key": hk,
                                    "value": v,
                                    "failed-op-index":
                                        ks.failed_vals[v]})
                self._bump("aborted_read")
            elif final:
                self.direct.append(
                    {"type": "incompatible-order", "key": hk,
                     "value": v,
                     "cause": "read observed a value never appended"})
                self._bump("phantom_value")
        ks.poisoned = True

    def _edge(self, u: int, v: int, et: int) -> None:
        if u == v:
            return
        e = (u, v, et)
        if e not in self._edges:
            self._edges.add(e)
            self._fresh.append(e)
            obs.count(f"txn.edges.{EDGE_NAMES[et]}")

    def _incompatible(self, hk: Any, ks: _KeyState, tid_r: int,
                      vs: Tuple[Any, ...]) -> None:
        self.direct.append(
            {"type": "incompatible-order", "key": hk, "txn": tid_r,
             "cause": "read is not a prefix of the recovered order",
             "version": list(vs), "order": list(ks.order)})
        self._bump("incompatible_order")
        ks.poisoned = True

    def _process_read(self, hk: Any, ks: _KeyState, tid_r: int,
                      vs: Tuple[Any, ...]) -> None:
        """A settled read: validate prefix-compatibility, extend the
        recovered order, and emit the wr/ww/rw edges it proves."""
        if ks.poisoned:
            return
        L = len(vs)
        cur = ks.order
        if len(set(vs)) != L:
            self.direct.append(
                {"type": "incompatible-order", "key": hk,
                 "cause": "duplicate value in one read",
                 "version": list(vs)})
            self._bump("incompatible_order")
            ks.poisoned = True
            return
        if L > len(cur):
            if tuple(cur) != vs[:len(cur)]:
                self._incompatible(hk, ks, tid_r, vs)
                return
            # extend: every value has a known appender (settled), so the
            # new positions' ww edges and the rw edges of readers parked
            # at the old frontier emit now
            for i in range(len(cur), L):
                hv = vs[i]
                w = ks.appenders[hv]
                if hv in ks.crashed_vals:
                    self._bump("crashed_recovered")
                ks.order.append(hv)
                ks.writers.append(w)
                if i > 0:
                    self._edge(ks.writers[i - 1], w, WW)
                for parked in ks.readers_by_len.pop(i, ()):
                    self._edge(parked, w, RW)
        elif tuple(vs) != tuple(cur[:L]):
            self._incompatible(hk, ks, tid_r, vs)
            return
        if L:
            self._edge(ks.writers[L - 1], tid_r, WR)
        if L < len(ks.order):
            self._edge(tid_r, ks.writers[L], RW)
        else:
            ks.readers_by_len.setdefault(L, []).append(tid_r)

    # -- views -----------------------------------------------------------
    @property
    def n(self) -> int:
        return len(self.txns)

    def pending_reads(self) -> int:
        return sum(len(ks.pending) for ks in self._keys.values())

    def drain_new_edges(self) -> Tuple[np.ndarray, np.ndarray,
                                       np.ndarray]:
        """Edges emitted since the last drain, as (src, dst, et) int32
        arrays: the device closure's dirty-block delta."""
        fresh, self._fresh = self._fresh, []
        if not fresh:
            z = np.zeros(0, np.int32)
            return z, z.copy(), z.copy()
        arr = np.asarray(fresh, np.int64)
        return (arr[:, 0].astype(np.int32),
                arr[:, 1].astype(np.int32),
                arr[:, 2].astype(np.int32))

    def drain_new_cm(self) -> Tuple[np.ndarray, np.ndarray]:
        """Commit-order edges proven since the last drain, as (src, dst)
        int32 arrays: the lattice closure's fourth lane (:data:`CM`)
        delta. Apart from :meth:`drain_new_edges` because cm is no
        :class:`DepGraph` edge type (post-hoc it comes from the txn
        intervals)."""
        fresh, self._cm_fresh = self._cm_fresh, []
        if not fresh:
            z = np.zeros(0, np.int32)
            return z, z.copy()
        arr = np.asarray(fresh, np.int64)
        return arr[:, 0].astype(np.int32), arr[:, 1].astype(np.int32)

    def intervals(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-tid (start, commit) stream positions: what the lattice's
        host reference needs to rebuild the commit order exactly as the
        incremental cm lane saw it."""
        return (np.asarray(self.starts, np.int64),
                np.asarray(self.ends, np.int64))

    def graph(self) -> DepGraph:
        """The accumulated dependency graph (the host booleans and the
        witness walk read it)."""
        n = len(self.txns)
        dt = txn_ops.idx_dtype(max(n, 1))
        if self._edges:
            es = np.array(sorted(self._edges), np.int64)
            src = es[:, 0].astype(dt)
            dst = es[:, 1].astype(dt)
            et = es[:, 2].astype(np.int8)
        else:
            src = np.zeros(0, dt)
            dst = np.zeros(0, dt)
            et = np.zeros(0, np.int8)
        return DepGraph(n=n, src=src, dst=dst, et=et,
                        txns=tuple(self.txns),
                        direct=tuple(self.direct),
                        counters=dict(self.counters))


def _blank_reads(value: Any) -> Tuple:
    """A crashed txn's micro-ops, its reads blanked (their values were
    never observed), as post-hoc ``collect`` does."""
    return tuple((k, key, None) if k == txn_ops.READ else (k, key, v)
                 for k, key, v in txn_ops.micro_ops(value))

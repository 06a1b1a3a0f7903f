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

A copy of the reference's post-hoc inference
(``jepsen_tpu/txn/infer.py``); its incremental inference for streaming
sessions is not ported yet.
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

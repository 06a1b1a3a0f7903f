"""The consistency-model lattice, a copy of the reference's
``jepsen_tpu/txn/lattice.py``: one parameterized word closure answers
"WHICH guarantee broke", not just "serializable or not".

Levels, weakest first::

    read-committed ⊏ causal ⊏ pl-2 ⊏ si ⊏ serializable

Each level maps to the edge-class masks allowed to close a cycle plus
host-side scans, evaluated CUMULATIVELY: a level proscribes its own
anomaly classes and everything below it, so ``holds`` is monotone by
construction (``holds[stronger] ⇒ holds[weaker]``). That resolves the
classical incomparability of snapshot isolation and serializability —
the top of this lattice is the strong-session reading of each level
(the one a safety-testing service actually wants: real systems that
claim a level also respect commit order and per-session monotonicity).

Newly proscribed per level:

- ``read-committed`` — the direct anomalies (G1a aborted read,
  duplicate appends, non-prefix reads — these fail EVERY level) and
  G0 (``ww`` cycles);
- ``causal``         — G1c (``ww ∪ wr`` cycles);
- ``pl-2``           — the four session guarantees, checked as cheap
  host prefix scans over the recovered orders: monotonic reads,
  monotonic writes, read-your-writes, writes-follow-reads;
- ``si``             — the G-SI write-skew taxonomy on the
  ``ww ∪ wr ∪ cm`` lane (``cm`` = commit-order edges from
  :func:`jepsen_tpu_torch.txn.cycles.commit_mask`): G-SIa (a dependency edge
  contradicting commit order), G-SIb (one rw edge closing a
  commit-order cycle — write skew between non-overlapping txns),
  G-SI (any other cycle in the lane);
- ``serializable``   — G-single and G2 (any dependency cycle).

All six device booleans come from ONE ``[K, Np, NW]`` squaring ladder
(:func:`jepsen_tpu_torch.txn.cycles.lattice_booleans` — checking five
levels costs one closure, not five; a launch of K8 a squaring), with
:func:`jepsen_tpu_torch.txn.host_ref.
lattice_classify_booleans` as the host reference, identical and
differentially tested. Witness walks are host-side and shared by
every engine path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.txn import cycles, host_ref
from jepsen_tpu_torch.txn.infer import DepGraph
from jepsen_tpu_torch.txn.ops import APPEND, READ
from jepsen_tpu_torch.util import hashable, hashable_seq

LEVELS = ("read-committed", "causal", "pl-2", "si", "serializable")

# accepted spellings -> canonical level key
_ALIASES = {
    "read-committed": "read-committed", "rc": "read-committed",
    "pl-2": "pl-2", "pl2": "pl-2",
    "causal": "causal",
    "si": "si", "snapshot-isolation": "si",
    "serializable": "serializable", "serializability": "serializable",
    "all": "all",
}

# session-guarantee violation types (the pl-2 scans)
SESSION_CLASSES = ("monotonic-reads", "monotonic-writes",
                   "read-your-writes", "writes-follow-reads")

# level -> anomaly classes it NEWLY proscribes (cumulative semantics:
# a level also proscribes everything weaker levels do)
LEVEL_ANOMALIES: Dict[str, Tuple[str, ...]] = {
    "read-committed": ("G0",),
    "causal": ("G1c",),
    "pl-2": SESSION_CLASSES,
    "si": ("G-SIa", "G-SIb", "G-SI"),
    "serializable": ("G-single", "G2"),
}


def canon_level(level: Any) -> str:
    """Canonicalize a requested consistency level (str, or a sequence
    of strs meaning "check these" — canonicalized elementwise by the
    caller). Raises ValueError on junk so serve/facade reject early."""
    if not isinstance(level, str) or level.lower() not in _ALIASES:
        raise ValueError(
            f"unknown consistency level {level!r}; expected one of "
            f"{sorted(set(_ALIASES))}")
    return _ALIASES[level.lower()]


def canon_levels(consistency: Any) -> Tuple[str, ...]:
    """A requested level, list of levels, or ``"all"`` -> the
    canonical tuple of levels the verdict gates on."""
    if isinstance(consistency, (list, tuple, set)):
        out = tuple(sorted({canon_level(x) for x in consistency},
                           key=LEVELS.index))
        if not out:
            raise ValueError("empty consistency level set")
        return out
    c = canon_level(consistency)
    return LEVELS if c == "all" else (c,)


def holds_from(booleans: Dict[str, bool], *, direct: bool = False,
               session_violated: bool = False) -> Dict[str, bool]:
    """Cumulative per-level verdicts from the six lattice booleans
    plus the host-scan facts. Monotone by construction. (G-SIa needs
    no separate input: its witness pattern is a 2-cycle in the
    ``ww ∪ wr ∪ cm`` lane, so ``cyc_si`` already covers it.)"""
    fail_rc = direct or booleans["cyc_ww"]
    fail_causal = fail_rc or booleans["cyc_wwwr"]
    fail_pl2 = fail_causal or session_violated
    fail_si = fail_pl2 or booleans.get("cyc_si", False) \
        or booleans.get("gsib", False)
    fail_ser = fail_si or booleans["cyc_full"] or booleans["gsingle"]
    return {"read-committed": not fail_rc, "causal": not fail_causal,
            "pl-2": not fail_pl2, "si": not fail_si,
            "serializable": not fail_ser}


def weakest_violated(holds: Dict[str, bool]) -> Optional[str]:
    for lvl in LEVELS:
        if not holds.get(lvl, True):
            return lvl
    return None


def all_false_holds() -> Dict[str, bool]:
    """Every level fails — the direct-anomaly short-circuit (aborted
    reads / duplicate appends / non-prefix reads poison all levels)."""
    return {lvl: False for lvl in LEVELS}


# -- session-guarantee scans (the pl-2 level) ----------------------------

def session_scans(txns: Sequence[Any]) -> List[Dict[str, Any]]:
    """Per-process session-guarantee violations as host prefix scans
    over the recovered orders — O(history), no device work.

    Soundness: only committed (non-crashed) txns participate; reads
    are compared by observed CONTENT (a later read must contain the
    process's own earlier appends and never shrink), and positional
    checks (monotonic writes, writes-follow-reads) only fire for
    appends some read actually recovered. Violations are monotone
    under history extension, so the streaming session can re-run the
    scan per block and never retract a verdict."""
    # recovered order per key: the longest observed read
    orders: Dict[Any, Tuple[Any, ...]] = {}
    for t in txns:
        for kind, k, v in t.micros:
            if kind == READ and v is not None:
                hk = hashable(k)
                hv = hashable_seq(v)
                if len(hv) > len(orders.get(hk, ())):
                    orders[hk] = hv
    pos: Dict[Any, Dict[Any, int]] = {
        hk: {v: i for i, v in enumerate(vs)}
        for hk, vs in orders.items()}

    by_proc: Dict[Any, List[Any]] = {}
    for t in txns:
        if not t.crashed:
            by_proc.setdefault(hashable(t.process), []).append(t)

    out: List[Dict[str, Any]] = []
    for proc in sorted(by_proc, key=lambda p: (str(type(p)), str(p))):
        max_read: Dict[Any, Tuple[int, int]] = {}   # key -> (len, tid)
        own: Dict[Any, List[Tuple[Any, int]]] = {}  # key -> [(val, tid)]
        last_pos: Dict[Any, Tuple[int, int]] = {}   # key -> (pos, tid)
        for t in by_proc[proc]:                     # tid order = program order
            appends_now: List[Tuple[Any, Any]] = []
            for kind, k, v in t.micros:
                hk = hashable(k)
                if kind == READ and v is not None:
                    vs = hashable_seq(v)
                    L = len(vs)
                    prev = max_read.get(hk)
                    if prev is not None and L < prev[0]:
                        out.append({
                            "type": "monotonic-reads", "process": proc,
                            "key": k, "txns": [prev[1], t.tid],
                            "lens": [prev[0], L]})
                    if prev is None or L > prev[0]:
                        max_read[hk] = (L, t.tid)
                    seen = set(vs)
                    for av, atid in own.get(hk, ()):
                        if av not in seen:
                            out.append({
                                "type": "read-your-writes",
                                "process": proc, "key": k, "value": av,
                                "txns": [atid, t.tid]})
                elif kind == APPEND:
                    hv = hashable(v)
                    p = pos.get(hk, {}).get(hv)
                    if p is not None:
                        lp = last_pos.get(hk)
                        if lp is not None and p < lp[0]:
                            out.append({
                                "type": "monotonic-writes",
                                "process": proc, "key": k, "value": v,
                                "txns": [lp[1], t.tid],
                                "positions": [lp[0], p]})
                        last_pos[hk] = (p, t.tid)
                        mr = max_read.get(hk)
                        if mr is not None and p < mr[0]:
                            out.append({
                                "type": "writes-follow-reads",
                                "process": proc, "key": k, "value": v,
                                "txns": [mr[1], t.tid],
                                "position": p, "read-len": mr[0]})
                    appends_now.append((hk, hv))
            # own appends join AFTER the txn: read-your-writes is an
            # ACROSS-txn guarantee (intra-txn read-after-append is the
            # direct prefix machinery's business)
            for hk, hv in appends_now:
                own.setdefault(hk, []).append((hv, t.tid))
    if out:
        obs.count("txn.lattice.scan_violations", len(out))
    return out


# -- per-level classification --------------------------------------------

def _class_presence(booleans: Dict[str, bool],
                    scans: List[Dict[str, Any]],
                    gsia: bool) -> Dict[str, bool]:
    """Anomaly class -> present, with the same implied-by-stronger
    suppression discipline as :func:`host_ref.derive_anomalies`."""
    scan_types = {s["type"] for s in scans}
    p = {
        "G0": booleans["cyc_ww"],
        "G1c": booleans["cyc_wwwr"] and not booleans["cyc_ww"],
        "G-single": booleans["gsingle"] and not booleans["cyc_wwwr"],
        "G2": booleans["cyc_full"] and not (booleans["cyc_wwwr"]
                                            or booleans["gsingle"]),
        "G-SIa": gsia,
        "G-SIb": booleans.get("gsib", False),
        "G-SI": booleans.get("cyc_si", False)
                and not gsia and not booleans["cyc_wwwr"],
    }
    for c in SESSION_CLASSES:
        p[c] = c in scan_types
    return p


def check_levels(graph: DepGraph, *,
                 device: _device.DeviceLike = None,
                 max_dense_txns: Optional[int] = None,
                 force_host: bool = False,
                 starts: Optional[np.ndarray] = None,
                 ends: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Evaluate every lattice level over one inferred graph: ONE
    device closure (six booleans), the host session scans, the G-SIa
    edge scan, per-level holds/anomalies/witnesses. ``starts``/
    ``ends`` override the txn intervals (the streaming session passes
    its own stream positions); post-hoc they come off the ``Txn``
    records. Graphs past the dense envelope go straight to the host
    lattice reference (the commit-order lane cannot ride the
    cycle-preserving Kahn trim: cm edges through trimmed nodes would
    vanish) — a recorded route, not a fallback. The closure runs on
    ``device`` (default: the card); a fault there propagates."""
    if starts is None:
        starts = np.asarray([t.index for t in graph.txns], np.int64)
    if ends is None:
        ends = np.asarray([t.end for t in graph.txns], np.int64)
    obs.count("txn.lattice.check")

    booleans: Optional[Dict[str, bool]] = None
    engine = "txn-lattice-host"
    if graph.e == 0:
        # no dependency edges: nothing can cycle (cm alone is an
        # interval order — acyclic), but the session scans still run
        booleans = {k: False for k in cycles.LATTICE_KEYS}
        engine = "txn-lattice-noedges"
    elif force_host:
        obs.decision("txn-lattice", "route", cause="host-forced",
                     txns=graph.n, edges=graph.e)
    else:
        cap = max_dense_txns if max_dense_txns is not None \
            else cycles.max_dense()
        if not cycles.admits(graph.n, cap):
            obs.decision("txn-lattice", "route", cause="past-envelope",
                         txns=graph.n, edges=graph.e)
        else:
            booleans = cycles.lattice_booleans(graph, starts, ends,
                                               device=device)
            obs.count("txn.lattice.word")
            engine = "txn-lattice-mxu"
    if booleans is None:
        booleans = dict(host_ref.classify_booleans(graph))
        booleans.update(host_ref.lattice_classify_booleans(
            graph, starts, ends))
        engine = "txn-lattice-host"
        obs.count("txn.lattice.host")

    scans = session_scans(graph.txns)
    gsia_w = host_ref.gsia_scan(graph, starts, ends)
    holds = holds_from(booleans,
                       session_violated=bool(scans))
    presence = _class_presence(booleans, scans, gsia_w is not None)

    levels: Dict[str, Any] = {}
    for lvl in LEVELS:
        found = [c for c in LEVEL_ANOMALIES[lvl] if presence.get(c)]
        d: Dict[str, Any] = {"holds": holds[lvl], "anomalies": found}
        if found:
            d["witness"] = _witness(graph, found[0], scans,
                                    starts, ends, gsia_w)
        levels[lvl] = d
    wv = weakest_violated(holds)
    if wv is not None:
        obs.count("txn.lattice.violations")
    return {"booleans": booleans, "holds": holds, "levels": levels,
            "weakest-violated": wv, "engine": engine,
            "session-violations": [dict(s) for s in scans[:32]]}


def _witness(graph: DepGraph, cls: str, scans: List[Dict[str, Any]],
             starts: np.ndarray, ends: np.ndarray,
             gsia_w: Optional[Dict[str, Any]]
             ) -> Optional[Dict[str, Any]]:
    """The shared host-side witness walk for every anomaly class the
    lattice reports (identical across the device and host verdict
    paths — witnesses never depend on which computed the booleans)."""
    if cls in SESSION_CLASSES:
        for s in scans:
            if s["type"] == cls:
                return dict(s)
        return None
    if cls == "G-SIa":
        return gsia_w
    if cls in ("G-SIb", "G-SI"):
        return host_ref.find_lattice_witness(graph, cls, starts, ends)
    return host_ref.find_witness(graph, cls)

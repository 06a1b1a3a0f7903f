"""``jepsen_tpu_torch.txn`` — the Elle-style transactional checker, the
port of the reference's ``jepsen_tpu/txn``: serializability (and, with
``consistency``, the consistency lattice) for list-append workloads as
dependency-cycle search over the inferred wr/ww/rw graph, run as
batched boolean squaring on the card.

Pipeline (:func:`check_history`):

1. :mod:`.ops`     — pair invocations/completions, normalize micro-ops,
   int-pack the history (narrow ``ops.idx_dtype`` arrays);
2. :mod:`.infer`   — per-key append-order recovery (Elle traceability)
   → COO ww/wr/rw edge tensor; ambiguity degrades to documented-weaker
   edges with ``txn.infer.*`` counters, never silently;
3. :mod:`.cycles`  — the device closure: edge-type-restricted boolean
   transitive closures under one batched squaring ladder (the
   word-packed body, a launch of the hand-written kernel K8 a squaring),
   with diagonal hits as the G0 / G1c / G-single / G2 verdicts;
   Kahn-trim to the cyclic core past the dense envelope;
4. :mod:`.host_ref`— the Tarjan/SCC reference, taken by decision
   (``force_host``, a core past the envelope), and the shared
   deterministic witness walk both paths report through.

``facade.auto_check_txn`` is the routed entry (standard selection
ledger); :class:`TxnChecker` is the ``facade.compose``-able checker.
Entry points run on the card unless ``device="cpu"``; a device fault
propagates (the reference records a fallback to the host instead).
Not ported yet: the streaming sessions' incremental inference and
closure, and the row-block mesh tiling.
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import obs, util
from jepsen_tpu_torch.op import Op
from jepsen_tpu_torch.txn import cycles, host_ref, infer as infer_mod, \
    lattice, ops
from jepsen_tpu_torch.txn.infer import DepGraph
from jepsen_tpu_torch.txn.ops import ListAppend, list_append_model

__all__ = ["check_history", "check_graph", "TxnChecker", "txn_checker",
           "ListAppend", "list_append_model", "ops", "cycles",
           "host_ref", "lattice", "DepGraph"]


def _witness_detail(graph: DepGraph,
                    w: Optional[Dict[str, Any]]) -> Optional[Dict]:
    if w is None:
        return None
    return {"cycle": [graph.txns[i].describe() for i in w["cycle"]],
            "edges": list(w["edges"])}


def check_graph(graph: DepGraph, *,
                device: _device.DeviceLike = None,
                max_dense_txns: Optional[int] = None,
                force_host: bool = False) -> Dict[str, Any]:
    """Cycle-search an inferred dependency graph. Routes the closure on
    ``device`` (default: the card) first, trimming to the cyclic core
    past the dense envelope; ``force_host`` and a core past the envelope
    take the host SCC reference, recorded route decisions. A device
    fault propagates."""
    res: Dict[str, Any] = {"txns": graph.n, "edges": graph.e,
                           "edge-counts": graph.edge_counts()}
    if graph.e == 0:
        res.update({"valid": True, "anomalies": [],
                    "engine": "txn-noedges"})
        obs.count("txn.closure.trivial")
        return res
    booleans: Optional[Dict[str, bool]] = None
    engine = "txn-host-scc"
    target = graph
    if force_host:
        obs.decision("txn-closure", "route", cause="host-forced",
                     txns=graph.n, edges=graph.e)
    else:
        cap = max_dense_txns if max_dense_txns is not None \
            else cycles.max_dense()
        if not cycles.admits(graph.n, cap):
            # cycle-preserving Kahn trim: the dense closure only needs
            # the cyclic core (every class-restricted cycle survives)
            core_ids, core = host_ref.trim_core(graph)
            obs.count("txn.core.trimmed")
            obs.gauge("txn.core.n", int(core.n))
            res["core-txns"] = int(core.n)
            if cycles.admits(core.n, cap):
                target = core
            else:
                obs.decision("txn-closure", "route",
                             cause="core-overflow", txns=graph.n,
                             core=int(core.n))
                target = None
        if target is not None:
            booleans = cycles.closure_booleans(target, device=device)
            obs.count("txn.closure.word")
            engine = "txn-mxu"
    if booleans is None:
        booleans = host_ref.classify_booleans(graph)
        engine = "txn-host-scc"
        obs.count("txn.closure.host")
    anomalies = host_ref.derive_anomalies(booleans)
    res.update({"valid": not anomalies, "anomalies": anomalies,
                "engine": engine, "booleans": booleans})
    if anomalies:
        # witness extraction is host-side and shared by both engine
        # paths: walk one concrete cycle of the most severe class back
        # out of the FULL graph for the report
        res["anomaly"] = anomalies[0]
        res["witness"] = _witness_detail(
            graph, host_ref.find_witness(graph, anomalies[0]))
    return res


def check_history(history: Sequence[Op], *,
                  device: _device.DeviceLike = None,
                  max_dense_txns: Optional[int] = None,
                  force_host: bool = False,
                  consistency: Optional[Any] = None) -> Dict[str, Any]:
    """The full transactional check: collect → infer → cycle-search.
    Inference-time (direct) anomalies — non-prefix reads, duplicate
    appends, G1a aborted reads — fail the history outright and skip
    the cycle stage (a poisoned order could fabricate cycles).

    With ``consistency`` (a lattice level name, a list of them, or
    ``"all"``) the check routes through the consistency lattice
    (:mod:`jepsen_tpu_torch.txn.lattice`): the result carries per-level
    ``holds``/``levels``/``weakest-violated``, and ``valid`` gates on
    the REQUESTED level(s) — every level is evaluated either way,
    because one closure covers them all. ``consistency=None`` keeps
    the legacy serializable-only verdict bit-for-bit.

    The closure runs on ``device`` (default: the card, which raises when
    there is none; ``"cpu"`` runs the plain versions); ``max_dense_txns``
    overrides the dense envelope."""
    t0 = _time.monotonic()
    device = _device.resolve(device)
    levels_req = (None if consistency is None
                  else lattice.canon_levels(consistency))
    # collect/infer allocate millions of long-lived micro-op tuples:
    # every gen0/1 collection re-scans the growing survivor set, so
    # GC is paused across the whole check (util.gc_paused — bounded,
    # re-entrant; the deferred collection runs at the caller's next
    # allocation)
    with util.gc_paused():
        with obs.span("txn.collect"):
            txns, fails = ops.collect(history)
        with obs.span("txn.infer", txns=len(txns)):
            graph = infer_mod.infer(txns, fails)
        res: Dict[str, Any] = {}
        if graph.direct:
            kinds = sorted({d["type"] for d in graph.direct})
            res = {"valid": False, "txns": graph.n, "edges": graph.e,
                   "edge-counts": graph.edge_counts(),
                   "engine": "txn-infer",
                   "anomalies": kinds, "anomaly": kinds[0],
                   "direct": [dict(d) for d in graph.direct[:32]],
                   "direct-count": len(graph.direct)}
            if levels_req is not None:
                # direct anomalies poison EVERY lattice level
                res["consistency"] = list(levels_req)
                res["holds"] = lattice.all_false_holds()
                res["weakest-violated"] = lattice.LEVELS[0]
                res["levels"] = {
                    lvl: {"holds": False, "anomalies": kinds}
                    for lvl in lattice.LEVELS}
        elif levels_req is not None:
            with obs.span("txn.lattice", txns=graph.n, edges=graph.e):
                lat = lattice.check_levels(
                    graph, device=device,
                    max_dense_txns=max_dense_txns,
                    force_host=force_host)
            anomalies = [c for lvl in lattice.LEVELS
                         for c in lat["levels"][lvl]["anomalies"]]
            res = {"txns": graph.n, "edges": graph.e,
                   "edge-counts": graph.edge_counts(),
                   "valid": all(lat["holds"][lvl]
                                for lvl in levels_req),
                   "consistency": list(levels_req),
                   "holds": lat["holds"], "levels": lat["levels"],
                   "weakest-violated": lat["weakest-violated"],
                   "booleans": lat["booleans"],
                   "engine": lat["engine"],
                   "anomalies": anomalies}
            if lat["session-violations"]:
                res["session-violations"] = lat["session-violations"]
            if anomalies:
                res["anomaly"] = anomalies[0]
                wv = lat["weakest-violated"]
                w = lat["levels"][wv].get("witness") if wv else None
                if w is not None:
                    res["witness"] = (_witness_detail(graph, w)
                                      if "cycle" in w else w)
        else:
            with obs.span("txn.cycles", txns=graph.n, edges=graph.e):
                res = check_graph(graph, device=device,
                                  max_dense_txns=max_dense_txns,
                                  force_host=force_host)
    res["failed-txns"] = len(fails)
    res["infer"] = dict(graph.counters)
    if graph.counters.get("ambiguous_appends"):
        # weaker edges were inferred (unobserved appends have no
        # position): the verdict stands on what WAS observable
        res["coverage"] = "weakened"
    res["check-s"] = round(_time.monotonic() - t0, 6)
    return res


@dataclass
class TxnChecker:
    """``facade.compose``-able transactional checker: Elle-style
    list-append serializability over the whole history (non-txn ops —
    nemesis, mixed workloads — are ignored by :func:`ops.collect`)."""
    opts: Dict[str, Any] = field(default_factory=dict)
    name = "txn"

    def check(self, test, history, opts=None):
        from jepsen_tpu_torch.checkers import facade
        kw = dict(self.opts)
        if opts:
            kw.update(opts)
        return facade.auto_check_txn(history, kw)


def txn_checker(**opts: Any) -> TxnChecker:
    return TxnChecker(opts=opts)

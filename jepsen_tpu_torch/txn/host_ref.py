"""Host SCC reference for the transactional checker — a copy of the
reference's ``jepsen_tpu/txn/host_ref.py``. The route behind
:mod:`jepsen_tpu_torch.txn.cycles` when the caller forces the host or
the graph is past the dense envelope (a recorded route decision, never
a fallback from a device fault), with verdicts identical to the device
closure's. Iterative Tarjan over the COO dependency graph, the
Kahn trim that strips the acyclic fringe before a big graph meets the
dense device closure, and the deterministic witness walk BOTH engine
paths use to turn "a cycle exists in class X" into one concrete cycle
for the report.

The anomaly taxonomy maps to edge-type-restricted cycle predicates
(Adya / Elle):

- ``G0``       — a cycle using only ``ww`` edges (write cycle);
- ``G1c``      — a cycle in ``ww ∪ wr`` that is not already G0;
- ``G-single`` — a cycle with exactly one ``rw`` edge: some rw edge
  ``u → v`` with a ``ww ∪ wr`` path ``v ⇒ u``;
- ``G2``       — any remaining cycle (≥2 rw edges).

:func:`derive_anomalies` turns the four raw booleans into the reported
class list identically for the device and host paths, so differential
identity reduces to boolean agreement (tested in
``tests/test_torch_txn.py``).
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch.txn.infer import (CM, EDGE_NAMES, RW, WR, WW,
                                        DepGraph)
from jepsen_tpu_torch.txn.ops import idx_dtype

# class name -> edge types allowed in its witness cycle
_CLASS_EDGES = {"G0": (WW,), "G1c": (WW, WR),
                "G-single": (WW, WR, RW), "G2": (WW, WR, RW)}


def _adj(graph: DepGraph, types: Sequence[int]
         ) -> List[List[Tuple[int, int]]]:
    """Adjacency lists restricted to ``types``: node -> sorted
    [(dst, et), ...] (sorted so every walk is deterministic)."""
    out: List[List[Tuple[int, int]]] = [[] for _ in range(graph.n)]
    tset = set(types)
    for u, v, t in zip(graph.src.tolist(), graph.dst.tolist(),
                       graph.et.tolist()):
        if t in tset:
            out[int(u)].append((int(v), int(t)))
    for lst in out:
        lst.sort()
    return out


def scc(n: int, adj: List[List[Tuple[int, int]]]) -> List[List[int]]:
    """Iterative Tarjan (100k-node graphs must not hit the recursion
    limit). Returns the strongly connected components, each sorted."""
    index = [-1] * n
    low = [0] * n
    on_stack = [False] * n
    stack: List[int] = []
    comps: List[List[int]] = []
    counter = 0
    for root in range(n):
        if index[root] >= 0:
            continue
        work: List[Tuple[int, int]] = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            advanced = False
            for i in range(pi, len(adj[v])):
                w = adj[v][i][0]
                if index[w] < 0:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    advanced = True
                    break
                if on_stack[w]:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp.append(w)
                    if w == v:
                        break
                comps.append(sorted(comp))
    return comps


def _has_cycle(n: int, adj: List[List[Tuple[int, int]]]) -> bool:
    return any(len(c) > 1 for c in scc(n, adj))


def classify_booleans(graph: DepGraph) -> Dict[str, bool]:
    """The four raw cycle predicates, from Tarjan/BFS on the host —
    the reference the device closure is differentially held to."""
    adj_ww = _adj(graph, (WW,))
    adj_wwwr = _adj(graph, (WW, WR))
    adj_full = _adj(graph, (WW, WR, RW))
    cyc_ww = _has_cycle(graph.n, adj_ww)
    cyc_wwwr = _has_cycle(graph.n, adj_wwwr)
    cyc_full = _has_cycle(graph.n, adj_full)
    gsingle = False
    if cyc_full:
        # a G-single cycle (one rw edge u->v + ww∪wr path v => u) lies
        # inside a full-graph SCC; search only there
        comp_of = {}
        for ci, comp in enumerate(scc(graph.n, adj_full)):
            if len(comp) > 1:
                for v in comp:
                    comp_of[v] = ci
        for u, v, t in zip(graph.src.tolist(), graph.dst.tolist(),
                           graph.et.tolist()):
            if t != RW:
                continue
            u, v = int(u), int(v)
            if comp_of.get(u) is None or comp_of.get(u) != comp_of.get(v):
                continue
            if _bfs_path(adj_wwwr, v, u) is not None:
                gsingle = True
                break
    return {"cyc_ww": cyc_ww, "cyc_wwwr": cyc_wwwr,
            "cyc_full": cyc_full, "gsingle": gsingle}


def derive_anomalies(b: Dict[str, bool]) -> List[str]:
    """Boolean predicates -> reported class list. Each class appears
    only when not implied by a stronger one, and the SAME derivation
    serves the device and host paths."""
    out: List[str] = []
    if b["cyc_ww"]:
        out.append("G0")
    if b["cyc_wwwr"] and not b["cyc_ww"]:
        out.append("G1c")
    if b["gsingle"] and not b["cyc_wwwr"]:
        out.append("G-single")
    if b["cyc_full"] and not (b["cyc_wwwr"] or b["gsingle"]):
        out.append("G2")
    return out


def _bfs_path(adj: List[List[Tuple[int, int]]], start: int,
              goal: int) -> Optional[List[int]]:
    """Shortest path start -> goal (deterministic: sorted adjacency,
    FIFO). Returns the node list including both ends, or None."""
    if start == goal:
        return [start]
    prev: Dict[int, int] = {start: -1}
    q: deque = deque([start])
    while q:
        u = q.popleft()
        for v, _t in adj[u]:
            if v in prev:
                continue
            prev[v] = u
            if v == goal:
                path = [v]
                while path[-1] != start:
                    path.append(prev[path[-1]])
                return list(reversed(path))
            q.append(v)
    return None


def _edge_type(graph_adj: List[List[Tuple[int, int]]], u: int,
               v: int) -> int:
    """The preferred (lowest-code: ww < wr < rw) edge type u -> v."""
    for dst, t in graph_adj[u]:          # sorted: (dst, et) ascending
        if dst == v:
            return t
    raise KeyError((u, v))


def find_witness(graph: DepGraph, cls: str) -> Optional[Dict[str, Any]]:
    """One concrete cycle of class ``cls``, deterministically (lowest
    node ids, shortest paths): ``{"cycle": [tid...], "edges":
    [type-name...]}`` where ``edges[i]`` labels ``cycle[i] ->
    cycle[i+1 mod len]``. None when the class has no cycle (callers
    only ask after a positive verdict)."""
    types = _CLASS_EDGES.get(cls)
    if types is None:
        return None
    adj = _adj(graph, types)
    if cls == "G-single":
        adj_wwwr = _adj(graph, (WW, WR))
        # only rw edges inside a full-graph SCC can close a cycle:
        # filtering first keeps the witness walk O(core), not
        # O(rw-edges * E) over a 100k-txn graph
        comp_of: Dict[int, int] = {}
        for ci, comp in enumerate(scc(graph.n, adj)):
            if len(comp) > 1:
                for v in comp:
                    comp_of[v] = ci
        rw_edges = sorted(
            (int(u), int(v))
            for u, v, t in zip(graph.src.tolist(), graph.dst.tolist(),
                               graph.et.tolist())
            if t == RW and comp_of.get(int(u)) is not None
            and comp_of.get(int(u)) == comp_of.get(int(v)))
        for u, v in rw_edges:
            path = _bfs_path(adj_wwwr, v, u)
            if path is not None:
                cycle = [u] + path[:-1]
                edges = [RW] + [_edge_type(adj_wwwr, path[i],
                                           path[i + 1])
                                for i in range(len(path) - 1)]
                return {"cycle": cycle,
                        "edges": [EDGE_NAMES[t] for t in edges]}
        return None
    # G0 / G1c / G2: shortest cycle through the smallest node of the
    # first multi-node SCC of the restricted graph
    for comp in scc(graph.n, adj):
        if len(comp) < 2:
            continue
        start = comp[0]
        comp_set = set(comp)
        sub = [[(v, t) for v, t in adj[u] if v in comp_set]
               for u in range(graph.n)]
        for succ, _t in sub[start]:
            path = _bfs_path(sub, succ, start)
            if path is not None:
                cycle = [start] + path[:-1]
                edges = [_edge_type(sub, cycle[i],
                                    cycle[(i + 1) % len(cycle)])
                         for i in range(len(cycle))]
                return {"cycle": cycle,
                        "edges": [EDGE_NAMES[t] for t in edges]}
    return None


# -- consistency-lattice host reference ----------------------------------
#
# The snapshot-isolation lane (ww ∪ wr ∪ cm) needs commit-order
# reachability WITHOUT materializing the dense [n, n] cm mask (the
# host reference must run on graphs far past the dense envelope). The
# chain-node trick realizes the interval order in O(n) extra nodes and
# edges: one chain node per txn in start order, forward chain edges,
# an entry edge into each txn from its start position, and one exit
# edge from each committed txn to the first chain position whose start
# follows its commit. Then u ⇒cm⇒ v iff a chain path u → … → v exists,
# and cm composed with dependency edges is plain reachability on the
# extended graph. Chain edges are labeled :data:`CM` so witness walks
# contract chain runs back into one reported ``cm`` hop.

_LANE_NAMES = ("ww", "wr", "rw", "cm")


def _chain_adj(graph: DepGraph, starts: np.ndarray, ends: np.ndarray,
               types: Sequence[int] = (WW, WR)
               ) -> List[List[Tuple[int, int]]]:
    """Extended adjacency (2n nodes: txns 0..n-1, chain n..2n-1 in
    start order) over ``types`` dependency edges plus the commit-order
    chain. Sorted per node for deterministic walks."""
    n = graph.n
    adj: List[List[Tuple[int, int]]] = [[] for _ in range(2 * n)]
    order = np.argsort(starts, kind="stable")
    sorted_starts = starts[order]
    for p in range(n):
        if p + 1 < n:
            adj[n + p].append((n + p + 1, CM))
        adj[n + p].append((int(order[p]), CM))
    exits = np.searchsorted(sorted_starts, ends, side="right")
    for u in range(n):
        if ends[u] >= 0 and exits[u] < n:
            adj[u].append((n + int(exits[u]), CM))
    tset = set(types)
    for u, v, t in zip(graph.src.tolist(), graph.dst.tolist(),
                       graph.et.tolist()):
        if t in tset:
            adj[int(u)].append((int(v), int(t)))
    for lst in adj:
        lst.sort()
    return adj


def _contract_chain(path: List[int], n: int,
                    adj: List[List[Tuple[int, int]]]
                    ) -> Tuple[List[int], List[str]]:
    """Collapse chain-node runs of an extended-graph walk into single
    ``cm`` hops between real txns. Returns (real nodes in walk order,
    labels between consecutive reals — direct dependency edges keep
    their type name, chain detours report as ``cm``)."""
    reals: List[int] = []
    labels: List[str] = []
    prev: Optional[int] = None
    pend_cm = False
    for v in path:
        if v >= n:
            pend_cm = True
            continue
        if prev is not None:
            labels.append("cm" if pend_cm
                          else _LANE_NAMES[_edge_type(adj, prev, v)])
        reals.append(v)
        prev = v
        pend_cm = False
    return reals, labels


def lattice_classify_booleans(graph: DepGraph, starts: np.ndarray,
                              ends: np.ndarray) -> Dict[str, bool]:
    """The two SI-lane predicates on the host — the reference the
    ``[K, Np, NW]`` lattice closure is differentially held to:
    ``cyc_si`` (a cycle in ``ww ∪ wr ∪ cm``) and ``gsib`` (an rw edge
    closing such a cycle — exactly one anti-dependency)."""
    n = graph.n
    adj_ext = _chain_adj(graph, starts, ends, (WW, WR))
    cyc_si = False
    for comp in scc(2 * n, adj_ext):
        if sum(1 for v in comp if v < n) >= 2:
            cyc_si = True
            break
    gsib = False
    adj_full_ext = _chain_adj(graph, starts, ends, (WW, WR, RW))
    comp_of: Dict[int, int] = {}
    for ci, comp in enumerate(scc(2 * n, adj_full_ext)):
        if len(comp) > 1:
            for v in comp:
                comp_of[v] = ci
    for u, v, t in zip(graph.src.tolist(), graph.dst.tolist(),
                       graph.et.tolist()):
        if t != RW:
            continue
        u, v = int(u), int(v)
        if comp_of.get(u) is None or comp_of.get(u) != comp_of.get(v):
            continue
        if _bfs_path(adj_ext, v, u) is not None:
            gsib = True
            break
    return {"cyc_si": cyc_si, "gsib": gsib}


def gsia_scan(graph: DepGraph, starts: np.ndarray,
              ends: np.ndarray) -> Optional[Dict[str, Any]]:
    """Adya's G-SIa interference witness, restricted to what intervals
    can PROVE: a ww/wr dependency ``u → v`` where ``v`` committed
    before ``u`` even began — ``v`` observed (or was overwritten by) a
    transaction from its future. Deliberately NOT the classic
    "no commit-before-start" form, which brands every overlapping-but-
    correct history invalid; this form never fires on a real system.
    Returns the first witness in sorted edge order, or None."""
    best: Optional[Tuple[int, int, int]] = None
    for u, v, t in zip(graph.src.tolist(), graph.dst.tolist(),
                       graph.et.tolist()):
        if t == RW:
            continue
        u, v = int(u), int(v)
        if ends[v] >= 0 and ends[v] < starts[u]:
            cand = (u, v, int(t))
            if best is None or cand < best:
                best = cand
    if best is None:
        return None
    u, v, t = best
    return {"cycle": [u, v], "edges": [_LANE_NAMES[t], "cm"]}


def find_lattice_witness(graph: DepGraph, cls: str,
                         starts: np.ndarray, ends: np.ndarray
                         ) -> Optional[Dict[str, Any]]:
    """One concrete SI-lane witness, deterministically — the lattice
    analogue of :func:`find_witness` for the classes the commit-order
    lane adds: ``G-SIa`` (a dependency edge contradicting commit
    order), ``G-SIb`` (one rw edge closing a ``ww ∪ wr ∪ cm`` cycle),
    ``G-SI`` (any other cycle in that lane). Chain-node runs report
    as single ``cm`` hops."""
    n = graph.n
    if cls == "G-SIa":
        return gsia_scan(graph, starts, ends)
    adj_ext = _chain_adj(graph, starts, ends, (WW, WR))
    if cls == "G-SIb":
        adj_full_ext = _chain_adj(graph, starts, ends, (WW, WR, RW))
        comp_of: Dict[int, int] = {}
        for ci, comp in enumerate(scc(2 * n, adj_full_ext)):
            if len(comp) > 1:
                for v in comp:
                    comp_of[v] = ci
        rw_edges = sorted(
            (int(u), int(v))
            for u, v, t in zip(graph.src.tolist(), graph.dst.tolist(),
                               graph.et.tolist())
            if t == RW and comp_of.get(int(u)) is not None
            and comp_of.get(int(u)) == comp_of.get(int(v)))
        for u, v in rw_edges:
            path = _bfs_path(adj_ext, v, u)
            if path is not None:
                reals, labels = _contract_chain(path, n, adj_ext)
                return {"cycle": [u] + reals[:-1],
                        "edges": ["rw"] + labels}
        return None
    if cls == "G-SI":
        for comp in scc(2 * n, adj_ext):
            reals = [v for v in comp if v < n]
            if len(reals) < 2:
                continue
            start = reals[0]
            comp_set = set(comp)
            sub = [[(v, t) for v, t in adj_ext[u] if v in comp_set]
                   for u in range(2 * n)]
            for succ, _t in sub[start]:
                path = _bfs_path(sub, succ, start)
                if path is not None:
                    reals_c, labels = _contract_chain(
                        [start] + path, n, sub)
                    return {"cycle": reals_c[:-1], "edges": labels}
        return None
    return None


def trim_core(graph: DepGraph
              ) -> Tuple[np.ndarray, DepGraph]:
    """Kahn-peel the acyclic fringe (queue-based, O(V+E)): repeatedly
    strip in-degree-0 nodes, then out-degree-0 nodes on the remainder.
    Every cycle of every edge-type restriction survives (a subgraph
    cycle is a full-graph cycle). Returns ``(core_node_ids, core
    subgraph relabeled dense)`` — the dense device closure runs on the
    core when the full graph is past its envelope."""
    n = graph.n
    src = graph.src.astype(np.int64)
    dst = graph.dst.astype(np.int64)
    alive = np.ones(n, bool)
    for direction in range(2):
        s, d = (src, dst) if direction == 0 else (dst, src)
        indeg = np.zeros(n, np.int64)
        np.add.at(indeg, d, alive[s] & alive[d])
        # adjacency (forward for this direction) for queue propagation
        order = np.argsort(s, kind="stable")
        s_sorted, d_sorted = s[order], d[order]
        starts = np.searchsorted(s_sorted, np.arange(n + 1))
        q = deque(np.nonzero(alive & (indeg == 0))[0].tolist())
        while q:
            u = q.popleft()
            if not alive[u]:
                continue
            alive[u] = False
            for i in range(starts[u], starts[u + 1]):
                v = int(d_sorted[i])
                if alive[v]:
                    indeg[v] -= 1
                    if indeg[v] == 0:
                        q.append(v)
    core = np.nonzero(alive)[0]
    relabel = -np.ones(n, np.int64)
    relabel[core] = np.arange(len(core))
    keep = alive[src] & alive[dst]
    dt = idx_dtype(max(len(core), 1))
    sub = DepGraph(
        n=len(core),
        src=relabel[src[keep]].astype(dt),
        dst=relabel[dst[keep]].astype(dt),
        et=graph.et[keep],
        txns=tuple(graph.txns[int(i)] for i in core),
        direct=(), counters={})
    return core, sub

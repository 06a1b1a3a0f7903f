"""Fault injection — upstream ``jepsen/src/jepsen/nemesis.clj``.
A nemesis is a client on the logical process
``"nemesis"``: the generator sends it ``{"f": "start"/"stop"/...}`` info
ops and its ``invoke`` breaks (or heals) the system, completing the op
with a description of what it did.

Partition topologies, process pause/kill (hammer-time), clock scrambling,
and composition mirror the upstream menu one for one.
"""
from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from jepsen_tpu_torch import control
from jepsen_tpu_torch.client import Client
from jepsen_tpu_torch.net import net_for
from jepsen_tpu_torch.op import INFO, Op
from jepsen_tpu_torch.util import majority


class Nemesis(Client):
    """Base nemesis: a client that harms. Default invoke echoes."""

    def invoke(self, test: Mapping, op: Op) -> Op:
        return op.with_(type=INFO)


class Noop(Nemesis):
    """Does nothing (upstream ``nemesis/noop``)."""


def noop() -> Noop:
    return Noop()


# -- partitions ---------------------------------------------------------------

Grudge = Dict[str, List[str]]     # node -> nodes it cannot hear from


def complete_grudge(components: Sequence[Sequence[str]]) -> Grudge:
    """Nodes in different components cannot talk (upstream
    ``nemesis/complete-grudge``)."""
    grudge: Grudge = {}
    for comp in components:
        others = [n for c in components if c is not comp for n in c]
        for node in comp:
            grudge[node] = list(others)
    return grudge


def bisect(nodes: Sequence[str]) -> List[List[str]]:
    """Split nodes into two halves (upstream ``nemesis/bisect``); the
    second half holds the majority when odd."""
    mid = len(nodes) // 2
    return [list(nodes[:mid]), list(nodes[mid:])]


def split_one(nodes: Sequence[str],
              rng: Optional[random.Random] = None) -> List[List[str]]:
    """Isolate one random node (upstream ``nemesis/split-one``)."""
    rng = rng or random
    lucky = rng.choice(list(nodes))
    return [[lucky], [n for n in nodes if n != lucky]]


def bridge_grudge(nodes: Sequence[str]) -> Grudge:
    """Two halves joined only by a single bridge node (upstream
    ``nemesis/bridge``): classic scenario where a quorum intersection
    argument fails."""
    ns = list(nodes)
    mid = len(ns) // 2
    bridge, a, b = ns[mid], ns[:mid], ns[mid + 1:]
    grudge: Grudge = {}
    for n in a:
        grudge[n] = list(b)
    for n in b:
        grudge[n] = list(a)
    grudge[bridge] = []
    return grudge


def majorities_ring_grudge(nodes: Sequence[str],
                           rng: Optional[random.Random] = None) -> Grudge:
    """Every node sees a majority, but no two nodes see the same one
    (upstream ``nemesis/majorities-ring``): each node hears only from its
    ⌈n/2⌉ ring neighbours."""
    ns = list(nodes)
    if rng:
        rng.shuffle(ns)
    n = len(ns)
    keep = majority(n)                      # visible-set size incl. self
    grudge: Grudge = {}
    for i, node in enumerate(ns):
        visible = {ns[(i + d) % n]
                   for d in range(-((keep - 1) // 2), keep // 2 + 1)}
        grudge[node] = [m for m in ns if m not in visible]
    return grudge


class Partitioner(Nemesis):
    """Apply a grudge on ``start``, heal on ``stop`` (upstream
    ``nemesis/partitioner``). ``grudge_fn(nodes) -> Grudge``."""

    def __init__(self, grudge_fn: Callable[[Sequence[str]], Grudge],
                 seed: Optional[int] = None):
        self._grudge_fn = grudge_fn
        self._rng = random.Random(seed)

    def invoke(self, test, op):
        net = net_for(test)
        if op.f == "start":
            grudge = self._grudge_fn(list(test["nodes"]))
            for dst, srcs in grudge.items():
                for src in srcs:
                    net.drop(test, src, dst)
            return op.with_(type=INFO, value={"isolated": {
                k: sorted(v) for k, v in grudge.items() if v}})
        if op.f == "stop":
            net.heal(test)
            return op.with_(type=INFO, value="network healed")
        return op.with_(type=INFO)


def partitioner(grudge_fn: Callable[[Sequence[str]], Grudge]) -> Partitioner:
    return Partitioner(grudge_fn)


def partition_halves() -> Partitioner:
    """Deterministic half split (upstream ``nemesis/partition-halves``)."""
    return Partitioner(lambda nodes: complete_grudge(bisect(nodes)))


def partition_random_halves(seed: Optional[int] = None) -> Partitioner:
    """Random half split (upstream ``nemesis/partition-random-halves``)."""
    nem = Partitioner(None, seed)                       # type: ignore[arg-type]

    def grudge_fn(nodes: Sequence[str]) -> Grudge:
        ns = list(nodes)
        nem._rng.shuffle(ns)
        return complete_grudge(bisect(ns))

    nem._grudge_fn = grudge_fn
    return nem


def partition_random_node(seed: Optional[int] = None) -> Partitioner:
    """Isolate one random node (upstream
    ``nemesis/partition-random-node``)."""
    nem = Partitioner(None, seed)                       # type: ignore[arg-type]
    nem._grudge_fn = lambda nodes: complete_grudge(
        split_one(nodes, nem._rng))
    return nem


def bridge() -> Partitioner:
    """Bridge partition (upstream ``nemesis/bridge``)."""
    return Partitioner(bridge_grudge)


def partition_majorities_ring(seed: Optional[int] = None) -> Partitioner:
    """Intersecting-majorities ring (upstream
    ``nemesis/partition-majorities-ring``)."""
    nem = Partitioner(None, seed)                       # type: ignore[arg-type]
    nem._grudge_fn = lambda nodes: majorities_ring_grudge(nodes, nem._rng)
    return nem


# -- process faults -----------------------------------------------------------

class HammerTime(Nemesis):
    """SIGSTOP a targeted process on ``start``, SIGCONT on ``stop``
    (upstream ``nemesis/hammer-time``). ``targeter`` picks nodes from the
    test; default one random node."""

    def __init__(self, process_pattern: str,
                 targeter: Optional[Callable[[Mapping], List[str]]] = None,
                 seed: Optional[int] = None):
        self._pattern = process_pattern
        self._rng = random.Random(seed)
        self._targeter = targeter or (
            lambda test: [self._rng.choice(list(test["nodes"]))])
        self._stopped: List[str] = []

    def _signal(self, test: Mapping, node: str, sig: str) -> None:
        cluster = test.get("cluster")
        if cluster is not None:
            cluster.pause_node(node) if sig == "STOP" else \
                cluster.resume_node(node)
            return
        s = control.session(test, node).su()
        s.exec_raw(f"pkill -{sig} -f {self._pattern} || true")

    def invoke(self, test, op):
        if op.f == "start":
            self._stopped = self._targeter(test)
            for node in self._stopped:
                self._signal(test, node, "STOP")
            return op.with_(type=INFO, value={"paused": self._stopped})
        if op.f == "stop":
            nodes = self._stopped or list(test["nodes"])
            for node in nodes:
                self._signal(test, node, "CONT")
            self._stopped = []
            return op.with_(type=INFO, value={"resumed": nodes})
        return op.with_(type=INFO)


def hammer_time(process_pattern: str = "", **kw: Any) -> HammerTime:
    return HammerTime(process_pattern, **kw)


class NodeStartStopper(Nemesis):
    """Run ``stop_fn``/``start_fn`` (session, node) on targeted nodes
    (upstream ``nemesis/node-start-stopper``) — e.g. kill -9 the DB on
    start, restart it on stop."""

    def __init__(self, targeter: Callable[[Mapping], List[str]],
                 stop_fn: Callable, start_fn: Callable):
        self._targeter = targeter
        self._stop_fn = stop_fn
        self._start_fn = start_fn
        self._affected: List[str] = []

    def invoke(self, test, op):
        if op.f == "start":
            self._affected = list(self._targeter(test))
            for node in self._affected:
                self._stop_fn(control.session(test, node), node)
            return op.with_(type=INFO, value={"stopped": self._affected})
        if op.f == "stop":
            nodes = self._affected or list(test["nodes"])
            for node in nodes:
                self._start_fn(control.session(test, node), node)
            self._affected = []
            return op.with_(type=INFO, value={"started": nodes})
        return op.with_(type=INFO)


def node_start_stopper(targeter, stop_fn, start_fn) -> NodeStartStopper:
    return NodeStartStopper(targeter, stop_fn, start_fn)


class DBNemesis(Nemesis):
    """Kill/pause the DB via its own Process protocol
    (:class:`jepsen_tpu_torch.db.DB`) — the modern upstream ``nemesis/db-nemesis``
    shape; works against the fake cluster too."""

    def __init__(self, mode: str = "kill",
                 targeter: Optional[Callable[[Mapping], List[str]]] = None,
                 seed: Optional[int] = None):
        assert mode in ("kill", "pause")
        self._mode = mode
        self._rng = random.Random(seed)
        self._targeter = targeter or (
            lambda test: [self._rng.choice(list(test["nodes"]))])
        self._affected: List[str] = []

    def invoke(self, test, op):
        db = test.get("db")
        cluster = test.get("cluster")
        if op.f == "start":
            self._affected = self._targeter(test)
            for node in self._affected:
                if self._mode == "kill":
                    db.kill(test, node) if db else cluster.kill_node(node)
                else:
                    db.pause(test, node) if db else cluster.pause_node(node)
            return op.with_(type=INFO, value={self._mode: self._affected})
        if op.f == "stop":
            nodes = self._affected or list(test["nodes"])
            for node in nodes:
                if self._mode == "kill":
                    db.start(test, node) if db else cluster.start_node(node)
                else:
                    db.resume(test, node) if db else cluster.resume_node(node)
            self._affected = []
            return op.with_(type=INFO, value={"restarted": nodes})
        return op.with_(type=INFO)


# -- clock faults -------------------------------------------------------------

class ClockScrambler(Nemesis):
    """Jump targeted nodes' clocks by up to ±dt seconds (upstream
    ``nemesis/clock-scrambler``; the newer ``nemesis.time`` bump/strobe
    variants live in :func:`clock_nemesis`)."""

    def __init__(self, dt: float, seed: Optional[int] = None):
        self._dt = dt
        self._rng = random.Random(seed)

    def invoke(self, test, op):
        cluster = test.get("cluster")
        if op.f == "start":
            shifts = {}
            for node in test["nodes"]:
                shift = self._rng.uniform(-self._dt, self._dt)
                if cluster is not None:
                    shifts[node] = round(shift, 3)
                    cluster.bump_clock(node, shift)
                else:
                    # GNU date only accepts integral relative offsets
                    whole = int(shift) or (1 if shift > 0 else -1)
                    shifts[node] = whole
                    s = control.session(test, node).su()
                    s.exec_raw(f"date -s \"$(date -d '{whole} seconds')\"")
            return op.with_(type=INFO, value={"clock-shift-s": shifts})
        if op.f == "stop":
            for node in test["nodes"]:
                if cluster is not None:
                    cluster.bump_clock(node, None)
                else:
                    s = control.session(test, node).su()
                    s.exec_raw("ntpdate -p 1 -b pool.ntp.org || "
                               "chronyc -a makestep || true")
            return op.with_(type=INFO, value="clocks reset")
        return op.with_(type=INFO)


def clock_scrambler(dt: float = 60.0, seed: Optional[int] = None
                    ) -> ClockScrambler:
    return ClockScrambler(dt, seed=seed)


class ClockNemesis(Nemesis):
    """Precise clock faults via the compiled ``bump-time`` helper
    (upstream ``jepsen.nemesis.time`` + ``resources/bump-time.c``):
    ``{"f": "bump", "value": {node: ms}}`` jumps clocks by exact deltas;
    ``strobe`` flaps the clock; ``reset`` restores."""

    HELPER = "/opt/jepsen/bump-time"

    def install(self, test: Mapping) -> None:
        """Compile bump-time.c on every node (upstream
        ``nemesis.time/install!``)."""
        import os as _os
        src = _os.path.join(_os.path.dirname(__file__), "resources",
                            "bump_time.c")

        def fn(s: control.Session, node: str):
            s = s.su()
            s.exec("mkdir", "-p", "/opt/jepsen")
            s.upload(src, "/opt/jepsen/bump-time.c")
            s.exec("gcc", "-O2", "-o", self.HELPER,
                   "/opt/jepsen/bump-time.c")
        control.on_nodes(test, fn)

    def invoke(self, test, op):
        cluster = test.get("cluster")
        if op.f == "bump":
            for node, ms in (op.value or {}).items():
                if cluster is not None:
                    cluster.bump_clock(node, ms / 1000.0)
                else:
                    control.session(test, node).su().exec(
                        self.HELPER, "bump", str(ms))
            return op.with_(type=INFO)
        if op.f == "strobe":
            v = op.value or {}
            for node in v.get("nodes", test["nodes"]):
                if cluster is None:
                    control.session(test, node).su().exec(
                        self.HELPER, "strobe", str(v.get("delta-ms", 200)),
                        str(v.get("period-ms", 10)),
                        str(v.get("duration-ms", 1000)))
            return op.with_(type=INFO)
        if op.f == "reset":
            for node in test["nodes"]:
                if cluster is not None:
                    cluster.bump_clock(node, None)
                else:
                    control.session(test, node).su().exec(
                        self.HELPER, "reset")
            return op.with_(type=INFO)
        return op.with_(type=INFO)


def clock_nemesis() -> ClockNemesis:
    return ClockNemesis()


# -- composition --------------------------------------------------------------

class Compose(Nemesis):
    """Route ops to sub-nemeses by an ``f``-dispatch table (upstream
    ``nemesis/compose``): ``{("start", "stop"): partitioner, ...}`` or
    ``{\"partition-start\": (nem, \"start\"), ...}`` for renamed fs."""

    def __init__(self, table: Mapping[Any, Any]):
        self._routes: List[Tuple[Any, Nemesis, Optional[str]]] = []
        for key, nem in table.items():
            if isinstance(key, (tuple, frozenset, set)):
                for f in key:
                    self._routes.append((f, nem, None))
            elif isinstance(nem, tuple):
                inner, rename = nem
                self._routes.append((key, inner, rename))
            else:
                self._routes.append((key, nem, None))

    def _distinct(self) -> List[Nemesis]:
        return list({id(n): n for _, n, _ in self._routes}.values())

    def setup(self, test):
        for nem in self._distinct():
            nem.setup(test)

    def invoke(self, test, op):
        for f, nem, rename in self._routes:
            if op.f == f:
                if rename is not None:
                    res = nem.invoke(test, op.with_(f=rename))
                    return res.with_(f=op.f)
                return nem.invoke(test, op)
        return op.with_(type=INFO, value=f"no nemesis handles f={op.f!r}")

    def teardown(self, test):
        for nem in self._distinct():
            nem.teardown(test)


def compose(table: Mapping[Any, Any]) -> Compose:
    return Compose(table)

"""Grow-only-set suite — upstream ``elasticsearch/`` / ``mongodb/``-style
set workloads: clients ``add`` unique integers under a
partition nemesis, then a final ``read`` returns the set contents, checked
with ``jepsen.checker/set`` (no acknowledged add may be lost, nothing
never-attempted may appear).

Runs against :class:`~jepsen_tpu_torch.fake.cluster.FakeCluster`:
``mode="linearizable"`` must pass; ``mode="sloppy"`` replicates adds only
to reachable peers and never merges, so partitioned adds vanish from the
final read — the classic lost-updates result the checker must catch.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from jepsen_tpu_torch import client as cl
from jepsen_tpu_torch import generators as g
from jepsen_tpu_torch import nemesis, util
from jepsen_tpu_torch.suites import partition_cycle
from jepsen_tpu_torch.checkers import facade, perf, timeline
from jepsen_tpu_torch.fake import FakeCluster, Unavailable
from jepsen_tpu_torch.fake.cluster import FakeTimeout


class SetClient(cl.Client):
    def __init__(self, key: Any = "s"):
        self.key = key
        self.node: Any = None

    def open(self, test, node):
        c = type(self)(self.key)
        c.node = node
        return c

    def invoke(self, test, op):
        cluster: FakeCluster = test["cluster"]
        try:
            if op.f == "add":
                cluster.sadd(self.node, self.key, op.value)
                return cl.ok(op)
            if op.f == "read":
                res = cl.ok(op, cluster.sread(self.node, self.key))
                test["_set_read_ok"] = True     # final-read phase stops here
                return res
            raise ValueError(f"unknown f {op.f!r}")
        except Unavailable as e:
            return cl.fail(op, str(e))
        except FakeTimeout as e:
            return cl.info(op, str(e))


def set_test(mode: str = "linearizable", *, time_limit: float = 5.0,
             concurrency: int = 5, seed: Optional[int] = None,
             with_nemesis: bool = True, store: bool = False,
             nemesis_interval: float = 1.0, nodes: Any = 5,
             universe: Optional[int] = 12,
             device: Optional[str] = None) -> Dict[str, Any]:
    """``universe`` bounds the add workload to that many unique
    elements and composes a ``linear`` checker over the int-coded
    :func:`jepsen_tpu_torch.models.bounded_set` model — a memo-enumerable
    state space (<= 2**universe), so the set suite's history reaches
    the dense-walk device engines instead of only the host invariant
    checker. ``universe=None`` restores the
    unbounded workload with host-only checking. ``device`` is where the
    ``linear`` check runs (default: the card; ``"cpu"`` for the plain
    PyTorch versions)."""
    from jepsen_tpu_torch import models

    node_names = util.node_names(nodes)
    cluster = FakeCluster(node_names, mode=mode, seed=seed)
    adds: g.GenLike = g.TimeLimit(
        time_limit, g.Stagger(0.001, g.unique_values("add"), seed=seed))
    if universe is not None:
        # unique_values counts 0,1,2,...: capping the COUNT at the
        # universe also caps every VALUE inside it
        adds = g.Limit(universe, adds)
    # Final reads retry (paced) until one succeeds — a fixed attempt
    # budget could be consumed entirely by a not-yet-healed partition,
    # turning a healthy run into {"valid": "unknown"}. The barrier makes
    # every worker finish its in-flight add before any read fires
    # (upstream gen/phases + gen/synchronize) — without it the last adds
    # race the read and show up as spurious "lost" elements. The
    # once-sleep is only a grace pause for the nemesis's final heal; the
    # run-time-limit bounds the retry loop if the cluster never heals.
    final_reads = g.synchronize(g.Seq(
        [{"sleep": 0.3},
         g.Stagger(0.02, g.Fn(
             lambda test, process: {"f": "read", "value": None}
             if not test.get("_set_read_ok") else None))]))
    client_seq = g.Seq([adds, final_reads])
    nem: Optional[nemesis.Nemesis] = None
    if with_nemesis:
        nem = nemesis.partition_random_halves(seed=seed)
        generator: g.GenLike = g.clients_gen(
            client_seq, partition_cycle(time_limit, nemesis_interval,
                                        seed=seed))
    else:
        generator = g.clients_gen(client_seq)
    return {
        "name": f"set-{mode}",
        "nodes": node_names,
        "cluster": cluster,
        "client": SetClient(),
        "nemesis": nem,
        "generator": generator,
        "checker": facade.compose({
            "set": facade.set_checker(),
            **({"linear": facade.Linearizable(
                    models.bounded_set(universe), device=device)}
               if universe is not None else {}),
            "timeline": timeline.html(),
            "latency": perf.latency_graph(),
            "rate": perf.rate_graph(),
            "stats": facade.stats(),
        }),
        "concurrency": concurrency,
        "device": device,
        "store": store,
        "run-time-limit": max(60.0, time_limit * 6),
        "op-timeout": 5.0,
    }

"""Counter suite — upstream etcd/zookeeper counter workloads:
concurrent ``add`` deltas and ``read`` observations, checked with
``jepsen.checker/counter`` (every ok read must lie inside the interval of
possible counter values given which adds had definitely / possibly taken
effect).

Runs against :class:`~jepsen_tpu_torch.fake.cluster.FakeCluster`:
``mode="linearizable"`` must pass; ``mode="sloppy"`` replicates the
post-increment VALUE last-writer-wins, so concurrent increments clobber
each other and reads drift below the definite sum — caught by the
checker.
"""
from __future__ import annotations

import random
from typing import Any, Dict, Optional

from jepsen_tpu_torch import client as cl
from jepsen_tpu_torch import generators as g
from jepsen_tpu_torch import nemesis, util
from jepsen_tpu_torch.suites import partition_cycle
from jepsen_tpu_torch.checkers import facade, perf, timeline
from jepsen_tpu_torch.fake import FakeCluster, Unavailable
from jepsen_tpu_torch.fake.cluster import FakeTimeout


class CounterClient(cl.Client):
    def __init__(self, key: Any = "c"):
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
                cluster.incr(self.node, self.key, op.value)
                return cl.ok(op)
            if op.f == "read":
                return cl.ok(op, cluster.read(self.node, self.key) or 0)
            raise ValueError(f"unknown f {op.f!r}")
        except Unavailable as e:
            return cl.fail(op, str(e))
        except FakeTimeout as e:
            return cl.info(op, str(e))


def workload(hi: int = 5, seed: Optional[int] = None) -> g.Generator:
    rng = random.Random(seed)
    return g.mix(g.Fn(lambda: {"f": "add", "value": rng.randint(1, hi)}),
                 g.Fn(lambda: {"f": "read", "value": None}), seed=seed)


def counter_test(mode: str = "linearizable", *, time_limit: float = 5.0,
                 concurrency: int = 5, seed: Optional[int] = None,
                 with_nemesis: bool = True, store: bool = False,
                 nemesis_interval: float = 1.0,
                 nodes: Any = 5,
                 device: Optional[str] = None) -> Dict[str, Any]:
    """The counter's check is host work; ``device`` (default: the card)
    goes into the test map as every suite's does, so a run without a
    card fails before any op."""
    node_names = util.node_names(nodes)
    cluster = FakeCluster(node_names, mode=mode, seed=seed)
    main = g.TimeLimit(time_limit,
                       g.Stagger(0.001, workload(seed=seed), seed=seed))
    # final reads after a barrier (every in-flight add completed first);
    # the once-sleep is only a grace pause for the nemesis's final heal —
    # correctness does not depend on its timing: quorum reads are valid
    # pre-heal too, and minority-side reads fail cleanly (the checker
    # scores ok reads only)
    client_seq = g.Seq([main, g.synchronize(g.Seq(
        [{"sleep": 0.3},
         g.Limit(concurrency,
                 g.Fn(lambda: {"f": "read", "value": None}))]))])
    nem: Optional[nemesis.Nemesis] = None
    if with_nemesis:
        nem = nemesis.partition_random_halves(seed=seed)
        generator: g.GenLike = g.clients_gen(
            client_seq, partition_cycle(time_limit, nemesis_interval,
                                        seed=seed))
    else:
        generator = g.clients_gen(client_seq)
    return {
        "name": f"counter-{mode}",
        "nodes": node_names,
        "cluster": cluster,
        "client": CounterClient(),
        "nemesis": nem,
        "generator": generator,
        "checker": facade.compose({
            "counter": facade.counter(),
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

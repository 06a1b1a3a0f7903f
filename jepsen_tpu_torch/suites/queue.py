"""RabbitMQ-style queue suite — upstream ``rabbitmq/``:
unique-value ``enqueue``/``dequeue`` ops against a replicated broker, a
partition nemesis, then a full drain phase, checked with
``jepsen.checker/queue`` (no phantom deliveries) and ``total-queue``
(every acknowledged enqueue consumed exactly once).

Runs against the in-proc :class:`~jepsen_tpu_torch.fake.broker.FakeBroker`:
``mode="safe"`` must pass; ``mode="lossy"`` autoheals by discarding one
partition side's state and must be caught.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from jepsen_tpu_torch import client as cl
from jepsen_tpu_torch import generators as g
from jepsen_tpu_torch import nemesis, util
from jepsen_tpu_torch.suites import partition_cycle
from jepsen_tpu_torch.checkers import facade, perf, timeline
from jepsen_tpu_torch.fake.broker import (Empty, FakeBroker, FakeTimeout,
                                          Unavailable)


class QueueClient(cl.Client):
    def __init__(self):
        self.node: Any = None

    def open(self, test, node):
        c = type(self)()
        c.node = node
        return c

    def invoke(self, test, op):
        broker: FakeBroker = test["cluster"]
        try:
            if op.f == "enqueue":
                broker.enqueue(self.node, op.value)
                return cl.ok(op)
            if op.f == "dequeue":
                return cl.ok(op, broker.dequeue(self.node))
            raise ValueError(f"unknown f {op.f!r}")
        except Empty as e:
            return cl.fail(op, str(e))
        except Unavailable as e:
            return cl.fail(op, str(e))
        except FakeTimeout as e:
            return cl.info(op, str(e))


def workload(seed: Optional[int] = None,
             enqueue_weight: int = 1,
             universe: Optional[int] = None) -> g.Generator:
    """Enqueue (unique ints) / dequeue mix; ``enqueue_weight`` > 1 biases
    toward enqueues so the queue keeps a backlog (useful for tests that
    need messages pending when a fault lands). ``universe`` caps the
    number of enqueues — unique_values counts 0,1,2,..., so capping the
    COUNT also caps every value inside the bounded-queue model's
    universe (the set suite's trick)."""
    enq: g.GenLike = g.unique_values("enqueue")
    if universe is not None:
        enq = g.Limit(universe, enq)
    deq = g.Fn(lambda: {"f": "dequeue", "value": None})
    return g.mix(*([enq] * max(1, enqueue_weight) + [deq]), seed=seed)


def _drain() -> g.Generator:
    """Dequeue until every replica is empty (the upstream ``:drain``
    phase); exhausts when nothing is left anywhere."""
    return g.Fn(lambda test, process:
                {"f": "dequeue", "value": None}
                if not test["cluster"].empty() else None)


def queue_test(mode: str = "safe", *, time_limit: float = 5.0,
               concurrency: int = 5, seed: Optional[int] = None,
               with_nemesis: bool = True, store: bool = False,
               nemesis_interval: float = 1.0,
               enqueue_weight: int = 1, nodes: Any = 5,
               universe: Optional[int] = None,
               device: Optional[str] = None) -> Dict[str, Any]:
    """``universe`` bounds the enqueue workload to that many unique
    values and composes a ``linear`` checker over the int-coded
    :func:`jepsen_tpu_torch.models.bounded_queue` model — a memo-enumerable
    state space (the arrangements of distinct pending values), so the
    queue suite's history reaches the dense-walk device engines
    instead of only the host queue invariants. Opt-in (default ``None``, the unbounded
    workload with host-only checking): capping the enqueue COUNT
    changes backlog dynamics, so faults that need a deep backlog —
    the lossy-autoheal scenario — keep the unbounded mix. ``device`` is
    where the ``linear`` check runs (default: the card; ``"cpu"`` for
    the plain PyTorch versions)."""
    from jepsen_tpu_torch import models

    node_names = util.node_names(nodes)
    broker = FakeBroker(node_names, mode=mode, seed=seed)
    wl = workload(seed=seed, enqueue_weight=enqueue_weight,
                  universe=universe)
    main = g.TimeLimit(time_limit, g.Stagger(0.001, wl, seed=seed))
    # each role runs its own phase sequence: clients mix, then drain; the
    # nemesis cycles faults for the mix window, then heals once and
    # exhausts. The barrier makes every worker finish its in-flight
    # enqueue before the drain's empty() poll can observe a transiently-
    # empty queue and stop early. (The once-sleep is a grace pause for
    # the nemesis's final heal, not a guarantee — drain correctness does
    # not depend on it: pre-heal drain ops just fail cleanly and the
    # stagger paces the retries.)
    client_seq = g.Seq([main, g.synchronize(g.Seq(
        [{"sleep": 0.3}, g.Stagger(0.001, _drain(), seed=seed)]))])
    nem: Optional[nemesis.Nemesis] = None
    if with_nemesis:
        nem = nemesis.partition_random_halves(seed=seed)
        generator: g.GenLike = g.clients_gen(
            client_seq, partition_cycle(time_limit, nemesis_interval,
                                        seed=seed))
    else:
        generator = g.clients_gen(client_seq)
    return {
        "name": f"queue-{mode}",
        "nodes": node_names,
        "cluster": broker,
        "client": QueueClient(),
        "nemesis": nem,
        "generator": generator,
        "checker": facade.compose({
            "queue": facade.queue(),
            "total-queue": facade.total_queue(),
            **({"linear": facade.Linearizable(
                    models.bounded_queue(universe), device=device)}
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

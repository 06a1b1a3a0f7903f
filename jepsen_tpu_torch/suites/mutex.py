"""ZooKeeper-style lock suite — upstream ``zookeeper/``:
acquire/release ops on a distributed lock, checked against the ``mutex``
model.

The client keeps per-process hold state and emits alternating
acquire/release attempts: a rejected try-acquire is a ``fail`` op
(stripped by the checker), so only successful transitions reach the
model — the same shape the upstream lock workload produces.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from jepsen_tpu_torch import client as cl
from jepsen_tpu_torch import generators as g
from jepsen_tpu_torch import models, nemesis, util
from jepsen_tpu_torch.checkers import facade, timeline
from jepsen_tpu_torch.fake.cluster import FakeTimeout, Unavailable
from jepsen_tpu_torch.fake.lock import FakeLockService


class LockClient(cl.Client):
    def __init__(self, name: Any = "lock"):
        self.name = name
        self.node: Any = None
        self.held = False

    def open(self, test, node):
        c = type(self)(self.name)
        c.node = node
        return c

    def invoke(self, test, op):
        svc: FakeLockService = test["cluster"]
        holder = op.process
        try:
            if op.f == "acquire":
                if svc.acquire(self.node, self.name, holder):
                    self.held = True
                    return cl.ok(op)
                return cl.fail(op, "lock held")
            if op.f == "release":
                if svc.release(self.node, self.name, holder):
                    self.held = False
                    return cl.ok(op)
                return cl.fail(op, "not the holder")
            raise ValueError(f"unknown f {op.f!r}")
        except Unavailable as e:
            return cl.fail(op, str(e))
        except FakeTimeout as e:
            # an indeterminate acquire/release may have taken effect; the
            # client no longer knows its hold state — drop the belief so
            # the generator keeps making progress either way
            self.held = False
            return cl.info(op, str(e))


class LockWorkload(g.Generator):
    """Alternating acquire/release per process, driven by each worker's
    *observed* completions: after a successful acquire, try release; else
    try acquire. State is tracked via the client's ``held`` flag exposed
    in the test map (simplest faithful analogue of the upstream
    ``gen/each`` lock generator)."""

    def __init__(self):
        self._held: Dict[Any, bool] = {}

    def op(self, test, process):
        # the worker records outcomes in test["_lock_held"]; emitting
        # based on our own bookkeeping of invocations would desync on
        # fail ops, so consult the client-side state when present
        held = test.get("_lock_held", {}).get(process, False)
        return {"f": "release" if held else "acquire", "value": None}


class TrackingLockClient(LockClient):
    """LockClient that mirrors hold state into the test map so the
    workload generator can alternate correctly."""

    def invoke(self, test, op):
        res = super().invoke(test, op)
        test.setdefault("_lock_held", {})[op.process] = self.held
        return res


def mutex_test(mode: str = "linearizable", *, time_limit: float = 5.0,
               concurrency: int = 5, seed: Optional[int] = None,
               with_nemesis: bool = True, store: bool = False,
               nemesis_interval: float = 0.5, lease_ttl: float = 30.0,
               algorithm: str = "auto", nodes: Any = 5,
               device: Optional[str] = None) -> Dict[str, Any]:
    """Modes: ``linearizable`` (safe), ``sloppy`` (split-brain grants,
    caught via partitions), ``leases`` (lease-based lock — safe under
    synchronized clocks, broken by clock skew: the nemesis becomes
    :func:`jepsen_tpu_torch.nemesis.clock_nemesis` bumping one node's clock
    past the TTL each cycle, the canonical ``bump-time`` fault).
    ``device`` is where the linearizability check runs (default: the
    card; ``"cpu"`` for the plain PyTorch versions)."""
    import random as _random

    node_names = util.node_names(nodes)
    svc = FakeLockService(node_names, mode=mode, seed=seed,
                          lease_ttl=lease_ttl)
    client_gen = g.TimeLimit(time_limit, g.Stagger(0.001, LockWorkload(),
                                                   seed=seed))
    nem: Optional[nemesis.Nemesis] = None
    generator: g.GenLike = client_gen
    if with_nemesis and mode == "leases":
        # clock-fault nemesis: bump a random node far past the lease
        # TTL, later reset — while bumped, that node judges every lease
        # expired and double-grants
        nem = nemesis.clock_nemesis()
        rng = _random.Random(seed)
        bump_ms = int(lease_ttl * 2000)

        def _cycle():
            node = rng.choice(node_names)
            return g.Seq([{"f": "bump", "value": {node: bump_ms}},
                          {"sleep": nemesis_interval},
                          {"f": "reset"},
                          {"sleep": nemesis_interval}])

        generator = g.clients_gen(client_gen, g.cycle(_cycle))
    elif with_nemesis:
        nem = nemesis.partition_random_halves(seed=seed)
        generator = g.clients_gen(client_gen, g.cycle(lambda: g.Seq(
            [{"f": "start"}, {"sleep": nemesis_interval},
             {"f": "stop"}, {"sleep": nemesis_interval}])))
    return {
        "name": f"mutex-{mode}",
        "nodes": node_names,
        "cluster": svc,
        "client": TrackingLockClient(),
        "nemesis": nem,
        "generator": generator,
        "model": models.mutex(),
        "checker": facade.compose({
            "linear": facade.Linearizable(models.mutex(),
                                          algorithm=algorithm,
                                          device=device),
            "timeline": timeline.html(),
            "stats": facade.stats(),
        }),
        "concurrency": concurrency,
        "device": device,
        "store": store,
        "run-time-limit": max(60.0, time_limit * 6),
        "op-timeout": 5.0,
    }

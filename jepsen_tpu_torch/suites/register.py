"""Etcd-style CAS-register suite — upstream ``etcd/``:
read/write/cas ops on a single register (or many independent ones),
partitions from the nemesis, linearizability checking with the
``cas_register`` model.

Runs against the in-proc :class:`~jepsen_tpu_torch.fake.cluster.FakeCluster`
by default (``mode="linearizable"`` should pass; ``mode="sloppy"`` should
fail — both asserted by the E2E tests). Pass a real client for a real
system. The workload is host Python; the check at the end runs on the
card unless ``device="cpu"`` is given.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from jepsen_tpu_torch import client as cl
from jepsen_tpu_torch import generators as g
from jepsen_tpu_torch import independent, models, nemesis, util
from jepsen_tpu_torch.suites import _common
from jepsen_tpu_torch.checkers import facade
from jepsen_tpu_torch.fake import FakeCluster, Unavailable
from jepsen_tpu_torch.fake.cluster import FakeTimeout
from jepsen_tpu_torch.op import OK, Op


class KVClient(cl.Client):
    """Client for the fake cluster's KV API; the value convention matches
    the upstream etcd suite: ``read -> value``, ``write value``,
    ``cas [old, new]``. With ``key=None``, values are ``[k, v]``
    independent tuples."""

    def __init__(self, key: Any = "r"):
        self.key = key
        self.node: Any = None

    def open(self, test, node):
        c = type(self)(self.key)
        c.node = node
        return c

    def _call(self, cluster: FakeCluster, key: Any, op: Op):
        if op.f == "read":
            # the value read, None included: ``cl.ok`` would keep the
            # invocation's value for an unwritten key, which is ``[k,
            # None]`` for an independent op
            return op.with_(type=OK, value=cluster.read(self.node, key))
        if op.f == "write":
            cluster.write(self.node, key, op.value if self.key is not None
                          else op.value[1])
            return cl.ok(op)
        if op.f == "cas":
            old, new = op.value if self.key is not None else op.value[1]
            if cluster.cas(self.node, key, old, new):
                return cl.ok(op)
            return cl.fail(op, "cas mismatch")
        raise ValueError(f"unknown f {op.f!r}")

    def invoke(self, test, op):
        cluster: FakeCluster = test["cluster"]
        if self.key is not None:
            key, value = self.key, op.value
        else:                                   # independent [k, v] tuple
            key, value = op.value[0], op.value[1]
        try:
            res = self._call(cluster, key, op)
            if self.key is None and res.type == "ok" and op.f == "read":
                res = res.with_(value=[key, res.value])
            return res
        except Unavailable as e:
            return cl.fail(op, str(e))
        except FakeTimeout as e:
            return cl.info(op, str(e))


def workload(hi: int = 5, seed: Optional[int] = None) -> g.Generator:
    """The classic r/w/cas mix (shared stock workload)."""
    return g.register_workload(hi=hi, seed=seed)


def register_test(mode: str = "linearizable", *,
                  time_limit: float = 5.0, n_ops: Optional[int] = None,
                  concurrency: int = 5, seed: Optional[int] = None,
                  nodes: Any = 5, algorithm: str = "auto",
                  with_nemesis: bool = True, store: bool = False,
                  nemesis_interval: float = 1.0,
                  device: Optional[str] = None) -> Dict[str, Any]:
    """Build the test map (upstream ``etcd/src/.../runner.clj``'s
    ``tests`` fn). ``nodes``: a count or explicit node names. ``device``
    is where the linearizability check runs (default: the card)."""
    node_names = util.node_names(nodes)
    cluster = FakeCluster(node_names, mode=mode, seed=seed)
    client_gen: g.GenLike = g.Stagger(0.001, workload(seed=seed), seed=seed)
    if n_ops is not None:
        client_gen = g.Limit(n_ops, client_gen)
    else:
        client_gen = g.TimeLimit(time_limit, client_gen)
    nem: Optional[nemesis.Nemesis] = None
    generator: g.GenLike = client_gen
    if with_nemesis:
        nem = nemesis.partition_random_halves(seed=seed)
        generator = _common.nemesis_schedule(client_gen, nemesis_interval)
    return {
        "name": f"register-{mode}",
        "nodes": node_names,
        "cluster": cluster,
        "client": KVClient("r"),
        "nemesis": nem,
        "generator": generator,
        "model": models.cas_register(),
        "checker": _common.standard_checker(models.cas_register(),
                                            algorithm=algorithm,
                                            device=device),
        "concurrency": concurrency,
        "device": device,
        "store": store,
        "run-time-limit": max(60.0, time_limit * 6),
        "op-timeout": 5.0,
    }


def independent_test(mode: str = "linearizable", *, keys: int = 8,
                     ops_per_key: int = 50, concurrency: int = 8,
                     seed: Optional[int] = None, store: bool = False,
                     with_nemesis: bool = False,
                     device: Optional[str] = None) -> Dict[str, Any]:
    """Multi-key variant (upstream independent/concurrent-generator usage):
    the checker fans per-key sub-histories into one batched device call
    (on the card unless ``device="cpu"``)."""
    node_names = [f"n{i + 1}" for i in range(5)]
    cluster = FakeCluster(node_names, mode=mode, seed=seed)
    gen_keys = g.concurrent_generator(
        max(1, concurrency // 2), (f"k{i}" for i in range(keys)),
        lambda key: g.Limit(ops_per_key, workload(seed=seed)))
    nem = nemesis.partition_random_halves(seed=seed) if with_nemesis else None
    generator: g.GenLike = gen_keys
    if with_nemesis:
        generator = g.clients_gen(gen_keys, g.cycle(lambda: g.Seq(
            [{"f": "start"}, {"sleep": 0.5}, {"f": "stop"},
             {"sleep": 0.5}])))
    return {
        "name": f"register-independent-{mode}",
        "nodes": node_names,
        "cluster": cluster,
        "client": KVClient(None),
        "nemesis": nem,
        "generator": generator,
        "model": models.cas_register(),
        "checker": independent.checker(
            facade.Linearizable(models.cas_register(), device=device)),
        "concurrency": concurrency,
        "device": device,
        "store": store,
        "run-time-limit": 120.0,
        "op-timeout": 5.0,
    }

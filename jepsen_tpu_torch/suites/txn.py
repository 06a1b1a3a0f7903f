"""Transactional list-append suite — the Elle workload (upstream
``jepsen.tests.cycle.append``) against three tiers:

- ``tier="fake"``  — multi-key transactions through
  :meth:`jepsen_tpu_torch.fake.FakeCluster.txn`: safe mode commits the whole
  txn atomically (histories serializable by construction, the
  :class:`~jepsen_tpu_torch.txn.TxnChecker` must agree); sloppy mode applies
  micro-ops to local replicas with last-writer-wins replication, so
  partitioned appends clobber whole lists — genuine Elle anomalies.
- ``tier="etcd"``  — single-key transactions over the etcd-v2 HTTP
  dialect (:mod:`jepsen_tpu_torch.fake.httpd` front-ends, or real etcd v2
  endpoints): the txn commits as ONE compare-and-swap of the encoded
  list (reads observe the snapshot the CAS validated — atomic at the
  CAS point), retried on compare failure.
- ``tier="redis"`` — the same CAS-commit discipline over RESP
  (:mod:`jepsen_tpu_torch.fake.resp`), using the canonical EVAL
  compare-and-set script.

Lists cross the CAS tiers encoded ``"L<v1>,<v2>,..."`` (the ``L``
prefix keeps the empty list a non-blank form value — etcd's
``parse_qs`` would otherwise drop an empty ``prevValue`` and turn the
CAS into a blind write).
"""
from __future__ import annotations

import urllib.error
import urllib.parse
import urllib.request
import socket
from typing import Any, Dict, List, Optional, Sequence

from jepsen_tpu_torch import client as cl
from jepsen_tpu_torch import generators as g
from jepsen_tpu_torch import nemesis, txn as txn_mod, util
from jepsen_tpu_torch.checkers import facade, perf, timeline
from jepsen_tpu_torch.fake import FakeCluster, Unavailable
from jepsen_tpu_torch.fake.cluster import FakeTimeout
from jepsen_tpu_torch.op import Op
from jepsen_tpu_torch.suites import partition_cycle
from jepsen_tpu_torch.suites.etcd import FakeEtcdDB
from jepsen_tpu_torch.fake.resp import CAS_SCRIPT
from jepsen_tpu_torch.suites.redis import FakeRedisDB, RespClient


def encode_list(vals: Sequence[Any]) -> str:
    return "L" + ",".join(str(v) for v in vals)


def decode_list(s: Optional[str]) -> List[int]:
    if not s or s == "L":
        return []
    body = s[1:] if s.startswith("L") else s
    return [int(x) for x in body.split(",")]


class FakeTxnClient(cl.Client):
    """Multi-key atomic transactions against the fake cluster."""

    def __init__(self) -> None:
        self.node: Any = None

    def open(self, test, node):
        c = type(self)()
        c.node = node
        return c

    def invoke(self, test, op: Op) -> Op:
        cluster: FakeCluster = test["cluster"]
        try:
            return cl.ok(op, cluster.txn(self.node, op.value))
        except Unavailable as e:
            return cl.fail(op, str(e))
        except FakeTimeout as e:
            return cl.info(op, str(e))


class _CasTxnClient(cl.Client):
    """Single-key list-append transactions committed as one
    compare-and-swap of the encoded list: read the current encoding,
    apply every micro-op (reads observe the snapshot plus the txn's
    own earlier appends — a prefix of the committed list), CAS
    old→new. Compare failure = definite no effect → retry; retries
    exhausted → ``fail``; indeterminate transport outcomes → ``info``
    immediately (a retry after a maybe-applied CAS could double-append
    and poison traceability)."""

    retries = 8

    # -- tier transport hooks -------------------------------------------
    def _get_enc(self, key: str) -> str:
        raise NotImplementedError

    def _cas_enc(self, key: str, old: str, new: str) -> bool:
        raise NotImplementedError

    def _invoke_txn(self, op: Op) -> Op:
        micros = op.value
        appends = any(m[0] == "append" for m in micros)
        for _attempt in range(self.retries):
            old = self._get_enc(self._storage_key(micros))
            state = decode_list(old)
            result = []
            for kind, k, v in micros:
                if kind == "append":
                    state.append(v)
                    result.append(["append", k, v])
                else:
                    result.append(["r", k, list(state)])
            if not appends:
                # a read-only single-key txn is one atomic GET
                return cl.ok(op, result)
            if self._cas_enc(self._storage_key(micros), old,
                             encode_list(state)):
                return cl.ok(op, result)
        return cl.fail(op, "cas contention")

    @staticmethod
    def _storage_key(micros) -> str:
        return str(micros[0][1])


class EtcdTxnClient(_CasTxnClient):
    """The etcd-v2 HTTP tier (``test["endpoints"]`` maps node → base
    URL — the fake front-ends by default, real etcd v2 if pointed
    there)."""

    def __init__(self, timeout_s: float = 1.0):
        self.timeout_s = timeout_s
        self.base: Optional[str] = None

    def open(self, test, node):
        c = type(self)(self.timeout_s)
        c.base = test["endpoints"][node]
        return c

    def _url(self, key: str) -> str:
        return f"{self.base}/v2/keys/{urllib.parse.quote(key)}"

    def _request(self, key: str, method: str,
                 form: Optional[Dict[str, str]] = None):
        import json
        data = urllib.parse.urlencode(form).encode() if form else None
        req = urllib.request.Request(self._url(key), data=data,
                                     method=method)
        if data:
            req.add_header("Content-Type",
                           "application/x-www-form-urlencoded")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.status, json.loads(resp.read().decode())

    def _get_enc(self, key: str) -> str:
        try:
            _, body = self._request(key, "GET")
            return str(body["node"]["value"])
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return "L"                       # unset key = empty list
            raise

    def _cas_enc(self, key: str, old: str, new: str) -> bool:
        try:
            self._request(key, "PUT", {"value": new, "prevValue": old})
            return True
        except urllib.error.HTTPError as e:
            if e.code in (404, 412):             # definite compare miss
                return False
            raise

    def invoke(self, test, op: Op) -> Op:
        try:
            return self._invoke_txn(op)
        except urllib.error.HTTPError as e:
            if e.code == 503:
                return cl.fail(op, "node unavailable")
            return cl.info(op, f"http {e.code}")
        except (urllib.error.URLError, socket.timeout, TimeoutError,
                ConnectionError) as e:
            if isinstance(getattr(e, "reason", None),
                          ConnectionRefusedError):
                return cl.fail(op, "connection refused")
            return cl.info(op, type(e).__name__)


class RedisTxnClient(RespClient, _CasTxnClient):
    """The RESP tier: GET + the EVAL compare-and-set script commit the
    encoded list atomically (the transport/completion mapping —
    CLUSTERDOWN → fail, timeouts → info — rides
    :class:`~jepsen_tpu_torch.suites.redis.RespClient`)."""

    retries = _CasTxnClient.retries

    def _get_enc(self, key: str) -> str:
        v = self._command("GET", key)
        return "L" if v is None else str(v)

    def _cas_enc(self, key: str, old: str, new: str) -> bool:
        return self._command("EVAL", CAS_SCRIPT, "1", key, old,
                             new) == 1

    def _invoke(self, op: Op) -> Op:
        # RespClient.invoke supplies the error mapping; the op body is
        # the CAS-commit txn instead of the register verbs
        return self._invoke_txn(op)


def txn_test(mode: str = "linearizable", *, tier: str = "fake",
             keys: int = 4, max_len: int = 4, read_p: float = 0.5,
             time_limit: float = 5.0, concurrency: int = 5,
             seed: Optional[int] = None, with_nemesis: bool = True,
             nemesis_interval: float = 1.0, store: bool = False,
             nodes: Any = 5,
             device: Optional[str] = None) -> Dict[str, Any]:
    """The list-append test over ``tier`` (fake, etcd or redis).
    ``device`` is where the txn check runs (default: the card;
    ``"cpu"`` for the plain PyTorch versions)."""
    node_names = util.node_names(nodes)
    cluster = FakeCluster(node_names, mode=mode, seed=seed)
    single_key = tier != "fake"
    workload = g.TimeLimit(
        time_limit,
        g.Stagger(0.002, g.txn_workload(keys=keys, max_len=max_len,
                                        read_p=read_p, seed=seed,
                                        single_key=single_key),
                  seed=seed))
    test: Dict[str, Any] = {
        "name": f"txn-{tier}-{mode}",
        "nodes": node_names,
        "cluster": cluster,
        "checker": facade.compose({
            "txn": txn_mod.TxnChecker(opts={"device": device}),
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
    if tier == "fake":
        test["client"] = FakeTxnClient()
    elif tier == "etcd":
        test["client"] = EtcdTxnClient()
        test["db"] = FakeEtcdDB(cluster)
    elif tier == "redis":
        test["client"] = RedisTxnClient()
        test["db"] = FakeRedisDB(cluster)
    else:
        raise ValueError(f"unknown tier {tier!r}")
    if tier != "fake":
        # seed every workload key with the encoded empty list so the
        # first CAS has a concrete prevValue (see encode_list)
        for i in range(keys):
            cluster.write(node_names[0], f"t{i}", encode_list([]))
    nem: Optional[nemesis.Nemesis] = None
    generator: g.GenLike = g.clients_gen(workload)
    if with_nemesis:
        nem = nemesis.partition_random_halves(seed=seed)
        generator = g.clients_gen(
            workload, partition_cycle(time_limit, nemesis_interval,
                                      seed=seed))
    test["nemesis"] = nem
    test["generator"] = generator
    return test

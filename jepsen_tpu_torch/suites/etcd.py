"""Etcd suite over HTTP — upstream ``etcd/``, which
drives etcd's v2 REST API (``GET/PUT /v2/keys/<k>``, CAS via
``prevValue``) and checks the history against the ``cas_register``
model.

Unlike :mod:`jepsen_tpu_torch.suites.register` (direct in-proc calls), this
suite speaks the REAL wire protocol: :class:`EtcdHttpClient` is a plain
urllib HTTP client, and by default the test boots one
etcd-v2-dialect server per node (:class:`jepsen_tpu_torch.fake.httpd
.HttpKVFrontend`, backed by the fake cluster so nemesis faults surface
as genuine 503s and socket timeouts) through the DB protocol —
the same lifecycle a real etcd would use. Point ``endpoints`` at real
etcd v2 URLs and the identical client/checker pipeline applies.

Completion mapping (the part upstream gets subtly right and tests):

- 2xx        → :ok
- 404        → :ok read of nil (key unset)
- 412        → :fail (CAS compare failed — definitely no effect)
- 503        → :fail (node refused — definitely no effect)
- timeout/5xx→ :info (indeterminate — may or may not have taken effect)
"""
from __future__ import annotations

import json
import socket
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Optional

from jepsen_tpu_torch import client as cl
from jepsen_tpu_torch import db as db_mod
from jepsen_tpu_torch import generators as g
from jepsen_tpu_torch import models, nemesis, util
from jepsen_tpu_torch.fake import FakeCluster
from jepsen_tpu_torch.fake.httpd import HttpKVFrontend
from jepsen_tpu_torch.op import Op
from jepsen_tpu_torch.suites._common import nemesis_schedule, standard_checker


class EtcdHttpClient(cl.Client):
    """urllib client for the etcd v2 keys API. ``test["endpoints"]`` maps
    node → base URL (set up by :class:`FakeEtcdDB`, or by hand for a real
    cluster)."""

    def __init__(self, key: str = "r", timeout_s: float = 1.0):
        self.key = key
        self.timeout_s = timeout_s
        self.base: Optional[str] = None

    def open(self, test, node):
        c = type(self)(self.key, self.timeout_s)
        c.base = test["endpoints"][node]
        return c

    def _url(self) -> str:
        return f"{self.base}/v2/keys/{urllib.parse.quote(self.key)}"

    def _request(self, method: str, form: Optional[Dict[str, str]] = None):
        data = urllib.parse.urlencode(form).encode() if form else None
        req = urllib.request.Request(self._url(), data=data, method=method)
        if data:
            req.add_header("Content-Type",
                           "application/x-www-form-urlencoded")
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.status, json.loads(resp.read().decode())

    def invoke(self, test, op: Op) -> Op:
        try:
            return self._invoke(op)
        except urllib.error.HTTPError as e:
            if e.code == 404 and op.f == "read":
                return cl.ok(op, None)          # unset key reads nil
            if e.code == 404 and op.f == "cas":
                return cl.fail(op, "key not found")     # no effect
            if e.code == 412 and op.f == "cas":
                return cl.fail(op, "cas compare failed")
            if e.code == 503:
                return cl.fail(op, "node unavailable")
            return cl.info(op, f"http {e.code}")
        except (urllib.error.URLError, socket.timeout, TimeoutError,
                ConnectionError) as e:
            if isinstance(getattr(e, "reason", None), ConnectionRefusedError):
                return cl.fail(op, "connection refused")
            return cl.info(op, f"{type(e).__name__}")

    def _invoke(self, op: Op) -> Op:
        if op.f == "read":
            _, body = self._request("GET")
            raw = body["node"]["value"]
            return cl.ok(op, int(raw) if raw.lstrip("-").isdigit() else raw)
        if op.f == "write":
            self._request("PUT", {"value": str(op.value)})
            return cl.ok(op)
        if op.f == "cas":
            old, new = op.value
            self._request("PUT", {"value": str(new),
                                  "prevValue": str(old)})
            return cl.ok(op)
        raise ValueError(f"unknown f {op.f!r}")


class FakeEtcdDB(db_mod.DB):
    """DB-protocol lifecycle for the per-node HTTP front-ends: ``setup``
    on the first node boots all servers and publishes
    ``test["endpoints"]``; ``teardown`` stops them (upstream
    ``etcd/.../db.clj`` installs and starts real etcd here)."""

    def __init__(self, cluster: FakeCluster):
        import threading
        self.cluster = cluster
        self._frontend: Optional[HttpKVFrontend] = None
        self._lock = threading.Lock()

    def setup(self, test, node):
        with self._lock:                # setup_all may fan out per node
            if self._frontend is None:
                self._frontend = HttpKVFrontend(self.cluster).start()
                test["endpoints"] = self._frontend.endpoints

    def teardown(self, test, node):
        with self._lock:
            if self._frontend is not None:
                self._frontend.stop()
                self._frontend = None


def etcd_test(mode: str = "linearizable", *,
              time_limit: float = 5.0, concurrency: int = 5,
              seed: Optional[int] = None, nodes: Any = 5,
              algorithm: str = "auto", with_nemesis: bool = True,
              nemesis_interval: float = 1.0,
              store: bool = False,
              device: Optional[str] = None) -> Dict[str, Any]:
    """The flagship CAS-register test over HTTP (upstream
    ``etcd/src/.../runner.clj``). ``device`` is where the
    linearizability check runs (default: the card; ``"cpu"`` for the
    plain PyTorch versions)."""
    node_names = util.node_names(nodes)
    cluster = FakeCluster(node_names, mode=mode, seed=seed)
    client_gen: g.GenLike = g.TimeLimit(
        time_limit, g.Stagger(0.002, g.register_workload(seed=seed),
                              seed=seed))
    nem: Optional[nemesis.Nemesis] = None
    generator: g.GenLike = client_gen
    if with_nemesis:
        nem = nemesis.partition_random_halves(seed=seed)
        generator = nemesis_schedule(client_gen, nemesis_interval)
    return {
        "name": f"etcd-{mode}",
        "nodes": node_names,
        "cluster": cluster,
        "db": FakeEtcdDB(cluster),
        "client": EtcdHttpClient("r"),
        "nemesis": nem,
        "generator": generator,
        "model": models.cas_register(),
        "checker": standard_checker(models.cas_register(),
                                    algorithm=algorithm,
                                    device=device),
        "concurrency": concurrency,
        "device": device,
        "store": store,
        "run-time-limit": max(60.0, time_limit * 6),
        "op-timeout": 5.0,
    }

"""HTTP front-end for the fake cluster: one etcd-v2-dialect server per
node, so suites can exercise a REAL wire protocol (sockets, timeouts,
HTTP error mapping) end-to-end without an external binary.

Upstream's flagship ``etcd/`` suite talks etcd's v2
REST API (``GET/PUT /v2/keys/<key>``, CAS via ``prevValue``); this
module serves the same dialect backed by a
:class:`~jepsen_tpu_torch.fake.cluster.FakeCluster` node, so nemesis
partitions/pauses surface as real 503s and socket timeouts. The
:class:`~jepsen_tpu_torch.suites.etcd.EtcdHttpClient` pointed at real etcd v2
endpoints speaks the identical protocol.

Error mapping (etcd-compatible where it matters):

- key missing            → 404 (errorCode 100)
- CAS precondition fails → 412 (errorCode 101) — a clean :fail
- node partitioned/down  → 503 — definite :fail (no effect)
- backend timeout        → server sleeps past the client's socket
  timeout → the client sees a timeout → indeterminate :info
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, unquote, urlparse

from jepsen_tpu_torch.fake import Unavailable
from jepsen_tpu_torch.fake.cluster import FakeCluster, FakeTimeout

_PREFIX = "/v2/keys/"
# how often a server's loop looks for ``stop``: ``shutdown`` waits up to
# this long for each of the five (the standard library's 0.5 s default
# made every run's teardown take 2.5 s)
_POLL_S = 0.05


class _Handler(BaseHTTPRequestHandler):
    # cluster / node / timeout_hold_s live on the ThreadingHTTPServer
    # instance (stamped by HttpKVFrontend.start), accessed via self.server
    server_version = "jepsen-tpu-fake-etcd/1"

    def log_message(self, fmt, *args):   # silence per-request stderr spam
        pass

    def _send(self, code: int, body: Dict[str, Any]) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _key(self) -> Optional[str]:
        path = urlparse(self.path).path
        if not path.startswith(_PREFIX):
            return None
        return unquote(path[len(_PREFIX):])

    def _guard(self, fn):
        """Run a cluster op with etcd-ish error mapping."""
        srv = self.server
        try:
            return True, fn()
        except Unavailable as e:
            self._send(503, {"errorCode": 300, "message": str(e)})
        except FakeTimeout:
            # hold the socket past the client's timeout so it observes a
            # real indeterminate network timeout, then answer 504 for
            # stragglers with longer timeouts
            time.sleep(getattr(srv, "timeout_hold_s", 2.0))
            try:
                self._send(504, {"errorCode": 301, "message": "timeout"})
            except OSError:
                pass        # the client already hung up — that's the point
        return False, None

    def do_GET(self):                                   # noqa: N802
        key = self._key()
        if key is None:
            return self._send(404, {"errorCode": 100, "message": "bad path"})
        srv = self.server
        okflag, value = self._guard(
            lambda: srv.cluster.read(srv.node, key))
        if not okflag:
            return
        if value is None:
            return self._send(404, {"errorCode": 100,
                                    "message": "Key not found", "key": key})
        self._send(200, {"action": "get",
                         "node": {"key": key, "value": str(value)}})

    def do_PUT(self):                                   # noqa: N802
        key = self._key()
        if key is None:
            return self._send(404, {"errorCode": 100, "message": "bad path"})
        length = int(self.headers.get("Content-Length") or 0)
        form = parse_qs(self.rfile.read(length).decode())
        if "value" not in form:
            return self._send(400, {"errorCode": 209,
                                    "message": "value required"})
        value = form["value"][0]
        srv = self.server
        if "prevValue" in form:                         # compare-and-swap
            prev = form["prevValue"][0]
            # real etcd v2 distinguishes a missing key (404, errorCode
            # 100) from a compare failure (412, errorCode 101); both are
            # definite no-effect outcomes, so the pre-read race below
            # only ever picks between two linearizable error replies
            okflag, cur = self._guard(
                lambda: srv.cluster.read(srv.node, key))
            if not okflag:
                return
            if cur is None:
                return self._send(404, {"errorCode": 100,
                                        "message": "Key not found",
                                        "key": key})

            def _cas():
                return srv.cluster.cas(srv.node, key, prev, value)

            okflag, swapped = self._guard(_cas)
            if not okflag:
                return
            if not swapped:
                return self._send(412, {"errorCode": 101,
                                        "message": "Compare failed"})
            return self._send(200, {"action": "compareAndSwap",
                                    "node": {"key": key, "value": value}})
        okflag, _ = self._guard(
            lambda: srv.cluster.write(srv.node, key, value))
        if not okflag:
            return
        self._send(200, {"action": "set",
                         "node": {"key": key, "value": value}})


class HttpKVFrontend:
    """One HTTP server per cluster node, on loopback ephemeral ports.
    ``endpoints`` maps node name → base URL."""

    def __init__(self, cluster: FakeCluster,
                 timeout_hold_s: float = 2.0):
        self.cluster = cluster
        self.timeout_hold_s = timeout_hold_s
        self._servers: List[ThreadingHTTPServer] = []
        self._threads: List[threading.Thread] = []
        self.endpoints: Dict[str, str] = {}

    def start(self) -> "HttpKVFrontend":
        for node in self.cluster.nodes:
            srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
            srv.cluster = self.cluster                  # type: ignore
            srv.node = node                             # type: ignore
            srv.timeout_hold_s = self.timeout_hold_s    # type: ignore
            t = threading.Thread(target=srv.serve_forever,
                                 args=(_POLL_S,), daemon=True,
                                 name=f"fake-etcd-{node}")
            t.start()
            self._servers.append(srv)
            self._threads.append(t)
            self.endpoints[node] = \
                f"http://127.0.0.1:{srv.server_address[1]}"
        return self

    def stop(self) -> None:
        for srv in self._servers:
            srv.shutdown()
            srv.server_close()
        for t in self._threads:
            t.join(5)
        self._servers, self._threads = [], []

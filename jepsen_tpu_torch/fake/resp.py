"""RESP (Redis Serialization Protocol) front-end for the fake cluster:
one RESP2 TCP server per node, so suites can exercise a second REAL wire
protocol (binary-safe framing over raw sockets) end-to-end without an
external binary.

Upstream-era Jepsen drove Redis-family systems over this protocol
(the redis-style suites among upstream's per-DB dirs); this
module serves the dialect backed by a
:class:`~jepsen_tpu_torch.fake.cluster.FakeCluster` node, so nemesis
partitions/pauses surface as real ``-CLUSTERDOWN`` errors and socket
timeouts. The :class:`~jepsen_tpu_torch.suites.redis.RespClient` pointed at a
real Redis speaks the identical protocol (CAS is sent as the canonical
``EVAL`` compare-and-set script a real server would execute atomically;
this fake recognizes that script's shape and applies the same
semantics).

Commands: ``PING``, ``GET k``, ``SET k v``,
``EVAL <cas-script> 1 k old new``.

Error mapping:

- key missing            → RESP nil bulk (``$-1``)
- CAS compare fails      → ``:0`` (script returns 0 — a clean :fail)
- node partitioned/down  → ``-CLUSTERDOWN`` — definite :fail (no effect)
- backend timeout        → server holds the socket past the client's
  timeout → the client sees a real network timeout → indeterminate :info
"""
from __future__ import annotations

import socketserver
import threading
import time
from typing import Dict, List, Optional, Tuple

from jepsen_tpu_torch.fake import Unavailable
from jepsen_tpu_torch.fake.cluster import FakeCluster, FakeTimeout

# the canonical Redis compare-and-set script (what a real client EVALs);
# the fake matches on its first characters to recognize intent
# how often a server's loop looks for ``stop`` (as ``fake.httpd``'s)
_POLL_S = 0.05

CAS_SCRIPT = ("if redis.call('get', KEYS[1]) == ARGV[1] then "
              "return redis.call('set', KEYS[1], ARGV[2]) and 1 "
              "else return 0 end")


def _read_exact(rf, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = rf.read(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return buf


def read_command(rf) -> Optional[List[bytes]]:
    """Parse one RESP array-of-bulk-strings command; None on clean EOF."""
    line = rf.readline()
    if not line:
        return None
    if not line.startswith(b"*"):
        raise ValueError(f"expected array, got {line!r}")
    n = int(line[1:].rstrip())
    parts: List[bytes] = []
    for _ in range(n):
        hdr = rf.readline()
        if not hdr.startswith(b"$"):
            raise ValueError(f"expected bulk string, got {hdr!r}")
        ln = int(hdr[1:].rstrip())
        parts.append(_read_exact(rf, ln))
        _read_exact(rf, 2)                              # trailing CRLF
    return parts


def bulk(v: Optional[str]) -> bytes:
    if v is None:
        return b"$-1\r\n"
    data = str(v).encode()
    return b"$%d\r\n%s\r\n" % (len(data), data)


class _Handler(socketserver.StreamRequestHandler):
    # cluster / node / timeout_hold_s live on the server instance

    def handle(self):
        while True:
            try:
                cmd = read_command(self.rfile)
            except (ValueError, ConnectionError, OSError):
                return
            if cmd is None:
                return
            try:
                reply = self._dispatch(cmd)
            except Unavailable as e:
                reply = b"-CLUSTERDOWN %s\r\n" % str(e).encode()
            except FakeTimeout:
                # hold the socket past the client's timeout so it
                # observes a real indeterminate network timeout
                time.sleep(getattr(self.server, "timeout_hold_s", 2.0))
                reply = b"-ERR timeout\r\n"
            except Exception as e:                      # noqa: BLE001
                reply = b"-ERR %s\r\n" % type(e).__name__.encode()
            try:
                self.wfile.write(reply)
            except OSError:
                return              # client hung up mid-timeout: the point

    def _dispatch(self, cmd: List[bytes]) -> bytes:
        srv = self.server
        name = cmd[0].upper()
        if name == b"PING":
            return b"+PONG\r\n"
        if name == b"GET" and len(cmd) == 2:
            v = srv.cluster.read(srv.node, cmd[1].decode())
            return bulk(None if v is None else str(v))
        if name == b"SET" and len(cmd) >= 3:
            srv.cluster.write(srv.node, cmd[1].decode(), cmd[2].decode())
            return b"+OK\r\n"
        if name == b"EVAL" and len(cmd) >= 6 and \
                cmd[1].decode().replace(" ", "").startswith(
                    "ifredis.call('get',KEYS[1])==ARGV[1]"):
            key, old, new = (cmd[3].decode(), cmd[4].decode(),
                             cmd[5].decode())
            # one atomic cluster op; a missing key compares unequal to
            # any old value, exactly as the script's nil would
            swapped = srv.cluster.cas(srv.node, key, old, new)
            return b":1\r\n" if swapped else b":0\r\n"
        return b"-ERR unknown command\r\n"


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class RespKVFrontend:
    """One RESP server per cluster node, on loopback ephemeral ports.
    ``endpoints`` maps node name → ``(host, port)``."""

    def __init__(self, cluster: FakeCluster, timeout_hold_s: float = 2.0):
        self.cluster = cluster
        self.timeout_hold_s = timeout_hold_s
        self._servers: List[_Server] = []
        self._threads: List[threading.Thread] = []
        self.endpoints: Dict[str, Tuple[str, int]] = {}

    def start(self) -> "RespKVFrontend":
        for node in self.cluster.nodes:
            srv = _Server(("127.0.0.1", 0), _Handler)
            srv.cluster = self.cluster                  # type: ignore
            srv.node = node                             # type: ignore
            srv.timeout_hold_s = self.timeout_hold_s    # type: ignore
            t = threading.Thread(target=srv.serve_forever,
                                 args=(_POLL_S,), daemon=True,
                                 name=f"fake-redis-{node}")
            t.start()
            self._servers.append(srv)
            self._threads.append(t)
            self.endpoints[node] = ("127.0.0.1", srv.server_address[1])
        return self

    def stop(self) -> None:
        for srv in self._servers:
            srv.shutdown()
            srv.server_close()
        for t in self._threads:
            t.join(5)
        self._servers, self._threads = [], []

"""Redis suite over RESP — the redis-family register test of the
upstream era, driving the REAL wire protocol: a raw
TCP socket speaking RESP2 (``GET``/``SET``, CAS as the canonical atomic
``EVAL`` compare-and-set script), checked against the ``cas_register``
model.

By default the test boots one RESP-dialect server per node
(:class:`jepsen_tpu_torch.fake.resp.RespKVFrontend`, backed by the fake
cluster so nemesis faults surface as genuine ``-CLUSTERDOWN`` errors
and socket timeouts) through the DB protocol. Point ``endpoints`` at a
real Redis's ``(host, port)`` pairs and the identical client/checker
pipeline applies — the CAS script is real Lua a real server executes
atomically.

Completion mapping:

- ``+OK`` / bulk / ``:1``  → :ok
- nil bulk on read         → :ok read of nil (key unset)
- ``:0`` from the script   → :fail (CAS compare failed — no effect)
- ``-CLUSTERDOWN`` / conn refused → :fail (definitely no effect)
- parse-time rejections (``-ERR unknown command`` / arity /
  ``-WRONGTYPE`` …) → :fail (rejected before execution, no effect)
- socket timeout / conn reset mid-command / other ``-ERR`` replies
  (possible effect before the error) → :info (indeterminate)
"""
from __future__ import annotations

import socket
from typing import Any, Dict, Optional, Tuple

from jepsen_tpu_torch import client as cl
from jepsen_tpu_torch import db as db_mod
from jepsen_tpu_torch import generators as g
from jepsen_tpu_torch import models, nemesis, util
from jepsen_tpu_torch.fake import FakeCluster
from jepsen_tpu_torch.fake.resp import CAS_SCRIPT, RespKVFrontend
from jepsen_tpu_torch.op import Op
from jepsen_tpu_torch.suites._common import nemesis_schedule, standard_checker


class RespError(Exception):
    """A RESP ``-...`` error reply."""

    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


# error-reply prefixes a server emits while rejecting a command BEFORE
# executing it — definitely no effect, so the op completes :fail
_DEFINITE_REJECTIONS = (
    "ERR unknown command",
    "ERR wrong number of arguments",
    "WRONGTYPE",
)


class RespClient(cl.Client):
    """Minimal RESP2 client on a raw socket (one connection per worker,
    re-dialed after errors). ``test["endpoints"]`` maps node →
    ``(host, port)``."""

    def __init__(self, key: str = "r", timeout_s: float = 1.0):
        self.key = key
        self.timeout_s = timeout_s
        self.addr: Optional[Tuple[str, int]] = None
        self._sock: Optional[socket.socket] = None
        self._rf = None

    def open(self, test, node):
        c = type(self)(self.key, self.timeout_s)
        c.addr = tuple(test["endpoints"][node])
        return c

    def close(self, test):
        self._drop()

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock, self._rf = None, None

    def _connect(self):
        if self._sock is None:
            s = socket.create_connection(self.addr, timeout=self.timeout_s)
            s.settimeout(self.timeout_s)
            self._sock = s
            self._rf = s.makefile("rb")

    def _command(self, *parts: str) -> Any:
        """Send one RESP array command, return the decoded reply
        (str bulk / int / None nil / ``+`` simple string); raises
        :class:`RespError` on ``-`` replies, OS errors on transport."""
        self._connect()
        enc = [f"*{len(parts)}\r\n".encode()]
        for p in parts:
            b = p.encode()
            enc.append(b"$%d\r\n%s\r\n" % (len(b), b))
        self._sock.sendall(b"".join(enc))
        return self._reply()

    def _reply(self) -> Any:
        line = self._rf.readline()
        if not line:
            raise ConnectionError("server closed connection")
        kind, rest = line[:1], line[1:].rstrip(b"\r\n")
        if kind == b"+":
            return rest.decode()
        if kind == b"-":
            raise RespError(rest.decode())
        if kind == b":":
            return int(rest)
        if kind == b"$":
            n = int(rest)
            if n < 0:
                return None
            # exact reads: a short read at EOF must surface as a broken
            # connection (-> :info), never as a truncated :ok value
            data = self._read_exact(n)
            self._read_exact(2)
            return data.decode()
        raise ValueError(f"bad RESP reply {line!r}")

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._rf.read(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed mid-reply")
            buf += chunk
        return buf

    def invoke(self, test, op: Op) -> Op:
        try:
            return self._invoke(op)
        except RespError as e:
            if e.message.startswith("CLUSTERDOWN"):
                return cl.fail(op, "node unavailable")
            # a complete error reply the server produced while PARSING the
            # command (unknown command, arity, type) is a definite
            # no-effect rejection — a clean :fail that keeps checker
            # concurrency down. Anything else (script errors mid-write,
            # "-ERR timeout", LOADING, …) may have applied an effect
            # before failing, so it stays indeterminate :info.
            if e.message.startswith(_DEFINITE_REJECTIONS):
                return cl.fail(op, e.message)
            return cl.info(op, e.message)
        except ConnectionRefusedError:
            self._drop()
            return cl.fail(op, "connection refused")
        except (socket.timeout, TimeoutError, ConnectionError, OSError) as e:
            # a timed-out or broken connection may have delivered the
            # command: indeterminate, and the socket is poisoned (a late
            # reply would desynchronize framing) — re-dial next op
            self._drop()
            return cl.info(op, type(e).__name__)

    def _invoke(self, op: Op) -> Op:
        if op.f == "read":
            raw = self._command("GET", self.key)
            if raw is None:
                return cl.ok(op, None)
            return cl.ok(op, int(raw) if raw.lstrip("-").isdigit() else raw)
        if op.f == "write":
            self._command("SET", self.key, str(op.value))
            return cl.ok(op)
        if op.f == "cas":
            old, new = op.value
            r = self._command("EVAL", CAS_SCRIPT, "1", self.key,
                              str(old), str(new))
            if r == 1:
                return cl.ok(op)
            return cl.fail(op, "cas compare failed")
        raise ValueError(f"unknown f {op.f!r}")


class FakeRedisDB(db_mod.DB):
    """DB-protocol lifecycle for the per-node RESP front-ends (upstream
    redis suites install and start real redis-server here)."""

    def __init__(self, cluster: FakeCluster):
        import threading
        self.cluster = cluster
        self._frontend: Optional[RespKVFrontend] = None
        self._lock = threading.Lock()

    def setup(self, test, node):
        with self._lock:
            if self._frontend is None:
                self._frontend = RespKVFrontend(self.cluster).start()
                test["endpoints"] = self._frontend.endpoints

    def teardown(self, test, node):
        with self._lock:
            if self._frontend is not None:
                self._frontend.stop()
                self._frontend = None


def redis_test(mode: str = "linearizable", *,
               time_limit: float = 5.0, concurrency: int = 5,
               seed: Optional[int] = None, nodes: Any = 5,
               algorithm: str = "auto", with_nemesis: bool = True,
               nemesis_interval: float = 1.0,
               store: bool = False,
               device: Optional[str] = None) -> Dict[str, Any]:
    """CAS-register test over RESP (redis-style upstream suite).
    ``device`` is where the linearizability check runs (default: the
    card; ``"cpu"`` for the plain PyTorch versions)."""
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
        "name": f"redis-{mode}",
        "nodes": node_names,
        "cluster": cluster,
        "db": FakeRedisDB(cluster),
        "client": RespClient("r"),
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

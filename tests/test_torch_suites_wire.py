"""The port's wire-protocol fakes and suites (``fake/httpd.py``, the
etcd-v2 HTTP dialect; ``fake/resp.py``, RESP2; ``suites/etcd.py``,
``suites/redis.py``) and the node helpers of the real-system paths
(``control_util.py``, ``faketime.py``) against the reference's, on the
CPU (``device="cpu"``; the reference under ``JAX_PLATFORMS=cpu``), after
``tests/test_etcd_suite.py``, ``tests/test_redis_suite.py`` and
``tests/test_control_util.py``.

Both packages' servers answer the same requests, on loopback sockets,
with the same status codes, bodies and RESP bytes; the clients map the
same replies and transport errors to the same completions; the helpers
send the same command strings through a recording session. Short runs
of each suite are then checked by the reference's checkers; a sloppy run
under a permanent partition is invalid in both packages at the same op;
the servers stop with the run, also when the run raises. Every test here
runs under its own time limit (SIGALRM), so a server that does not stop
cannot hold a worker.
"""
import io
import json
import signal
import socket
import tarfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from jepsen_tpu import cli as cli_ref
from jepsen_tpu import control as ctl_ref
from jepsen_tpu import control_util as cu_ref
from jepsen_tpu import core as core_ref
from jepsen_tpu import faketime as ft_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import facade as fa_ref
from jepsen_tpu.fake import cluster as fc_ref
from jepsen_tpu.fake import httpd as http_ref
from jepsen_tpu.fake import resp as resp_ref
from jepsen_tpu.op import Op as OpRef
from jepsen_tpu.op import invoke as inv_ref
from jepsen_tpu.suites import etcd as etcd_ref
from jepsen_tpu.suites import redis as redis_ref
from jepsen_tpu_torch import cli as cli_pt
from jepsen_tpu_torch import control as ctl_pt
from jepsen_tpu_torch import control_util as cu_pt
from jepsen_tpu_torch import core as core_pt
from jepsen_tpu_torch import faketime as ft_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.fake import cluster as fc_pt
from jepsen_tpu_torch.fake import httpd as http_pt
from jepsen_tpu_torch.fake import resp as resp_pt
from jepsen_tpu_torch.op import invoke as inv_pt
from jepsen_tpu_torch.suites import etcd as etcd_pt
from jepsen_tpu_torch.suites import redis as redis_pt

torch.set_num_threads(1)

NODES = ["n1", "n2", "n3", "n4", "n5"]
VERDICT = ("valid", "op", "dead-event")
TEST_LIMIT_S = 30


@pytest.fixture(autouse=True)
def time_limit():
    """Each test's own time limit: past it, SIGALRM raises in the test."""
    def over(signum, frame):
        raise TimeoutError(f"test ran past its {TEST_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, over)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def to_ref(history):
    return [OpRef.from_dict(op.to_dict()) for op in history]


def same(want, got, keys=VERDICT):
    diff = {k: (want.get(k), got.get(k)) for k in keys
            if want.get(k) != got.get(k)}
    assert not diff, diff


def split(c):
    """The permanent partition {n1, n2} | {n3, n4, n5}."""
    for a in ("n1", "n2"):
        for b in ("n3", "n4", "n5"):
            c.drop_link(a, b)
            c.drop_link(b, a)


def isolate(c, node):
    for other in NODES:
        if other != node:
            c.drop_link(node, other)
            c.drop_link(other, node)


def outlast_pause():
    """Keep a paused node paused past the fake cluster's 0.5 s wait, so
    the op the client timed out on ends in the cluster's own timeout,
    not applied (a resume inside the wait would apply it, racing the
    next request)."""
    time.sleep(0.45)


def stop(fe):
    """Stop a frontend of either package, its five servers' loops shut
    down at once (each waits up to its poll interval)."""
    waits = [threading.Thread(target=srv.shutdown) for srv in fe._servers]
    for t in waits:
        t.start()
    for t in waits:
        t.join(5)
    fe.stop()


def server_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("fake-etcd-", "fake-redis-"))]


# -- the HTTP dialect ---------------------------------------------------------

def _http(base, method, key, form=None, timeout=0.2):
    data = urllib.parse.urlencode(form).encode() if form is not None \
        else None
    req = urllib.request.Request(f"{base}{key}", data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())
    except (socket.timeout, TimeoutError, urllib.error.URLError) as e:
        return "timeout", type(e).__name__


def _http_script(fc, http):
    cluster = fc.FakeCluster(NODES, mode="linearizable", seed=2)
    fe = http.HttpKVFrontend(cluster, timeout_hold_s=0.3).start()
    try:
        ep = fe.endpoints
        k = "/v2/keys/"
        out = [
            _http(ep["n1"], "GET", k + "r"),
            _http(ep["n1"], "PUT", k + "r", {"value": "5"}),
            _http(ep["n3"], "GET", k + "r"),
            _http(ep["n2"], "PUT", k + "r", {"value": "6", "prevValue": "5"}),
            _http(ep["n2"], "PUT", k + "r", {"value": "7", "prevValue": "5"}),
            _http(ep["n4"], "PUT", k + "nope", {"value": "1",
                                                "prevValue": "0"}),
            _http(ep["n4"], "PUT", k + "r", {"prevValue": "6"}),
            _http(ep["n1"], "GET", "/v3/other"),
            _http(ep["n1"], "PUT", "/v3/other", {"value": "1"}),
            _http(ep["n1"], "GET", k + "a%20b"),
            _http(ep["n1"], "PUT", k + "a%20b", {"value": "x y"}),
            _http(ep["n2"], "GET", k + "a%20b"),
        ]
        isolate(cluster, "n5")
        out += [_http(ep["n5"], "GET", k + "r"),
                _http(ep["n5"], "PUT", k + "r", {"value": "8"}),
                _http(ep["n5"], "PUT", k + "r", {"value": "8",
                                                 "prevValue": "6"})]
        cluster.heal()
        out.append(_http(ep["n5"], "GET", k + "r"))
        cluster.pause_node("n2")
        out.append(_http(ep["n2"], "PUT", k + "r", {"value": "9"}))
        outlast_pause()
        cluster.resume_node("n2")
        out.append(_http(ep["n1"], "GET", k + "r"))
        return out, dict(cluster._global)
    finally:
        stop(fe)


def test_http_dialect_matches_reference():
    """Status codes and bodies: 200 get/set/compareAndSwap, 404 errorCode
    100 (missing key, CAS on a missing key, bad path), 412 errorCode 101,
    400 errorCode 209, 503 errorCode 300 on an isolated node, a timeout
    on a paused one."""
    want = _http_script(fc_ref, http_ref)
    got = _http_script(fc_pt, http_pt)
    assert got == want
    assert [s for s, _ in got[0]] == [404, 200, 200, 200, 412, 404, 400,
                                      404, 404, 404, 200, 200, 503, 503,
                                      503, 200, "timeout", 200]
    assert not server_threads()


# -- RESP ---------------------------------------------------------------------

FRAMES = [b"*1\r\n$4\r\nPING\r\n",
          b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$4\r\na\r\nb\r\n",
          b"", b"+OK\r\n", b"*2\r\n:1\r\n", b"*2\r\n$3\r\nGET\r\n$5\r\nk\r\n"]


def _parse(resp, frame):
    try:
        return ("ok", resp.read_command(io.BytesIO(frame)))
    except (ValueError, ConnectionError) as e:
        return (type(e).__name__, str(e))


def test_resp_parser_bulk_and_script_match_reference():
    for frame in FRAMES:
        assert _parse(resp_pt, frame) == _parse(resp_ref, frame)
    assert _parse(resp_pt, FRAMES[1]) == ("ok", [b"SET", b"k", b"a\r\nb"])
    for v in (None, "", "abc", 5, "L1,2"):
        assert resp_pt.bulk(v) == resp_ref.bulk(v)
    assert resp_pt.CAS_SCRIPT == resp_ref.CAS_SCRIPT


def _raw(addr, payload, timeout=0.2):
    s = socket.create_connection(addr, timeout=timeout)
    try:
        s.sendall(payload)
        buf = b""
        while True:
            try:
                chunk = s.recv(4096)
            except (socket.timeout, TimeoutError):
                return buf + b"<timeout>"
            if not chunk:
                return buf + b"<closed>"
            buf += chunk
            if buf.endswith(b"\r\n") and _complete(buf):
                return buf
    finally:
        s.close()


def _complete(buf):
    if buf[:1] == b"$" and not buf.startswith(b"$-1"):
        n = int(buf[1:buf.index(b"\r\n")])
        return len(buf) >= buf.index(b"\r\n") + 2 + n + 2
    return True


def _cmd(*parts):
    out = [b"*%d\r\n" % len(parts)]
    for p in parts:
        b = p.encode()
        out.append(b"$%d\r\n%s\r\n" % (len(b), b))
    return b"".join(out)


def _resp_script(fc, resp):
    cluster = fc.FakeCluster(NODES, mode="linearizable", seed=2)
    fe = resp.RespKVFrontend(cluster, timeout_hold_s=0.3).start()
    try:
        ep = fe.endpoints
        cas = resp.CAS_SCRIPT
        out = [_raw(ep["n1"], _cmd("PING")),
               _raw(ep["n1"], _cmd("GET", "k")),
               _raw(ep["n1"], _cmd("SET", "k", "5")),
               _raw(ep["n3"], _cmd("GET", "k")),
               _raw(ep["n2"], _cmd("EVAL", cas, "1", "k", "5", "6")),
               _raw(ep["n2"], _cmd("EVAL", cas, "1", "k", "5", "7")),
               _raw(ep["n2"], _cmd("EVAL", cas, "1", "nope", "0", "1")),
               _raw(ep["n2"], _cmd("EVAL", "return 1", "1", "k", "a", "b")),
               _raw(ep["n1"], _cmd("FLUSHALL")),
               _raw(ep["n1"], _cmd("GET")),
               _raw(ep["n1"], b"PING\r\n"),
               _raw(ep["n1"], _cmd("SET", "b", "x\r\ny")),
               _raw(ep["n4"], _cmd("GET", "b"))]
        isolate(cluster, "n5")
        out += [_raw(ep["n5"], _cmd("GET", "k")),
                _raw(ep["n5"], _cmd("SET", "k", "8"))]
        cluster.heal()
        cluster.pause_node("n2")
        out.append(_raw(ep["n2"], _cmd("SET", "k", "9")))
        outlast_pause()
        cluster.resume_node("n2")
        out.append(_raw(ep["n1"], _cmd("GET", "k")))
        return out, dict(cluster._global)
    finally:
        stop(fe)


def test_resp_server_bytes_match_reference():
    want = _resp_script(fc_ref, resp_ref)
    got = _resp_script(fc_pt, resp_pt)
    assert got == want
    replies = got[0]
    assert replies[0] == b"+PONG\r\n" and replies[1] == b"$-1\r\n"
    assert replies[4:7] == [b":1\r\n", b":0\r\n", b":0\r\n"]
    assert replies[10] == b"<closed>"
    assert replies[13].startswith(b"-CLUSTERDOWN")
    assert replies[15] == b"<timeout>"
    assert not server_threads()


# -- the clients' completion mappings ----------------------------------------

def _etcd_client_script(fc, http, etcd, inv):
    cluster = fc.FakeCluster(NODES, mode="linearizable", seed=3)
    fe = http.HttpKVFrontend(cluster, timeout_hold_s=0.3).start()
    try:
        test = {"endpoints": fe.endpoints}
        c1 = etcd.EtcdHttpClient("k", timeout_s=0.2).open(test, "n1")
        ops = [inv(0, "read"), inv(0, "cas", [0, 1]), inv(0, "write", 3),
               inv(0, "read"), inv(0, "cas", [9, 1]), inv(0, "cas", [3, 4]),
               inv(0, "write", "abc"), inv(0, "read")]
        out = [c1.invoke(test, op) for op in ops]
        isolate(cluster, "n1")
        out.append(c1.invoke(test, inv(0, "write", 4)))
        cluster.heal()
        cluster.pause_node("n1")
        out.append(c1.invoke(test, inv(0, "write", 5)))
        outlast_pause()
        cluster.resume_node("n1")
        out.append(c1.invoke(test, inv(0, "read")))
    finally:
        stop(fe)
    # nothing listens on the stopped server's port: refused, a clean fail
    out.append(c1.invoke(test, inv(0, "read")))
    return [(o.type, o.value, o.extra) for o in out]


def test_etcd_client_completions_match_reference():
    want = _etcd_client_script(fc_ref, http_ref, etcd_ref, inv_ref)
    got = _etcd_client_script(fc_pt, http_pt, etcd_pt, inv_pt)
    assert got == want
    assert [t for t, _, _ in got] == ["ok", "fail", "ok", "ok", "fail", "ok",
                                      "ok", "ok", "fail", "info", "ok",
                                      "fail"]
    assert got[0][1] is None and got[3][1] == 3 and got[7][1] == "abc"


def _redis_client_script(fc, resp, redis, inv):
    cluster = fc.FakeCluster(NODES, mode="linearizable", seed=3)
    fe = resp.RespKVFrontend(cluster, timeout_hold_s=0.3).start()
    try:
        test = {"endpoints": fe.endpoints}
        c1 = redis.RespClient("k", timeout_s=0.2).open(test, "n1")
        ops = [inv(0, "read"), inv(0, "cas", [0, 1]), inv(0, "write", 3),
               inv(0, "read"), inv(0, "cas", [9, 1]), inv(0, "cas", [3, 4]),
               inv(0, "write", -2), inv(0, "read")]
        out = [c1.invoke(test, op) for op in ops]
        isolate(cluster, "n1")
        out.append(c1.invoke(test, inv(0, "write", 5)))
        cluster.heal()
        cluster.pause_node("n1")
        out.append(c1.invoke(test, inv(0, "write", 6)))
        outlast_pause()
        cluster.resume_node("n1")
        out.append(c1.invoke(test, inv(0, "write", 7)))
        c1.close(test)
    finally:
        stop(fe)
    out.append(c1.invoke(test, inv(0, "read")))
    return [(o.type, o.value, o.extra) for o in out]


def test_redis_client_completions_match_reference():
    want = _redis_client_script(fc_ref, resp_ref, redis_ref, inv_ref)
    got = _redis_client_script(fc_pt, resp_pt, redis_pt, inv_pt)
    assert got == want
    assert [t for t, _, _ in got] == ["ok", "fail", "ok", "ok", "fail", "ok",
                                      "ok", "ok", "fail", "info", "ok",
                                      "fail"]
    assert got[7][1] == -2


def _raising(etcd_or_redis, cls_name, exc, hook):
    cls = getattr(etcd_or_redis, cls_name)

    class Raising(cls):
        pass

    setattr(Raising, hook, lambda self, *a, **k: (_ for _ in ()).throw(
        exc))
    return Raising


def _http_errors(mod):
    return [urllib.error.HTTPError("u", code, "m", {}, None)
            for code in (404, 412, 503, 500, 504)] + [
        urllib.error.URLError(ConnectionRefusedError()),
        urllib.error.URLError("no route"), socket.timeout("t"),
        TimeoutError(), ConnectionResetError()]


def _resp_errors(mod):
    return [mod.RespError(m) for m in (
        "CLUSTERDOWN n1 lost quorum", "ERR unknown command 'X'",
        "ERR wrong number of arguments for 'get'", "WRONGTYPE bad",
        "ERR timeout", "LOADING", "ERR something")] + [
        ConnectionRefusedError(), socket.timeout("t"), TimeoutError(),
        ConnectionError("closed"), OSError("broken")]


@pytest.mark.parametrize("f", ["read", "write", "cas"])
def test_transport_error_mappings_match_reference(f):
    """Every reply and transport error each client maps: its type,
    value and error text, the reference's, op by op."""
    for mod_pt, mod_ref, cls, hook, errors in (
            (etcd_pt, etcd_ref, "EtcdHttpClient", "_request", _http_errors),
            (redis_pt, redis_ref, "RespClient", "_command", _resp_errors)):
        got, want = ([(r.type, r.value, r.extra) for r in (
            _raising(mod, cls, e, hook)("k").invoke(
                {}, inv(0, f, [1, 2] if f == "cas" else 1 if f == "write"
                        else None)) for e in errors(mod))]
            for mod, inv in ((mod_pt, inv_pt), (mod_ref, inv_ref)))
        assert got == want, cls


# -- test maps ---------------------------------------------------------------

def map_fields(t):
    return {
        "keys": sorted(set(t) - {"device"}),
        "checkers": list(t["checker"].checkers),
        "types": {k: type(t.get(k)).__name__ for k in
                  ("cluster", "client", "nemesis", "db", "model")},
        "mode": t["cluster"].mode,
        "fields": {k: t[k] for k in ("name", "nodes", "concurrency",
                                     "store", "run-time-limit",
                                     "op-timeout")},
        "client": vars(t["client"]),
    }


@pytest.mark.parametrize("kw", [{}, {"mode": "sloppy"},
                                {"with_nemesis": False, "nodes": 3,
                                 "time_limit": 20.0}])
@pytest.mark.parametrize("suite", ["etcd", "redis"])
def test_builder_test_map_matches_reference(suite, kw):
    pt, ref = ((etcd_pt.etcd_test, etcd_ref.etcd_test) if suite == "etcd"
               else (redis_pt.redis_test, redis_ref.redis_test))
    t = pt(seed=1, **kw)
    assert map_fields(t) == map_fields(ref(seed=1, **kw))
    assert t["device"] is None
    assert t["checker"].checkers["linear"].device is None
    t = pt(seed=1, device="cpu", **kw)
    assert t["device"] == t["checker"].checkers["linear"].device == "cpu"


# -- short runs, checked by both packages ------------------------------------

def _route(ledger):
    return [(r["engine"], r["states"]) for r in ledger
            if r["stage"] == "reach" and r["event"] == "route"]


@pytest.mark.parametrize("suite", ["etcd", "redis"])
def test_run_linearizable_matches_reference(suite):
    pt = etcd_pt.etcd_test if suite == "etcd" else redis_pt.redis_test
    t = pt(mode="linearizable", time_limit=1.5, seed=4,
           nemesis_interval=0.3, device="cpu")
    with obs.capture() as cap:
        done = core_pt.run(t)
    res = done["results"]["results"]
    h = done["history"]
    assert res["linear"]["valid"] is True and len(h) > 50
    assert any(op.type in ("fail", "info") for op in h)
    assert [e for e, _ in _route(cap.ledger)] == ["reach-lane"]
    same(fa_ref.Linearizable(m_ref.cas_register()).check(None, to_ref(h)),
         res["linear"])
    assert done["results"]["valid"] is True
    assert t["db"]._frontend is None and not server_threads()


@pytest.mark.parametrize("suite", ["etcd", "redis"])
def test_sloppy_run_under_partition_fails_at_reference_op(suite, tmp_path,
                                                         capsys):
    """A sloppy cluster split for the whole run: each side serves its own
    writes, so reads go stale; invalid in both packages at the same op,
    and the port's run dir rechecks in the reference's command line."""
    pt = etcd_pt.etcd_test if suite == "etcd" else redis_pt.redis_test
    t = pt(mode="sloppy", time_limit=1.0, seed=11, with_nemesis=False,
           store=True, device="cpu")
    t["store-root"] = str(tmp_path)
    split(t["cluster"])
    done = core_pt.run(t)
    lin = done["results"]["results"]["linear"]
    assert lin["valid"] is False and lin["op"]
    capsys.readouterr()
    assert cli_ref.main(["recheck", done["dir"]]) == 1
    want = json.loads(capsys.readouterr().out)
    assert want["valid"] is False
    same(want, lin)


def test_reference_run_dir_rechecks_in_port(tmp_path, capsys):
    rt = redis_ref.redis_test(mode="linearizable", time_limit=0.5, seed=6,
                              with_nemesis=False, store=True)
    rt["store-root"] = str(tmp_path)
    db, teardown = rt["db"], rt["db"].teardown

    def teardown_at_once(test, node):
        if db._frontend is not None:
            stop(db._frontend)
        teardown(test, node)

    db.teardown = teardown_at_once
    ref_done = core_ref.run(rt)
    capsys.readouterr()
    rc = cli_pt.main(["recheck", ref_done["dir"], "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert rc == 0 and got["valid"] is True
    same(ref_done["results"]["results"]["linear"], got)


@pytest.mark.parametrize("suite", ["etcd", "redis"])
def test_servers_stop_when_the_run_raises(suite):
    pt = etcd_pt.etcd_test if suite == "etcd" else redis_pt.redis_test
    t = pt(time_limit=0.3, seed=1, device="cpu")
    seen = {}

    def boom(test):
        seen["endpoints"] = dict(test["endpoints"])
        raise RuntimeError("nemesis setup failed")

    t["nemesis"].setup = boom
    with pytest.raises(RuntimeError, match="nemesis setup failed"):
        core_pt.run(t)
    assert len(seen["endpoints"]) == 5
    assert t["db"]._frontend is None and not server_threads()
    addr = seen["endpoints"]["n1"]
    host, port = (addr if isinstance(addr, tuple) else
                  urllib.parse.urlparse(addr)[1].split(":"))
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection((host, int(port)), timeout=1).close()


def test_run_without_card_starts_no_server(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for t in (etcd_pt.etcd_test(time_limit=0.3),
              redis_pt.redis_test(time_limit=0.3)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            core_pt.run(t)
        assert t["db"]._frontend is None and "endpoints" not in t
    assert not server_threads()


# -- control_util and faketime -----------------------------------------------

def _helper_script(ctl, cu, ft, responses):
    remote = ctl.FakeRemote(responses=dict(responses))
    s = ctl.Session(remote, "n1")
    out = [cu.exists(s, "/opt/x y"), cu.ls_full(s, "/var/log"),
           cu.daemon_running(s, "/tmp/d.pid")]
    cu.start_daemon(s, "/opt/db/bin/dbd", "--port", 7000, "a b",
                    logfile="/var/log/db.log", chdir="/opt/db",
                    env={"X": "1 2", "FAKETIME": "-3s"})
    cu.start_daemon(s.su(), "/usr/bin/etcd")
    cu.stop_daemon(s, "/opt/db/bin/dbd", pidfile="/run/dbd.pid")
    cu.stop_daemon(s, "/usr/bin/etcd")
    cu.grepkill(s, "etcd", signal=15)
    out.append(cu.wget(s, "http://host/pkg.tgz"))
    out.append(cu.wget(s, "http://host/pkg.tgz", "/tmp/p.tgz", force=True))
    for url in ("http://host/etcd-v3.tar.gz", "file:///srv/pkg.zip",
                "file:///srv/pkg.tgz"):
        for dest, force in (("/opt/pkg", True), ("/opt/pkg2", False)):
            try:
                out.append(cu.install_archive(s, url, dest, force=force))
            except ctl.RemoteError as e:
                out.append(("RemoteError", e.exit_code))
    ft.install(s)
    out += [ft.lib_path(s), ft.env(), ft.env("-30s", rate=1.1, lib="/l.so"),
            ft.wrap("dbd --x", "+2h"), ft.wrap("dbd", rate=0.5)]
    cu.start_daemon(s, "/opt/db/bin/dbd", env=ft.env("-30s", rate=1.1))
    return out, remote.commands, remote.uploads, remote.downloads


@pytest.mark.parametrize("responses", [
    {},
    {"test -e": (1, ""), "ls -A": "a b\n", "which faketime": (1, ""),
     "kill -0": (1, "")},
    {"test -e /opt/pkg": (1, ""), "tar": (2, "gzip: bad"),
     "find /usr/lib": "/usr/lib/x/libfaketime.so.1\n"}])
def test_helper_commands_match_reference(responses):
    got = _helper_script(ctl_pt, cu_pt, ft_pt, responses)
    assert got == _helper_script(ctl_ref, cu_ref, ft_ref, responses)
    assert any("nohup" in c and "FAKETIME=" in c for _, c in got[1])


def test_helpers_on_a_local_shell(tmp_path):
    """As the reference's tests: ``exists``, ``ls_full`` and a
    ``file://`` archive install on a real local shell."""
    s = ctl_pt.Session(ctl_pt.LocalRemote(), "n1")
    assert cu_pt.exists(s, str(tmp_path))
    assert not cu_pt.exists(s, str(tmp_path / "nope"))
    (tmp_path / "a").write_text("x")
    assert cu_pt.ls_full(s, str(tmp_path)) == [str(tmp_path / "a")]
    src = tmp_path / "pkg"
    (src / "bin").mkdir(parents=True)
    (src / "bin" / "tool").write_text("#!/bin/sh\n")
    tar = tmp_path / "pkg.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        tf.add(src, arcname="pkg-1.0")
    dest = tmp_path / "installed"
    assert cu_pt.install_archive(s, f"file://{tar}", str(dest)) == str(dest)
    assert (dest / "bin" / "tool").exists()
    assert cu_pt.install_archive(s, f"file://{tar}", str(dest)) == str(dest)

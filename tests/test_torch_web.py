"""The port's results browser (``jepsen_tpu_torch/web.py``) against the
reference's on the same store: the index (run rows, verdict badges, the
txn anomaly and lattice badges, the live row), the ``/engine`` dashboard
(a daemon's stats with open sessions, none open, none at all), and the
``/files`` path-traversal guard; the port daemon's own ``stats.json``
rendered with its open sessions; and ``python -m jepsen_tpu_torch
serve`` answering over HTTP.
"""
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from jepsen_tpu import web as web_ref
from jepsen_tpu_torch import fixtures as fx
from jepsen_tpu_torch import serve, store
from jepsen_tpu_torch import web as web_pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _store(root):
    """Runs of both kinds: a valid and an invalid register run, a txn
    verdict with anomalies and a witness at the top level, a suite run's
    lattice holds under ``results.txn``, and an unreadable one."""
    hist = fx.gen_history("cas", n_ops=10, processes=2, seed=1)
    store.save_check(root, "reg", "a1", hist, {"valid": True})
    store.save_check(root, "reg", "a2", hist, {"valid": False})
    store.save_check(root, "txn", "b1", hist, {
        "valid": False, "anomalies": ["G-single", "G2", "made-up"],
        "witness": {"cycle": [{"txn": 3, "process": 0, "index": 7,
                               "value": [["append", 1, 2]]},
                              {"txn": 5, "process": 1, "index": 9,
                               "value": [["r", 1, [2]]]}],
                    "edges": ["rw", "wr"]}})
    store.save_check(root, "suite", "c1", hist, {
        "valid": False, "results": {"txn": {
            "holds": {"read-committed": True, "si": False,
                      "serializable": False},
            "weakest-violated": "si"}}})
    bad = os.path.join(root, "broken", "d1")
    os.makedirs(bad)
    with open(os.path.join(bad, "results.json"), "w") as f:
        f.write("{not json")


def _stats(root, payload):
    d = os.path.join(root, "serve")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "stats.json"), "w") as f:
        json.dump(payload, f)


SESSIONS_OPEN = {
    "counters": {"serve.completed": 5, "serve.session.appends": 12},
    "queue": {"depth": 0, "max_depth": 256},
    "breaker": {"state": "closed"},
    "sessions": {"open": 2, "closed": 1, "oldest-age-s": 12.5,
                 "per-tenant": {"team-a": 2}, "appends": 7, "ops": 420},
    "timeseries": [{"req_s": 1.0, "p50_s": 0.1}, {"req_s": 2.0,
                                                  "p50_s": 0.2}],
    "histograms": {"serve.e2e_s": {"count": 5, "p50": 0.1, "p99": 0.2,
                                   "mean": 0.12}}}


def test_index_equals_the_reference(tmp_path):
    root = str(tmp_path)
    _store(root)
    page = web_pt._index_html(root)
    assert page == web_ref._index_html(root)
    for text in ("INVALID", "G-single", "witness cycle (2 txns)",
                 "si &#10007;", "made-up"):
        assert text in page
    _stats(root, SESSIONS_OPEN)
    page = web_pt._index_html(root)
    assert page == web_ref._index_html(root)
    assert "check-serve daemon (5 checks served)" in page


@pytest.mark.parametrize("stats", [
    SESSIONS_OPEN,
    {"counters": {}, "queue": {}, "sessions": {"open": 0, "closed": 3}},
    {"counters": {"serve.quarantined": 2}, "queue": {}, "degraded": True,
     "breaker": {"state": "open", "consecutive_failures": 5},
     "journal": {"pending": 1, "terminal": 4}}],
    ids=["open-sessions", "no-open-sessions", "degraded"])
def test_engine_page_equals_the_reference(tmp_path, stats):
    root = str(tmp_path)
    _stats(root, stats)
    page = web_pt._engine_html(root)
    assert page == web_ref._engine_html(root)
    if stats is SESSIONS_OPEN:
        assert "2 open sessions" in page and "team-a" in page
    elif "degraded" in stats:
        assert "DEGRADED: breaker open" in page
    else:
        assert "no open sessions" in page


def test_engine_page_without_a_daemon_names_the_port(tmp_path):
    page = web_pt._engine_html(str(tmp_path))
    assert "python -m jepsen_tpu_torch check-serve" in page
    assert page.replace("jepsen_tpu_torch", "jepsen_tpu") == \
        web_ref._engine_html(str(tmp_path))


def test_daemon_stats_render_open_sessions(tmp_path):
    """The port daemon's own ``serve/stats.json`` with two open sessions
    renders their row."""
    root = str(tmp_path)
    d = serve.Daemon(port=0, store_root=root, device="cpu").start()
    try:
        url = f"http://127.0.0.1:{d.port}"
        for t in ("ta", "tb"):
            req = urllib.request.Request(
                url + "/session", data=json.dumps({"tenant": t}).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=30).read()
        d.dispatcher._write_stats_file()
    finally:
        d.shutdown()
    st = json.load(open(os.path.join(root, "serve", "stats.json")))
    assert st["sessions"]["open"] == 2
    page = web_pt._engine_html(root)
    assert "2 open sessions" in page and "ta: 1, tb: 1" in page


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def test_files_and_the_traversal_guard(tmp_path):
    root = tmp_path / "store"
    _store(str(root))
    (tmp_path / "secret.txt").write_text("secret")
    os.symlink(str(tmp_path / "secret.txt"), str(root / "link.txt"))
    httpd = web_pt.serve(root=str(root), port=0, block=False)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        run = os.path.relpath(store.tests(str(root))["reg"][0], str(root))
        code, body = _get(f"{url}/files/{run}/results.json")
        assert code == 200 and json.loads(body)["valid"] is True
        assert _get(f"{url}/")[0] == 200 and _get(f"{url}/engine")[0] == 200
        for path in ("/files/../secret.txt", "/files/%2e%2e/secret.txt",
                     "/files/%252e%252e/secret.txt", "/files/link.txt",
                     "/files//etc/passwd", "/nope"):
            code, body = _get(url + path)
            assert code == 404 and b"secret" not in body, path
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_serve_command_answers(tmp_path):
    _store(str(tmp_path))
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch", "serve", "--store-root",
         str(tmp_path), "--port", "0"], stdout=subprocess.PIPE, text=True,
        env=env, cwd=str(tmp_path))
    try:
        line = proc.stdout.readline()
        assert line.startswith("jepsen-tpu web: http://127.0.0.1:")
        url = line.split()[2]
        end = time.monotonic() + 30
        while True:
            code, body = _get(url)
            if code == 200 or time.monotonic() > end:
                break
            time.sleep(0.05)
        assert code == 200 and b"jepsen-tpu results" in body
        assert b"INVALID" in body
    finally:
        proc.terminate()
        proc.wait(10)

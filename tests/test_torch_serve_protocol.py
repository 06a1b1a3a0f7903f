"""The check daemon's HTTP protocol on the CPU (``docs/SERVING.md``):
the refusals (400, 413, 415, 429, 503), cancel (200, 404, 409),
deadlines, the journal's replay across a shutdown and a ``DELETE`` of a
journaled request not yet replayed, ``/session*`` (no 501: item 3(c)),
``/metrics``, ``/profile``, and the idempotency race: eight concurrent
duplicate POSTs, 50 rounds, each admitting exactly one request.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from jepsen_tpu_torch import fixtures, obs, serve
from jepsen_tpu_torch.serve import engine as serve_engine
from jepsen_tpu_torch.serve import journal as jr
from jepsen_tpu_torch.serve import request as rq

torch.set_num_threads(1)


def _http(url, method, path, payload=None, raw=None,
          ctype="application/json"):
    data = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            body = r.read()
            return r.status, (json.loads(body) if body[:1] == b"{"
                              else body.decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _body(seed=3, n_ops=12, **extra):
    hist = [op.to_dict() for op in fixtures.gen_history(
        "cas", n_ops=n_ops, processes=2, seed=seed)]
    return {"model": "cas-register", "history": hist, **extra}


@pytest.fixture
def admit_only(tmp_path):
    """A daemon that admits and journals, and dispatches nothing."""
    d = serve.Daemon(port=0, store_root=str(tmp_path), queue_depth=2,
                     max_body_bytes=64 << 10, device="cpu")
    d.start(dispatch=False)
    yield d, f"http://127.0.0.1:{d.port}"
    d.shutdown(drain_timeout=0.1)


def _wait_terminal(url, rid, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        code, st = _http(url, "GET", f"/check/{rid}")
        if st.get("status") not in ("queued", "dispatched"):
            return code, st
        time.sleep(0.02)
    raise AssertionError(f"{rid} never finished")


def test_refusals(admit_only):
    d, url = admit_only
    code, resp = _http(url, "POST", "/check", _body())
    assert code == 202 and resp["status"] == "queued"
    for bad in ({"model": "cas-register", "history": []},
                {"model": "no-such-model", "history": _body()["history"]},
                {"history": "not-a-list"},
                _body(**{"timeout-s": -1}),
                _body(options={"consistency": "nope"})):
        code, err = _http(url, "POST", "/check", bad)
        assert code == 400 and "error" in err
    code, err = _http(url, "POST", "/check", raw=b"{not json")
    assert code == 400
    code, err = _http(url, "POST", "/check", raw=b"x" * (65 << 10))
    assert code == 413 and "exceeds" in err["error"]
    code, err = _http(url, "POST", "/check", _body(), ctype="text/xml")
    assert code == 415
    code, resp2 = _http(url, "POST", "/check", _body(seed=4))
    assert code == 202
    code, err = _http(url, "POST", "/check", _body(seed=5))
    assert code == 429 and err["retry-after-s"] == 1.0
    code, st = _http(url, "GET", "/stats")
    assert st["requests"] == {"queued": 2}
    assert st["counters"]["serve.rejected.backpressure"] >= 1
    assert len(d.journal.pending_ids()) == 2    # the 429 left no entry
    d.accepting = False
    code, err = _http(url, "POST", "/check", _body(seed=6))
    assert code == 503 and "shutting down" in err["error"]
    for method, path in (("POST", "/nope"), ("GET", "/nope"),
                         ("DELETE", "/stats")):
        assert _http(url, method, path, {})[0] == 404
    code, hz = _http(url, "GET", "/healthz")
    assert code == 200 and hz["ok"] is True and hz["device"] == "cpu"


def test_sessions_answer_501_naming_their_item(admit_only):
    """Item 3(c) is ported: no ``/session*`` route answers 501. An open
    answers 201 (the default model), an unknown session 404, a route
    with no action 404."""
    d, url = admit_only
    code, opened = _http(url, "POST", "/session", {})
    assert code == 201 and opened["model"] == "cas-register"
    for method, path in (("POST", "/session/x/append"),
                         ("POST", "/session/x/close"), ("GET", "/session/x"),
                         ("POST", f"/session/{opened['session']}/nope")):
        code, err = _http(url, method, path, {})
        assert code == 404 and "error" in err


def test_cancel_codes(admit_only):
    d, url = admit_only
    rid = _http(url, "POST", "/check", _body())[1]["id"]
    code, st = _http(url, "DELETE", f"/check/{rid}")
    assert code == 200 and st["status"] == rq.CANCELLED
    assert d.journal.lookup_terminal(rid)["status"] == "cancelled"
    assert _http(url, "DELETE", f"/check/{rid}")[0] == 409
    assert _http(url, "DELETE", "/check/doesnotexist")[0] == 404
    # a dispatched request is flagged; its publish reads the flag
    rid2 = _http(url, "POST", "/check", _body(seed=8))[1]["id"]
    req = d.registry.get(rid2)
    req.status = rq.DISPATCHED
    d.queue.cancel(rid2)
    code, st = _http(url, "DELETE", f"/check/{rid2}")
    assert code == 200 and req.cancel_requested


def test_deadlines_time_out(tmp_path):
    """A deadline that passes while queued finishes ``timeout`` without
    a dispatch; one whose group is still walking at its deadline aborts
    and finishes ``timeout`` (cause ``deadline``)."""
    d = serve.Daemon(port=0, store_root=str(tmp_path), device="cpu")
    d.start(dispatch=False)
    url = f"http://127.0.0.1:{d.port}"
    try:
        rid = _http(url, "POST", "/check",
                    _body(**{"timeout-s": 0.01}))[1]["id"]
        time.sleep(0.05)
        d.dispatcher.start()
        code, st = _wait_terminal(url, rid)
        assert st["status"] == rq.TIMEOUT
        assert st["result"]["cause"] == "deadline"
        assert st["result"]["queued-only"] is True
        assert [w["stage"] for w in st["waterfall"]] == ["queued"]
        # dispatched past its deadline: the abort hook ends the walk
        code, resp = _http(url, "POST", "/check", _body(
            seed=11, n_ops=6_000, **{"timeout-s": 0.3}))
        code, st = _wait_terminal(url, resp["id"])
        assert st["status"] in (rq.TIMEOUT, rq.DONE)
        if st["status"] == rq.TIMEOUT:
            assert st["result"]["cause"] == "deadline"
    finally:
        d.shutdown(drain_timeout=30)


def test_journal_replay_after_shutdown(tmp_path):
    """Admitted into a daemon that stops before dispatching: a fresh
    daemon on the same store root replays them under their ids (the
    idempotency index too), checks them, and after its own restart
    answers ``GET /check/<id>`` from the journal's markers."""
    root = str(tmp_path)
    d1 = serve.Daemon(port=0, store_root=root, device="cpu")
    d1.start(dispatch=False)
    u1 = f"http://127.0.0.1:{d1.port}"
    a = _http(u1, "POST", "/check", _body(idempotency_key="k",
                                          tenant="team-a"))[1]["id"]
    b = _http(u1, "POST", "/check", _body(seed=9))[1]["id"]
    other = _http(u1, "POST", "/check", _body(idempotency_key="k",
                                              tenant="team-b"))[1]
    assert other["id"] != a and not other.get("deduped")
    d1.shutdown(drain_timeout=0.1)

    d2 = serve.Daemon(port=0, store_root=root, device="cpu")
    with obs.capture() as cap:
        assert d2.replay_journal() == 3
    assert cap.counters.get("serve.journal.replayed") == 3
    assert d2.registry.get(a).tenant == "team-a"
    assert d2.registry.get(a).journaled and d2.replay_journal() == 0
    d2.dispatcher.start()
    d2.start(dispatch=False)
    u2 = f"http://127.0.0.1:{d2.port}"
    code, dup = _http(u2, "POST", "/check", _body(idempotency_key="k",
                                                  tenant="team-a"))
    assert code == 202 and dup["id"] == a and dup["deduped"] is True
    for rid in (a, b):
        code, st = _wait_terminal(u2, rid)
        assert code == 200 and st["status"] == rq.DONE
        assert st["result"]["valid"] is True
    d2.shutdown(drain_timeout=10)

    d3 = serve.Daemon(port=0, store_root=root, device="cpu")
    d3.start(dispatch=False)
    u3 = f"http://127.0.0.1:{d3.port}"
    code, st = _http(u3, "GET", f"/check/{a}")
    assert code == 200 and st["recovered-from-journal"] is True
    assert st["status"] == "done" and st["result"]["valid"] is True
    assert d3.replay_journal() == 0
    d3.shutdown(drain_timeout=0.1)


def test_delete_of_journaled_unreplayed_request(tmp_path):
    root = str(tmp_path)
    d1 = serve.Daemon(port=0, store_root=root, device="cpu")
    d1.start(dispatch=False)
    rid = _http(f"http://127.0.0.1:{d1.port}", "POST", "/check",
                _body())[1]["id"]
    d1.shutdown(drain_timeout=0.1)
    d2 = serve.Daemon(port=0, store_root=root, device="cpu")
    d2.start(dispatch=False)
    u2 = f"http://127.0.0.1:{d2.port}"
    try:
        assert _http(u2, "GET", f"/check/{rid}")[0] == 404
        code, out = _http(u2, "DELETE", f"/check/{rid}")
        assert code == 200 and out["cancelled-in-journal"] is True
        assert d2.replay_journal() == 0 and d2.registry.get(rid) is None
        code, st = _http(u2, "GET", f"/check/{rid}")
        assert code == 200 and st["status"] == "cancelled"
        assert st["recovered-from-journal"] is True
    finally:
        d2.shutdown(drain_timeout=0.1)


def test_replay_rederives_deadline_and_quarantines_corrupt(tmp_path):
    d = serve.Daemon(port=0, store_root=str(tmp_path), device="cpu")
    ops = fixtures.gen_history("cas", n_ops=4, processes=2, seed=9)
    d.journal._write(d.journal._req_path("old1"), {
        "id": "old1", "tenant": "t", "model": "cas-register",
        "options": {}, "timeout-s": 5.0, "idempotency-key": None,
        "submitted-at": time.time() - 100.0,
        "history-edn": jr.history_to_edn(ops)})
    with open(d.journal._req_path("junk"), "w") as f:
        f.write("{definitely not json")
    with obs.capture() as cap:
        assert d.replay_journal() == 1
    assert d.registry.get("old1").expired()
    assert [f["stage"] for f in cap.fallbacks()] == ["serve-journal"]
    assert d.journal.lookup_terminal("junk")["status"] == rq.QUARANTINED
    assert d.journal.pending_ids() == ["old1"]
    d.shutdown(drain_timeout=0.1)


def test_concurrent_duplicate_posts_dedup_to_one_id(tmp_path):
    """Eight concurrent POSTs with one idempotency key, 50 rounds: each
    round admits exactly one request, and the other seven answer its id.
    (The reference's check-then-act window admitted a second one now and
    then: ``jepsen_tpu/serve/http.py:1017-1048`` against
    ``:1136-1149``.)"""
    d = serve.Daemon(port=0, store_root=str(tmp_path), queue_depth=512,
                     device="cpu")
    d.start(dispatch=False)
    url = f"http://127.0.0.1:{d.port}"
    body = _body()
    try:
        for rnd in range(50):
            results, lock = [], threading.Lock()
            barrier = threading.Barrier(8)

            def post(key=f"race-{rnd}"):
                barrier.wait()
                code, resp = _http(url, "POST", "/check",
                                   dict(body, **{"idempotency-key": key,
                                                 "tenant": "race"}))
                with lock:
                    results.append((code, resp))

            threads = [threading.Thread(target=post) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert not any(t.is_alive() for t in threads)
            assert [c for c, _ in results] == [202] * 8
            assert len({r["id"] for _, r in results}) == 1, (rnd, results)
            assert sum(1 for _, r in results if r.get("deduped")) == 7
            assert d.queue.depth() == rnd + 1
        assert len(d.journal.pending_ids()) == 50
    finally:
        d.shutdown(drain_timeout=0.1)


def test_metrics_and_profile_routes(tmp_path, monkeypatch):
    """``/metrics`` is a parseable exposition whose e2e histogram counts
    the completed requests; ``/profile`` arms the profiler around the
    next N dispatches (400 on a bad count, 409 while armed or without a
    store root) and writes its capture."""
    started, stopped = [], []
    monkeypatch.setattr(serve_engine, "_profiler_start",
                        lambda path: started.append(path) or "prof")
    monkeypatch.setattr(serve_engine, "_profiler_stop",
                        lambda prof, path: stopped.append(path) or 3)
    d = serve.Daemon(port=0, store_root=str(tmp_path), device="cpu")
    d.start()
    url = f"http://127.0.0.1:{d.port}"
    try:
        assert _http(url, "POST", "/profile", {"dispatches": 0})[0] == 400
        code, armed = _http(url, "POST", "/profile", {"dispatches": 2})
        assert code == 202 and armed["dispatches"] == 2
        assert _http(url, "POST", "/profile", {"dispatches": 1})[0] == 409
        for s in range(2):
            rid = _http(url, "POST", "/check", _body(seed=s))[1]["id"]
            _wait_terminal(url, rid)
        assert d.dispatcher.drain(10)
        assert started == [armed["profile-dir"]] == stopped
        assert d.dispatcher.profile_state()["device-records"] == 3
        code, text = _http(url, "GET", "/metrics")
        parsed = obs.parse_prometheus(text)
        done = parsed["jepsen_serve_completed"][0][1]
        assert parsed["jepsen_serve_e2e_s_count"][0][1] == done >= 2
        assert "jepsen_serve_queue_wait_s_bucket" in parsed
        code, st = _http(url, "GET", "/stats")
        assert st["histograms"]["serve.e2e_s"]["count"] == done
        assert st["profile"]["armed"] == 0 and st["pipeline_k"] == 4
    finally:
        d.shutdown(drain_timeout=10)
    no_root = serve.Daemon(port=0, device="cpu")
    assert no_root.profile(b'{"dispatches": 1}')[0] == 409
    no_root.shutdown(drain_timeout=0.1)


def test_real_profiler_capture(tmp_path):
    """The torch profiler itself, around one dispatch on the CPU: its
    Chrome trace lands in the capture dir, and it records no device
    activity here."""
    d = serve.Daemon(port=0, store_root=str(tmp_path), device="cpu")
    d.start()
    url = f"http://127.0.0.1:{d.port}"
    try:
        pdir = _http(url, "POST", "/profile", {"dispatches": 1})[1][
            "profile-dir"]
        _wait_terminal(url, _http(url, "POST", "/check", _body())[1]["id"])
        assert d.dispatcher.drain(10)
        st = d.dispatcher.profile_state()
        assert st["active"] is False and st["device-records"] == 0
        with open(f"{pdir}/trace.json") as f:
            assert "traceEvents" in json.load(f)
    finally:
        d.shutdown(drain_timeout=10)

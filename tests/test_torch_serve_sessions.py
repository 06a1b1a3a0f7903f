"""The daemon's session endpoints over HTTP on the CPU (``device="cpu"``):
open, append, close and status with their refusals (400, 404, 409 for a
closed session and a seq gap, 429 at the tenant's cap), a retried block
deduped, a replay after a crash keeping the id, the seq and the verdict,
the idle sweeper closing a stale session (its marker survives a
restart), the journal's collection of closed sessions, and a session
journal written by the reference daemon replayed by the port's, and the
other way round, with the same verdicts.
"""
import json
import os
import time
import urllib.error
import urllib.request

import pytest
import torch

from jepsen_tpu import models as m_ref
from jepsen_tpu import serve as serve_ref
from jepsen_tpu.serve import journal as jr_ref
from jepsen_tpu_torch import fixtures as fx
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import models, obs, serve
from jepsen_tpu_torch.checkers import facade
from jepsen_tpu_torch.serve import journal as jr_pt

torch.set_num_threads(1)


def _http(url, method, path, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _body(ops, **extra):
    return {"history": [op.to_dict() for op in ops], **extra}


def _exact(ops):
    return facade.auto_check_packed(models.cas_register(),
                                    h.pack(h.index(list(ops))),
                                    {"device": "cpu"})


def _daemon(root, **kw):
    return serve.Daemon(port=0, store_root=root, device="cpu", **kw)


def test_http_end_to_end_with_replay(tmp_path):
    """Open, append, a crash, a second daemon deriving the session again
    (same id and seq), a retried block deduped, a seq gap refused, the
    close equal to the one-shot check (the witness op of the violating
    stream), the close marker answering afterwards, 409 for an append
    after the close."""
    root = str(tmp_path / "store")
    d1 = _daemon(root).start()
    url = f"http://127.0.0.1:{d1.port}"
    bad = fx.corrupt(fx.gen_history("cas", n_ops=150, processes=3,
                                    seed=21), seed=2)
    blocks = [bad[i:i + 60] for i in range(0, len(bad), 60)]
    code, r = _http(url, "POST", "/session",
                    {"model": "cas-register", "tenant": "tt"})
    assert code == 201 and r["engine"] == "session-frontier-device"
    sid = r["session"]
    code, r = _http(url, "POST", f"/session/{sid}/append",
                    _body(blocks[0], seq=1))
    assert code == 200 and r["seq"] == 1 and "valid-so-far" in r
    first = r["valid-so-far"]
    d1.httpd.server_close()
    d1.dispatcher.stop()
    d2 = _daemon(root).start()
    url2 = f"http://127.0.0.1:{d2.port}"
    try:
        code, st = _http(url2, "GET", f"/session/{sid}")
        assert code == 200 and st["status"] == "open"
        assert st["seq"] == 1 and st["replayed-appends"] == 1
        assert st["valid-so-far"] is first
        code, r = _http(url2, "POST", f"/session/{sid}/append",
                        _body(blocks[0], seq=1))
        assert code == 200 and r.get("deduped") is True
        code, r = _http(url2, "POST", f"/session/{sid}/append",
                        _body(blocks[1], seq=5))
        assert code == 409 and "seq gap" in r["error"]
        for seq, b in enumerate(blocks[1:], start=2):
            code, r = _http(url2, "POST", f"/session/{sid}/append",
                            _body(b, seq=seq))
            assert code == 200 and r["seq"] == seq
        code, r = _http(url2, "POST", f"/session/{sid}/close", {})
        assert code == 200 and r["status"] == "closed"
        ref = _exact(bad)
        assert r["result"]["valid"] is False is ref["valid"]
        assert r["result"]["op"] == json.loads(json.dumps(
            ref["op"], default=lambda o: o.to_dict()))
        code, st = _http(url2, "GET", f"/session/{sid}")
        assert code == 200 and st["status"] == "closed"
        assert _http(url2, "POST", f"/session/{sid}/append",
                     _body(blocks[0], seq=99))[0] == 409
        stats = _http(url2, "GET", "/stats")[1]
        assert stats["counters"]["serve.session.replayed"] >= 1
        assert stats["sessions"]["open"] == 0
    finally:
        d2.shutdown()
    d3 = _daemon(root).start(dispatch=False)
    try:
        code, st = _http(f"http://127.0.0.1:{d3.port}", "GET",
                         f"/session/{sid}")
        assert code == 200 and st["recovered-from-journal"] is True
        assert st["result"]["valid"] is False
    finally:
        d3.shutdown()


def test_refusals(tmp_path):
    d = _daemon(str(tmp_path), session_tenant_cap=2).start(dispatch=False)
    url = f"http://127.0.0.1:{d.port}"
    hist = fx.gen_history("cas", n_ops=6, processes=2, seed=1)
    try:
        assert _http(url, "GET", "/session/nope")[0] == 404
        assert _http(url, "POST", "/session/nope/append",
                     _body(hist, seq=1))[0] == 404
        assert _http(url, "POST", "/session/nope/close", {})[0] == 404
        assert _http(url, "POST", "/session",
                     {"model": "not-a-model"})[0] == 400
        sids = [_http(url, "POST", "/session", {"tenant": "tt"})[1]["session"]
                for _ in range(2)]
        code, r = _http(url, "POST", "/session", {"tenant": "tt"})
        assert code == 429 and r["cause"] == "tenant-cap"
        assert r["retry-after-s"] == 1.0
        assert _http(url, "POST", "/session", {"tenant": "other"})[0] == 201
        # the refused open left no journal entry to replay
        assert set(sids) <= set(d.journal.open_session_ids())
        assert len(d.journal.open_session_ids()) == 3
        assert _http(url, "POST", f"/session/{sids[0]}/append",
                     {"history": []})[0] == 400
        # the journaled block waits in the queue (no dispatch here): 202
        code, r = _http(url, "POST", f"/session/{sids[0]}/append",
                        _body(hist, seq=1, **{"wait-s": 0}))
        assert code == 202 and r["seq"] == 1
        assert _http(url, "GET", f"/check/{r['id']}")[1]["status"] \
            == "queued"
    finally:
        d.shutdown(drain_timeout=0.1)


def test_idle_sweeper_closes_and_journal_remembers(tmp_path):
    d = _daemon(str(tmp_path), session_idle_ttl_s=3600.0).start()
    url = f"http://127.0.0.1:{d.port}"
    hist = fx.gen_history("cas", n_ops=20, processes=2, seed=5)
    try:
        stale = _http(url, "POST", "/session", {"tenant": "tt"})[1]["session"]
        assert _http(url, "POST", f"/session/{stale}/append",
                     _body(hist, seq=1))[0] == 200
        fresh = _http(url, "POST", "/session", {"tenant": "tt"})[1]["session"]
        d.sessions.get(stale).last_active_mono = time.monotonic() - 7200.0
        assert [s.id for s in d.sessions.idle_open(3600.0)] == [stale]
        with obs.capture() as cap:
            assert d.expire_idle_sessions() == 1
        assert cap.counters.get("serve.session.evicted_idle") == 1
        code, st = _http(url, "GET", f"/session/{stale}")
        assert st["status"] == "closed" and st["result"]["valid"] is True
        assert _http(url, "GET", f"/session/{fresh}")[1]["status"] == "open"
        assert _http(url, "POST", f"/session/{stale}/append",
                     _body(hist, seq=2))[0] == 409
    finally:
        d.shutdown()
    t_restart = time.monotonic()
    d2 = _daemon(str(tmp_path), session_idle_ttl_s=3600.0).start()
    try:
        code, st = _http(f"http://127.0.0.1:{d2.port}", "GET",
                         f"/session/{stale}")
        assert st["status"] == "closed"
        # the replayed session's idle clock restarts at the replay
        assert d2.sessions.get(fresh).last_active_mono >= t_restart
        assert d2.expire_idle_sessions() == 0
    finally:
        d2.shutdown()


@pytest.mark.parametrize("Journal", [jr_pt.Journal, jr_ref.Journal],
                         ids=["port", "reference"])
def test_journal_collects_closed_sessions(tmp_path, Journal):
    """Both journals over the same calls: closed sessions past
    ``keep_terminal`` are collected, oldest first, open ones never."""
    j = Journal(str(tmp_path), keep_terminal=2)
    for i in range(4):
        sid = f"s{i}"
        j.session_open(sid, tenant="t", model_name="cas-register",
                       options={})
        j.session_append_entry(sid, 1, fx.gen_history(
            "cas", n_ops=4, processes=2, seed=i))
        j.session_close_marker(sid, {"valid": True})
        os.utime(os.path.join(str(tmp_path), f"{sid}.sdone.json"),
                 (1000 + i, 1000 + i))
    assert j.gc() >= 2
    left = sorted({n.split(".")[0] for n in os.listdir(str(tmp_path))
                   if "sess" in n or "sapp" in n or "sdone" in n})
    assert left == ["s2", "s3"]
    j.session_open("sopen", tenant="t", model_name="cas-register",
                   options={})
    j.gc()
    assert j.open_session_ids() == ["sopen"]


def _write_session(journal, sid, blocks, close=None):
    journal.session_open(sid, tenant="tx", model_name="cas-register",
                         options={})
    for seq, b in enumerate(blocks, start=1):
        journal.session_append_entry(sid, seq, b)
    if close is not None:
        journal.session_close_marker(sid, close)


def test_journal_replays_across_packages(tmp_path):
    """A session journal written by the reference's ``Journal`` replays in
    the port's daemon, and one written by the port's replays in the
    reference's, each into the same seq and verdict as the one-shot
    check; a closed session's marker is read by the other."""
    bad = fx.corrupt(fx.gen_history("cas", n_ops=80, processes=3, seed=7),
                     seed=7)
    good = fx.gen_history("cas", n_ops=80, processes=3, seed=8)
    from jepsen_tpu.op import Op as OpRef

    def ref_ops(ops):
        return [OpRef.from_dict(o.to_dict()) for o in ops]

    root_a = str(tmp_path / "a")
    ja = jr_ref.Journal(os.path.join(root_a, "serve", "journal"))
    _write_session(ja, "sbad", [ref_ops(bad[:70]), ref_ops(bad[70:])])
    _write_session(ja, "sgood", [ref_ops(good)], close={"valid": True})
    d = _daemon(root_a).start()
    try:
        s = d.sessions.get("sbad")
        assert s is not None and s.seq == 2 and s.replayed == 2
        assert d.sessions.get("sgood") is None
        url = f"http://127.0.0.1:{d.port}"
        code, r = _http(url, "POST", "/session/sbad/close", {})
        ref = _exact(bad)
        assert code == 200 and r["result"]["valid"] is ref["valid"]
        assert _http(url, "GET", "/session/sgood")[1]["result"] \
            == {"valid": True}
    finally:
        d.shutdown()

    root_b = str(tmp_path / "b")
    jb = jr_pt.Journal(os.path.join(root_b, "serve", "journal"))
    _write_session(jb, "sbad", [bad[:70], bad[70:]])
    _write_session(jb, "sgood", [good], close={"valid": True})
    dr = serve_ref.Daemon(port=0, store_root=root_b)
    try:
        assert dr.replay_sessions() == 1
        s = dr.sessions.get("sbad")
        assert s.seq == 2 and s.replayed == 2
        res = s.close()
        from jepsen_tpu import history as h_ref
        from jepsen_tpu.checkers import facade as facade_ref
        ref = facade_ref.auto_check_packed(
            m_ref.cas_register(), h_ref.pack(h_ref.index(ref_ops(bad))), {})
        assert res["valid"] is ref["valid"] is False
        assert dr.journal.session_lookup_closed("sgood")["result"] \
            == {"valid": True}
    finally:
        dr.httpd.server_close()

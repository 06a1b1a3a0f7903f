"""The port's streaming sessions (``serve/session.py``: ``Session``,
``advance_group``, ``SessionRegistry``) against the reference's on the
CPU, on the same op streams: every block's verdict, the first violation
and the close's result; the group advance (K10's plain version) bit for
bit against the solo one; a mid-stream violation isolated to its lane; a
member whose feed regrows its geometry falling out alone; replayed
sessions joining a group again; the exactly-one host fallback of an
injected fault (solo, in a group's stage, at its launch, and the txn
engine's hook); and the port's fault rule: a device fault (a wrapper
raising ``RuntimeError("CUDA error: ...")``) ends the session or the
whole group ``error`` with no solo re-advance and no host monitor, and
the daemon counts it and turns ``/healthz`` to 503.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from jepsen_tpu.serve import session as ses_ref
from jepsen_tpu_torch import fixtures as fx
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import models, obs, serve
from jepsen_tpu_torch.checkers import facade, reach, reach_lane, reach_word
from jepsen_tpu_torch.op import invoke, ok
from jepsen_tpu_torch.serve import faults
from jepsen_tpu_torch.serve import session as sm

torch.set_num_threads(1)

CUDA_FAULT = "CUDA error: an illegal memory access was encountered"


def _ref_ops(ops):
    from jepsen_tpu.op import Op as OpRef
    return [OpRef.from_dict(o.to_dict()) for o in ops]


def _plain(x):
    """A verdict as JSON-shaped data (ops as maps), for comparing the two
    packages' results."""
    return json.loads(json.dumps(x, default=lambda o: o.to_dict()
                                 if hasattr(o, "to_dict") else str(o)))


def _strip(v, drop=("session",)):
    return {k: val for k, val in _plain(v).items() if k not in drop}


def _sessions(prefix, n, model_name="cas-register"):
    mk = models.cas_register if model_name == "cas-register" \
        else models.register
    return [sm.Session(f"{prefix}{i}", f"t{i % 2}", model_name, mk(),
                       device="cpu") for i in range(n)]


def _ref_sessions(prefix, n, model_name="cas-register"):
    from jepsen_tpu import models as m_ref
    mk = m_ref.cas_register if model_name == "cas-register" \
        else m_ref.register
    return [ses_ref.Session(f"{prefix}{i}", f"t{i % 2}", model_name, mk())
            for i in range(n)]


def _run_waves(sessions, blocks_per, grouped, mod=sm, conv=list):
    results = [[] for _ in sessions]
    for w in range(max(len(b) for b in blocks_per)):
        entries = [(s, conv(blocks_per[i][w]), w + 1)
                   for i, s in enumerate(sessions) if w < len(blocks_per[i])]
        out = (mod.advance_group(entries) if grouped else
               [s.advance_block(o, seq=q) for s, o, q in entries])
        for (s, _o, _q), r in zip(entries, out):
            results[sessions.index(s)].append(r)
    return results


def _ragged(hist, seed, n_cuts):
    rng = np.random.RandomState(seed)
    cuts = sorted(rng.choice(len(hist), size=n_cuts, replace=False))
    out, prev = [], 0
    for c in list(cuts) + [len(hist)]:
        if c > prev:
            out.append(hist[prev:c])
            prev = c
    return out


def _closed_register_blocks(waves):
    """Register streams over a closed two-value alphabet: every (op,
    value) pair is in block 1, so later blocks never regrow the geometry
    and every wave after the first is one group."""
    b1 = [invoke(0, "write", 1), ok(0, "write", 1), invoke(1, "read"),
          ok(1, "read", 1), invoke(0, "write", 2), ok(0, "write", 2),
          invoke(1, "read"), ok(1, "read", 2)]
    bw = [invoke(1, "write", 1), ok(1, "write", 1), invoke(0, "read"),
          ok(0, "read", 1), invoke(0, "write", 2), ok(0, "write", 2),
          invoke(1, "read"), ok(1, "read", 2)]
    return [b1] + [list(bw) for _ in range(waves - 1)]


def _cas_hists(n, n_ops=120, bad=(2,), crash=()):
    out = []
    for seed in range(n):
        hh = fx.gen_history("cas", n_ops=n_ops, processes=3, seed=seed,
                            crash_p=0.02 if seed in crash else 0.0)
        out.append(fx.corrupt(hh, seed=seed) if seed in bad else hh)
    return out


def _exact(model, ops):
    return facade.auto_check_packed(model, h.pack(h.index(list(ops))),
                                    {"device": "cpu"})


# -- against the reference ------------------------------------------------

VERDICT_KEYS = ("seq", "block-ops", "ops", "valid-so-far", "tail-alarm",
                "engine", "settled-returns", "violation")
CLOSE_KEYS = ("valid", "op", "dead-event", "appends", "session-ops",
              "session-engine", "incremental")


def test_block_verdicts_and_close_equal_the_reference():
    """Ragged blocks (one stream corrupted, one with crashed ops): every
    block's verdict (validity, tail alarm, settled returns, the first
    violation), then the close's exact verdict, equal the reference's
    sessions on the same streams, solo and in groups."""
    hists = _cas_hists(5, bad=(2,), crash=(4,))
    blocks = [_ragged(hh, seed=i + 1, n_cuts=2 + i % 3)
              for i, hh in enumerate(hists)]
    for grouped in (False, True):
        pt = _sessions("p", 5)
        rf = _ref_sessions("p", 5)
        rp = _run_waves(pt, blocks, grouped)
        rr = _run_waves(rf, blocks, grouped, mod=ses_ref, conv=_ref_ops)
        for i in range(5):
            assert [{k: _plain(v).get(k) for k in VERDICT_KEYS}
                    for v in rp[i]] == \
                [{k: _plain(v).get(k) for k in VERDICT_KEYS}
                 for v in rr[i]], (grouped, i)
            cp, cr = _plain(pt[i].close()), _plain(rf[i].close())
            assert {k: cp.get(k) for k in CLOSE_KEYS} == \
                {k: cr.get(k) for k in CLOSE_KEYS}, (grouped, i)
        assert rp[2][-1]["valid-so-far"] is False


def test_txn_session_equals_the_reference():
    """A txn session's blocks and close against the reference's, a write
    skew included (the closure's join on K9's plain version)."""
    hist = fx.gen_txn_history(60, keys=3, seed=4)
    hist = h.index(hist + [op.with_(index=-1)
                           for op in fx.txn_anomaly_block("write-skew")])
    blocks = [hist[i:i + 40] for i in range(0, len(hist), 40)]
    from jepsen_tpu.txn import ops as txn_ref
    from jepsen_tpu_torch.txn import ops as txn_pt
    pt = sm.Session("x", "t", "txn-list-append", txn_pt.list_append_model(),
                    device="cpu")
    rf = ses_ref.Session("x", "t", "txn-list-append",
                         txn_ref.list_append_model())
    keys = ("valid-so-far", "txns", "engine", "in-flight", "ops")
    for k, b in enumerate(blocks):
        vp = pt.advance_block(b, seq=k + 1)
        vr = rf.advance_block(_ref_ops(b), seq=k + 1)
        assert {x: vp.get(x) for x in keys} == {x: vr.get(x) for x in keys}
    cp, cr = pt.close(), rf.close()
    for k in ("valid", "anomalies", "anomaly"):
        assert _plain(cp).get(k) == _plain(cr).get(k)
    assert cp["valid"] is False and cp["session-engine"] == "session-txn-mxu"


# -- the group against solo -------------------------------------------------

def test_group_vs_solo_bit_identical_ragged():
    hists = _cas_hists(5, bad=(2,))
    blocks = [_ragged(hh, seed=i + 1, n_cuts=2 + i % 3)
              for i, hh in enumerate(hists)]
    solo, mega = _sessions("s", 5), _sessions("m", 5)
    rs = _run_waves(solo, blocks, False)
    with obs.capture() as cap:
        rm = _run_waves(mega, blocks, True)
    assert cap.counters.get("serve.session.mega.groups", 0) >= 1
    assert cap.counters.get("serve.session.mega.lanes", 0) >= 2
    assert cap.counters.get("reach.mega_walk", 0) >= 1
    for i in range(5):
        assert [_strip(v) for v in rs[i]] == [_strip(v) for v in rm[i]]
        cs, cm = solo[i]._eng._carry, mega[i]._eng._carry
        assert (cs is None) == (cm is None)
        if cs is not None:
            assert torch.equal(cs._R, cm._R)
    for i in range(5):
        fs, fm = solo[i].close(), mega[i].close()
        ref = _exact(models.cas_register(), hists[i])
        assert fs["valid"] is fm["valid"] is ref["valid"]
        assert fs.get("op") == fm.get("op") == ref.get("op")


def test_group_mid_stream_violation_isolates():
    good = [fx.gen_history("cas", n_ops=90, processes=3, seed=s)
            for s in (10, 11, 12)]
    bad = fx.corrupt(fx.gen_history("cas", n_ops=90, processes=3, seed=13),
                     seed=3)
    hists = good[:1] + [bad] + good[1:]
    blocks = [[hh[j:j + 30] for j in range(0, len(hh), 30)] for hh in hists]
    rs = _run_waves(_sessions("vs", 4), blocks, False)
    mega = _sessions("vm", 4)
    rm = _run_waves(mega, blocks, True)
    assert [v["valid-so-far"] for v in rs[1]] == \
        [v["valid-so-far"] for v in rm[1]]
    assert False in [v["valid-so-far"] for v in rm[1]]
    for i in (0, 2, 3):
        assert all(v["valid-so-far"] for v in rm[i])
        assert mega[i].close()["valid"] is True
    res, ref = mega[1].close(), _exact(models.cas_register(), bad)
    assert res["valid"] is False and res.get("op") == ref.get("op")


def test_group_geometry_regrowth_falls_out_solo():
    blk1 = [invoke(0, "write", 1), ok(0, "write", 1), invoke(1, "read"),
            ok(1, "read", 1)]
    calm = [invoke(1, "write", 1), ok(1, "write", 1), invoke(0, "read"),
            ok(0, "read", 1)]
    burst = []
    for val in range(10, 50):           # 40 fresh values: O regrows
        burst += [invoke(0, "write", val), ok(0, "write", val)]
    burst_bad = burst + [invoke(1, "read"), ok(1, "read", 999)]
    for tail, valid in ((burst, True), (burst_bad, False)):
        blocks = [[blk1, calm, calm], [blk1, tail, calm]]
        rs = _run_waves(_sessions("rs", 2, "register"), blocks, False)
        mega = _sessions("rm", 2, "register")
        with obs.capture() as cap:
            rm = _run_waves(mega, blocks, True)
        regrows = [r for r in cap.ledger if r.get("stage") == "session-mega"
                   and r.get("event") == "regrow"]
        assert [r.get("session") for r in regrows] == ["rm1"]
        for i in range(2):
            assert [_strip(v) for v in rs[i]] == [_strip(v) for v in rm[i]]
        assert rm[1][1]["valid-so-far"] is valid
        assert mega[0].close()["valid"] is True
        assert mega[1].close()["valid"] is valid


# -- the fault rule -----------------------------------------------------------

def _seeded(prefix, n):
    blocks = _closed_register_blocks(2)
    sessions = _sessions(prefix, n, "register")
    for s in sessions:
        s.advance_block(blocks[0], seq=1)
    assert len({s.mega_sig() for s in sessions}) == 1
    return sessions, blocks


def test_injected_stage_fault_takes_exactly_one_fallback():
    faults.reset()
    sessions, blocks = _seeded("fd", 3)
    faults.arm("session-advance", at=2)         # member index 1's stage
    try:
        with obs.capture() as cap:
            out = sm.advance_group([(s, blocks[1], 2) for s in sessions])
    finally:
        faults.reset()
    falls = [f for f in cap.fallbacks() if f["stage"] == "session-advance"]
    assert len(falls) == 1 and falls[0]["session"] == "fd1"
    assert cap.counters.get("serve.session.mega.lanes") == 2
    assert sessions[1].engine_name == "session-host-monitor"
    assert sessions[1].fallbacks == 1
    assert all(r["valid-so-far"] for r in out)
    ref = _exact(models.register(), blocks[0] + blocks[1])
    for s in sessions:
        assert s.close()["valid"] is ref["valid"]


def test_injected_launch_fault_re_advances_members_alone():
    """An injected fault at the group's launch: one ``session-mega``
    fallback with the lane count, every staged member re-advanced alone
    on its staged operands, no member's device path given up."""
    faults.reset()
    solo, blocks = _seeded("ls", 3)
    mega, _ = _seeded("lm", 3)
    want = [s.advance_block(blocks[1], seq=2) for s in solo]
    faults.arm("session-mega", at=1)
    try:
        with obs.capture() as cap:
            out = sm.advance_group([(s, blocks[1], 2) for s in mega])
    finally:
        faults.reset()
    falls = [f for f in cap.fallbacks() if f["stage"] == "session-mega"]
    assert len(falls) == 1 and falls[0]["lanes"] == 3
    assert not [f for f in cap.fallbacks()
                if f["stage"] == "session-advance"]
    for s, o, w in zip(mega, out, want):
        assert s.engine_name == "session-frontier-device"
        assert _strip(o) == _strip(w)


@pytest.mark.parametrize("where", ["launch", "collect"])
def test_device_fault_in_group_ends_every_member_error(where, monkeypatch):
    """A CUDA error at K10's launch or collect: every staged member ends
    ``error`` (cause device-fault), none is re-advanced alone or sent to
    the host monitor, and the members that completed before the launch
    (here: none) keep their verdicts."""
    sessions, blocks = _seeded("df", 3)
    solo_walks = []
    monkeypatch.setattr(reach.FrontierCarry, "advance",
                        lambda *a: solo_walks.append(a) or -1)

    def _boom(*a, **k):
        raise RuntimeError(f"mega_walk kernel launch failed: {CUDA_FAULT}")

    target = "launch_frontiers_mega" if where == "launch" \
        else "collect_frontiers_mega"
    monkeypatch.setattr(reach_word, target, _boom)
    with obs.capture() as cap:
        out = sm.advance_group([(s, blocks[1], 2) for s in sessions])
    assert not solo_walks
    assert not [f for f in cap.fallbacks()
                if f["stage"] == "session-advance"]
    for s, r in zip(sessions, out):
        assert r["cause"] == "device-fault" and CUDA_FAULT in r["error"]
        assert s.faulted and s.closed and s.fallbacks == 0
        assert s._host is None and s.status()["status"] == "error"
        with pytest.raises(sm.SessionClosed):
            s.advance_block(blocks[1], seq=3)


def test_device_fault_in_solo_advance_ends_the_session(monkeypatch):
    """A CUDA error in K1's wrapper during a solo advance ends the session
    ``error``, with no host monitor; another error ends it ``error`` with
    cause ``fault``; the close returns the same result."""
    def _boom(*a, **k):
        raise RuntimeError(f"lane_walk kernel launch failed: {CUDA_FAULT}")

    monkeypatch.setattr(reach_lane, "lane_walk", _boom)
    s = _sessions("so", 1)[0]
    hist = fx.gen_history("cas", n_ops=40, processes=2, seed=1)
    with obs.capture() as cap:
        r = s.advance_block(hist, seq=1)
    assert r["cause"] == "device-fault" and s.faulted
    assert s.engine_name == "session-frontier-device" and s._host is None
    assert not cap.fallbacks()
    assert s.close() == s.result and s.result["cause"] == "device-fault"

    def _other(*a, **k):
        raise ValueError("not a device fault")

    monkeypatch.setattr(reach_lane, "lane_walk", _other)
    s2 = _sessions("so2", 1)[0]
    assert s2.advance_block(hist, seq=1)["cause"] == "fault"


@pytest.mark.parametrize("grouped", [False, True], ids=["solo", "group"])
def test_deadline_abort_ends_the_session_error(grouped):
    """The dispatcher's deadline abort is no fallback: a solo advance or
    every member of a group ends ``error`` with cause ``deadline``, keeps
    no host monitor, records no fallback and launches no group."""
    sessions, blocks = _seeded("dl", 3)
    entries = [(s, blocks[1], 2) for s in sessions]
    with obs.capture() as cap:
        out = (sm.advance_group(entries, should_abort=lambda: True)
               if grouped else
               [s.advance_block(o, seq=q, should_abort=lambda: True)
                for s, o, q in entries])
    assert not cap.fallbacks()
    assert "serve.session.mega.lanes" not in cap.counters
    for s, r in zip(sessions, out):
        assert r["cause"] == "deadline" and "dispatch deadline" in r["error"]
        assert s.faulted and s._host is None and s.fallbacks == 0
        assert s.status()["status"] == "error"
        assert s.close()["cause"] == "deadline"


def test_txn_hook_injected_fault_exactly_one_fallback():
    from jepsen_tpu_torch.txn import ops as txn_pt
    faults.reset()
    hist = fx.gen_txn_history(40, keys=2, seed=3)
    s = sm.Session("tx", "t", "txn-list-append", txn_pt.list_append_model(),
                   device="cpu")
    faults.arm("session-advance", at=1)
    try:
        with obs.capture() as cap:
            r = s.advance_block(hist[:40], seq=1)
    finally:
        faults.reset()
    assert len([f for f in cap.fallbacks()
                if f["stage"] == "session-advance"]) == 1
    assert s.engine_name == "session-txn-host" and r["valid-so-far"]
    s.advance_block(hist[40:], seq=2)
    ref = facade.auto_check_txn(h.index(list(hist)), {"device": "cpu"})
    assert s.close()["valid"] is ref["valid"]


# -- the daemon ---------------------------------------------------------------

def _http(url, method, path, payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_replayed_sessions_reenter_a_group(tmp_path):
    root = str(tmp_path / "store")
    d1 = serve.Daemon(port=0, store_root=root, device="cpu").start()
    url = f"http://127.0.0.1:{d1.port}"
    blocks = _closed_register_blocks(2)
    sids = []
    for _ in range(2):
        code, r = _http(url, "POST", "/session",
                        {"model": "register", "tenant": "tt"})
        assert code == 201
        sids.append(r["session"])
        code, r = _http(url, "POST", f"/session/{r['session']}/append",
                        {"history": [op.to_dict() for op in blocks[0]],
                         "seq": 1})
        assert code == 200, r
    d1.httpd.server_close()              # a crash: no drain, no shutdown
    d1.dispatcher.stop()
    d2 = serve.Daemon(port=0, store_root=root, device="cpu").start()
    try:
        ss = [d2.sessions.get(sid) for sid in sids]
        sigs = {s.mega_sig() for s in ss}
        assert len(sigs) == 1 and None not in sigs
        with obs.capture() as cap:
            out = sm.advance_group([(s, blocks[1], 2) for s in ss])
        assert cap.counters.get("serve.session.mega.groups") == 1
        assert cap.counters.get("serve.session.mega.lanes") == 2
        assert all(r["valid-so-far"] for r in out)
        ref = _exact(models.register(), blocks[0] + blocks[1])
        for s in ss:
            assert s.close()["valid"] is ref["valid"]
    finally:
        d2.shutdown()


def test_dispatcher_group_and_device_fault_through_the_daemon(
        tmp_path, monkeypatch):
    """Queued appends of three sessions ride one group dispatch; then a
    device fault in the next group ends all three ``error`` (500 on
    their appends, ``status: error``), counts one device fault, turns
    ``/healthz`` to 503 and writes their journal markers."""
    d = serve.Daemon(port=0, store_root=str(tmp_path), device="cpu"
                     ).start(dispatch=False)
    url = f"http://127.0.0.1:{d.port}"
    blocks = _closed_register_blocks(3)
    try:
        sids = []
        for i in range(3):
            code, r = _http(url, "POST", "/session",
                            {"model": "register", "tenant": f"t{i % 2}"})
            sids.append(r["session"])
        for sid in sids:                # seeded alone: one geometry
            s = d.sessions.get(sid)
            s.advance_block(blocks[0], seq=1)
            s.seq = 1
        rids = [_http(url, "POST", f"/session/{sid}/append",
                      {"history": [op.to_dict() for op in blocks[1]],
                       "seq": 2, "wait-s": 0})[1]["id"] for sid in sids]
        d.dispatcher.start()
        for rid in rids:
            end = time.monotonic() + 60
            while True:
                code, r = _http(url, "GET", f"/check/{rid}")
                if r.get("status") == "done":
                    assert r["result"]["valid-so-far"] is True
                    break
                assert time.monotonic() < end
                time.sleep(0.02)
        stats = _http(url, "GET", "/stats")[1]
        assert stats["counters"]["serve.session.mega.groups"] >= 1
        assert stats["sessions"]["open"] == 3

        def _boom(*a, **k):
            raise RuntimeError(f"mega_walk kernel launch failed: "
                               f"{CUDA_FAULT}")

        monkeypatch.setattr(reach_word, "launch_frontiers_mega", _boom)
        d.dispatcher.stop()
        d.dispatcher._stop.clear()
        rids = [_http(url, "POST", f"/session/{sid}/append",
                      {"history": [op.to_dict() for op in blocks[2]],
                       "seq": 3, "wait-s": 0})[1]["id"] for sid in sids]
        d.dispatcher.start()
        for rid in rids:
            end = time.monotonic() + 60
            while True:
                code, r = _http(url, "GET", f"/check/{rid}")
                if r.get("status") not in ("queued", "dispatched"):
                    assert code == 500 and r["status"] == "error"
                    assert r["result"]["cause"] == "device-fault"
                    break
                assert time.monotonic() < end
                time.sleep(0.02)
        code, hz = _http(url, "GET", "/healthz")
        assert code == 503 and hz["device-faults"] == 1
        for sid in sids:
            code, st = _http(url, "GET", f"/session/{sid}")
            assert st["status"] == "error"
            assert d.journal.session_lookup_closed(sid)["result"][
                "cause"] == "device-fault"
        assert not d.journal.open_session_ids()
    finally:
        d.shutdown()


def test_session_device_keyword_routes_to_the_host(tmp_path):
    """``Daemon(session_device=False)`` (the reference's
    ``JEPSEN_TPU_NO_SESSION_DEVICE``) opens register sessions on the
    host monitor, with the same verdicts."""
    d = serve.Daemon(port=0, store_root=str(tmp_path), device="cpu",
                     session_device=False).start()
    url = f"http://127.0.0.1:{d.port}"
    hist = fx.corrupt(fx.gen_history("cas", n_ops=60, processes=2, seed=9),
                      seed=9)
    try:
        code, r = _http(url, "POST", "/session", {"model": "cas-register"})
        assert code == 201 and r["engine"] == "session-host-monitor"
        sid = r["session"]
        code, r = _http(url, "POST", f"/session/{sid}/append",
                        {"history": [op.to_dict() for op in hist]})
        assert code == 200
        code, r = _http(url, "POST", f"/session/{sid}/close", {})
        ref = _exact(models.cas_register(), hist)
        assert r["result"]["valid"] is ref["valid"] is False
        assert r["result"].get("op") == _plain(ref).get("op")
    finally:
        d.shutdown()

"""The check daemon's journal across the two packages, on the CPU: a
journal the JAX daemon wrote replays in the port's daemon and the
reverse, with the same pending ids, idempotency index and terminal
lookups; the port's verdict markers read in the reference's journal;
the entry round trip, cancellation and GC; and the fleet leases (claim,
renew, expire, steal, release, a torn and a corrupt lease, exactly one
winner under contention).
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import serve as serve_ref
from jepsen_tpu.serve import journal as jr_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import obs, serve
from jepsen_tpu_torch.serve import faults
from jepsen_tpu_torch.serve import journal as jr

torch.set_num_threads(1)


def _post(url, payload):
    req = urllib.request.Request(
        url + "/check", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _delete(url, rid):
    req = urllib.request.Request(url + f"/check/{rid}", method="DELETE")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _bodies(fx):
    hist = lambda s: [o.to_dict() for o in fx.gen_history(  # noqa: E731
        "cas", n_ops=16, processes=2, seed=s)]
    return [{"model": "cas-register", "history": hist(1), "tenant": "a",
             "idempotency-key": "job-1"},
            {"model": "cas-register", "history": hist(2), "tenant": "b",
             "timeout-s": 3600, "options": {"max_states": 5000}},
            {"model": "mutex", "history": [
                {"process": 0, "type": "invoke", "f": "acquire",
                 "value": None},
                {"process": 0, "type": "ok", "f": "acquire",
                 "value": None}], "tenant": "c"},
            {"model": "cas-register", "history": hist(4), "tenant": "a",
             "idempotency-key": "job-2"}]


def _admit(daemon_cls, fx, root, **kw):
    """Admit the four bodies into a daemon that dispatches nothing, and
    cancel the last; returns the ids."""
    d = daemon_cls(port=0, store_root=root, **kw)
    d.start(dispatch=False)
    url = f"http://127.0.0.1:{d.port}"
    ids = [_post(url, b)["id"] for b in _bodies(fx)]
    _delete(url, ids[3])
    d.shutdown(drain_timeout=0.1)
    return ids


def _view(j, ids):
    return (j.pending_ids(), j.idempotency_index(),
            [j.lookup_terminal(r) and (j.lookup_terminal(r)["status"],
                                       j.lookup_terminal(r)["result"])
             for r in ids],
            [j.load_entry(r)["history-edn"] for r in ids])


def _replayed(d, ids):
    return [(r.tenant, r.model_name, r.opts, r.idem_key, r.n_ops,
             r.deadline is not None, r.status)
            for r in map(d.registry.get, ids[:3])]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_replays_across_packages(writer, tmp_path):
    root = str(tmp_path)
    if writer == "reference":
        ids = _admit(serve_ref.Daemon, fx_ref, root)
    else:
        ids = _admit(serve.Daemon, fx_pt, root, device="cpu")
    jdir = os.path.join(root, "serve", "journal")
    ref_view = _view(jr_ref.Journal(jdir), ids)
    assert _view(jr.Journal(jdir), ids) == ref_view
    assert sorted(ref_view[0]) == sorted(ids[:3])
    assert ref_view[1] == {("a", "job-1"): ids[0], ("a", "job-2"): ids[3]}
    assert ref_view[2][3][0] == "cancelled"

    d_ref = serve_ref.Daemon(port=0, store_root=root)
    d_pt = serve.Daemon(port=0, store_root=root, device="cpu")
    try:
        assert d_pt.replay_journal() == d_ref.replay_journal() == 3
        assert _replayed(d_pt, ids) == _replayed(d_ref, ids)
        assert d_pt.registry.get(ids[3]) is None
        assert d_pt._idem == d_ref._idem
        assert d_pt.lookup(ids[3])[1]["status"] == "cancelled"
        assert d_pt.lookup("nope")[0] == d_ref.lookup("nope")[0] == 404
    finally:
        d_ref.shutdown(drain_timeout=0.1)
        d_pt.shutdown(drain_timeout=0.1)


def test_port_verdicts_read_in_the_reference_journal(tmp_path):
    """Entries the reference admitted, checked by the port's daemon: the
    reference's journal and daemon answer from the port's markers."""
    root = str(tmp_path)
    ids = _admit(serve_ref.Daemon, fx_ref, root)
    d = serve.Daemon(port=0, store_root=root, device="cpu")
    d.start()
    assert d.dispatcher.drain(60)
    d.shutdown(drain_timeout=10)
    j = jr_ref.Journal(os.path.join(root, "serve", "journal"))
    assert j.pending_ids() == []
    for rid in ids[:3]:
        term = j.lookup_terminal(rid)
        assert term["status"] == "done" and term["result"]["valid"] is True
    d_ref = serve_ref.Daemon(port=0, store_root=root)
    try:
        code, st = d_ref.lookup(ids[0])
        assert code == 200 and st["recovered-from-journal"]
        assert st["result"]["engine"] == "reach-lane"
        assert d_ref.replay_journal() == 0
    finally:
        d_ref.shutdown(drain_timeout=0.1)


def _ops(seed=0):
    return fx_pt.gen_history("cas", n_ops=4, processes=2, seed=seed)


def test_journal_entry_roundtrip_cancel_and_gc(tmp_path):
    j = jr.Journal(str(tmp_path), keep_terminal=2, gc_every=100)
    ops = _ops(1)
    with obs.capture() as cap:
        j.append(req_id="r1", tenant="team.a", model_name="cas-register",
                 options={"max_states": 500}, timeout_s=9.5,
                 idempotency_key="k1", history=ops)
    assert cap.counters.get("serve.journal.appended") == 1
    e = j.load_entry("r1")
    assert (e["tenant"], e["timeout-s"], e["options"]) == \
        ("team.a", 9.5, {"max_states": 500})
    assert [o.to_dict() for o in jr.history_from_edn(e["history-edn"])] \
        == [o.to_dict() for o in ops]
    assert jr.history_to_edn(ops) == jr_ref.history_to_edn(
        fx_ref.gen_history("cas", n_ops=4, processes=2, seed=1))
    j.finish("r1", "done", {"valid": True, "engine": "reach"})
    j.finish("r1", "timeout")
    assert j.lookup_terminal("r1")["status"] == "done"
    assert j.idempotency_index() == {("team.a", "k1"): "r1"}
    j.append(req_id="c1", tenant="t", model_name="cas-register",
             options={}, timeout_s=None, idempotency_key=None,
             history=ops)
    assert j.cancel_pending("c1") is True
    assert j.cancel_pending("c1") is False and not j.cancel_pending("nope")
    for i in range(4):
        j.append(req_id=f"g{i}", tenant="t", model_name="cas-register",
                 options={}, timeout_s=None, idempotency_key=None,
                 history=ops)
        j.finish(f"g{i}", "done", {"valid": True})
        os.utime(j._done_path(f"g{i}"), (100 + i, 100 + i))
    j.append(req_id="pending", tenant="t", model_name="cas-register",
             options={}, timeout_s=None, idempotency_key=None, history=ops)
    os.utime(j._done_path("r1"), (1, 1))
    os.utime(j._done_path("c1"), (2, 2))
    assert j.gc() == 4
    assert [r for r in ("r1", "c1", "g0", "g1", "g2", "g3")
            if j.lookup_terminal(r)] == ["g2", "g3"]
    assert j.pending_ids() == ["pending"]
    with open(j._req_path("bad"), "w") as f:
        f.write("{not json")
    assert j.load_entry("bad") is None and "bad" in j.pending_ids()
    assert j.stats()["terminal"] == 2


def test_injected_journal_corruption_is_quarantined_at_replay(tmp_path):
    faults.reset()
    try:
        faults.arm("journal-write", at=1)
        d = serve.Daemon(port=0, store_root=str(tmp_path), device="cpu")
        d.start(dispatch=False)
        rid = _post(f"http://127.0.0.1:{d.port}",
                    _bodies(fx_pt)[0])["id"]
        d.shutdown(drain_timeout=0.1)
        d2 = serve.Daemon(port=0, store_root=str(tmp_path), device="cpu")
        assert d2.replay_journal() == 0
        assert d2.journal.lookup_terminal(rid)["status"] == "quarantined"
        d2.shutdown(drain_timeout=0.1)
    finally:
        faults.reset()


# -- fleet leases -------------------------------------------------------------------

def test_lease_claim_renew_expire_steal_release(tmp_path):
    j = jr.Journal(str(tmp_path / "j"))
    assert j.claim("e1", replica="a", ttl_s=5.0) is True
    assert j.lease_live("e1") == "a"
    assert j.claim("e1", replica="b", ttl_s=5.0) is False
    with obs.capture() as cap:
        assert j.claim("e1", replica="a", ttl_s=5.0) is True
        assert j.claim("e2", replica="a", ttl_s=0.05)
        time.sleep(0.08)
        assert j.lease_live("e2") is None
        assert j.claim("e2", replica="b", ttl_s=5.0) is True
    assert cap.counters.get("serve.lease.renewed") == 1
    assert cap.counters.get("serve.lease.stolen") == 1
    assert j.lease_live("e2") == "b"
    # the reference's journal reads the port's leases
    assert jr_ref.Journal(str(tmp_path / "j")).lease_live("e2") == "b"
    j.release("e1", "b")
    assert j.lease_live("e1") == "a"
    j.release("e1", "a")
    assert j.lease_live("e1") is None
    assert "e1" not in j.leases() and "e2" in j.leases()


def test_torn_and_corrupt_leases(tmp_path):
    j = jr.Journal(str(tmp_path / "j"))
    with open(j._lease_path("e3"), "wb") as f:
        f.write(b'{"replica": "a", "expires')
    assert j.lease_live("e3") is None
    assert j.claim("e3", replica="b", ttl_s=5.0) is True
    faults.reset()
    try:
        faults.arm("lease-write", at=1)
        assert j.claim("e4", replica="a", ttl_s=5.0) is True
    finally:
        faults.reset()
    with obs.capture() as cap:
        assert j.lease_live("e4") is None
    assert cap.counters.get("serve.lease.corrupt") == 1
    assert os.path.exists(j._lease_path("e4") + ".corrupt")
    assert j.claim("e4", replica="b", ttl_s=5.0) is True


def test_lease_contention_admits_exactly_one(tmp_path):
    """Two replicas (two journals over one root) and the reference's
    journal race every claim, fresh and stolen: exactly one wins."""
    root = str(tmp_path / "j")
    racers = [(jr.Journal(root), "a"), (jr.Journal(root), "b"),
              (jr_ref.Journal(root), "r")]
    for i in range(16):
        eid = f"e{i}"
        if i % 2:
            assert racers[0][0].claim(eid, replica="gone", ttl_s=0.01)
            time.sleep(0.03)
        wins = {}
        barrier = threading.Barrier(len(racers))

        def go(j, name):
            barrier.wait()
            wins[name] = j.claim(eid, replica=name, ttl_s=5.0)

        ts = [threading.Thread(target=go, args=r) for r in racers]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert sum(wins.values()) == 1, (eid, wins)
        assert racers[0][0].lease_live(eid) in ("a", "b", "r")


def test_fleet_pair_dedups_and_adopts(tmp_path):
    """Two port replicas over one store root: a duplicate POST on the
    other replica dedups to the first id, either answers the poll, and
    a replica adopts an entry whose holder's lease expired."""
    root = str(tmp_path / "store")
    da = serve.Daemon(port=0, store_root=root, replica_id="a",
                      lease_ttl_s=0.3, device="cpu")
    db = serve.Daemon(port=0, store_root=root, replica_id="b",
                      lease_ttl_s=0.3, device="cpu")
    da.start(dispatch=False)
    db.start(dispatch=False)
    ua, ub = f"http://127.0.0.1:{da.port}", f"http://127.0.0.1:{db.port}"
    try:
        body = _bodies(fx_pt)[0]
        rid = _post(ua, body)["id"]
        assert da.journal.lease_live(rid) == "a"
        dup = _post(ub, body)
        assert dup["id"] == rid and dup["deduped"] is True
        code, st = db.lookup(rid)
        assert code == 200 and st["fleet"] and st["claimed-by"] == "a"
        assert db.fleet_scan() == 0             # a's lease is live
        time.sleep(0.4)
        assert db.fleet_scan() == 1             # expired: b adopts it
        assert db.journal.lease_live(rid) == "b"
        assert db.registry.get(rid) is not None
    finally:
        da.shutdown(drain_timeout=0.1)
        db.shutdown(drain_timeout=0.1)

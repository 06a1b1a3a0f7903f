"""The check daemon's recovery on the CPU, as the reference's
``tests/test_serve_recovery.py`` and ``tests/test_serve_fleet.py`` drive
it: injected faults take the ladder (retry, bisect, quarantine of a
poison member while the others complete, the breaker's open,
host-served ``degraded`` results and half-open heal, per-lane breakers),
a hung dispatch requeues its survivors; and the port's line: a device
fault (a kernel wrapper's ``CUDA error`` launch failure, a
``torch.AcceleratorError``) ends its group ``error`` with cause
``device-fault``, with no retry, no bisection and no host rescue, and
turns ``/healthz`` to 503.
"""
import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

from jepsen_tpu_torch import fixtures, models, obs
from jepsen_tpu_torch.checkers import (facade, reach_batch, reach_lane,
                                       reach_pallas, wgl_ref)
from jepsen_tpu_torch.serve import engine as serve_engine
from jepsen_tpu_torch.serve import faults, recovery
from jepsen_tpu_torch.serve import request as rq
from jepsen_tpu_torch.serve.coalesce import AdmissionQueue
from jepsen_tpu_torch.txn import cycles

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    yield
    faults.reset()


def _mk_req(n_ops=8, tenant="t"):
    return rq.CheckRequest(
        id=rq.new_request_id(), tenant=tenant, model_name="cas-register",
        model=models.cas_register(), packed=types.SimpleNamespace(n=n_ops),
        history=[], n_ops=n_ops)


def _counter_delta(before):
    """Recovery counters are bumped on the lane threads, which a test's
    capture does not see: deltas of the process-wide counters."""
    after = obs.counters()
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


@pytest.fixture
def ladder(monkeypatch):
    """A real Dispatcher over a stubbed facade and host oracle; the real
    faults module raises, so the production fire points are under
    test. ``pipeline_k=1``: the stub histories cannot be staged."""
    calls = {"many": 0, "one": 0, "host": 0, "behavior": None}

    def fake_many(model, packed_list, kw):
        calls["many"] += 1
        if calls["behavior"]:
            calls["behavior"](kw, len(packed_list))
        return [{"valid": True, "engine": "stub"} for _ in packed_list]

    def fake_one(model, packed, kw):
        calls["one"] += 1
        if calls["behavior"]:
            calls["behavior"](kw, 1)
        return {"valid": True, "engine": "stub"}

    def fake_host(model, packed, **kw):
        calls["host"] += 1
        return {"valid": True, "engine": "wgl-cpu"}

    monkeypatch.setattr(facade, "auto_check_many_packed", fake_many)
    monkeypatch.setattr(facade, "auto_check_packed", fake_one)
    monkeypatch.setattr(wgl_ref, "check_packed", fake_host)
    started = []

    def build(lanes=1, group=8, **dkw):
        q = AdmissionQueue(max_depth=64, group=group, lanes=lanes)
        reg = rq.Registry()
        d = serve_engine.Dispatcher(
            q, reg, engine_kw={"device": "cpu"}, pipeline_k=1, lanes=lanes,
            retry_policy=recovery.RetryPolicy(max_retries=1, base_s=0.001,
                                              max_requeues=2), **dkw)
        d.start()
        started.append(d)
        return d, q, reg

    yield build, calls
    for d in started:
        d.stop()


def _run(reg, q, reqs, timeout=20.0):
    for r in reqs:
        reg.add(r)
        q.submit(r)
    for r in reqs:
        assert r.done_event.wait(timeout), (r.id, r.status)


def test_transient_dispatch_crash_retries_and_completes(ladder):
    build, calls = ladder
    faults.arm("dispatch", at=1, times=1)
    d, q, reg = build()
    c0 = obs.counters()
    reqs = [_mk_req(tenant=f"t{i}") for i in range(3)]
    _run(reg, q, reqs)
    assert all(r.status == rq.DONE and r.result["valid"] is True
               for r in reqs)
    c = _counter_delta(c0)
    assert c.get("serve.retry.attempts") == 1
    assert "serve.retry.bisects" not in c and "serve.quarantined" not in c
    assert any(t["stage"] == "serve-dispatch" and t["event"] == "fallback"
               for r in reqs for t in r.trace)


def test_poison_member_quarantined_innocents_complete(ladder):
    build, calls = ladder
    faults.arm("dispatch", tenant="bad", times=1 << 30, name="poison")
    d, q, reg = build()
    c0 = obs.counters()
    good = [_mk_req(tenant=f"ok{i}") for i in range(3)]
    bad = _mk_req(tenant="bad")
    _run(reg, q, good + [bad])
    assert all(r.status == rq.DONE and r.result["valid"] is True
               for r in good)
    assert bad.status == rq.QUARANTINED and bad.result["quarantined"]
    assert "InjectedFault" in bad.result["error"]
    c = _counter_delta(c0)
    assert c.get("serve.quarantined") == 1
    assert c.get("serve.retry.bisects", 0) >= 1
    assert len([t for t in bad.trace
                if t["stage"] == "serve-quarantine"]) == 1
    assert reg.stats()["requests"].get("quarantined") == 1


def test_breaker_opens_serves_host_then_heals(ladder):
    build, calls = ladder
    faults.arm("device", at=1, times=100)
    d, q, reg = build(
        breaker=recovery.CircuitBreaker(threshold=2, cooldown_s=0.1))
    c0 = obs.counters()
    reqs = [_mk_req(tenant="t") for _ in range(3)]
    _run(reg, q, reqs)
    assert all(r.status == rq.DONE and r.result["valid"] is True
               for r in reqs)
    assert d.breaker.state == "open" and calls["host"] >= 1
    assert any(r.result.get("degraded") for r in reqs)
    c = _counter_delta(c0)
    assert c.get("serve.breaker.opened") == 1
    assert c.get("serve.breaker.degraded_dispatches", 0) >= 1
    st = d.stats()
    assert st["degraded"] is True and st["breaker"]["state"] == "open"
    faults.reset()
    time.sleep(0.12)
    probe = _mk_req(tenant="t")
    _run(reg, q, [probe])
    assert probe.status == rq.DONE and d.breaker.state == "closed"
    assert d.stats()["degraded"] is False


def test_hung_dispatch_requeue_path(ladder):
    """An abort that returns unknowns (the walk's own shape) requeues the
    survivors instead of publishing the abort."""
    build, calls = ladder
    state = {"n": 0}

    def slow_then_fast(kw, lanes):
        state["n"] += 1
        if state["n"] == 1:
            end = time.monotonic() + 5.0
            while time.monotonic() < end:
                if kw["should_abort"]():
                    raise _Unknown()
                time.sleep(0.005)

    class _Unknown(Exception):
        pass

    stub_many = facade.auto_check_many_packed

    def many(model, packed_list, kw):
        try:
            return stub_many(model, packed_list, kw)
        except _Unknown:
            return [{"valid": "unknown", "cause": "aborted"}
                    for _ in packed_list]

    calls["behavior"] = slow_then_fast
    import unittest.mock as mock
    with mock.patch.object(facade, "auto_check_many_packed", many):
        d, q, reg = build(dispatch_deadline_s=0.05)
        c0 = obs.counters()
        reqs = [_mk_req(tenant=f"t{i}") for i in range(2)]
        _run(reg, q, reqs)
        assert all(r.status == rq.DONE and r.result["valid"] is True
                   and r.requeues == 1 for r in reqs)
        assert _counter_delta(c0).get("serve.retry.requeued") == 2
        assert any(t["stage"] == "serve-hang" for r in reqs
                   for t in r.trace)


def test_lane_fault_isolation_breaker_per_lane(ladder):
    """Lane 1's card route fails on every call (an injected fault): its
    breaker opens and its work completes on the host, while lane 0 keeps
    the card with its breaker closed."""
    build, calls = ladder

    def maybe_boom(kw, lanes):
        if threading.current_thread().name.endswith("-1"):
            raise faults.InjectedFault("lane-1 card route dies")

    calls["behavior"] = maybe_boom
    d, q, reg = build(lanes=2, group=1,
                      breaker=recovery.CircuitBreaker(threshold=1,
                                                      cooldown_s=60.0))
    reqs = [_mk_req(tenant=f"t{i}") for i in range(4)]
    _run(reg, q, reqs)
    assert all(r.status == rq.DONE and r.result["valid"] is True
               for r in reqs)
    lane0, lane1 = d._lanes
    assert lane1.breaker.degraded and not lane0.breaker.degraded
    assert calls["host"] >= 1 and calls["one"] >= 1
    st = d.stats()
    assert st["lanes"]["n"] == 2 and st["degraded"] is True
    assert len(st["lanes"]["breakers"]) == 2


def test_engine_fault_is_not_laddered(ladder):
    """A fault that is neither injected nor a capacity decline (a bug in
    an engine) ends the group ``error``: no retry, no host rescue, and
    the breaker is not fed."""
    build, calls = ladder

    def boom(kw, lanes):
        raise ValueError("batch_walk: inconsistent shapes")

    calls["behavior"] = boom
    d, q, reg = build()
    c0 = obs.counters()
    reqs = [_mk_req(tenant=f"t{i}") for i in range(3)]
    _run(reg, q, reqs)
    for r in reqs:
        assert r.status == rq.ERROR and r.result["cause"] == "fault"
        assert "inconsistent shapes" in r.result["error"]
    c = _counter_delta(c0)
    assert "serve.retry.attempts" not in c and "serve.device_faults" not in c
    assert calls["host"] == 0 and d.breaker.state == "closed"
    assert d.device_faults == 0


# -- device faults, through the daemon and the real engines ----------------------

def _post(url, payload):
    req = urllib.request.Request(
        url + "/check", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _launch_failure(name, exc=RuntimeError):
    def _raise(*a, **kw):
        raise exc(f"{name} kernel launch failed: CUDA error 701")
    return _raise


def _cas(n, seed, values=5):
    return [o.to_dict() for o in fixtures.gen_history(
        "cas", n_ops=n, processes=4, seed=seed, values=values)]


def _txn():
    return [o.to_dict() for o in fixtures.gen_txn_history(40, keys=3,
                                                          seed=2)]


# (the kernel, the wrapper its launch failure is raised from, the
# pipeline window, the requests that reach it)
DEVICE_CASES = [
    ("K1", (reach_lane, "lane_walk"), 4, [("cas-register", _cas(120, 1))]),
    ("K2-staged", (reach_batch, "batch_walk"), 4,
     [("cas-register", _cas(120 + 10 * s, s)) for s in range(3)]),
    ("K2-blocking", (reach_batch, "batch_walk"), 1,
     [("cas-register", _cas(120 + 10 * s, s)) for s in range(3)]),
    ("K4", (reach_pallas, "walk"), 4,
     [("cas-register", _cas(200, 3, values=40))]),
    ("K5", (reach_pallas, "keyed_walk"), 4,
     [("cas-register", _cas(200 + 5 * s, s, values=40)) for s in range(3)]),
    ("K8", (cycles, "square_step"), 4, [("txn-list-append", _txn())]),
    ("K1-accelerator-error", (reach_lane, "lane_walk"), 4,
     [("cas-register", _cas(120, 4))]),
]


@pytest.mark.parametrize("case", DEVICE_CASES, ids=[c[0] for c in DEVICE_CASES])
def test_device_fault_ends_group_with_no_rescue(case, tmp_path, monkeypatch):
    name, (mod, fn), k, posts = case
    exc = torch.AcceleratorError if "accelerator" in name else RuntimeError
    monkeypatch.setattr(mod, fn, _launch_failure(fn, exc))
    host = {"n": 0}
    real_host = wgl_ref.check_packed

    def spy_host(*a, **kw):
        host["n"] += 1
        return real_host(*a, **kw)

    monkeypatch.setattr(wgl_ref, "check_packed", spy_host)
    from jepsen_tpu_torch import serve
    d = serve.Daemon(port=0, store_root=str(tmp_path), device="cpu",
                     pipeline_k=k)
    d.start(dispatch=False)
    url = f"http://127.0.0.1:{d.port}"
    try:
        ids = [_post(url, {"model": m, "history": hist,
                           "tenant": f"t{i}"})["id"]
               for i, (m, hist) in enumerate(posts)]
        c0 = obs.counters()
        d.dispatcher.start()
        assert d.dispatcher.drain(60.0)
        for rid in ids:
            code, r = _get(url, f"/check/{rid}")
            assert code == 500 and r["status"] == "error", r
            assert r["result"]["cause"] == "device-fault"
            assert "CUDA error 701" in r["result"]["error"]
            assert not r["result"].get("degraded")
        c = _counter_delta(c0)
        assert c.get("serve.device_faults", 0) >= 1
        for k_ in ("serve.retry.attempts", "serve.retry.bisects",
                   "serve.quarantined", "serve.breaker.opened"):
            assert k_ not in c, (k_, c)
        assert host["n"] == 0
        code, hz = _get(url, "/healthz")
        assert code == 503 and hz["ok"] is False
        assert "CUDA error 701" in hz["device-fault"]
        assert d.dispatcher.breaker.state == "closed"
    finally:
        d.shutdown(drain_timeout=5.0)

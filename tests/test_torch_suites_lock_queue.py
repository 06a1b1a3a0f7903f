"""The port's lock service and broker (``fake/lock.py``,
``fake/broker.py``) and the mutex and queue suites (``suites/mutex.py``,
``suites/queue.py``) against the reference's, on the CPU
(``device="cpu"``; the reference under ``JAX_PLATFORMS=cpu``), after
``tests/test_mutex_suite.py`` and ``tests/test_queue_suite.py``.

Each fake is driven by one scripted op sequence on one thread, with the
same seed and partitions, in both packages, and every return compared;
the clients' completions, the workloads' op sketches and the builders'
test maps must be the reference's. Short runs of each suite on the CPU
are then checked by the reference's checkers, sub-checker by
sub-checker; the forced faults (a permanent partition before a sloppy
run, the lossy broker healed on its first drain poll) must be invalid
in both packages, and run dirs recheck across the two.
"""
import json
import os

import pytest
import torch

from jepsen_tpu import cli as cli_ref
from jepsen_tpu import core as core_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import facade as fa_ref
from jepsen_tpu.fake import broker as br_ref
from jepsen_tpu.fake import cluster as fc_ref
from jepsen_tpu.fake import lock as lk_ref
from jepsen_tpu.op import Op as OpRef
from jepsen_tpu.op import invoke as inv_ref
from jepsen_tpu.suites import mutex as mx_ref
from jepsen_tpu.suites import queue as q_ref
from jepsen_tpu_torch import cli as cli_pt
from jepsen_tpu_torch import core as core_pt
from jepsen_tpu_torch import fake as fake_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.fake import broker as br_pt
from jepsen_tpu_torch.fake import cluster as fc_pt
from jepsen_tpu_torch.fake import lock as lk_pt
from jepsen_tpu_torch.op import invoke as inv_pt
from jepsen_tpu_torch.suites import mutex as mx_pt
from jepsen_tpu_torch.suites import queue as q_pt

torch.set_num_threads(1)

NODES = ["n1", "n2", "n3", "n4", "n5"]
VERDICT = ("valid", "op", "dead-event")


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


def recorder(obj, errors):
    """``do(name, *args)`` calls ``obj.name(*args)`` and records the
    return, or the name and message of one of ``errors``."""
    out = []

    def do(name, *a):
        try:
            out.append((name, a, "ok", getattr(obj, name)(*a)))
        except errors as e:
            out.append((name, a, type(e).__name__, str(e)))
    return out, do


def route_of(ledger):
    return [(r["engine"], r["states"]) for r in ledger
            if r["stage"] == "reach" and r["event"] == "route"]


def ref_results(ref_test, history):
    """The reference's composed checker of the same suite on the port's
    history: sub-checker name -> result."""
    return ref_test["checker"].check(None, to_ref(history))["results"]


def same_subresults(got, want, exact=()):
    assert set(got) == set(want)
    for name in got:
        assert got[name]["valid"] == want[name]["valid"], name
    for name in exact:
        assert got[name] == want[name], name


# -- the lock service ---------------------------------------------------------

def _lock_script(lk, fc, mode, seed):
    svc = lk.FakeLockService(NODES, mode=mode, seed=seed)
    out, do = recorder(svc, (fc.Unavailable, fc.FakeTimeout))
    do("acquire", "n1", "L", 0)
    do("acquire", "n2", "L", 1)
    do("release", "n3", "L", 1)
    do("release", "n2", "L", 0)
    do("acquire", "n2", "L", 1)
    do("acquire", "n4", "M", 2)
    split(svc)
    do("acquire", "n1", "L", 3)
    do("acquire", "n3", "N", 4)
    do("acquire", "n1", "N", 5)
    do("release", "n4", "M", 2)
    do("acquire", "n2", "M", 6)
    svc.heal()
    do("acquire", "n5", "N", 7)
    # a clock bumped past the lease: that node judges every lease expired
    svc.bump_clock("n3", 61.0)
    do("acquire", "n3", "L", 8)
    do("acquire", "n1", "L", 9)
    do("release", "n2", "L", 1)
    svc.bump_clock("n3", None)
    do("acquire", "n3", "L", 10)
    svc.kill_node("n5")
    do("acquire", "n5", "P", 11)
    svc.start_node("n5")
    do("acquire", "n5", "P", 11)
    svc.set_loss(0.5)
    for i in range(12):
        do("acquire" if i % 2 else "release", NODES[i % 5], "P", 11)
    svc.set_loss(0.0)
    do("acquire", "nX", "L", 12)
    state = ({k: v for k, v in svc._lock_holder.items()},
             {k: v[0] for k, v in svc._leases.items()},
             {k: dict(v.data) for k, v in svc.nodes.items()})
    return out, state


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("mode", ["linearizable", "sloppy", "leases"])
def test_lock_service_script_matches_reference(mode, seed):
    want = _lock_script(lk_ref, fc_ref, mode, seed)
    got = _lock_script(lk_pt, fc_pt, mode, seed)
    assert got == want
    kinds = {r[2] for r in got[0]}
    assert {"ok", "Unavailable", "FakeTimeout"} <= kinds
    assert lk_pt.FakeLockService.MODES == lk_ref.FakeLockService.MODES


def test_leases_double_grant_under_clock_bump():
    """As the reference's: a node whose clock is bumped past the TTL
    grants a held lock a second time."""
    svc = lk_pt.FakeLockService(NODES, mode="leases", lease_ttl=30.0)
    assert svc.acquire("n1", "L", 0) is True
    assert svc.acquire("n3", "L", 1) is False
    svc.bump_clock("n3", 61.0)
    assert svc.acquire("n3", "L", 1) is True


def _lock_client_script(mx, lk, svc_mode):
    svc = lk.FakeLockService(NODES, mode=svc_mode, seed=1)
    test = {"cluster": svc}
    clients = [mx.TrackingLockClient().open(test, n) for n in NODES[:3]]
    out = []

    def do(i, f):
        op = (inv_ref if mx is mx_ref else inv_pt)(i, f)
        res = clients[i].invoke(test, op)
        out.append((i, f, res.type, res.value, res.extra,
                    dict(test["_lock_held"])))

    do(0, "acquire")
    do(1, "acquire")
    do(1, "release")
    do(0, "release")
    do(1, "acquire")
    split(svc)
    do(2, "acquire")
    do(0, "acquire")
    svc.heal()
    svc.set_loss(1.0)
    do(1, "release")
    svc.set_loss(0.0)
    do(1, "release")
    return out


@pytest.mark.parametrize("mode", ["linearizable", "sloppy", "leases"])
def test_lock_client_completions_match_reference(mode):
    want = _lock_client_script(mx_ref, lk_ref, mode)
    got = _lock_client_script(mx_pt, lk_pt, mode)
    assert got == want
    assert {r[2] for r in got} >= {"ok", "fail", "info"}


# -- the broker ---------------------------------------------------------------

def _broker_script(br, mode, seed):
    b = br.FakeBroker(NODES, mode=mode, seed=seed)
    out, do = recorder(b, (br.Empty, br.Unavailable, br.FakeTimeout))
    do("enqueue", "n1", 1)
    do("enqueue", "n2", 2)
    do("dequeue", "n3")
    do("empty")
    do("enqueue", "n4", 3)
    split(b)
    do("enqueue", "n1", 4)
    do("enqueue", "n3", 5)
    do("dequeue", "n1")
    do("dequeue", "n4")
    do("dequeue", "n2")
    b.heal()                    # lossy: the first alive node's replica wins
    for n in ("n5", "n2", "n3", "n1"):
        do("dequeue", n)
    do("empty")
    do("enqueue", "n2", 6)
    b.kill_node("n1")
    do("enqueue", "n1", 7)
    do("enqueue", "n3", 8)
    b.start_node("n1")
    do("dequeue", "n1")
    b.set_loss(0.5)
    for i in range(12):
        do("enqueue" if i % 3 else "dequeue", NODES[i % 5], *(
            (10 + i,) if i % 3 else ()))
    b.set_loss(0.0)
    for _ in range(8):
        do("dequeue", "n4")
    do("empty")
    do("enqueue", "nX", 9)
    state = (list(b._queue), {k: list(v.queue) for k, v in b.nodes.items()})
    return out, state


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("mode", ["safe", "lossy"])
def test_broker_script_matches_reference(mode, seed):
    want = _broker_script(br_ref, mode, seed)
    got = _broker_script(br_pt, mode, seed)
    assert got == want
    assert {"ok", "Empty", "Unavailable", "FakeTimeout"} <= \
        {r[2] for r in got[0]}
    assert br_pt.FakeBroker.MODES == br_ref.FakeBroker.MODES
    assert fake_pt.FakeBroker is br_pt.FakeBroker


def test_broker_lossy_autoheal_and_duplicate_delivery():
    """As the reference's: autoheal keeps the first alive node's side
    (an acknowledged enqueue on the other side is lost), and a message
    consumed on one side of a partition is delivered again on the
    other."""
    b = br_pt.FakeBroker(NODES, mode="lossy")
    split(b)
    b.enqueue("n1", "minority-msg")
    b.enqueue("n3", "majority-msg")
    b.heal()
    seen = []
    while not b.empty():
        seen.append(b.dequeue("n2"))
    assert seen == ["minority-msg"]
    b = br_pt.FakeBroker(NODES, mode="lossy")
    b.enqueue("n1", "m")
    split(b)
    assert b.dequeue("n1") == "m" and b.dequeue("n3") == "m"


def _queue_client_script(q, br):
    b = br.FakeBroker(NODES, mode="safe", seed=2)
    test = {"cluster": b}
    c = q.QueueClient().open(test, "n2")
    inv = inv_ref if q is q_ref else inv_pt
    out = []
    for op in (inv(0, "enqueue", 1), inv(0, "dequeue"), inv(0, "dequeue")):
        out.append(c.invoke(test, op))
    split(b)
    c1 = q.QueueClient().open(test, "n1")
    out.append(c1.invoke(test, inv(1, "enqueue", 2)))
    b.heal()
    b.set_loss(1.0)
    out.append(c1.invoke(test, inv(1, "enqueue", 3)))
    return [(o.type, o.value, o.extra) for o in out]


def test_queue_client_completions_match_reference():
    got = _queue_client_script(q_pt, br_pt)
    assert got == _queue_client_script(q_ref, br_ref)
    assert [t for t, _, _ in got] == ["ok", "ok", "fail", "fail", "info"]


# -- workloads and test maps --------------------------------------------------

def draw(gen, test, procs=(0, 1, "nemesis", 2), cap=400):
    out = []
    for i in range(cap):
        p = procs[i % len(procs)]
        out.append((p, gen.op(test, p)))
    return out


def test_lock_workload_follows_the_observed_hold():
    out = []
    for mx in (mx_ref, mx_pt):
        test = {"_lock_held": {0: True, 2: False}}
        out.append(draw(mx.LockWorkload(), test, cap=8))
    assert out[0] == out[1]
    assert [s["f"] for _, s in out[1][:4]] == \
        ["release", "acquire", "acquire", "acquire"]


@pytest.mark.parametrize("seed", [4, 9])
def test_leases_schedule_matches_reference(seed):
    """The leases mode's nemesis: a random node bumped twice the TTL,
    then reset, each cycle (and the clients' alternation)."""
    got, want = (draw(mx.mutex_test(mode="leases", seed=seed)["generator"],
                      {"_lock_held": {1: True}}, cap=60)
                 for mx in (mx_pt, mx_ref))
    assert got == want
    bumps = [s for p, s in got if p == "nemesis" and s and
             s.get("f") == "bump"]
    assert bumps and all(list(s["value"].values()) == [60_000]
                         for s in bumps)


class _Emptying:
    def __init__(self, n):
        self.n = n

    def empty(self):
        self.n -= 1
        return self.n < 0


@pytest.mark.parametrize("kw", [dict(seed=5), dict(seed=5, enqueue_weight=3),
                                dict(seed=8, universe=6)])
def test_queue_workload_and_drain_match_reference(kw):
    assert draw(q_pt.workload(**kw), {}) == draw(q_ref.workload(**kw), {})
    got, want = (draw(q._drain(), {"cluster": _Emptying(5)}, cap=9)
                 for q in (q_pt, q_ref))
    assert got == want
    assert [s for _, s in got].count(None) == 4


@pytest.mark.parametrize("universe", [None, 6])
def test_queue_schedule_matches_reference(universe):
    got, want = (draw(q.queue_test(seed=3, universe=universe)["generator"],
                      {"cluster": _Emptying(10 ** 6)}, cap=120)
                 for q in (q_pt, q_ref))
    assert got == want


BUILDS = {
    "mutex": lambda mx: mx.mutex_test(seed=1),
    "mutex-sloppy": lambda mx: mx.mutex_test(mode="sloppy", seed=1),
    "mutex-leases": lambda mx: mx.mutex_test(mode="leases", seed=1),
    "mutex-bare": lambda mx: mx.mutex_test(seed=1, with_nemesis=False,
                                           nodes=3, concurrency=2),
    "queue": lambda q: q.queue_test(seed=1),
    "queue-lossy": lambda q: q.queue_test(mode="lossy", seed=1),
    "queue-bounded": lambda q: q.queue_test(seed=1, universe=6,
                                            with_nemesis=False),
}


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
    }


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_builder_test_map_matches_reference(name):
    mod_pt, mod_ref = ((mx_pt, mx_ref) if name.startswith("mutex")
                       else (q_pt, q_ref))
    t = BUILDS[name](mod_pt)
    assert map_fields(t) == map_fields(BUILDS[name](mod_ref))
    assert t["device"] is None
    lin = t["checker"].checkers.get("linear")
    assert lin is None or lin.device is None


def test_builders_put_the_device_in_the_test_map():
    for t in (mx_pt.mutex_test(device="cpu"),
              q_pt.queue_test(device="cpu", universe=6)):
        assert t["device"] == "cpu"
        assert t["checker"].checkers["linear"].device == "cpu"
    assert q_pt.queue_test(device="cpu")["device"] == "cpu"


def test_run_without_card_fails_before_any_op(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for t in (mx_pt.mutex_test(time_limit=0.3), q_pt.queue_test(
            time_limit=0.3)):
        calls = []
        t["client"].invoke = lambda *a: calls.append(a)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            core_pt.run(t)
        assert calls == []


# -- short runs, checked by both packages ------------------------------------

def test_mutex_run_linearizable_matches_reference():
    t = mx_pt.mutex_test(mode="linearizable", time_limit=1.0, seed=7,
                         nemesis_interval=0.25, device="cpu")
    with obs.capture() as cap:
        done = core_pt.run(t)
    res = done["results"]["results"]
    h = done["history"]
    assert res["linear"]["valid"] is True
    assert {op.f for op in h if op.process != "nemesis"} >= \
        {"acquire", "release"}
    assert any(op.process == "nemesis" for op in h)
    assert route_of(cap.ledger) == [("reach-lane", 2)]
    same_subresults(res, ref_results(mx_ref.mutex_test(seed=7), h))
    same(fa_ref.Linearizable(m_ref.mutex()).check(None, to_ref(h)),
         res["linear"])


def test_mutex_run_sloppy_under_partition_fails_at_reference_op(tmp_path,
                                                               capsys):
    """As the reference's test: a permanent partition before the sloppy
    run, so both sides grant the lock. The port's CPU dense engine fails
    it at the JAX reference's op; its run dir rechecks in the
    reference's command line to the same op."""
    t = mx_pt.mutex_test(mode="sloppy", time_limit=1.5, seed=13,
                         with_nemesis=False, store=True, device="cpu")
    t["store-root"] = str(tmp_path)
    split(t["cluster"])
    done = core_pt.run(t)
    lin = done["results"]["results"]["linear"]
    assert lin["valid"] is False and lin["op"]
    assert os.path.exists(os.path.join(done["dir"], "linear.svg"))
    capsys.readouterr()
    assert cli_ref.main(["recheck", done["dir"], "--model", "mutex"]) == 1
    want = json.loads(capsys.readouterr().out)
    assert want["valid"] is False
    same(want, lin)


def test_mutex_run_leases_matches_reference():
    t = mx_pt.mutex_test(mode="leases", time_limit=1.0, seed=5,
                         nemesis_interval=0.2, device="cpu")
    done = core_pt.run(t)
    h = done["history"]
    assert any(op.process == "nemesis" and op.f == "bump" for op in h)
    res = done["results"]["results"]
    same_subresults(res, ref_results(mx_ref.mutex_test(mode="leases",
                                                       seed=5), h))
    same(fa_ref.Linearizable(m_ref.mutex()).check(None, to_ref(h)),
         res["linear"])


def test_queue_run_safe_matches_reference():
    t = q_pt.queue_test(mode="safe", time_limit=1.0, seed=11,
                        nemesis_interval=0.25, device="cpu")
    done = core_pt.run(t)
    res = done["results"]["results"]
    assert res["queue"]["valid"] is True
    assert res["total-queue"]["valid"] is True
    assert res["total-queue"]["acknowledged-count"] > 0
    assert res["total-queue"]["lost-count"] == 0
    assert "linear" not in res
    same_subresults(res, ref_results(q_ref.queue_test(seed=11),
                                     done["history"]),
                    exact=("queue", "total-queue", "stats"))


def test_queue_run_lossy_loses_acknowledged_enqueues():
    """As the reference's test: both sides of a permanent partition take
    enqueues, and the first drain poll heals the broker, whose autoheal
    discards one side's backlog."""
    t = q_pt.queue_test(mode="lossy", time_limit=1.5, seed=23,
                        with_nemesis=False, enqueue_weight=3, device="cpu")
    b = t["cluster"]
    split(b)
    orig_empty = b.empty

    def empty_healing_first():
        if b.dropped:
            b.heal()
        return orig_empty()

    b.empty = empty_healing_first
    done = core_pt.run(t)
    res = done["results"]["results"]
    assert res["total-queue"]["valid"] is False
    assert res["total-queue"]["lost-count"] > 0
    want = ref_results(q_ref.queue_test(mode="lossy", seed=23),
                       done["history"])
    assert want["total-queue"]["valid"] is False
    same_subresults(res, want, exact=("queue", "total-queue", "stats"))


def test_queue_run_bounded_takes_the_dense_engine(tmp_path, capsys):
    """``universe=6``: the ``linear`` check over the bounded-queue model
    on the dense engine, its route recorded (which walk depends on the
    states the history reaches), its verdict the reference's; the reference's run
    dir of the same suite rechecks in the port's command line."""
    t = q_pt.queue_test(mode="safe", time_limit=1.0, seed=7,
                        with_nemesis=False, universe=6, device="cpu")
    with obs.capture() as cap:
        done = core_pt.run(t)
    res = done["results"]["results"]
    assert res["queue"]["valid"] is True and res["linear"]["valid"] is True
    route = route_of(cap.ledger)
    assert len(route) == 1 and route[0][0].startswith("reach")
    same(fa_ref.Linearizable(m_ref.bounded_queue(6)).check(
        None, to_ref(done["history"])), res["linear"])
    rt = q_ref.queue_test(mode="safe", time_limit=0.5, seed=7,
                          with_nemesis=False, universe=6, store=True)
    rt["store-root"] = str(tmp_path)
    ref_done = core_ref.run(rt)
    capsys.readouterr()
    rc = cli_pt.main(["recheck", ref_done["dir"], "--model",
                      "bounded-queue", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert rc == 0 and got["valid"] is True
    same(ref_done["results"]["results"]["linear"], got)

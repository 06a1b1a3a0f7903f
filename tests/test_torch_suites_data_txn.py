"""The port's set, counter and list-append suites (``suites/set_suite.py``,
``suites/counter.py``, ``suites/txn.py``) against the reference's, on the
CPU (``device="cpu"``; the reference under ``JAX_PLATFORMS=cpu``), after
``tests/test_set_counter_suites.py`` and ``tests/test_txn.py``'s suite
tests.

The clients' completions (the txn tiers' over the fake etcd-v2 and RESP
servers too), ``encode_list``/``decode_list``, the workloads' op
sketches and the builders' test maps must be the reference's. Short runs
of each suite are then checked by the reference's checkers: the set and
counter sub-checkers result for result, the set's ``linear`` check over
the bounded-set model at the JAX engine's verdict with its route
recorded, and each txn tier's ``valid``, ``anomalies`` and edge counts
as the reference's ``TxnChecker`` finds them on the same history; a
sloppy run under a permanent partition is invalid in both packages, and
run dirs recheck across the two. The tests that start servers run under
their own time limit (SIGALRM).
"""
import json
import signal
import threading

import pytest
import torch

from jepsen_tpu import cli as cli_ref
from jepsen_tpu import core as core_ref
from jepsen_tpu import generators as g_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu import txn as txn_ref
from jepsen_tpu.checkers import facade as fa_ref
from jepsen_tpu.fake import cluster as fc_ref
from jepsen_tpu.fake import httpd as http_ref
from jepsen_tpu.fake import resp as resp_ref
from jepsen_tpu.op import Op as OpRef
from jepsen_tpu.op import invoke as inv_ref
from jepsen_tpu.suites import counter as ct_ref
from jepsen_tpu.suites import set_suite as set_ref
from jepsen_tpu.suites import txn as ts_ref
from jepsen_tpu_torch import cli as cli_pt
from jepsen_tpu_torch import core as core_pt
from jepsen_tpu_torch import generators as g_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.fake import cluster as fc_pt
from jepsen_tpu_torch.fake import httpd as http_pt
from jepsen_tpu_torch.fake import resp as resp_pt
from jepsen_tpu_torch.op import invoke as inv_pt
from jepsen_tpu_torch.suites import counter as ct_pt
from jepsen_tpu_torch.suites import set_suite as set_pt
from jepsen_tpu_torch.suites import txn as ts_pt

torch.set_num_threads(1)

NODES = ["n1", "n2", "n3", "n4", "n5"]
VERDICT = ("valid", "op", "dead-event")
TXN_KEYS = ("valid", "anomalies", "edge-counts", "txns")
SERVER_LIMIT_S = 30


@pytest.fixture
def time_limit():
    """A server test's own time limit: past it, SIGALRM raises in it."""
    def over(signum, frame):
        raise TimeoutError(f"test ran past its {SERVER_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, over)
    signal.alarm(SERVER_LIMIT_S)
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


def ref_results(ref_test, history):
    return ref_test["checker"].check(None, to_ref(history))["results"]


def same_subresults(got, want, exact=()):
    assert set(got) == set(want)
    for name in got:
        assert got[name]["valid"] == want[name]["valid"], name
    for name in exact:
        assert got[name] == want[name], name


def server_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("fake-etcd-", "fake-redis-"))]


# -- clients ------------------------------------------------------------------

def _set_counter_script(fc, st, ct, inv):
    cluster = fc.FakeCluster(NODES, mode="sloppy", seed=4)
    test = {"cluster": cluster}
    s1, s3 = (st.SetClient().open(test, n) for n in ("n1", "n3"))
    c1, c4 = (ct.CounterClient().open(test, n) for n in ("n1", "n4"))
    ops = [(s1, inv(0, "add", 1)), (s3, inv(1, "add", 2)),
           (s1, inv(0, "read")), (c1, inv(2, "read")),
           (c1, inv(2, "add", 3)), (c4, inv(3, "read"))]
    out = [c.invoke(test, op) for c, op in ops]
    split(cluster)
    for c, op in ((s1, inv(0, "add", 3)), (s3, inv(1, "add", 4)),
                  (s1, inv(0, "read")), (s3, inv(1, "read")),
                  (c1, inv(2, "add", 5)), (c4, inv(3, "add", 7)),
                  (c1, inv(2, "read")), (c4, inv(3, "read"))):
        out.append(c.invoke(test, op))
    cluster.kill_node("n1")
    out += [s1.invoke(test, inv(0, "add", 9)),
            c1.invoke(test, inv(2, "read"))]
    cluster.start_node("n1")
    cluster.set_loss(1.0)
    out += [s3.invoke(test, inv(1, "read")),
            c4.invoke(test, inv(3, "add", 1))]
    return [(o.type, o.value, o.extra) for o in out], \
        test.get("_set_read_ok")


def test_set_and_counter_client_completions_match_reference():
    got = _set_counter_script(fc_pt, set_pt, ct_pt, inv_pt)
    assert got == _set_counter_script(fc_ref, set_ref, ct_ref, inv_ref)
    assert {t for t, _, _ in got[0]} == {"ok", "fail", "info"}
    assert got[1] is True


@pytest.mark.parametrize("s", [None, "", "L", "L1", "L1,2,30", "3,4", "L-1"])
def test_decode_list_matches_reference(s):
    assert ts_pt.decode_list(s) == ts_ref.decode_list(s)


@pytest.mark.parametrize("vals", [[], [1], [1, 2, 30], ["a", 5]])
def test_encode_list_matches_reference(vals):
    enc = ts_pt.encode_list(vals)
    assert enc == ts_ref.encode_list(vals)
    if all(isinstance(v, int) for v in vals):
        assert ts_pt.decode_list(enc) == vals


def _txn_client_script(fc, http, resp, ts, inv):
    cluster = fc.FakeCluster(NODES, mode="linearizable", seed=6)
    for i in range(2):
        cluster.write("n1", f"t{i}", ts.encode_list([]))
    fes = [http.HttpKVFrontend(cluster, timeout_hold_s=0.3).start(),
           resp.RespKVFrontend(cluster, timeout_hold_s=0.3).start()]
    out = []
    try:
        txns = [[["append", "t0", 1], ["r", "t0", None]],
                [["r", "t0", None]],
                [["append", "t0", 2], ["append", "t0", 3],
                 ["r", "t0", None]],
                [["r", "t1", None], ["append", "t1", 4]]]
        for fe, cls in zip(fes, (ts.EtcdTxnClient, ts.RedisTxnClient)):
            test = {"endpoints": fe.endpoints, "cluster": cluster}
            c = cls(timeout_s=0.2).open(test, "n2")
            for i, t in enumerate(txns):
                out.append(c.invoke(test, inv(i, "txn", t)))
            for other in NODES:
                if other != "n2":
                    cluster.drop_link("n2", other)
                    cluster.drop_link(other, "n2")
            out.append(c.invoke(test, inv(9, "txn", txns[0])))
            cluster.heal()
        fake = ts.FakeTxnClient().open({"cluster": cluster}, "n3")
        for i, t in enumerate(txns):
            out.append(fake.invoke({"cluster": cluster},
                                   inv(i, "txn", [["append", "k", i]] + t)))
        cluster.set_loss(1.0)
        out.append(fake.invoke({"cluster": cluster}, inv(5, "txn", txns[1])))
        cluster.set_loss(0.0)
        out.append(fake.invoke({"cluster": cluster}, inv(5, "txn", txns[1])))
    finally:
        for fe in fes:
            fe.stop()
    return [(o.type, o.value, o.extra) for o in out], dict(cluster._global)


def test_txn_client_completions_match_reference(time_limit):
    """The fake, etcd and redis tiers' clients: each commit, read-only
    txn, partition and timeout, with the stored encodings after."""
    got = _txn_client_script(fc_pt, http_pt, resp_pt, ts_pt, inv_pt)
    assert got == _txn_client_script(fc_ref, http_ref, resp_ref, ts_ref,
                                     inv_ref)
    assert [t for t, _, _ in got[0]] == ["ok"] * 4 + ["fail"] + \
        ["ok"] * 4 + ["fail"] + ["ok"] * 4 + ["info", "ok"]
    assert got[1]["t0"] == "L1,2,3,1,2,3"
    assert not server_threads()


class _Contended(ts_pt._CasTxnClient):
    def __init__(self):
        self.cas_calls = 0

    def _get_enc(self, key):
        return "L7"

    def _cas_enc(self, key, old, new):
        self.cas_calls += 1
        return False


def test_cas_tier_gives_up_after_its_retries():
    c = _Contended()
    res = c._invoke_txn(inv_pt(0, "txn", [["append", "t0", 1]]))
    assert (res.type, res.extra) == ("fail", {"error": "cas contention"})
    assert c.cas_calls == ts_pt._CasTxnClient.retries == \
        ts_ref._CasTxnClient.retries == 8


# -- workloads and test maps --------------------------------------------------

def draw(gen, test, procs=(0, 1, "nemesis", 2), cap=300):
    return [(procs[i % len(procs)], gen.op(test, procs[i % len(procs)]))
            for i in range(cap)]


@pytest.mark.parametrize("seed", [2, 7])
def test_workloads_match_reference(seed):
    """The counter's add/read mix and the txn suite's list-append
    workload (multi-key for the fake tier, single-key for the CAS
    tiers)."""
    assert draw(ct_pt.workload(seed=seed), {}) == \
        draw(ct_ref.workload(seed=seed), {})
    assert draw(ct_pt.workload(hi=2, seed=seed), {}) == \
        draw(ct_ref.workload(hi=2, seed=seed), {})
    for single_key in (False, True):
        got, want = (draw(g.txn_workload(keys=4, max_len=4, read_p=0.5,
                                         seed=seed, single_key=single_key),
                          {}) for g in (g_pt, g_ref))
        assert got == want


BUILDS = {
    "set": lambda m: m.set_test(seed=3),
    "set-unbounded": lambda m: m.set_test(seed=3, universe=None),
    "set-sloppy": lambda m: m.set_test(mode="sloppy", seed=3,
                                       with_nemesis=False),
    "counter": lambda m: m.counter_test(seed=3),
    "counter-bare": lambda m: m.counter_test(seed=3, with_nemesis=False,
                                             nodes=3),
    "txn-fake": lambda m: m.txn_test(seed=3),
    "txn-etcd": lambda m: m.txn_test(tier="etcd", seed=3, keys=3),
    "txn-redis": lambda m: m.txn_test(mode="sloppy", tier="redis", seed=3),
}
MODULES = {"set": (set_pt, set_ref), "counter": (ct_pt, ct_ref),
           "txn": (ts_pt, ts_ref)}


def map_fields(t):
    c = t["cluster"]
    return {
        "keys": sorted(set(t) - {"device"}),
        "checkers": list(t["checker"].checkers),
        "types": {k: type(t.get(k)).__name__ for k in
                  ("cluster", "client", "nemesis", "db")},
        "mode": c.mode,
        "data": (dict(c._global), {k: dict(v.data)
                                   for k, v in c.nodes.items()}),
        "fields": {k: t[k] for k in ("name", "nodes", "concurrency",
                                     "store", "run-time-limit",
                                     "op-timeout")},
    }


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_builder_test_map_matches_reference(name):
    pt, ref = MODULES[name.split("-")[0]]
    t = BUILDS[name](pt)
    assert map_fields(t) == map_fields(BUILDS[name](ref))
    assert t["device"] is None
    draws = [draw(BUILDS[name](m)["generator"],
                  {"_set_read_ok": False}, cap=40) for m in (pt, ref)]
    assert draws[0] == draws[1]


def test_builders_put_the_device_in_the_test_map():
    t = set_pt.set_test(device="cpu")
    assert t["device"] == t["checker"].checkers["linear"].device == "cpu"
    assert ct_pt.counter_test(device="cpu")["device"] == "cpu"
    t = ts_pt.txn_test(device="cpu")
    assert t["device"] == t["checker"].checkers["txn"].opts["device"] == \
        "cpu"
    with pytest.raises(ValueError, match="unknown tier"):
        ts_pt.txn_test(tier="zk")


def test_run_without_card_fails_before_any_op(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for t in (set_pt.set_test(time_limit=0.3),
              ct_pt.counter_test(time_limit=0.3),
              ts_pt.txn_test(time_limit=0.3)):
        calls = []
        t["client"].invoke = lambda *a: calls.append(a)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            core_pt.run(t)
        assert calls == []


# -- short runs, checked by both packages ------------------------------------

def test_set_run_linearizable_matches_reference(tmp_path, capsys):
    """The bounded set's ``linear`` check: its route recorded (the wide
    walk where the states the history reaches fit it), the JAX engine's
    verdict; the port's run dir rechecks in the reference's command
    line."""
    t = set_pt.set_test(mode="linearizable", time_limit=1.0, seed=5,
                        nemesis_interval=0.25, store=True, device="cpu")
    t["store-root"] = str(tmp_path)
    with obs.capture() as cap:
        done = core_pt.run(t)
    res = done["results"]["results"]
    h = done["history"]
    assert res["set"]["valid"] is True and res["linear"]["valid"] is True
    assert res["set"]["acknowledged-count"] > 0
    assert res["set"]["lost-count"] == 0
    routes = [r for r in cap.ledger
              if r["stage"] == "reach" and r["event"] == "route"]
    assert len(routes) == 1 and routes[0]["engine"].startswith("reach")
    same_subresults(res, ref_results(set_ref.set_test(seed=5), h),
                    exact=("set", "stats"))
    capsys.readouterr()
    assert cli_ref.main(["recheck", done["dir"], "--model",
                         "bounded-set"]) == 0
    same(json.loads(capsys.readouterr().out), res["linear"])


def test_set_run_sloppy_loses_adds_in_both_packages():
    t = set_pt.set_test(mode="sloppy", time_limit=1.0, seed=17,
                        with_nemesis=False, device="cpu")
    split(t["cluster"])
    done = core_pt.run(t)
    res = done["results"]["results"]
    assert res["set"]["valid"] is False and res["set"]["lost-count"] > 0
    want = ref_results(set_ref.set_test(mode="sloppy", seed=17),
                       done["history"])
    assert want["set"]["valid"] is False
    same_subresults(res, want, exact=("set", "stats"))
    same(fa_ref.Linearizable(m_ref.bounded_set(12)).check(
        None, to_ref(done["history"])), res["linear"])


@pytest.mark.parametrize("mode", ["linearizable", "sloppy"])
def test_counter_run_matches_reference(mode):
    if mode == "sloppy":
        t = ct_pt.counter_test(mode="sloppy", time_limit=1.0, seed=31,
                               with_nemesis=False, device="cpu")
        split(t["cluster"])
    else:
        t = ct_pt.counter_test(mode="linearizable", time_limit=1.0, seed=29,
                               nemesis_interval=0.25, device="cpu")
    done = core_pt.run(t)
    res = done["results"]["results"]
    assert res["counter"]["valid"] is (mode == "linearizable")
    assert res["counter"]["reads-checked"] > 0
    want = ref_results(ct_ref.counter_test(mode=mode, seed=1),
                       done["history"])
    same_subresults(res, want, exact=("counter", "stats"))


def _txn_same(done):
    res = done["results"]["results"]["txn"]
    want = txn_ref.TxnChecker().check(None, to_ref(done["history"]))
    same(want, res, TXN_KEYS)
    return res


@pytest.mark.parametrize("tier", ["fake", "etcd", "redis"])
def test_txn_run_matches_reference(tier, time_limit):
    t = ts_pt.txn_test(mode="linearizable", tier=tier, time_limit=0.5,
                       seed=7, with_nemesis=tier == "fake",
                       nemesis_interval=0.2, device="cpu")
    res = _txn_same(core_pt.run(t))
    assert res["valid"] is True and res["txns"] > 0
    assert res["edge-counts"]["ww"] + res["edge-counts"]["wr"] > 0
    assert res["engine"] == "txn-mxu"
    assert not server_threads()


def test_txn_run_sloppy_under_partition_in_both_packages():
    """A sloppy cluster split for the whole run: appends on each side
    clobber the other's lists, which both packages find anomalous."""
    t = ts_pt.txn_test(mode="sloppy", tier="fake", time_limit=0.5, seed=9,
                       with_nemesis=False, device="cpu")
    split(t["cluster"])
    res = _txn_same(core_pt.run(t))
    assert res["valid"] is False and res["anomalies"]


def test_reference_txn_run_dir_checks_in_port(tmp_path, capsys):
    rt = ts_ref.txn_test(mode="linearizable", tier="fake", time_limit=0.3,
                         seed=3, with_nemesis=False, store=True)
    rt["store-root"] = str(tmp_path)
    ref_done = core_ref.run(rt)
    capsys.readouterr()
    rc = cli_pt.main(["check", ref_done["dir"], "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert rc == 0
    same(ref_done["results"]["results"]["txn"], got, TXN_KEYS)

"""The port's test runner (``core``, ``client``, ``control``, ``os_setup``,
``db``, ``net``, ``nemesis``, ``fake/cluster``, ``tests_base``, the
register suites, ``checkers/timeline.py``, ``checkers/perf.py``, the
run's ``obs`` export and ``store``) against the reference's, on the CPU
(``device="cpu"``; the reference under ``JAX_PLATFORMS=cpu``), after
``tests/test_harness.py`` and ``tests/test_nemesis_compose.py``.

Control sessions, grudges, nemeses and a scripted op sequence through
the fake cluster must give the reference's outputs for the same seeds;
the port's verdict and failing op on a history the port recorded must
equal the JAX ``Linearizable``'s; ``timeline.html`` must be byte-equal
to the reference's; run dirs must load across the two packages; and a
device-style fault in the check must propagate out of ``core.run``
(with ``history.jsonl`` on disk), ``Compose`` and ``IndependentChecker``
while a capacity decline becomes an ``unknown``.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from jepsen_tpu import control as ctl_ref
from jepsen_tpu import core as core_ref
from jepsen_tpu import db as db_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu import nemesis as nem_ref
from jepsen_tpu import net as net_ref
from jepsen_tpu import os_setup as os_ref
from jepsen_tpu import store as store_ref
from jepsen_tpu import independent as ind_ref
from jepsen_tpu.checkers import facade as fa_ref
from jepsen_tpu.checkers import perf as perf_ref
from jepsen_tpu.checkers import timeline as tl_ref
from jepsen_tpu.fake import cluster as fc_ref
from jepsen_tpu.op import Op as OpRef
from jepsen_tpu.suites import register as reg_ref
from jepsen_tpu_torch import client as cl_pt
from jepsen_tpu_torch import control as ctl_pt
from jepsen_tpu_torch import core as core_pt
from jepsen_tpu_torch import db as db_pt
from jepsen_tpu_torch import generators as g_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import independent as ind_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch import nemesis as nem_pt
from jepsen_tpu_torch import net as net_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch import os_setup as os_pt
from jepsen_tpu_torch import store as store_pt
from jepsen_tpu_torch import util as util_pt
from jepsen_tpu_torch.checkers import facade as fa_pt
from jepsen_tpu_torch.checkers import perf as perf_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_batch as rb_pt
from jepsen_tpu_torch.checkers import reach_lane as rl_pt
from jepsen_tpu_torch.checkers import timeline as tl_pt
from jepsen_tpu_torch.fake import cluster as fc_pt
from jepsen_tpu_torch.op import FAIL, INFO, OK, Op, invoke
from jepsen_tpu_torch.suites import register as reg_pt
from jepsen_tpu_torch.tests_base import noop_test

torch.set_num_threads(1)

NODES = ["n1", "n2", "n3", "n4", "n5"]
VERDICT = ("valid", "op", "dead-event")
RUN_FILES = ("test.json", "results.json", "results.edn", "history.jsonl",
             "history.edn", "history.txt", "jepsen.log", "timeline.html",
             "obs.jsonl", "trace.json", "latency-raw.png", "rate.png")


def to_ref(history):
    return [OpRef.from_dict(op.to_dict()) for op in history]


def ref_linear(history):
    return fa_ref.Linearizable(m_ref.cas_register()).check(
        None, to_ref(history))


def same(want, got, keys=VERDICT):
    diff = {k: (want.get(k), got.get(k)) for k in keys
            if want.get(k) != got.get(k)}
    assert not diff, diff


# -- control ------------------------------------------------------------------

def _session_script(ctl, remote):
    s = ctl.Session(remote, "n1")
    s.exec("echo", "a b", "it's", ctl.lit("$HOME"), 3)
    s.su().exec("ls", "-l", "/var/log")
    s.cd("/tmp/x y").exec("cat", "f")
    s.su("jepsen").cd("/opt").exec("rm", "-rf", "*")
    s.exec_raw("uptime; hostname")
    s.upload("local.tar", "/opt/remote.tar")
    s.download("/var/log/db.log", "out/db.log")
    try:
        s.exec("bad", "cmd")
    except ctl.RemoteError as e:
        return e.exit_code, e.cmd
    return None


@pytest.mark.parametrize("responses", [{}, {"echo": "hi\n", "bad": (3, "no")}])
def test_session_through_fake_remote_matches_reference(responses):
    r_ref, r_pt = (ctl_ref.FakeRemote(responses=dict(responses)),
                   ctl_pt.FakeRemote(responses=dict(responses)))
    out_ref = _session_script(ctl_ref, r_ref)
    out_pt = _session_script(ctl_pt, r_pt)
    assert out_pt == out_ref
    assert r_pt.commands == r_ref.commands
    assert r_pt.uploads == r_ref.uploads
    assert r_pt.downloads == r_ref.downloads
    assert ctl_pt.Session(r_pt, "n1").exec("echo") == \
        ctl_ref.Session(r_ref, "n1").exec("echo")


@pytest.mark.parametrize("arg", ["plain", "a b", "it's", "$HOME", "", "x;y",
                                 3, "tab\tnl\n"])
def test_escape_matches_reference(arg):
    assert ctl_pt.escape(arg) == ctl_ref.escape(arg)
    assert ctl_pt.escape(ctl_pt.lit(str(arg))) == str(arg)


def test_session_sudo_and_cd_wrap():
    r = ctl_pt.FakeRemote()
    ctl_pt.Session(r, "n1").su().cd("/tmp").exec("ls")
    node, cmd = r.commands[0]
    assert "sudo" in cmd and "cd /tmp" in cmd and "ls" in cmd


def test_local_remote_matches_reference(tmp_path):
    for ctl in (ctl_pt, ctl_ref):
        r = ctl.LocalRemote()
        assert ctl.Session(r, "anywhere").exec("echo", "a b") == "a b"
    out = [ctl.Session(ctl.LocalRemote(), "n").cd(str(tmp_path)).exec(
        "pwd") for ctl in (ctl_pt, ctl_ref)]
    assert out[0] == out[1] == str(tmp_path)
    res = [ctl.Session(ctl.LocalRemote(), "n").exec_raw("echo err >&2; "
                                                        "exit 4")
           for ctl in (ctl_pt, ctl_ref)]
    assert (res[0].exit_code, res[0].out, res[0].err) == \
        (res[1].exit_code, res[1].out, res[1].err) == (4, "", "err\n")
    with pytest.raises(ctl_pt.RemoteError):
        ctl_pt.Session(ctl_pt.LocalRemote(), "n").exec("false")


def test_on_nodes_and_remote_for():
    r = ctl_pt.FakeRemote()
    test = {"nodes": ["n1", "n2", "n3"], "remote": r, "ssh": {}}
    out = ctl_pt.on_nodes(test, lambda s, n: s.exec("hostname") or n)
    assert out == {"n1": "n1", "n2": "n2", "n3": "n3"}
    assert sorted(r.commands) == [(n, "hostname") for n in test["nodes"]]
    assert ctl_pt.remote_for(test) is r

    def boom(s, n):
        raise ValueError(n)

    with pytest.raises(RuntimeError, match="on_nodes failed"):
        ctl_pt.on_nodes(test, boom)


def test_ssh_remote_commands_without_connecting(tmp_path):
    """The ``ssh`` argument list, built but not run."""
    for ctl in (ctl_pt, ctl_ref):
        r = ctl.SSHRemote(control_dir=str(tmp_path))
        r.connect("n1", {"username": "admin", "port": 2222,
                         "private-key-path": "k"})
        assert r._base("n1")[:7] == ["ssh", "-l", "admin", "-p", "2222",
                                     "-i", "k"]
        assert r._scp_target("n1") == "admin@n1"


# -- os, db, net automation over a fake remote --------------------------------

class _LogDB:
    def __init__(self, db_mod):
        self.base = db_mod.DB

    def make(self):
        calls = []

        class D(self.base):
            def setup(self, test, node):
                calls.append(("setup", node))

            def teardown(self, test, node):
                calls.append(("teardown", node))

            def log_files(self, test, node):
                return [f"/var/log/{node}.log"]

            def primaries(self, test):
                return ["n1"]

            def setup_primary(self, test, node):
                calls.append(("primary", node))

        return D(), calls


@pytest.mark.parametrize("os_name", ["debian", "ubuntu", "centos", "noop"])
def test_os_db_net_automation_matches_reference(os_name, tmp_path):
    out = []
    for mods in ((ctl_ref, os_ref, db_ref, net_ref),
                 (ctl_pt, os_pt, db_pt, net_pt)):
        ctl, os_mod, db_mod, net_mod = mods
        remote = ctl.FakeRemote(responses={"dpkg -s curl": (1, "")})
        db, calls = _LogDB(db_mod).make()
        test = {"nodes": NODES[:3], "remote": remote, "ssh": {},
                "os": getattr(os_mod, os_name)(), "db": db}
        os_mod.setup_all(test)
        db_mod.setup_all(test)
        net = net_mod.iptables()
        net.drop(test, "n1", "n2")
        net.heal(test)
        net.slow(test, 20.0, 5.0)
        net.flaky(test, 0.1)
        net.fast(test)
        got = db_mod.snarf_logs(test, str(tmp_path / type(db).__module__))
        db_mod.teardown_all(test)
        os_mod.teardown_all(test)
        out.append((sorted(remote.commands), sorted(remote.downloads),
                    sorted(calls), len(got)))
    assert out[1][0] == out[0][0]
    assert [d[:2] for d in out[1][1]] == [d[:2] for d in out[0][1]]
    assert out[1][2:] == out[0][2:]


def test_net_for_picks_by_test_map():
    assert isinstance(net_pt.net_for({"cluster": object()}), net_pt.FakeNet)
    assert isinstance(net_pt.net_for({}), net_pt.IptablesNet)
    n = net_pt.fake()
    assert net_pt.net_for({"net": n}) is n


# -- nemesis grudges and faults ----------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 7])
def test_grudges_match_reference(n):
    import random
    nodes = [f"n{i + 1}" for i in range(n)]
    assert nem_pt.bisect(nodes) == nem_ref.bisect(nodes)
    assert nem_pt.complete_grudge(nem_pt.bisect(nodes)) == \
        nem_ref.complete_grudge(nem_ref.bisect(nodes))
    assert nem_pt.bridge_grudge(nodes) == nem_ref.bridge_grudge(nodes)
    for seed in range(4):
        assert nem_pt.split_one(nodes, random.Random(seed)) == \
            nem_ref.split_one(nodes, random.Random(seed))
        assert nem_pt.majorities_ring_grudge(nodes, random.Random(seed)) \
            == nem_ref.majorities_ring_grudge(nodes, random.Random(seed))
    assert nem_pt.majorities_ring_grudge(nodes) == \
        nem_ref.majorities_ring_grudge(nodes)


def test_majorities_ring_every_node_sees_majority():
    for nodes in (NODES, NODES[:3]):
        grudge = nem_pt.majorities_ring_grudge(nodes)
        maj = util_pt.majority(len(nodes))
        for node in nodes:
            assert len(nodes) - len(grudge[node]) == maj
            assert grudge[node]


def _nem_op(mod, f, value=None):
    return mod.Op(process="nemesis", type="invoke", f=f, value=value)


PARTITIONERS = {
    "random-halves": lambda nem, s: nem.partition_random_halves(seed=s),
    "random-node": lambda nem, s: nem.partition_random_node(seed=s),
    "majorities-ring": lambda nem, s: nem.partition_majorities_ring(seed=s),
    "halves": lambda nem, s: nem.partition_halves(),
    "bridge": lambda nem, s: nem.bridge(),
}


@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("kind", sorted(PARTITIONERS))
def test_partitioner_on_fake_net_matches_reference(kind, seed):
    from jepsen_tpu import op as op_ref
    from jepsen_tpu_torch import op as op_pt
    out = []
    for nem, fc, opm in ((nem_ref, fc_ref, op_ref), (nem_pt, fc_pt, op_pt)):
        cluster = fc.FakeCluster(NODES, seed=seed)
        test = {"nodes": NODES, "cluster": cluster}
        p = PARTITIONERS[kind](nem, seed)
        seq = []
        for _ in range(4):
            res = p.invoke(test, _nem_op(opm, "start"))
            seq.append((res.type, res.value, sorted(cluster.dropped)))
            res = p.invoke(test, _nem_op(opm, "stop"))
            seq.append((res.type, res.value, sorted(cluster.dropped)))
        out.append(seq)
    assert out[1] == out[0]
    assert out[1][0][0] == INFO and out[1][0][2] or kind == "bridge"
    assert all(not dropped for _, _, dropped in out[1][1::2])


def _fault_script(nem, fc, opm, seed):
    cluster = fc.FakeCluster(NODES, seed=seed)
    test = {"nodes": NODES, "cluster": cluster}
    ham = nem.hammer_time(seed=seed)
    kill = nem.DBNemesis("kill", seed=seed)
    pause = nem.DBNemesis("pause", seed=seed + 1)
    clock = nem.clock_scrambler(5.0, seed=seed)
    bump = nem.clock_nemesis()
    comp = nem.compose({("start", "stop"): ham, "kill-start": (kill, "start"),
                        "kill-stop": (kill, "stop"),
                        "pause-start": (pause, "start"),
                        "pause-stop": (pause, "stop"),
                        "clock-start": (clock, "start"),
                        "clock-stop": (clock, "stop"),
                        "bump": bump, "reset": bump})

    def state():
        return [(n.alive, n.pause.is_set(), round(n.clock_skew, 6))
                for n in cluster.nodes.values()]

    out = []
    for f, v in (("start", None), ("stop", None), ("kill-start", None),
                 ("kill-stop", None), ("pause-start", None),
                 ("pause-stop", None), ("clock-start", None),
                 ("clock-stop", None), ("bump", {"n2": 250}),
                 ("reset", None), ("mystery", None)):
        res = comp.invoke(test, _nem_op(opm, f, v))
        out.append((res.f, res.type, res.value, state()))
    return out


@pytest.mark.parametrize("seed", [1, 5])
def test_process_and_clock_nemeses_match_reference(seed):
    from jepsen_tpu import op as op_ref
    from jepsen_tpu_torch import op as op_pt
    want = _fault_script(nem_ref, fc_ref, op_ref, seed)
    got = _fault_script(nem_pt, fc_pt, op_pt, seed)
    assert got == want
    assert "no nemesis handles" in str(got[-1][2])


def test_node_start_stopper_and_noop():
    r = ctl_pt.FakeRemote()
    test = {"nodes": NODES[:2], "remote": r, "ssh": {}}
    nss = nem_pt.node_start_stopper(
        lambda t: ["n2"], lambda s, n: s.exec("kill", n),
        lambda s, n: s.exec("start", n))
    assert nss.invoke(test, invoke("nemesis", "start")).value == \
        {"stopped": ["n2"]}
    assert nss.invoke(test, invoke("nemesis", "stop")).value == \
        {"started": ["n2"]}
    assert [c for _, c in r.commands] == ["kill n2", "start n2"]
    assert nem_pt.noop().invoke(test, invoke("nemesis", "x")).type == INFO


# -- the fake cluster ---------------------------------------------------------

def _cluster_script(fc, mode, seed):
    c = fc.FakeCluster(NODES, mode=mode, seed=seed)
    out = []

    def do(name, *a):
        try:
            out.append((name, a, "ok", getattr(c, name)(*a)))
        except (fc.Unavailable, fc.FakeTimeout) as e:
            out.append((name, a, type(e).__name__, str(e)))

    do("write", "n1", "r", 0)
    do("read", "n3", "r")
    do("cas", "n2", "r", 0, 3)
    do("cas", "n2", "r", 0, 4)
    for a in ("n1", "n2"):
        for b in ("n3", "n4", "n5"):
            c.drop_link(a, b)
            c.drop_link(b, a)
    do("write", "n1", "r", 1)
    do("read", "n3", "r")
    do("read", "n1", "r")
    do("cas", "n4", "r", 3, 2)
    do("sadd", "n1", "s", 1)
    do("sadd", "n4", "s", 2)
    do("sread", "n5", "s")
    do("incr", "n1", "c", 2)
    do("incr", "n3", "c", 5)
    do("txn", "n4", [["append", "x", 1], ["r", "x", None]])
    do("txn", "n1", [["r", "x", None], ["append", "x", 2]])
    c.heal()
    do("read", "n1", "r")
    do("sread", "n2", "s")
    c.kill_node("n5")
    do("read", "n5", "r")
    c.start_node("n5")
    do("read", "n5", "r")
    c.pause_node("n2")
    do("read", "n2", "r")
    c.resume_node("n2")
    do("write", "n2", "r", 9)
    c.set_loss(0.5)
    for i in range(12):
        do("write", NODES[i % 5], "r", i)
    c.set_loss(0.0)
    c.set_latency(0.001)
    c.bump_clock("n3", 2.5)
    do("read", "n4", "r")
    do("read", "nX", "r")
    return out, {k: dict(v.data) for k, v in c.nodes.items()}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("mode", ["linearizable", "sloppy"])
def test_scripted_ops_through_fake_cluster_match_reference(mode, seed):
    want = _cluster_script(fc_ref, mode, seed)
    got = _cluster_script(fc_pt, mode, seed)
    assert got == want
    kinds = {r[2] for r in got[0]}
    assert {"ok", "Unavailable", "FakeTimeout"} <= kinds


def test_sloppy_cluster_serves_stale_reads():
    c = fc_pt.FakeCluster(NODES, mode="sloppy")
    c.write("n1", "k", 0)
    for a in ("n1", "n2"):
        for b in ("n3", "n4", "n5"):
            c.drop_link(a, b)
            c.drop_link(b, a)
    c.write("n1", "k", 1)
    assert c.read("n3", "k") == 0
    history = [invoke(0, "write", 0), Op(0, OK, "write", 0),
               invoke(0, "write", 1), Op(0, OK, "write", 1),
               invoke(0, "read", None), Op(0, OK, "read", 0)]
    res = fa_pt.Linearizable(m_pt.register(), device="cpu").check(
        None, h_pt.index(history))
    assert res["valid"] is False
    same(fa_ref.Linearizable(m_ref.register()).check(
        None, to_ref(h_pt.index(history))), res)


# -- the runner ----------------------------------------------------------------

def test_noop_test_runs_like_reference(tmp_path):
    done = []
    for core, root in ((core_pt, tmp_path / "pt"), (core_ref,
                                                    tmp_path / "ref")):
        t = (noop_test() if core is core_pt
             else __import__("jepsen_tpu.tests_base",
                             fromlist=["x"]).noop_test())
        t["store-root"] = str(root)
        g = g_pt if core is core_pt else __import__(
            "jepsen_tpu.generators", fromlist=["x"])
        t["generator"] = g.limit(3, g.Fn(lambda: {"f": "ping"}))
        done.append(core.run(t))
    pt, ref = done
    assert pt["results"]["valid"] is ref["results"]["valid"] is True
    assert len(pt["history"]) == len(ref["history"]) == 6
    assert [(o.process, o.type, o.f) for o in pt["history"]] == \
        [(o.process, o.type, o.f) for o in ref["history"]]
    for f in ("history.jsonl", "results.json", "obs.jsonl", "trace.json"):
        assert os.path.exists(os.path.join(pt["dir"], f)), f
    assert "device" not in pt


@pytest.mark.parametrize("mode,seed", [("linearizable", 3),
                                       ("linearizable", 8), ("sloppy", 4),
                                       ("sloppy", 9)])
def test_register_run_verdict_matches_jax_linearizable(mode, seed):
    t = reg_pt.register_test(mode=mode, n_ops=1_500, seed=seed,
                             nemesis_interval=0.05, device="cpu")
    with obs.capture() as cap:
        done = core_pt.run(t)
    res = done["results"]
    lin = res["results"]["linear"]
    history = done["history"]
    assert any(op.process == "nemesis" for op in history)
    assert res["results"]["stats"]["by-f"]
    assert done["device"] == "cpu"
    same(ref_linear(history), lin)
    assert res["valid"] is lin["valid"]
    if mode == "linearizable":
        assert lin["valid"] is True
    routes = [r for r in cap.ledger if r["event"] == "route"
              and r["stage"] == "reach"]
    assert routes and routes[0]["engine"] in ("reach-lane",
                                              "reach-chunklock")
    assert res["obs"]["ledger"]


def test_register_sloppy_run_finds_violation():
    """As ``tests/test_harness.py``'s: a 1.5 s sloppy run under the
    partition nemesis is not linearizable, and the JAX Linearizable
    fails it at the same op."""
    t = reg_pt.register_test(mode="sloppy", time_limit=1.5, seed=11,
                             with_nemesis=True, nemesis_interval=0.25,
                             store=False, concurrency=5, device="cpu")
    done = core_pt.run(t)
    lin = done["results"]["results"]["linear"]
    assert lin["valid"] is False and lin["op"]
    same(ref_linear(done["history"]), lin)


@pytest.mark.parametrize("mode,with_nemesis", [("linearizable", False),
                                               ("sloppy", True)])
def test_independent_run_matches_jax_key_by_key(mode, with_nemesis):
    t = reg_pt.independent_test(mode=mode, keys=4, ops_per_key=40,
                                concurrency=4, seed=5,
                                with_nemesis=with_nemesis, device="cpu")
    done = core_pt.run(t)
    res = done["results"]
    assert res["key-count"] == 4
    if mode == "linearizable":
        assert res["valid"] is True
    want = ind_ref.checker(fa_ref.linearizable(m_ref.cas_register())).check(
        None, to_ref(done["history"]))
    assert res["valid"] == want["valid"]
    assert sorted(res["failures"]) == sorted(want["failures"])
    for k, r in res["results"].items():
        same(want["results"][k], r)


def test_read_of_an_unwritten_key():
    """A read of a key no write has reached: ``None`` in both packages
    for the single register; for an independent op the port completes it
    ``[k, None]``, where the reference's client keeps the invocation's
    value, ``[k, [k, None]]``, which no state of the model explains (so
    the reference's ``register-independent`` run fails any key whose
    first op is such a read)."""
    from jepsen_tpu import op as op_ref
    from jepsen_tpu_torch import op as op_pt
    out = []
    for reg, fc, opm in ((reg_pt, fc_pt, op_pt), (reg_ref, fc_ref, op_ref)):
        test = {"cluster": fc.FakeCluster(NODES)}
        single = reg.KVClient("r").open(test, "n1")
        keyed = reg.KVClient(None).open(test, "n1")
        out.append((single.invoke(test, opm.invoke(0, "read")).value,
                    keyed.invoke(test, opm.invoke(0, "read",
                                                  ["k", None])).value))
    assert out == [(None, ["k", None]), (None, ["k", ["k", None]])]


def test_worker_crash_bumps_process():
    class Flaky(reg_pt.KVClient):
        calls = 0

        def invoke(self, test, op):
            type(self).calls += 1
            if type(self).calls == 2:
                raise RuntimeError("connection torn")
            return super().invoke(test, op)

    t = reg_pt.register_test(mode="linearizable", seed=0,
                             with_nemesis=False, store=False,
                             concurrency=2, device="cpu")
    t["client"] = Flaky("r")
    t["generator"] = g_pt.each(
        lambda: g_pt.limit(3, g_pt.Fn(lambda: {"f": "read",
                                               "value": None})))
    done = core_pt.run(t)
    infos = [op for op in done["history"] if op.type == INFO]
    assert len(infos) == 1
    assert infos[0].extra["error"] == "RuntimeError: connection torn"
    crashed_p = infos[0].process
    assert any(op.process == crashed_p + 2 for op in done["history"])
    lin = done["results"]["results"]["linear"]
    same(ref_linear(done["history"]), lin)


def test_op_timeout_is_info_and_bumps_process():
    class Slow(cl_pt.Client):
        def invoke(self, test, op):
            if op.process == 0:
                time.sleep(0.3)
            return cl_pt.ok(op, 0)

    t = noop_test()
    t.update(store=False, concurrency=2, client=Slow(), **{"op-timeout": 0.05})
    t["generator"] = g_pt.each(lambda: g_pt.limit(2, g_pt.Fn(
        lambda: {"f": "read", "value": None})))
    done = core_pt.run(t)
    infos = [op for op in done["history"] if op.type == INFO]
    assert infos and all(op.extra["error"] == "timeout" for op in infos)
    assert {op.process for op in done["history"]} >= {0, 1, 2}


def test_client_helpers():
    op = invoke(0, "cas", [1, 2])
    assert cl_pt.ok(op).type == OK and cl_pt.ok(op, 5).value == 5
    assert cl_pt.fail(op, "no").extra == {"error": "no"}
    assert cl_pt.info(op).type == INFO and cl_pt.info(op).extra is None
    assert cl_pt.noop_client().invoke({}, op).type == OK
    assert not cl_pt.closable(cl_pt.noop_client())
    assert util_pt.with_retry(iter([1]).__next__) == 1
    assert util_pt.meh(lambda: 1 / 0) is None


# -- store both ways, artifacts ----------------------------------------------

def test_port_run_dir_rechecks_in_reference(tmp_path):
    t = reg_pt.register_test(mode="sloppy", n_ops=1_500, seed=9,
                             nemesis_interval=0.05, store=True,
                             device="cpu")
    t["store-root"] = str(tmp_path)
    done = core_pt.run(t)
    d = done["dir"]
    for f in RUN_FILES:
        assert os.path.exists(os.path.join(d, f)), f
    if done["results"]["valid"] is False:
        assert os.path.exists(os.path.join(d, "linear.svg"))
    hist_ref = store_ref.load_history(d)
    assert [o.to_dict() for o in hist_ref] == \
        [o.to_dict() for o in done["history"]]
    assert len(h_ref.load_edn(os.path.join(d, "history.edn"))) == \
        len(hist_ref)
    same(fa_ref.Linearizable(m_ref.cas_register()).check(None, hist_ref),
         done["results"]["results"]["linear"])
    res = store_ref.load_results(d)
    assert res["valid"] == done["results"]["valid"]
    assert store_pt.latest(str(tmp_path)) == os.path.realpath(d)
    assert list(store_pt.tests(str(tmp_path))) == ["register-sloppy"]


def test_reference_run_dir_rechecks_in_port(tmp_path):
    t = reg_ref.register_test(mode="sloppy", n_ops=1_500, seed=12,
                              nemesis_interval=0.05, store=True)
    t["store-root"] = str(tmp_path)
    done = core_ref.run(t)
    hist = store_pt.load_history(done["dir"])
    assert [o.to_dict() for o in hist] == \
        [o.to_dict() for o in done["history"]]
    got = fa_pt.Linearizable(m_pt.cas_register(), device="cpu").check(
        None, hist)
    same(done["results"]["results"]["linear"], got)


def _history(seed=4, n_ops=400):
    t = reg_pt.register_test(mode="sloppy", n_ops=n_ops, seed=seed,
                             nemesis_interval=0.05, device="cpu")
    t["checker"] = None
    return core_pt.run(t)["history"]


def test_timeline_html_byte_equal_to_reference(tmp_path):
    history = _history()
    assert tl_pt.render(history, "register") == \
        tl_ref.render(to_ref(history), "register")
    assert tl_pt.render(history[:7]) == tl_ref.render(to_ref(history[:7]))
    res = tl_pt.html().check({"dir": str(tmp_path), "name": "t"}, history)
    assert res == {"valid": True,
                   "file": str(tmp_path / "timeline.html")}
    assert open(res["file"]).read() == tl_ref.render(to_ref(history), "t")
    assert tl_pt.html().check(None, history)["html-bytes"] == \
        len(tl_ref.render(to_ref(history)))


def test_latency_and_rate_points_match_reference():
    history = _history(seed=6)
    assert perf_pt.latency_points(history) == \
        perf_ref.latency_points(to_ref(history))
    for dt in (1.0, 0.05):
        got = perf_pt.rate_points(history, dt)
        want = perf_ref.rate_points(to_ref(history), dt)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k][0], want[k][0])
            np.testing.assert_array_equal(got[k][1], want[k][1])


def test_charts_skip_without_matplotlib(tmp_path, monkeypatch):
    import importlib.util

    history = _history(seed=7, n_ops=100)
    assert perf_pt.latency_graph().check(None, history) == \
        {"valid": True, "skipped": "no store dir"}
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda n, *a: None if n == "matplotlib"
                        else real(n, *a))
    with obs.capture() as cap:
        for chart in (perf_pt.latency_graph(), perf_pt.rate_graph()):
            assert chart.check({"dir": str(tmp_path)}, history) == \
                {"valid": True, "skipped": "matplotlib not installed"}
    assert [(r["stage"], r["event"], r["cause"]) for r in cap.ledger] == \
        [("perf", "skipped", "no-matplotlib")] * 2
    assert os.listdir(tmp_path) == []


def test_obs_files_parse(tmp_path):
    t = reg_pt.register_test(n_ops=300, seed=1, nemesis_interval=0.05,
                             store=True, device="cpu")
    t["store-root"] = str(tmp_path)
    done = core_pt.run(t)
    d = done["dir"]
    recs = [json.loads(ln) for ln in open(os.path.join(d, "obs.jsonl"))]
    spans = {r["name"] for r in recs if r["type"] == "span"}
    assert {"run.setup", "run.workers", "run.worker", "run.nemesis",
            "run.teardown", "run.check", "facade.pack"} <= spans
    assert any(r["type"] == "decision" and r["stage"] == "reach"
               for r in recs)
    trace = json.load(open(os.path.join(d, "trace.json")))
    assert trace["traceEvents"][0]["ph"] == "M"
    assert {e["name"] for e in trace["traceEvents"][1:]} >= spans
    summary = done["results"]["obs"]
    assert set(summary) == {"counters", "gauges", "histograms", "ledger"}
    assert json.load(open(os.path.join(d, "results.json")))["obs"][
        "ledger"] == json.loads(json.dumps(summary["ledger"]))


# -- faults propagate; capacity declines are unknowns -------------------------

def _cuda_fault(*a, **k):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


def test_device_fault_propagates_out_of_run(tmp_path, monkeypatch):
    monkeypatch.setattr(rl_pt, "lane_walk", _cuda_fault)
    t = reg_pt.register_test(n_ops=300, seed=2, nemesis_interval=0.05,
                             store=True, device="cpu")
    t["store-root"] = str(tmp_path)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        core_pt.run(t)
    d = store_pt.latest(str(tmp_path))
    hist = store_pt.load_history(d)
    assert len(hist) >= 600 and not os.path.exists(
        os.path.join(d, "results.json"))
    monkeypatch.undo()
    res = fa_pt.Linearizable(m_pt.cas_register(), device="cpu").check(
        None, hist)
    same(ref_linear(hist), res)


def test_capacity_decline_is_unknown_in_run(monkeypatch):
    def decline(*a, **k):
        raise reach_pt.DenseOverflow("too many states")

    monkeypatch.setattr(reach_pt, "check", decline)
    t = reg_pt.register_test(n_ops=200, seed=2, nemesis_interval=0.05,
                             algorithm="reach", device="cpu")
    done = core_pt.run(t)
    lin = done["results"]["results"]["linear"]
    assert lin == {"valid": "unknown",
                   "error": "DenseOverflow: too many states"}
    assert done["results"]["valid"] == "unknown"
    assert done["results"]["results"]["stats"]["valid"] is True


def test_compose_fault_propagates_and_decline_is_unknown(monkeypatch):
    history = _history(seed=3, n_ops=200)
    comp = fa_pt.compose({"linear": fa_pt.Linearizable(
        m_pt.cas_register(), device="cpu"), "stats": fa_pt.stats()})
    monkeypatch.setattr(rl_pt, "lane_walk", _cuda_fault)
    with pytest.raises(RuntimeError, match="CUDA error"):
        comp.check(None, history)
    monkeypatch.undo()

    def decline(*a, **k):
        raise reach_pt.DenseOverflow("wide")

    monkeypatch.setattr(reach_pt, "check", decline)
    comp = fa_pt.compose({"linear": fa_pt.Linearizable(
        m_pt.cas_register(), algorithm="reach", device="cpu"),
        "stats": fa_pt.stats()})
    res = comp.check(None, history)
    assert res["valid"] == "unknown"
    assert res["results"]["linear"] == {"valid": "unknown",
                                        "error": "DenseOverflow: wide"}
    # check_safe, the upstream function, still swallows anything
    monkeypatch.setattr(reach_pt, "check", _cuda_fault)
    res = fa_pt.check_safe(fa_pt.Linearizable(
        m_pt.cas_register(), algorithm="reach", device="cpu"), None,
        history)
    assert res["valid"] == "unknown" and "CUDA error" in res["error"]


def _independent_history():
    t = reg_pt.independent_test(keys=3, ops_per_key=30, concurrency=4,
                                seed=2, device="cpu")
    t["checker"] = None
    return core_pt.run(t)["history"]


@pytest.mark.parametrize("algorithm", ["auto", "reach", "wgl-cpu"])
def test_independent_fault_propagates(algorithm, monkeypatch):
    history = _independent_history()
    chk = ind_pt.checker(fa_pt.Linearizable(
        m_pt.cas_register(), algorithm=algorithm, device="cpu"))
    if algorithm == "wgl-cpu":
        from jepsen_tpu_torch.checkers import wgl_ref
        monkeypatch.setattr(wgl_ref, "check", _cuda_fault)
    else:
        monkeypatch.setattr(rb_pt, "batch_walk", _cuda_fault)
        monkeypatch.setattr(rl_pt, "keyed_walk", _cuda_fault)
    with pytest.raises(RuntimeError, match="CUDA error"):
        chk.check(None, history)


def test_independent_decline_is_unknown_key_by_key(monkeypatch):
    history = _independent_history()

    def decline(*a, **k):
        raise reach_pt.DenseOverflow("union too wide")

    monkeypatch.setattr(reach_pt, "check_many", decline)
    monkeypatch.setattr(reach_pt, "check", decline)
    res = ind_pt.checker(fa_pt.Linearizable(
        m_pt.cas_register(), algorithm="reach", device="cpu")).check(
        None, history)
    assert res["valid"] == "unknown" and res["key-count"] == 3
    assert all(r == {"valid": "unknown",
                     "error": "DenseOverflow: union too wide"}
               for r in res["results"].values())


def test_no_card_fails_before_any_op(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = reg_pt.register_test(n_ops=50, store=True)
    t["store-root"] = str(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core_pt.run(t)
    assert os.listdir(tmp_path) == []


def test_online_check_is_not_ported():
    """``online-check`` runs the online monitor beside the workers: a
    short valid run reports its result and stays valid."""
    t = reg_pt.register_test(n_ops=10, device="cpu")
    t["online-check"] = True
    done = core_pt.run(t)
    online = done["results"]["online-check"]
    assert online["valid"] is True and online["mode"] == "incremental"
    assert online["ops-checked"] == len(done["history"])
    assert done["results"]["results"]["linear"]["valid"] is True
    h = core_pt.History(observer=lambda op: 1 / 0)
    assert h.append(invoke(0, "read")).index == 0     # the observer hook


# -- the runner's helpers -------------------------------------------------------

def test_util_helpers_match_reference(caplog):
    import logging
    import threading

    from jepsen_tpu import util as util_ref
    for n in range(1, 8):
        assert util_pt.majority(n) == util_ref.majority(n)
    for nodes in (3, "solo", ["a", "b"], ("x",)):
        assert util_pt.node_names(nodes) == util_ref.node_names(nodes)
    d = {"a": 1, "b": [2, 3]}
    assert util_pt.map_vals(repr, d) == util_ref.map_vals(repr, d)
    assert util_pt.pprint_str(d) == util_ref.pprint_str(d)
    start = time.monotonic() - 1.0
    assert 1e9 <= util_pt.relative_time_nanos(start) < 60e9
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("again")
        return "done"

    assert util_pt.with_retry(flaky, retries=3, delay=0.001) == "done"
    with pytest.raises(OSError):
        util_pt.with_retry(lambda: (_ for _ in ()).throw(OSError("x")),
                           retries=1, delay=0.001)
    with util_pt.with_thread_name("jepsen-worker-9"):
        assert threading.current_thread().name == "jepsen-worker-9"
    assert threading.current_thread().name != "jepsen-worker-9"
    with caplog.at_level(logging.INFO, logger="jepsen.ops"):
        util_pt.log_op(invoke(3, "cas", [1, 2]))
    assert caplog.records[-1].getMessage() == "3\tinvoke\tcas\t[1, 2]"


def test_report_to_matches_reference(tmp_path):
    from jepsen_tpu import report as report_ref
    from jepsen_tpu_torch import report as report_pt
    res = {"valid": False, "op": {"index": 3}, "x": object()}
    a = report_pt.to(str(tmp_path / "pt" / "r.json"), res)
    b = report_ref.to(str(tmp_path / "ref" / "r.json"), res)
    assert open(a).read().split("object at")[0] == \
        open(b).read().split("object at")[0]

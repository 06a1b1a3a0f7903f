"""The port's command line (``python -m jepsen_tpu_torch check`` /
``recheck``) and its store, against the reference's ``cli.main`` and
``store`` on the CPU (``--device cpu``; the reference under
``JAX_PLATFORMS=cpu``), after ``tests/test_harness.py``'s CLI tests and
``tests/test_txn.py``'s txn check.

Verdict fields and exit codes must be the reference's for ``check`` on
the fixtures and a txn history, and for ``recheck`` of one path,
several paths (the lockstep batch), an unreadable path and a run dir
the reference's store wrote; the reference's store must load a run dir
the port wrote. Without a card the commands fail with the port's
``default_device`` error and run nothing on the CPU.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from jepsen_tpu import cli as cli_ref
from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import store as store_ref
from jepsen_tpu_torch import cli as cli_pt
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch import store as store_pt
from jepsen_tpu_torch.checkers import reach as reach_pt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
CPU = ["--device", "cpu"]

VERDICT = ("valid", "op", "dead-event", "max-linearized")

FIXTURES = [
    ("cas-register-ok-small.edn", "cas-register"),
    ("cas-register-bad.edn", "cas-register"),
    ("register-ok.edn", "register"),
    ("register-bad.edn", "register"),
    ("mutex-ok.edn", "mutex"),
    ("multi-register-bad.edn", "multi-register"),
]


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _one(out):
    return json.loads(out)


def _lines(out):
    return [json.loads(ln) for ln in out.strip().splitlines()]


def _same(want, got, keys=VERDICT):
    diff = {k: (want.get(k), got.get(k)) for k in keys
            if want.get(k) != got.get(k)}
    assert not diff, diff


@pytest.mark.parametrize("fname,model", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_check_fixture(fname, model, capsys):
    path = os.path.join(DATA, fname)
    rc_ref, out_ref = _run(cli_ref.main, ["check", path, "--model", model],
                           capsys)
    rc_pt, out_pt = _run(cli_pt.main,
                         ["check", path, "--model", model] + CPU, capsys)
    assert rc_pt == rc_ref
    keys = ("valid", "op") if model == "multi-register" else VERDICT
    _same(_one(out_ref), _one(out_pt), keys)


@pytest.mark.parametrize("algorithm", ["reach-chunked", "linear",
                                       "competition", "wgl-native"])
def test_check_algorithm(algorithm, capsys):
    path = os.path.join(DATA, "cas-register-bad.edn")
    rc_ref, out_ref = _run(cli_ref.main, ["check", path, "--algorithm",
                                          algorithm], capsys)
    rc_pt, out_pt = _run(cli_pt.main, ["check", path, "--algorithm",
                                       algorithm] + CPU, capsys)
    assert rc_pt == rc_ref == 1
    got = _one(out_pt)
    _same(_one(out_ref), got, ("valid", "op"))
    if algorithm == "competition":
        assert "winner" in got


def test_check_txn_file_and_store(tmp_path, capsys):
    hist = fx_ref.gen_txn_history(20, keys=2, seed=9) + \
        [o.with_(index=-1) for o in fx_ref.txn_anomaly_block("G-single")]
    path = str(tmp_path / "history.edn")
    h_ref.save_edn(h_ref.index(hist), path)
    rc_ref, out_ref = _run(cli_ref.main, ["check", path, "--store-root",
                                          str(tmp_path / "ref")], capsys)
    rc_pt, out_pt = _run(cli_pt.main, ["check", path, "--store-root",
                                       str(tmp_path / "pt")] + CPU, capsys)
    assert rc_pt == rc_ref == 1
    want, got = _one(out_ref), _one(out_pt)
    assert got["anomalies"] == want["anomalies"] == ["G-single"]
    assert got["engine"] == want["engine"]
    run_dir = got["run-dir"]
    assert run_dir.startswith(str(tmp_path / "pt" / "txn-check"))
    # the reference's store reads the port's run dir
    saved = store_ref.load_results(run_dir)
    assert saved["anomalies"] == ["G-single"] and saved["witness"]["cycle"]
    assert [o.to_dict() for o in store_ref.load_history(run_dir)] == \
        [o.to_dict() for o in h_ref.load_edn(path)]
    assert sorted(os.listdir(run_dir)) == sorted(os.listdir(want["run-dir"]))
    # a valid txn history exits 0 and auto-detects the txn route
    clean = str(tmp_path / "clean.edn")
    h_ref.save_edn(fx_ref.gen_txn_history(10, seed=2), clean)
    rc, out = _run(cli_pt.main, ["check", clean] + CPU, capsys)
    assert rc == 0 and _one(out)["engine"].startswith("txn-")


def _stored_runs(tmp_path, seeds, bad=()):
    """Run dirs written by the reference's store, one history each."""
    dirs = []
    for s in seeds:
        hist = fx_ref.gen_history("cas", n_ops=200, processes=4, seed=s)
        if s in bad:
            hist = fx_ref.corrupt(hist, seed=s)
        dirs.append(store_ref.save({
            "name": f"cas-{s}", "history": hist, "results": {},
            "store-root": str(tmp_path), "start-time": "t0"}))
    return dirs


def test_recheck_one_reference_store_dir(tmp_path, capsys):
    (d,) = _stored_runs(tmp_path, (11,), bad=(11,))
    assert store_ref.latest(str(tmp_path)) == os.path.realpath(d)
    rc_ref, out_ref = _run(cli_ref.main, ["recheck", d], capsys)
    latest = os.path.join(str(tmp_path), "latest")
    rc_pt, out_pt = _run(cli_pt.main, ["recheck", latest] + CPU, capsys)
    assert rc_pt == rc_ref == 1
    _same(_one(out_ref), _one(out_pt))


def test_recheck_several_paths_batch(tmp_path, capsys, monkeypatch):
    dirs = _stored_runs(tmp_path, (21, 22, 23), bad=(22,))
    rc_ref, out_ref = _run(cli_ref.main, ["recheck", *dirs], capsys)
    calls = []
    real = reach_pt.check_batch

    def spy(model, packed, **kw):
        calls.append((len(packed), kw))
        return real(model, packed, **kw)

    monkeypatch.setattr(reach_pt, "check_batch", spy)
    rc_pt, out_pt = _run(cli_pt.main, ["recheck", *dirs] + CPU, capsys)
    assert rc_pt == rc_ref == 1
    want, got = _lines(out_ref), _lines(out_pt)
    assert [ln["path"] for ln in got] == dirs
    for w, g in zip(want, got):
        _same(w, g, ("path", "valid", "op", "dead-event"))
    assert [ln["valid"] for ln in got] == [True, False, True]
    # one lockstep batch for the three histories
    assert calls == [(3, {"device": torch.device("cpu")})]


def test_recheck_unreadable_path(tmp_path, capsys):
    (good,) = _stored_runs(tmp_path, (13,))
    missing = str(tmp_path / "no-such-run.jsonl")
    rc_ref, out_ref = _run(cli_ref.main, ["recheck", good, missing], capsys)
    rc_pt, out_pt = _run(cli_pt.main, ["recheck", good, missing] + CPU,
                         capsys)
    assert rc_pt == rc_ref == 1
    want, got = _lines(out_ref), _lines(out_pt)
    assert got[0]["valid"] is want[0]["valid"] is True
    assert got[1]["valid"] == want[1]["valid"] == "unknown"
    assert got[1]["error"] == want[1]["error"]


def test_recheck_jsonl_paths_and_valid_exit(tmp_path, capsys):
    paths = []
    for s in (31, 32):
        p = str(tmp_path / f"h{s}.jsonl")
        h_pt.save_jsonl(fx_pt.gen_history("cas", n_ops=150, processes=3,
                                          seed=s), p)
        paths.append(p)
    rc_ref, out_ref = _run(cli_ref.main, ["recheck", *paths], capsys)
    rc_pt, out_pt = _run(cli_pt.main, ["recheck", *paths] + CPU, capsys)
    assert rc_pt == rc_ref == 0
    assert [ln["valid"] for ln in _lines(out_pt)] == [True, True]


def test_recheck_batch_capacity_decline_checks_each(tmp_path, capsys,
                                                    monkeypatch):
    dirs = _stored_runs(tmp_path, (41, 42), bad=(42,))

    def declines(*a, **k):
        raise reach_pt.DenseOverflow("batched dense config space")

    monkeypatch.setattr(reach_pt, "check_batch", declines)
    with obs.capture() as cap:
        rc, out = _run(cli_pt.main, ["recheck", *dirs] + CPU, capsys)
    assert rc == 1
    assert [ln["valid"] for ln in _lines(out)] == [True, False]
    rec = [d for d in cap.ledger if d["stage"] == "recheck"]
    assert rec and rec[0]["event"] == "fallback"
    assert rec[0]["cause"] == "DenseOverflow"


def test_recheck_batch_fault_propagates(tmp_path, capsys, monkeypatch):
    dirs = _stored_runs(tmp_path, (51, 52))

    def fault(*a, **k):
        raise RuntimeError("K2 launch failed: CUDA error 700")

    monkeypatch.setattr(reach_pt, "check_batch", fault)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        cli_pt.main(["recheck", *dirs] + CPU)


def test_port_store_round_trip(tmp_path):
    hist = fx_pt.gen_history("cas", n_ops=50, processes=3, seed=1)
    d = store_pt.save({"name": "pt/run", "history": hist,
                       "results": {"valid": True},
                       "store-root": str(tmp_path), "model": object()})
    assert os.path.basename(os.path.dirname(d)) == "pt_run"
    assert store_pt.latest(str(tmp_path)) == os.path.realpath(d)
    assert store_ref.latest(str(tmp_path)) == os.path.realpath(d)
    assert store_pt.tests(str(tmp_path)) == store_ref.tests(str(tmp_path))
    assert store_ref.load_results(d) == store_pt.load_results(d) == \
        {"valid": True}
    assert [o.to_dict() for o in store_ref.load_history(d)] == \
        [o.to_dict() for o in store_pt.load_history(d)] == \
        [o.to_dict() for o in hist]
    test_json = json.load(open(os.path.join(d, "test.json")))
    assert test_json["model"].startswith("<object")
    # an edn-only run dir loads too
    os.remove(os.path.join(d, "history.jsonl"))
    assert [o.to_dict() for o in store_pt.load_history(d)] == \
        [o.to_dict() for o in store_ref.load_history(d)]
    with pytest.raises(FileNotFoundError):
        store_pt.load_history(str(tmp_path))
    h = store_pt.attach_log(d)
    import logging
    logging.getLogger("jepsen.cli").warning("logged")
    store_pt.detach_log(h)
    assert "logged" in open(os.path.join(d, "jepsen.log")).read()


def test_no_card_fails_without_running(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(DATA, "cas-register-bad.edn")
    for cmd in (["check", path], ["recheck", path, path]):
        rc, out = _run(cli_pt.main, cmd, capsys)
        err = capsys.readouterr().err
        assert rc == 2 and out == ""
    assert cli_pt.main(["check", path] + CPU) == 1


@pytest.mark.parametrize("argv", [
    # the daemon and the results browser are ported; the pod mode is not
    pytest.param(["check-serve", "--num-processes", "2"] + CPU,
                 id="check-serve-pod"),
    pytest.param(["check-serve", "--coordinator", "localhost:1"] + CPU,
                 id="check-serve")])
def test_unported_commands_exit_2(argv, capsys):
    assert cli_pt.main(argv) == 2
    assert "ROADMAP.md" in capsys.readouterr().err


RUN_KEYS = {"run", "name", "valid", "dir", "ops"}


@pytest.mark.parametrize("mode,rc_want", [("linearizable", 0),
                                          ("sloppy", 1)])
def test_run_register_on_cpu(mode, rc_want, tmp_path, capsys):
    """``run --device cpu``: the README's command at a short time limit;
    the sloppy cluster under the partition nemesis fails the check."""
    rc, out = _run(cli_pt.main, ["run", "--suite", "register", "--mode", mode,
                                 "--time-limit", "1.5", "--seed", "11",
                                 "--store-root", str(tmp_path)] + CPU,
                   capsys)
    line = _one(out)
    assert set(line) == RUN_KEYS
    assert rc == rc_want and line["valid"] is (rc_want == 0)
    assert line["name"] == f"register-{mode}" and line["ops"] > 100
    hist = store_ref.load_history(line["dir"])
    assert len(hist) == line["ops"]
    res = json.load(open(os.path.join(line["dir"], "results.json")))
    assert res["valid"] is line["valid"]
    assert res["results"]["linear"]["valid"] is line["valid"]
    if rc_want:
        rc2, out2 = _run(cli_pt.main, ["recheck", line["dir"]] + CPU, capsys)
        assert rc2 == 1
        _same(res["results"]["linear"], _one(out2))


def test_run_independent_and_test_count(tmp_path, capsys):
    rc, out = _run(cli_pt.main, ["run", "--suite", "register-independent",
                                 "--test-count", "2", "--concurrency", "4",
                                 "--seed", "3",
                                 "--store-root", str(tmp_path)] + CPU, capsys)
    lines = _lines(out)
    assert rc == 0 and [ln["run"] for ln in lines] == [0, 1]
    assert all(ln["valid"] is True and set(ln) == RUN_KEYS for ln in lines)
    res = json.load(open(os.path.join(lines[0]["dir"], "results.json")))
    assert res["key-count"] == 8


def test_run_line_has_the_reference_keys(tmp_path, capsys):
    args = ["run", "--suite", "register", "--time-limit", "0.3",
            "--no-nemesis", "--seed", "1"]
    rc_ref, out_ref = _run(cli_ref.main, args + ["--store-root",
                                                 str(tmp_path / "ref")],
                           capsys)
    rc_pt, out_pt = _run(cli_pt.main, args + ["--store-root",
                                              str(tmp_path / "pt")] + CPU,
                         capsys)
    assert rc_pt == rc_ref == 0
    assert set(_one(out_pt)) == set(_one(out_ref)) == RUN_KEYS
    assert sorted(os.listdir(_one(out_pt)["dir"])) == \
        sorted(os.listdir(_one(out_ref)["dir"]))


def test_run_without_card_exits_2_before_any_op(monkeypatch, tmp_path,
                                                  capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli_pt.main(["run", "--suite", "register", "--time-limit", "1",
                      "--store-root", str(tmp_path)])
    cap = capsys.readouterr()
    assert rc == 2 and cap.out == "" and "no CUDA device" in cap.err
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("args,name", [
    (["--online", "--suite", "set"], "set-linearizable"),
    (["--suite", "mutex"], "mutex-linearizable"),
    (["--suite", "queue"], "queue-safe"),
    (["--suite", "etcd"], "etcd-linearizable")])
def test_run_not_ported_yet_exits_2(args, name, tmp_path, capsys, caplog):
    """Each suite of the reference's ``run``, on the port with ``--device
    cpu``: the reference's exit code and JSON line, its run dir's files;
    ``--online`` on a suite whose test map has no model only logs the
    reference's warning."""
    args = ["run", "--time-limit", "1", "--seed", "5"] + args
    rc_ref, out_ref = _run(cli_ref.main, args + [
        "--store-root", str(tmp_path / "ref")], capsys)
    rc_pt, out_pt = _run(cli_pt.main, args + [
        "--store-root", str(tmp_path / "pt")] + CPU, capsys)
    line, want = _one(out_pt), _one(out_ref)
    assert rc_pt == rc_ref == 0
    assert set(line) == set(want) == RUN_KEYS
    assert line["name"] == want["name"] == name
    assert line["valid"] is want["valid"] is True and line["ops"] > 0
    assert sorted(os.listdir(line["dir"])) == sorted(os.listdir(want["dir"]))
    warned = [r for r in caplog.records if "jepsen_tpu_torch" in r.pathname
              and "online-check requested" in r.getMessage()]
    assert len(warned) == ("--online" in args)


def test_run_check_fault_exits_with_traceback(tmp_path):
    """A fault in the run's check (a kernel wrapper that raises) is a
    traceback and exit 1, the history on disk."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from jepsen_tpu_torch.checkers import reach_lane\n"
         "def boom(*a, **k):\n"
         "    raise RuntimeError('CUDA error: launch failure')\n"
         "reach_lane.lane_walk = boom\n"
         "from jepsen_tpu_torch.cli import main\n"
         "sys.exit(main(['run', '--time-limit', '0.3', '--no-nemesis',\n"
         "               '--store-root', sys.argv[1], '--device', 'cpu']))\n",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 1 and out.stdout == ""
    assert "Traceback" in out.stderr and "launch failure" in out.stderr
    assert store_pt.load_history(store_pt.latest(str(tmp_path)))


def test_module_entry_point(tmp_path):
    """``python -m jepsen_tpu_torch`` runs the same main, in a fresh
    interpreter, and imports neither JAX nor the reference."""
    path = os.path.join(DATA, "register-bad.edn")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys\n"
         "sys.argv = ['jepsen_tpu_torch', 'check', sys.argv[1], '--model',"
         " 'register', '--device', 'cpu']\n"
         "try:\n"
         "    runpy.run_module('jepsen_tpu_torch', run_name='__main__')\n"
         "finally:\n"
         "    assert not any(m == 'jax' or m.startswith('jepsen_tpu.')\n"
         "                   for m in sys.modules)\n", path],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 1, out.stderr
    assert json.loads(out.stdout)["valid"] is False

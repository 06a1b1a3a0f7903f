"""The port's soak (``python -m jepsen_tpu_torch.tools.soak``) against the
reference's ``tools/soak.py``, on the CPU: the configs, the test maps its
``build`` makes, its "never caught" and crash rules with ``core.run``
stubbed, and one short run of a correct config on the port's suite."""
import importlib.util
import json
import os

import pytest
import torch

from jepsen_tpu_torch import core as core_pt
from jepsen_tpu_torch.tools import soak as soak_pt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference_soak():
    spec = importlib.util.spec_from_file_location(
        "reference_soak", os.path.join(ROOT, "tools", "soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


soak_ref = _load_reference_soak()

# the test map's data keys; the live objects are compared by class
SCALARS = ("name", "concurrency", "nodes", "op-timeout", "run-time-limit",
           "store")
LIVE = ("nemesis", "client", "checker", "generator")


def test_configs_equal_reference():
    assert soak_pt.CONFIGS == soak_ref.CONFIGS


@pytest.mark.parametrize("suite,mode,expect", soak_ref.CONFIGS,
                         ids=[f"{s}-{m}" for s, m, _ in soak_ref.CONFIGS])
def test_build_makes_the_reference_test_maps(suite, mode, expect):
    got = soak_pt.build(suite, mode, 12345, 1.5, device="cpu")
    want = soak_ref.build(suite, mode, 12345, 1.5)
    assert set(got) - {"device"} == set(want)
    assert got["device"] == "cpu"
    assert {k: got[k] for k in SCALARS} == {k: want[k] for k in SCALARS}
    assert [type(got[k]).__name__ for k in LIVE] == \
        [type(want[k]).__name__ for k in LIVE]


def _stub_run(monkeypatch, verdict):
    """``core.run`` answering ``verdict(test)`` without running."""
    seen = []

    def run(test):
        seen.append(test["name"])
        v = verdict(test)
        if isinstance(v, Exception):
            raise v
        return {"results": {"valid": v}}

    monkeypatch.setattr(core_pt, "run", run)
    return seen


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_every_expected_verdict_exits_0(monkeypatch, capsys):
    expected = {}
    for suite, mode, expect in soak_pt.CONFIGS:
        expected[soak_pt.build(suite, mode, 0, 0.1)["name"]] = expect
    seen = _stub_run(monkeypatch, lambda t: expected[t["name"]])
    assert soak_pt.main(["--rounds", "2", "--device", "cpu"]) == 0
    out = _summary(capsys)
    assert out["runs"] == 2 * len(soak_pt.CONFIGS) == len(seen)
    assert out["unexpected"] == 0
    assert set(out["caught"]) == {f"{s}-{m}" for s, m, e in soak_pt.CONFIGS
                                  if e is False}


def test_a_bug_never_caught_fails(monkeypatch, capsys):
    """Every run valid: each buggy mode is never caught in any round, one
    failure each, exit 1 (the reference's rule)."""
    _stub_run(monkeypatch, lambda t: True)
    assert soak_pt.main(["--rounds", "3", "--device", "cpu"]) == 1
    out = _summary(capsys)
    buggy = sum(1 for _, _, e in soak_pt.CONFIGS if e is False)
    assert out["unexpected"] == buggy and out["caught"] == {}


def test_a_bug_caught_in_one_round_is_enough(monkeypatch, capsys):
    """A buggy mode caught in one round of three passes."""
    calls = {}
    expected = {soak_pt.build(s, m, 0, 0.1)["name"]: e
                for s, m, e in soak_pt.CONFIGS}

    def verdict(test):
        n = calls[test["name"]] = calls.get(test["name"], 0) + 1
        return expected[test["name"]] or n < 3     # caught in round 3
    _stub_run(monkeypatch, verdict)
    assert soak_pt.main(["--rounds", "3", "--device", "cpu"]) == 0
    assert all(v == 1 for v in _summary(capsys)["caught"].values())


def test_a_crash_is_never_a_verdict(monkeypatch, capsys):
    """A run that raises (a device fault, say) fails the soak even in a
    buggy mode that another round caught."""
    expected = {soak_pt.build(s, m, 0, 0.1)["name"]: e
                for s, m, e in soak_pt.CONFIGS}
    calls = {}

    def verdict(test):
        n = calls[test["name"]] = calls.get(test["name"], 0) + 1
        if test["name"].startswith("mutex") and not expected[test["name"]] \
                and n == 1:
            return RuntimeError("CUDA error: an illegal memory access")
        return expected[test["name"]]
    _stub_run(monkeypatch, verdict)
    assert soak_pt.main(["--rounds", "2", "--device", "cpu"]) == 1
    assert _summary(capsys)["unexpected"] == 1


RULE_CASES = [(True, True, False), (True, False, True),
              (True, "unknown", True), (False, False, False),
              (False, True, False), (True, "crash: E: x", True),
              (False, "crash: E: x", True)]


@pytest.mark.parametrize("expect,valid,want", RULE_CASES)
def test_unexpected_rule(expect, valid, want):
    """A correct mode must be valid; a crash is unexpected in any mode;
    a buggy mode's single round may go either way."""
    assert soak_pt.unexpected(expect, valid) is want


@pytest.mark.parametrize("expect,verdicts,want", [
    (False, [True, True, True], True), (False, [True, False], False),
    (False, [], True), (True, [True], False), (True, [False], False)])
def test_never_caught_rule(expect, verdicts, want):
    assert soak_pt.never_caught(expect, verdicts) is want


def test_run_once_reports_a_crash(monkeypatch):
    _stub_run(monkeypatch, lambda t: RuntimeError("boom"))
    assert soak_pt.run_once({"name": "t"}) == "crash: RuntimeError: boom"


def test_short_correct_run(monkeypatch):
    """One correct config through the real ``core.run`` on the CPU."""
    monkeypatch.setenv("JEPSEN_TPU_NO_PERSIST", "1")
    test = soak_pt.build("register", "linearizable", 7, 1.0, device="cpu")
    done = core_pt.run(test)
    assert done["results"]["valid"] is True
    assert done["results"]["results"]["linear"]["valid"] is True

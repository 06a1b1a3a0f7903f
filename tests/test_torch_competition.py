"""The port's ``Linearizable`` under every algorithm name of the
reference's, the ``competition`` race, the failure report and the
data-invariant checkers, against the reference facade on the CPU.

The parametrisation is that of ``tests/test_checkers.py``'s
``TestLinearizable``, with every name: each gives the reference's
verdict and failing op on a valid and a corrupted history. The race
must name its ``winner``, leave no device racer running, and raise a
device racer's fault even when another racer has won (the reference
turns every racer error into an ``unknown``).
"""
import os
import threading
import time

import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import facade as fa_ref
from jepsen_tpu.checkers import linear_report as rep_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.op import fail as fail_ref
from jepsen_tpu.op import info as info_ref
from jepsen_tpu.op import invoke as inv_ref
from jepsen_tpu.op import ok as ok_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import facade as fa_pt
from jepsen_tpu_torch.checkers import frontier as frontier_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.op import fail as fail_pt
from jepsen_tpu_torch.op import info as info_pt
from jepsen_tpu_torch.op import invoke as inv_pt
from jepsen_tpu_torch.op import ok as ok_pt

torch.set_num_threads(1)

ALGORITHMS = ["auto", "reach", "reach-chunked", "chunklock", "frontier",
              "decompose", "wgl-native", "wgl-cpu", "linear", "competition"]


def _pair(corrupt, **kw):
    kw = dict(dict(n_ops=40, processes=4, seed=5), **kw)
    a = fx_ref.gen_history("cas", **kw)
    b = fx_pt.gen_history("cas", **kw)
    if corrupt:
        a, b = fx_ref.corrupt(a, seed=5), fx_pt.corrupt(b, seed=5)
    return a, b


def _ref(algorithm, history):
    reach_ref._MEMO_CACHE.clear()
    if algorithm == "chunklock":
        # the reference's chunk-lockstep runs its Pallas kernels, which
        # take about 20 s in interpret mode here; its verdict and op are
        # its dense engine's by construction
        algorithm = "reach"
    c = fa_ref.linearizable(m_ref.cas_register(), algorithm=algorithm)
    try:
        return c.check(None, history)
    except Exception as e:                              # noqa: BLE001
        return type(e).__name__


def _pt(algorithm, history):
    c = fa_pt.Linearizable(m_pt.cas_register(), algorithm=algorithm,
                           device="cpu")
    try:
        return c.check(None, history)
    except Exception as e:                              # noqa: BLE001
        return type(e).__name__


@pytest.mark.parametrize("algorithm", ALGORITHMS)
@pytest.mark.parametrize("corrupt", [False, True], ids=["valid", "invalid"])
def test_every_algorithm_gives_the_reference_verdict(algorithm, corrupt):
    a, b = _pair(corrupt)
    want, got = _ref(algorithm, a), _pt(algorithm, b)
    if isinstance(want, str):
        assert got == want                      # the same decline
        return
    assert got["valid"] == want["valid"]
    if algorithm != "decompose":
        assert got["valid"] is (not corrupt)
    if want["valid"] is False and algorithm != "competition":
        assert got["op"] == want["op"]
    if algorithm == "competition":
        assert got["winner"] in ("wgl-native", "reach", "linear",
                                 "frontier")
        if corrupt:
            assert got["op"] == want["op"]


def test_unknown_algorithm_raises_value_error():
    b = fx_pt.gen_history("cas", n_ops=10, processes=2, seed=0)
    with pytest.raises(ValueError, match="unknown algorithm"):
        fa_pt.Linearizable(m_pt.cas_register(), algorithm="nope",
                           device="cpu").check(None, b)


# -- the race ------------------------------------------------------------------

def _racers_alive():
    return [t.name for t in threading.enumerate()
            if t.name in ("competition-reach", "competition-frontier")]


@pytest.mark.parametrize("corrupt", [False, True])
def test_competition_names_winner_and_stops_losers(corrupt):
    a, b = _pair(corrupt, n_ops=300, processes=5, seed=3)
    with obs.capture() as cap:
        got = fa_pt.Linearizable(m_pt.cas_register(),
                                 algorithm="competition",
                                 device="cpu").check(None, b)
    want = fa_ref.linearizable(m_ref.cas_register(),
                               algorithm="competition").check(None, a)
    assert got["valid"] == want["valid"] == (not corrupt)
    assert got["winner"] in ("wgl-native", "reach", "linear", "frontier")
    assert not _racers_alive()                  # device racers joined
    rec = [d for d in cap.ledger if d["stage"] == "competition"]
    assert len(rec) == 1 and rec[0]["winner"] == got["winner"]
    assert rec[0]["stop_s"] >= 0


def test_device_racer_fault_propagates_when_another_wins(monkeypatch):
    """The dense engine's racer raises (a device fault) after the C++
    search has already won: the caller raises it anyway."""
    a, b = _pair(False, n_ops=60, processes=3, seed=1)

    def boom(*a, **k):
        time.sleep(0.3)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(reach_pt, "check", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        fa_pt.Linearizable(m_pt.cas_register(), algorithm="competition",
                           device="cpu").check(None, b)
    assert not _racers_alive()


def test_frontier_racer_fault_propagates(monkeypatch):
    a, b = _pair(True, n_ops=60, processes=3, seed=1)

    def boom(*a, **k):
        raise RuntimeError("frontier fault")

    monkeypatch.setattr(frontier_pt, "check", boom)
    with pytest.raises(RuntimeError, match="frontier fault"):
        fa_pt.Linearizable(m_pt.cas_register(), algorithm="competition",
                           device="cpu").check(None, b)


def test_capacity_decline_is_an_unknown_racer(monkeypatch):
    """A racer that declines the history for capacity loses quietly: the
    others decide."""
    a, b = _pair(True, n_ops=60, processes=3, seed=1)

    def overflow(*a, **k):
        raise reach_pt.DenseOverflow("too dense")

    monkeypatch.setattr(reach_pt, "check", overflow)
    got = fa_pt.Linearizable(m_pt.cas_register(), algorithm="competition",
                             device="cpu").check(None, b)
    assert got["valid"] is False and got["winner"] != "reach"


def test_every_racer_unknown_gives_unknown():
    a, b = _pair(False, n_ops=60, processes=3, seed=1)
    got = fa_pt.Linearizable(m_pt.cas_register(), algorithm="competition",
                             device="cpu",
                             opts={"time_limit": 0.0}).check(None, b)
    want = fa_ref.linearizable(m_ref.cas_register(), algorithm="competition",
                               time_limit=0.0).check(None, a)
    assert got["valid"] in (True, "unknown")
    assert want["valid"] in (True, "unknown")
    assert not _racers_alive()


def test_no_card_raises_before_the_race(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = fx_pt.gen_history("cas", n_ops=20, processes=2, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        fa_pt.Linearizable(m_pt.cas_register(),
                           algorithm="competition").check(None, b)


# -- the failure report --------------------------------------------------------

@pytest.mark.parametrize("algorithm", ["reach", "linear", "competition"])
def test_invalid_check_writes_linear_svg(algorithm, tmp_path):
    a, b = _pair(True)
    d_ref, d_pt = tmp_path / "ref", tmp_path / "pt"
    d_ref.mkdir()
    d_pt.mkdir()
    want = fa_ref.linearizable(m_ref.cas_register(),
                               algorithm=algorithm).check(
        {"dir": str(d_ref)}, a)
    got = fa_pt.Linearizable(m_pt.cas_register(), algorithm=algorithm,
                             device="cpu").check({"dir": str(d_pt)}, b)
    assert got["report-file"] == str(d_pt / "linear.svg")
    assert open(got["report-file"]).read() == \
        open(want["report-file"]).read() == rep_ref.render_analysis(a, got)


def test_valid_check_writes_no_report(tmp_path):
    a, b = _pair(False)
    got = fa_pt.Linearizable(m_pt.cas_register(), device="cpu").check(
        {"dir": str(tmp_path)}, b)
    assert got["valid"] is True and "report-file" not in got
    assert not os.listdir(tmp_path)


def test_report_failure_never_masks_the_verdict(tmp_path, monkeypatch):
    from jepsen_tpu_torch.checkers import linear_report

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(linear_report, "render_analysis", broken)
    a, b = _pair(True)
    got = fa_pt.Linearizable(m_pt.cas_register(), device="cpu").check(
        {"dir": str(tmp_path)}, b)
    assert got["valid"] is False and "report-file" not in got


# -- the data-invariant checkers ------------------------------------------------

def _both(build):
    """A history built from each package's op constructors."""
    ref = h_ref.index(build(inv_ref, ok_ref, info_ref, fail_ref))
    pt = h_pt.index(build(inv_pt, ok_pt, info_pt, fail_pt))
    return ref, pt


HOST_CASES = [
    ("set_checker", lambda i, o, n, f: [
        i(0, "add", 1), o(0, "add", 1), i(1, "add", 2), o(1, "add", 2),
        i(2, "add", 3), n(2, "add", 3), i(0, "read"), o(0, "read", [1, 3])]),
    ("set_checker", lambda i, o, n, f: [i(0, "read"), o(0, "read", [9])]),
    ("set_checker", lambda i, o, n, f: [i(0, "add", 1), o(0, "add", 1)]),
    ("counter", lambda i, o, n, f: [
        i(0, "add", 2), o(0, "add", 2), i(0, "read"), o(0, "read", 2),
        i(1, "add", 3), o(1, "add", 3), i(0, "read"), o(0, "read", 5)]),
    ("counter", lambda i, o, n, f: [
        i(0, "add", 5), i(1, "read"), o(1, "read", 7), o(0, "add", 5)]),
    ("counter", lambda i, o, n, f: [
        i(0, "add", 5), n(0, "add", 5), i(1, "read"), o(1, "read", 5)]),
    ("counter", lambda i, o, n, f: [
        i(0, "add", 1), o(0, "add", 1), i(1, "read"), o(1, "read", 9)]),
    ("queue", lambda i, o, n, f: [
        i(0, "enqueue", 1), o(0, "enqueue", 1), i(1, "dequeue"),
        o(1, "dequeue", 1), i(2, "dequeue"), o(2, "dequeue", 1)]),
    ("total_queue", lambda i, o, n, f: [
        i(0, "enqueue", 1), o(0, "enqueue", 1), i(0, "enqueue", 2),
        o(0, "enqueue", 2), i(1, "dequeue"), o(1, "dequeue", 1)]),
    ("total_queue", lambda i, o, n, f: [
        i(0, "enqueue", 1), n(0, "enqueue", 1), i(1, "dequeue"),
        o(1, "dequeue", 1)]),
    ("stats", lambda i, o, n, f: [
        i(0, "read"), o(0, "read", None), i(0, "write", 1),
        f(0, "write", 1)]),
    ("noop_checker", lambda i, o, n, f: [i(0, "read"), o(0, "read", 1)]),
    ("unbridled_optimism", lambda i, o, n, f: [i(0, "read")]),
]


@pytest.mark.parametrize("name,build", HOST_CASES,
                         ids=[f"{c[0]}-{k}" for k, c in
                              enumerate(HOST_CASES)])
def test_host_checkers_equal_reference(name, build):
    ref, pt = _both(build)
    assert getattr(fa_pt, name)().check(None, pt) == \
        getattr(fa_ref, name)().check(None, ref)


def test_compose_with_host_checkers():
    a, b = _pair(True, n_ops=20, processes=3, seed=1)
    got = fa_pt.compose({"linear": fa_pt.Linearizable(m_pt.cas_register(),
                                                      device="cpu"),
                         "stats": fa_pt.stats(),
                         "optimism": fa_pt.unbridled_optimism()}).check(
        None, b)
    want = fa_ref.compose({"linear": fa_ref.linearizable(
        m_ref.cas_register()), "stats": fa_ref.stats(),
        "optimism": fa_ref.unbridled_optimism()}).check(None, a)
    assert got["valid"] is want["valid"] is False
    assert got["results"]["stats"] == want["results"]["stats"]

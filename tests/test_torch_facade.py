"""The port's ``Linearizable`` against the reference facade, on the CPU.

Verdict, failing op, dead event, linearized count and witness
(``final-configs``, ``previous-ok``) must be equal exactly on the
``data/*.edn`` fixtures and on generated histories, through each of the
dense engine's routes. The reference's memo cache is cleared first so
its state numbering is that of a cold build, as the port's is.
"""
import os

import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import facade as fa_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu_torch import Linearizable, obs
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_lane as lane_pt
from jepsen_tpu_torch.checkers import reach_pallas as pallas_pt

# tiny tensors: one thread each keeps the parallel test workers from
# crowding each other's cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")

KEYS = ("valid", "op", "dead-event", "max-linearized", "final-configs",
        "previous-ok", "events", "slots", "states")

FIXTURES = [
    ("cas-register-ok-small.edn", "cas_register", True),
    ("cas-register-ok-large.edn", "cas_register", True),
    ("cas-register-bad.edn", "cas_register", False),
    ("cas-register-recorded-bad.edn", "cas_register", False),
    ("register-ok.edn", "register", True),
    ("register-bad.edn", "register", False),
    ("mutex-ok.edn", "mutex", True),
    ("multi-register-ok.edn", "multi_register", True),
    ("multi-register-bad.edn", "multi_register", False),
]


def _same(r_ref, r_pt):
    diff = {k: (r_ref.get(k), r_pt.get(k)) for k in KEYS
            if r_ref.get(k) != r_pt.get(k)}
    assert not diff, diff


def _ref_check(model_name, history):
    """The reference facade's verdict. Multi-register models go straight
    to its ``auto`` chain: the per-key decomposition it tries first is
    not ported, and reports its witness per key."""
    reach_ref._MEMO_CACHE.clear()
    model = getattr(m_ref, model_name)()
    if model_name == "multi_register":
        return fa_ref.auto_check_packed(model, h_ref.pack(history), {})
    return fa_ref.Linearizable(model).check(None, history)


@pytest.mark.parametrize("fname,model_name,want", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixtures_match_reference(fname, model_name, want):
    path = os.path.join(DATA, fname)
    r_ref = _ref_check(model_name, h_ref.load_edn(path))
    r_pt = Linearizable(getattr(m_pt, model_name)(), device="cpu").check(
        None, h_pt.load_edn(path))
    assert r_pt["valid"] is want
    assert r_pt["engine"] == "reach-lane"
    _same(r_ref, r_pt)
    if want is False:
        assert r_pt["final-configs"] and r_pt["previous-ok"]


MODEL_OF = {"cas": "cas_register", "register": "register",
            "mutex": "mutex"}

GENERATED = [
    ("cas", 0, 0.0, False), ("cas", 1, 0.0, True), ("cas", 2, 0.05, False),
    ("cas", 3, 0.05, True), ("register", 4, 0.05, True),
    ("mutex", 5, 0.05, False),
]


@pytest.mark.parametrize("kind,seed,crash_p,corrupt", GENERATED)
def test_generated_match_reference(kind, seed, crash_p, corrupt):
    kw = dict(n_ops=60, processes=4, crash_p=crash_p, seed=seed)
    h1 = fx_ref.gen_history(kind, **kw)
    h2 = fx_pt.gen_history(kind, **kw)
    if corrupt:
        h1, h2 = fx_ref.corrupt(h1, seed=seed), fx_pt.corrupt(h2, seed=seed)
    r_ref = _ref_check(MODEL_OF[kind], h1)
    r_pt = Linearizable(fx_pt.model_for(kind), device="cpu").check(None, h2)
    _same(r_ref, r_pt)
    assert r_pt["valid"] is (not corrupt)


@pytest.mark.parametrize("route", ["torch-returns", "torch-events"])
@pytest.mark.parametrize("corrupt", [False, True])
def test_other_routes_match_reference(monkeypatch, route, corrupt):
    """Geometries the kernels do not take go to the torch returns walk;
    those the matrix form does not fit go to the torch event walk. Both
    give the reference's answers, witness included."""
    if route == "torch-returns":
        monkeypatch.setattr(lane_pt, "lane_fits", lambda *a: False)
        monkeypatch.setattr(pallas_pt, "fits", lambda *a: False)
    else:
        monkeypatch.setattr(reach_ref, "_FAST_MAX_ELEMS", 1)
        monkeypatch.setattr(reach_pt, "_FAST_MAX_ELEMS", 1)
    h1 = fx_ref.gen_history("cas", n_ops=60, processes=4, seed=7)
    h2 = fx_pt.gen_history("cas", n_ops=60, processes=4, seed=7)
    if corrupt:
        h1, h2 = fx_ref.corrupt(h1, seed=7), fx_pt.corrupt(h2, seed=7)
    r_ref = _ref_check("cas_register", h1)
    with obs.capture() as cap:
        r_pt = Linearizable(m_pt.cas_register(), device="cpu").check(None,
                                                                     h2)
    _same(r_ref, r_pt)
    assert r_pt["engine"] == "reach"
    routes = [r["engine"] for r in cap.ledger if r["event"] == "route"]
    assert routes == (["reach"] if route == "torch-returns"
                      else ["reach-events"])


@pytest.mark.parametrize("corrupt", [False, True])
def test_wide_kernel_route_matches_reference(monkeypatch, corrupt):
    """A geometry the lane kernel does not take goes to the wide kernel
    K4, which takes one word a mask too; its verdict and witness (the
    prefix re-walked by K4) are the reference's."""
    monkeypatch.setattr(lane_pt, "lane_fits", lambda *a: False)
    h1 = fx_ref.gen_history("cas", n_ops=60, processes=4, seed=7)
    h2 = fx_pt.gen_history("cas", n_ops=60, processes=4, seed=7)
    if corrupt:
        h1, h2 = fx_ref.corrupt(h1, seed=7), fx_pt.corrupt(h2, seed=7)
    r_ref = _ref_check("cas_register", h1)
    with obs.capture() as cap:
        r_pt = Linearizable(m_pt.cas_register(), device="cpu").check(None,
                                                                     h2)
    _same(r_ref, r_pt)
    assert r_pt["engine"] == "reach-pallas"
    assert [r["engine"] for r in cap.ledger if r["event"] == "route"] == \
        ["reach-pallas"]


def test_ledger_records_route_and_unported_stages():
    h = fx_pt.gen_history("cas", n_ops=40, processes=3, seed=1)
    with obs.capture() as cap:
        res = Linearizable(m_pt.cas_register(), device="cpu").check(None, h)
    assert res["valid"] is True
    assert [r["stage"] for r in cap.selections()] == ["reach-lane"]
    assert cap.fallbacks() == []
    skipped = {r["stage"]: r["cause"] for r in cap.skipped()}
    assert skipped == {"reach-word": "not-ported",
                       "reach-chunklock": "below-min-returns"}
    assert [r["engine"] for r in cap.ledger
            if r["event"] == "route"] == ["reach-lane"]


@pytest.mark.parametrize("error", [RuntimeError, ValueError])
def test_witness_failure_is_never_hidden(monkeypatch, error):
    """A kernel or device failure in the witness re-walk propagates; any
    other failure drops the witness but is recorded in the ledger."""
    def fail(*a, **k):
        raise error("witness walk failed")

    monkeypatch.setattr(lane_pt, "prefix_set", fail)
    bad = fx_pt.corrupt(fx_pt.gen_history("cas", n_ops=40, processes=3,
                                          seed=1), seed=1)
    check = Linearizable(m_pt.cas_register(), device="cpu").check
    if error is RuntimeError:
        with pytest.raises(RuntimeError, match="witness walk failed"):
            check(None, bad)
        return
    with obs.capture() as cap:
        res = check(None, bad)
    assert res["valid"] is False and "final-configs" not in res
    assert [(r["stage"], r["cause"]) for r in cap.fallbacks()] == \
        [("reach.witness", "ValueError")]


def test_overflow_falls_back_to_python_oracle():
    """Too many pending ops for the dense engine: the chain records the
    fallback, skips the stages not ported, and the oracle decides."""
    h = fx_pt.gen_history("cas", n_ops=40, processes=4, seed=2)
    with obs.capture() as cap:
        res = Linearizable(m_pt.cas_register(), device="cpu",
                           opts={"max_slots": 1}).check(None, h)
    assert res["valid"] is True and res["engine"] == "wgl-cpu-fallback"
    assert [r["cause"] for r in cap.fallbacks()] == ["ConcurrencyOverflow"]
    assert {r["stage"] for r in cap.skipped()} == {"wgl-native",
                                                   "frontier"}


def test_multi_register_records_unported_stages():
    h = fx_pt.gen_history("multi", n_ops=30, processes=3, seed=4, keys=2)
    with obs.capture() as cap:
        Linearizable(m_pt.multi_register(), device="cpu").check(None, h)
    assert "decompose" in {r["stage"] for r in cap.skipped()}


def test_algorithms():
    h = fx_pt.gen_history("cas", n_ops=30, processes=3, seed=3)
    bad = fx_pt.corrupt(h, seed=3)
    model = m_pt.cas_register()
    ref = _ref_check("cas_register", fx_ref.corrupt(
        fx_ref.gen_history("cas", n_ops=30, processes=3, seed=3), seed=3))
    r_reach = Linearizable(model, algorithm="reach",
                           device="cpu").check(None, bad)
    _same(ref, r_reach)
    assert Linearizable(model, algorithm="wgl-cpu").check(
        None, bad)["valid"] is False
    with pytest.raises(NotImplementedError, match="not ported"):
        Linearizable(model, algorithm="frontier",
                     device="cpu").check(None, h)

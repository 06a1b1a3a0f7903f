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
from jepsen_tpu.op import info as info_ref
from jepsen_tpu.op import invoke as inv_ref
from jepsen_tpu.op import ok as ok_ref
from jepsen_tpu_torch import Linearizable, obs
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch.checkers import facade as fa_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_lane as lane_pt
from jepsen_tpu_torch.checkers import reach_pallas as pallas_pt
from jepsen_tpu_torch.op import info as info_pt
from jepsen_tpu_torch.op import invoke as inv_pt
from jepsen_tpu_torch.op import ok as ok_pt

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
    to its ``auto`` chain, past the per-key decomposition both packages
    try first (which reports its witness per key; compared in
    :func:`test_multi_register_fixtures_decompose`)."""
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
    model = getattr(m_pt, model_name)()
    if model_name == "multi_register":
        r_pt = fa_pt.auto_check_packed(model, h_pt.pack(h_pt.load_edn(path)),
                                       {"device": "cpu"})
    else:
        r_pt = Linearizable(model, device="cpu").check(None,
                                                       h_pt.load_edn(path))
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


def test_overflow_falls_back_to_python_oracle(monkeypatch):
    """Too many pending ops for the dense engine: the chain records the
    fallback and the C++ WGL search decides; when every later stage
    declines too, the oracle does."""
    from jepsen_tpu_torch.checkers import frontier as fr_pt
    from jepsen_tpu_torch.checkers import wgl_native as wn_pt

    h = fx_pt.gen_history("cas", n_ops=40, processes=4, seed=2)
    check = Linearizable(m_pt.cas_register(), device="cpu",
                         opts={"max_slots": 1}).check
    with obs.capture() as cap:
        res = check(None, h)
    assert res["valid"] is True and res["engine"] == "wgl-native-fallback"
    assert [r["cause"] for r in cap.fallbacks()] == ["ConcurrencyOverflow"]
    assert cap.skipped() == []

    def declines(*a, **k):
        return {"valid": "unknown", "cause": "config-set-explosion"}

    def overflows(*a, **k):
        raise fr_pt.FrontierOverflow("too many rows")

    monkeypatch.setattr(wn_pt, "check_packed", declines)
    monkeypatch.setattr(fr_pt, "check_packed", overflows)
    with obs.capture() as cap:
        res = check(None, h)
    assert res["valid"] is True and res["engine"] == "wgl-cpu-fallback"
    assert [(r["stage"], r["cause"]) for r in cap.fallbacks()] == [
        ("reach", "ConcurrencyOverflow"),
        ("wgl-native", "unknown:config-set-explosion"),
        ("frontier", "FrontierOverflow")]


def test_multi_register_records_unported_stages():
    """No stage of the multi-register chain is recorded as not ported:
    the per-key decomposition decides."""
    h = fx_pt.gen_history("multi", n_ops=30, processes=3, seed=4, keys=2)
    with obs.capture() as cap:
        res = Linearizable(m_pt.multi_register(), device="cpu").check(None,
                                                                      h)
    assert res["valid"] is True and res["engine"] == "decompose"
    assert not [r for r in cap.skipped() if r.get("cause") == "not-ported"
                and r["stage"] in STAGES]


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
    assert Linearizable(model, algorithm="frontier",
                        device="cpu").check(None, h)["valid"] is True
    with pytest.raises(NotImplementedError, match="not ported"):
        Linearizable(model, algorithm="linear",
                     device="cpu").check(None, h)


# -- the chain past the dense engine ----------------------------------------

STAGES = ("decompose", "wgl-native", "frontier", "restricted-product",
          "transactional-screen")
CHAIN_KEYS = ("valid", "engine", "op", "dead-event", "max-linearized",
              "final-configs", "previous-ok", "quotient", "product-space",
              "frontier-cap")


def _crash_heavy(ops, n_crashed, values=(1,)):
    """``n_crashed`` crashed writes (cycling through ``values``), a read
    of 0 after each, then live read/write traffic; valid."""
    invoke, ok, info = ops
    h = [invoke(0, "write", 0), ok(0, "write", 0)]
    for c in range(n_crashed):
        v = values[c % len(values)]
        h += [invoke(100 + c, "write", v), info(100 + c, "write", v),
              invoke(0, "read"), ok(0, "read", 0)]
    for i in range(20):
        v = i % 3
        h += [invoke(0, "write", v), ok(0, "write", v),
              invoke(0, "read"), ok(0, "read", v)]
    return h


def _ops(side):
    return ((inv_ref, ok_ref, info_ref), (inv_pt, ok_pt, info_pt))[side]


def _chain(model_name, h1, h2, **opts):
    """The reference's and the port's ``auto`` chain on one history, with
    the port's ledger."""
    reach_ref._MEMO_CACHE.clear()
    reach_pt._MEMO_CACHE.clear()
    a = fa_ref.Linearizable(getattr(m_ref, model_name)(),
                            opts=dict(opts)).check(None, h1)
    with obs.capture() as cap:
        b = Linearizable(getattr(m_pt, model_name)(), device="cpu",
                         opts=dict(opts)).check(None, h2)
    diff = {k: (a.get(k), b.get(k)) for k in CHAIN_KEYS
            if a.get(k) != b.get(k)}
    assert not diff, diff
    assert len(cap.selections()) == 1
    assert not [r for r in cap.skipped() if r.get("cause") == "not-ported"
                and r["stage"] in STAGES]
    return b, cap


@pytest.mark.parametrize("n_crashed", [22, 24])
def test_auto_crash_heavy_selects_wgl_native(n_crashed):
    """More pending ops than the dense engine takes: the C++ WGL search
    decides, where the oracle alone timed out."""
    h1, h2 = (h.index(_crash_heavy(_ops(i), n_crashed))
              for i, h in enumerate((h_ref, h_pt)))
    res, cap = _chain("register", h1, h2)
    assert res["valid"] is True and res["engine"] == "wgl-native-fallback"
    assert [r["stage"] for r in cap.fallbacks()] == ["reach"]


def test_auto_pile_up_selects_frontier():
    """The two-value crashed pile-up under a tight config budget: the C++
    search gives up and the frontier's quotient decides."""
    h1, h2 = (h.index(_crash_heavy(_ops(i), 24, values=(1, 2)))
              for i, h in enumerate((h_ref, h_pt)))
    res, cap = _chain("register", h1, h2, max_configs=1000, frontier0=64)
    assert res["valid"] is True and res["engine"] == "frontier-fallback"
    assert res["quotient"] == "dense-product"
    assert [r["stage"] for r in cap.fallbacks()] == ["reach", "wgl-native"]


@pytest.mark.parametrize("max_configs", [None, 1000])
def test_auto_corrupted_w33(max_configs):
    """A 2,000-op register history with crashed ops (W = 33), corrupted:
    the C++ search names the failing op; under a tight config budget the
    frontier does, at dead event 562."""
    kw = dict(n_ops=2000, processes=5, crash_p=0.02, values=3, seed=5)
    h1 = fx_ref.corrupt(fx_ref.gen_history("register", **kw), seed=1)
    h2 = fx_pt.corrupt(fx_pt.gen_history("register", **kw), seed=1)
    opts = {} if max_configs is None else {"max_configs": max_configs}
    res, _ = _chain("register", h1, h2, **opts)
    assert res["valid"] is False and res["op"]
    if max_configs is None:
        assert res["engine"] == "wgl-native-fallback"
    else:
        assert res["engine"] == "frontier-fallback"
        assert res["dead-event"] == 562


def test_multi_register_selects_decompose():
    kw = dict(n_ops=60, processes=3, keys=3, values=3, seed=4)
    a = fa_ref.Linearizable(m_ref.multi_register()).check(
        None, fx_ref.gen_history("multi", **kw))
    with obs.capture() as cap:
        b = Linearizable(m_pt.multi_register(), device="cpu").check(
            None, fx_pt.gen_history("multi", **kw))
    assert a["engine"] == b["engine"] == "decompose"
    assert (a["valid"], a["key-count"]) == (b["valid"], b["key-count"])
    assert [r["stage"] for r in cap.selections()] == ["decompose"]


@pytest.mark.parametrize("fname,want", [("multi-register-ok.edn", True),
                                        ("multi-register-bad.edn", False)])
def test_multi_register_fixtures_decompose(fname, want):
    path = os.path.join(DATA, fname)
    reach_ref._MEMO_CACHE.clear()
    a = fa_ref.Linearizable(m_ref.multi_register()).check(
        None, h_ref.load_edn(path))
    b = Linearizable(m_pt.multi_register(), device="cpu").check(
        None, h_pt.load_edn(path))
    keys = ("valid", "engine", "key-count", "failures", "key", "op")
    assert {k: a.get(k) for k in keys} == {k: b.get(k) for k in keys}
    assert b["valid"] is want and b["engine"] == "decompose"


def test_transactions_take_the_monolithic_chain():
    """A multi-key write is no per-key history: decomposition declines
    (recorded) and the dense engine decides."""
    txn = [inv_pt(0, "write", {0: 1, 1: 2}), ok_pt(0, "write", {0: 1, 1: 2}),
           inv_pt(0, "read", {0: None}), ok_pt(0, "read", {0: 1})]
    with obs.capture() as cap:
        res = Linearizable(m_pt.multi_register(), device="cpu").check(
            None, h_pt.index(txn))
    assert res["valid"] is True and res["engine"] == "reach-lane"
    assert [(r["stage"], r["cause"]) for r in cap.skipped()
            if r["stage"] == "decompose"] == [("decompose",
                                               "not-decomposable")]


@pytest.mark.parametrize("algorithm", ["frontier", "wgl-native",
                                       "decompose"])
@pytest.mark.parametrize("corrupt", [False, True])
def test_new_algorithms_match_reference(algorithm, corrupt):
    kind, model = (("multi", "multi_register") if algorithm == "decompose"
                   else ("cas", "cas_register"))
    kw = dict(n_ops=40, processes=3, crash_p=0.1, seed=6)
    h1, h2 = fx_ref.gen_history(kind, **kw), fx_pt.gen_history(kind, **kw)
    if corrupt:
        h1, h2 = fx_ref.corrupt(h1, seed=6), fx_pt.corrupt(h2, seed=6)
    reach_ref._MEMO_CACHE.clear()
    reach_pt._MEMO_CACHE.clear()
    a = fa_ref.Linearizable(getattr(m_ref, model)(), algorithm=algorithm,
                            opts={"frontier0": 64}).check(None, h1)
    b = Linearizable(getattr(m_pt, model)(), algorithm=algorithm,
                     device="cpu", opts={"frontier0": 64}).check(None, h2)
    keys = ("valid", "engine", "key-count", "failures") \
        if algorithm == "decompose" else CHAIN_KEYS + ("configs-explored",)
    assert {k: a.get(k) for k in keys} == {k: b.get(k) for k in keys}
    assert b["valid"] is (not corrupt)


def test_decompose_algorithm_declines_transactions():
    txn = h_pt.index([inv_pt(0, "write", {0: 1, 1: 2}),
                      ok_pt(0, "write", {0: 1, 1: 2})])
    res = Linearizable(m_pt.multi_register(), algorithm="decompose",
                       device="cpu").check(None, txn)
    assert res == {"valid": "unknown", "cause": "not-decomposable",
                   "engine": "decompose"}


def test_chain_time_limit_gives_timeout():
    h = fx_pt.gen_history("cas", n_ops=40, processes=4, seed=2)
    with obs.capture() as cap:
        res = Linearizable(m_pt.cas_register(), device="cpu",
                           opts={"max_slots": 1,
                                 "time_limit": 1e-9}).check(None, h)
    assert res == {"valid": "unknown", "cause": "timeout",
                   "engine": "auto-chain"}
    assert [r["stage"] for r in cap.ledger
            if r["event"] == "timeout"] == ["auto-chain"]


def test_frontier_fault_is_never_hidden(monkeypatch):
    """Only a capacity decline of the frontier stage moves the chain on;
    a fault propagates."""
    from jepsen_tpu_torch.checkers import frontier as fr_pt

    def fail(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(fr_pt, "check_packed", fail)
    h = h_pt.index(_crash_heavy(_ops(1), 24, values=(1, 2)))
    with pytest.raises(RuntimeError, match="device fault"):
        Linearizable(m_pt.register(), device="cpu",
                     opts={"max_configs": 1000}).check(None, h)


def _tx(side, n=120, values=30, bad=False):
    """Two-key transactional reads and single-key writes."""
    import random

    invoke, ok, _info = _ops(side)
    rng = random.Random(3)
    h, state = [], {"x": 0, "y": 0}
    for i in range(n):
        p = i % 3
        if rng.random() < 0.7:
            k = rng.choice(["x", "y"])
            v = rng.randrange(values)
            h += [invoke(p, "write", {k: v}), ok(p, "write", {k: v})]
            state[k] = v
        else:
            vals = dict(state)
            h += [invoke(p, "read", {k: None for k in vals}),
                  ok(p, "read", vals)]
    if bad:
        h += [invoke(0, "read", {"x": None, "y": None}),
              ok(0, "read", {"x": 9999, "y": 9999})]
    return (h_ref, h_pt)[side].index(h)


@pytest.mark.parametrize("max_states,bad,engine,valid", [
    (300, False, "decompose-product", True),
    (300, True, "decompose-product", False),
    (40, False, "decompose-projection", "unknown"),
    (40, True, "decompose-projection", False)])
def test_transactional_chain_matches_reference(max_states, bad, engine,
                                               valid):
    """A multi-key history past the memo budget: every memoized stage
    explodes, the restricted product decides exactly, and past its own
    budget the projection screen gives a sound False or an explicit
    unknown."""
    opts = {"max_states": max_states, "time_limit": 30}
    reach_ref._MEMO_CACHE.clear()
    a = fa_ref.Linearizable(m_ref.multi_register({"x": 0, "y": 0}),
                            opts=dict(opts)).check(None, _tx(0, bad=bad))
    with obs.capture() as cap:
        b = Linearizable(m_pt.multi_register({"x": 0, "y": 0}),
                         device="cpu", opts=dict(opts)).check(
            None, _tx(1, bad=bad))
    keys = ("valid", "engine", "op", "dead-event", "cause", "failures")
    assert {k: a.get(k) for k in keys} == {k: b.get(k) for k in keys}
    assert b["valid"] == valid and b["engine"] == engine
    assert len(cap.selections()) == 1
    assert [r["stage"] for r in cap.fallbacks()][:3] == \
        ["reach", "wgl-native", "frontier"]

"""The port's per-key decomposition (``checkers/decompose.py``) against the
reference's, on the CPU.

``split`` and ``split_projections`` give the same per-key entries;
``check`` on single-key multi-register histories (valid, corrupted, with
crashed writes, with initial values, and 8 keys x 5 values, beyond the
monolithic memo) gives the same merged verdict, failing key, failing op
and per-key verdict; ``check_transactional`` and
``check_restricted_product`` give the same verdicts on multi-key
transactional histories, valid and invalid. The port runs each key's
register check through its own ``reach.check_many`` (the lockstep lane
on K2's plain version here); only a capacity decline of that batch sends
the keys one by one through the ``auto`` chain, any other error
propagates.
"""
import random

import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import decompose as dc_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.op import Op as Op_ref
from jepsen_tpu.op import info as info_ref
from jepsen_tpu.op import invoke as inv_ref
from jepsen_tpu.op import ok as ok_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import decompose as dc_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers.events import ConcurrencyOverflow
from jepsen_tpu_torch.op import Op as Op_pt
from jepsen_tpu_torch.op import info as info_pt
from jepsen_tpu_torch.op import invoke as inv_pt
from jepsen_tpu_torch.op import ok as ok_pt

torch.set_num_threads(1)

REF = (h_ref, m_ref, (inv_ref, ok_ref, info_ref), Op_ref)
PT = (h_pt, m_pt, (inv_pt, ok_pt, info_pt), Op_pt)
MERGED = ("valid", "key-count", "failures", "key", "op")
PER_KEY = ("valid", "op", "dead-event", "max-linearized", "previous-ok")


@pytest.fixture(autouse=True)
def _cold_memos(monkeypatch):
    for r in (reach_ref, reach_pt):      # no seeds, none left over
        monkeypatch.setattr(r, "_seed_union_memo", lambda *a: None)
        r._SUPERSET_SEEDS.clear()
    reach_ref._MEMO_CACHE.clear()
    reach_pt._MEMO_CACHE.clear()


def _same(a, b, keys=MERGED):
    diff = {k: (a.get(k), b.get(k)) for k in keys if a.get(k) != b.get(k)}
    assert not diff, diff
    if "key-result" in a or "key-result" in b:
        _same(a["key-result"], b["key-result"], PER_KEY)


def _entries(groups):
    return {k: [(e.eid, e.inv_ev, e.ret_ev, e.crashed, e.op.to_dict())
                for e in es] for k, es in groups.items()}


def test_split_and_projections_match_reference():
    def hist(side):
        h_mod, _m, (invoke, ok, info), _op = side
        return h_mod.index([
            invoke(0, "write", {0: 1}), ok(0, "write", {0: 1}),
            invoke(1, "write", [[1, 2]]), info(1, "write", [[1, 2]]),
            invoke(0, "read", {1: None}), ok(0, "read", {1: 2})])

    def txn(side):
        h_mod, _m, (invoke, ok, _info), _op = side
        return h_mod.index([invoke(0, "write", {0: 1, 1: 2}),
                            ok(0, "write", {0: 1, 1: 2}),
                            invoke(0, "read", {0: None}),
                            ok(0, "read", {0: 1})])

    a, b = dc_ref.split(hist(REF)), dc_pt.split(hist(PT))
    assert set(b) == {0, 1} and _entries(a) == _entries(b)
    assert dc_ref.split(txn(REF)) is None and dc_pt.split(txn(PT)) is None
    a, b = dc_ref.split_projections(txn(REF)), dc_pt.split_projections(
        txn(PT))
    assert set(b) == {0, 1} and _entries(a) == _entries(b)
    cas = [inv_pt(0, "cas", {0: (1, 2)}), ok_pt(0, "cas", {0: (1, 2)})]
    assert dc_pt.split(h_pt.index(cas)) is None
    assert dc_pt.split_projections(h_pt.index(cas)) is None


def _multi(fx, corrupt, **kw):
    h = fx.gen_history("multi", **kw)
    return fx.corrupt(h, seed=kw["seed"]) if corrupt else h


MULTI = [(dict(n_ops=40, processes=4, values=3, keys=3, crash_p=0.1,
               seed=s), c) for s in range(3) for c in (False, True)]


@pytest.mark.parametrize("kw,corrupt", MULTI)
def test_check_matches_reference(kw, corrupt):
    a = dc_ref.check(m_ref.multi_register(), _multi(fx_ref, corrupt, **kw))
    b = dc_pt.check(m_pt.multi_register(), _multi(fx_pt, corrupt, **kw),
                    device="cpu")
    _same(a, b)
    assert b["engine"] == "decompose"
    if corrupt:
        assert b["valid"] is False and b["failures"]


def _hand(side, which):
    h_mod, _m, (invoke, ok, info), _op = side
    if which == "stale":
        h = [invoke(0, "write", {0: 1}), ok(0, "write", {0: 1}),
             invoke(0, "write", {1: 5}), ok(0, "write", {1: 5}),
             invoke(0, "read", {1: None}), ok(0, "read", {1: 7})]
    elif which == "crashed":
        h = [invoke(0, "write", {0: 1}), ok(0, "write", {0: 1}),
             invoke(1, "write", {0: 2}), info(1, "write", {0: 2}),
             invoke(0, "read", {0: None}), ok(0, "read", {0: 2})]
    else:
        h = [invoke(0, "read", {"a": None}), ok(0, "read", {"a": 10}),
             invoke(0, "read", {"b": None}),
             ok(0, "read", {"b": 20 if which == "init-ok" else 10})]
    return h_mod.index(h)


@pytest.mark.parametrize("which,want", [
    ("stale", False), ("crashed", True), ("init-ok", True),
    ("init-bad", False)])
def test_hand_written_match_reference(which, want):
    init = {"a": 10, "b": 20} if which.startswith("init") else None
    a = dc_ref.check(m_ref.multi_register(init), _hand(REF, which))
    b = dc_pt.check(m_pt.multi_register(init), _hand(PT, which),
                    device="cpu")
    _same(a, b)
    assert b["valid"] is want


def test_eight_keys_beyond_the_monolithic_memo():
    """8 keys x 5 values: 5^8 product states, past the memo budget of
    the monolithic engines; the decomposition stays small."""
    kw = dict(n_ops=400, processes=5, values=5, keys=8, seed=3)
    for corrupt in (False, True):
        a = dc_ref.check(m_ref.multi_register(),
                         _multi(fx_ref, corrupt, **kw))
        with obs.capture() as cap:
            b = dc_pt.check(m_pt.multi_register(),
                            _multi(fx_pt, corrupt, **kw), device="cpu")
        _same(a, b)
        assert b["key-count"] == 8 and b["valid"] is (not corrupt)
        assert [r["cause"] for r in cap.ledger
                if r["stage"] == "reach-many"] == ["lockstep"]


def _tx_history(side, n=60, values=6, bad=False):
    _h, _m, (invoke, ok, _info), _op = side
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
    return h


@pytest.mark.parametrize("bad", [False, True], ids=["valid", "invalid"])
def test_transactional_screen_matches_reference(bad):
    a = dc_ref.check_transactional(
        m_ref.multi_register({"x": 0, "y": 0}),
        h_ref.pack(h_ref.index(_tx_history(REF, bad=bad))))
    b = dc_pt.check_transactional(
        m_pt.multi_register({"x": 0, "y": 0}),
        h_pt.pack(h_pt.index(_tx_history(PT, bad=bad))), device="cpu")
    _same(a, b, MERGED + ("cause", "engine"))
    assert b["valid"] is False if bad else b["valid"] == "unknown"


@pytest.mark.parametrize("bad", [False, True], ids=["valid", "invalid"])
def test_restricted_product_matches_reference(bad):
    """Values**keys = 900 product states past a 300-state budget: the
    restricted product decides exactly."""
    a = dc_ref.check_restricted_product(
        m_ref.multi_register({"x": 0, "y": 0}),
        h_ref.pack(h_ref.index(_tx_history(REF, n=120, values=30,
                                           bad=bad))), max_states=300)
    b = dc_pt.check_restricted_product(
        m_pt.multi_register({"x": 0, "y": 0}),
        h_pt.pack(h_pt.index(_tx_history(PT, n=120, values=30, bad=bad))),
        max_states=300, device="cpu")
    _same(a, b, ("valid", "op", "dead-event", "max-linearized",
                 "final-configs", "previous-ok", "engine",
                 "product-states", "key-count"))
    assert b["valid"] is (not bad) and b["product-states"] < 300


def test_restricted_product_honours_abort():
    h = []
    for i in range(40):
        h += [inv_pt(i % 3, "write", {"x": i}), ok_pt(i % 3, "write",
                                                     {"x": i})]
    res = dc_pt.check_restricted_product(
        m_pt.multi_register({"x": 0}), h_pt.pack(h_pt.index(h)),
        should_abort=lambda: True, device="cpu")
    assert res["valid"] == "unknown" and res["cause"] == "aborted"


def test_check_many_fault_propagates(monkeypatch):
    """A fault of the batch propagates; a capacity decline sends the keys
    one by one through the auto chain, recorded in the ledger."""
    def fail(*a, **k):
        raise RuntimeError("lane fault")

    monkeypatch.setattr(reach_pt, "check_many", fail)
    h = fx_pt.gen_history("multi", n_ops=30, processes=3, keys=2, seed=1)
    with pytest.raises(RuntimeError, match="lane fault"):
        dc_pt.check(m_pt.multi_register(), h, device="cpu")

    def decline(*a, **k):
        raise ConcurrencyOverflow("too many slots")

    monkeypatch.setattr(reach_pt, "check_many", decline)
    with obs.capture() as cap:
        res = dc_pt.check(m_pt.multi_register(), h, device="cpu")
    assert res["valid"] is True and res["key-count"] == 2
    assert [(r["stage"], r["cause"]) for r in cap.fallbacks()] == \
        [("reach-many", "ConcurrencyOverflow")]
    assert [r["stage"] for r in cap.selections()] == ["reach-lane"] * 2

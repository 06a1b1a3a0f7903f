"""The port's sparse frontier engine (``checkers/frontier.py``) against the
reference's, on the CPU.

The dedup step is held against ``numpy.unique`` and against the
reference's own ``_sort_unique_compact`` on random rows (one mask word,
in both of the reference's sort orders, and two words at W = 40), the
crashed-slot scan against its per-event plain version and the
reference's, and ``check_packed`` against the reference on crash-heavy
histories, the two-value pile-up, and small generated histories with
crashed ops and their corrupted twins: through the dense-product
quotient, the sparse-live quotient and the sparse rows
(``quotient=False``; the reference's rows are reached by switching its
quotient off). Verdict, failing op, dead event, witness, ``quotient``,
``product-space`` and ``frontier-cap`` must be equal exactly.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import events as ev_ref
from jepsen_tpu.checkers import frontier as fr_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.op import info as info_ref
from jepsen_tpu.op import invoke as inv_ref
from jepsen_tpu.op import ok as ok_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import events as ev_pt
from jepsen_tpu_torch.checkers import frontier as fr_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_q as rq_pt
from jepsen_tpu_torch.op import info as info_pt
from jepsen_tpu_torch.op import invoke as inv_pt
from jepsen_tpu_torch.op import ok as ok_pt

torch.set_num_threads(1)

KEYS = ("valid", "op", "previous-ok", "dead-event", "max-linearized",
        "cause", "final-configs", "quotient", "product-space",
        "frontier-cap", "events", "slots", "states")
REF_OPS = (inv_ref, ok_ref, info_ref)
PT_OPS = (inv_pt, ok_pt, info_pt)
SENT = 0xFFFFFFFF


@pytest.fixture(autouse=True)
def _cold_memos(monkeypatch):
    """Both packages build every memo cold, so both number the states
    the same way."""
    monkeypatch.setattr(reach_ref, "_seed_union_memo", lambda *a: None)
    reach_ref._MEMO_CACHE.clear()
    reach_pt._MEMO_CACHE.clear()


def crash_heavy(ops, n_crashed=24, n_live=20, value=1):
    """``n_crashed`` processes invoke write(value) and never return, a
    successful read(0) after each; then live read/write traffic. Valid;
    the crashed writes share one op id."""
    invoke, ok, info = ops
    h = [invoke(0, "write", 0), ok(0, "write", 0)]
    for c in range(n_crashed):
        h += [invoke(100 + c, "write", value), info(100 + c, "write", value),
              invoke(0, "read"), ok(0, "read", 0)]
    for i in range(n_live):
        v = i % 3
        h += [invoke(0, "write", v), ok(0, "write", v),
              invoke(0, "read"), ok(0, "read", v)]
    return h


def pile_up(ops):
    """Two-value crashed pile-up: 24 crashed writes of 1 or 2, a read of
    0 after each, then live traffic."""
    invoke, ok, info = ops
    h = [invoke(0, "write", 0), ok(0, "write", 0)]
    for c in range(24):
        v = 1 + (c % 2)
        h += [invoke(100 + c, "write", v), info(100 + c, "write", v),
              invoke(0, "read"), ok(0, "read", 0)]
    for i in range(20):
        v = i % 3
        h += [invoke(0, "write", v), ok(0, "write", v),
              invoke(0, "read"), ok(0, "read", v)]
    return h


def distinct_crashed_cas(ops):
    """Ten crashed cas ops of distinct values: the quotient cannot
    collapse them."""
    invoke, ok, info = ops
    h = [invoke(0, "write", 0), ok(0, "write", 0)]
    for c in range(10):
        v = (c % 5, (c + 1) % 5)
        h += [invoke(100 + c, "cas", v), info(100 + c, "cas", v)]
    for i in range(6):
        h += [invoke(0, "write", i % 5), ok(0, "write", i % 5)]
    return h


def _hist(side, spec):
    """The same history for the reference (``side`` 0) or the port."""
    kind, arg = spec
    if kind == "fn":
        return (h_ref, h_pt)[side].index(arg((REF_OPS, PT_OPS)[side]))
    fx = (fx_ref, fx_pt)[side]
    gen_kind, kw, corrupt = arg
    h = fx.gen_history(gen_kind, **kw)
    return fx.corrupt(h, seed=kw["seed"]) if corrupt else h


def _pair(spec, model, quotient, monkeypatch, **kw):
    monkeypatch.setattr(fr_ref, "_use_quotient", lambda: quotient)
    a = fr_ref.check(getattr(m_ref, model)(), _hist(0, spec), **kw)
    with obs.capture() as cap:
        b = fr_pt.check(getattr(m_pt, model)(), _hist(1, spec),
                        quotient=quotient, device="cpu", **kw)
    diff = {k: (a.get(k), b.get(k)) for k in KEYS if a.get(k) != b.get(k)}
    assert not diff, diff
    return b, cap


def _gen(kind, seed, crash_p, corrupt):
    return ("gen", (kind, dict(n_ops=30, processes=3, values=3,
                               crash_p=crash_p, seed=seed), corrupt))


GENERATED = [("register", 0, 0.0, False), ("register", 1, 0.1, True),
             ("register", 1, 0.2, False), ("register", 0, 0.2, True),
             ("cas", 0, 0.1, False), ("cas", 1, 0.1, True),
             ("cas", 0, 0.2, True)]


def _sort_case(K, pack, seed, F):
    """Random rows with duplicates and empty rows: the same rows as
    ``uint32`` (the reference's) and ``int64`` (the port's)."""
    rng = np.random.default_rng(seed)
    n = 300
    words = rng.integers(0, 8, size=(n // 3, K)).astype(np.int64)
    if not pack:
        words[0] = SENT                 # a mask word of all ones is real
        words[:, -1] |= rng.integers(0, 2, size=n // 3) << 31
    states = rng.integers(0, 5, size=(n // 3, 1))
    rows = np.concatenate([words, states], axis=1)
    U = rows[rng.integers(0, len(rows), size=n)]
    U[rng.random(n) < 0.2] = SENT
    return U


@pytest.mark.parametrize("K,pack", [(1, 0), (1, 8), (2, 0)],
                         ids=["K1-word-major", "K1-packed", "K2-W40"])
@pytest.mark.parametrize("F", [512, 16])
def test_sort_unique_compact(K, pack, F):
    import jax.numpy as jnp

    U = _sort_case(K, pack, seed=K + pack + F, F=F)
    C, count = fr_pt._sort_unique_compact(torch.as_tensor(U), F, pack)
    C, count = C.numpy(), int(count)
    live = U[U[:, K] != SENT]
    want = np.unique(live, axis=0)             # words, then the state
    if pack:                                   # the state, then the word
        want = want[np.lexsort((want[:, 0], want[:, 1]))]
    assert count == len(want)
    n = min(count, F)
    assert np.array_equal(C[:n], want[:n])
    assert (C[n:] == SENT).all()
    Cr, count_r = fr_ref._sort_unique_compact(
        jnp.asarray(U.astype(np.uint32)), F, pack)
    assert int(count_r) == count
    assert np.array_equal(np.asarray(Cr).astype(np.int64), C)


def test_crashed_slots_match_plain_and_reference():
    for seed in range(4):
        kw = dict(n_ops=50, processes=4, values=3, crash_p=0.25, seed=seed)
        outs = []
        for h_mod, fx, mods, ev, fr in (
                (h_ref, fx_ref, (m_ref, reach_ref), ev_ref, fr_ref),
                (h_pt, fx_pt, (m_pt, reach_pt), ev_pt, fr_pt)):
            packed = h_mod.pack(fx.gen_history("cas", **kw))
            memo = mods[1]._cached_memo(mods[0].cas_register(), packed,
                                        100_000)
            stream = ev.build(packed, memo, max_slots=128)
            W = max(stream.W, 1)
            got = fr._crashed_slots(stream, packed, W)
            assert np.array_equal(got, fr._crashed_slots_ref(stream, packed,
                                                             W))
            outs.append(got)
        assert np.array_equal(*outs), seed


@pytest.mark.parametrize("quotient", [True, False],
                         ids=["quotient", "rows"])
@pytest.mark.parametrize("spec", [("fn", crash_heavy), ("fn", pile_up)],
                         ids=["crash-heavy-24", "pile-up"])
def test_crash_heavy_shapes(spec, quotient, monkeypatch):
    res, cap = _pair(spec, "register", quotient, monkeypatch, frontier0=64)
    assert res["valid"] is True and res["slots"] >= 24
    if quotient:
        assert res["quotient"] == "dense-product"
    else:
        assert cap.counters["frontier.returns"] >= 1
        assert cap.counters["frontier.syncs"] >= \
            cap.counters["frontier.returns"]


@pytest.mark.parametrize("quotient", [True, False],
                         ids=["quotient", "rows"])
@pytest.mark.parametrize("kind,seed,crash_p,corrupt", GENERATED)
def test_generated_match_reference(kind, seed, crash_p, corrupt, quotient,
                                   monkeypatch):
    model = "register" if kind == "register" else "cas_register"
    res, _ = _pair(_gen(kind, seed, crash_p, corrupt), model, quotient,
                   monkeypatch, frontier0=64)
    assert res["valid"] is (not corrupt)
    if corrupt:
        assert res["final-configs"]


def test_two_word_rows_match_reference(monkeypatch):
    """More than 32 pending slots: rows of two mask words."""
    spec = ("fn", lambda o: crash_heavy(o, n_crashed=36, n_live=6))
    res, _ = _pair(spec, "register", False, monkeypatch, frontier0=64)
    assert res["valid"] is True and res["slots"] > 32


def test_sparse_live_quotient_matches_reference(monkeypatch):
    """A history past the dense product's live-slot cap: the quotient
    takes its sparse-live walk."""
    def burst(ops):
        invoke, ok, info = ops
        h = [invoke(0, "write", 0), ok(0, "write", 0),
             invoke(9, "write", 3), info(9, "write", 3)]
        for p in range(18):
            h.append(invoke(100 + p, "write", 1))
        for p in range(18):
            h.append(ok(100 + p, "write", 1))
        return h + [invoke(0, "read"), ok(0, "read", 3)]

    with obs.capture() as cap:
        res, _ = _pair(("fn", burst), "register", True, monkeypatch,
                       frontier0=64)
    assert res["quotient"] == "dense-product" and res["valid"] is True
    walks = [s["args"]["walk"] for s in cap.spans
             if s["name"] == "reach_q.walk"]
    assert walks == ["sparse-live"]


def test_escalation_from_64(monkeypatch):
    res, cap = _pair(_gen("cas", 1, 0.2, False), "cas_register", False,
                     monkeypatch, frontier0=64)
    assert res["frontier-cap"] == 1024
    assert cap.counters["frontier.escalations"] == 2


def test_frontier_overflow_past_max_frontier(monkeypatch):
    monkeypatch.setattr(fr_ref, "_use_quotient", lambda: False)
    with pytest.raises(fr_ref.FrontierOverflow):
        fr_ref.check(m_ref.cas_register(),
                     _hist(0, ("fn", distinct_crashed_cas)), frontier0=64,
                     max_frontier=64)
    with pytest.raises(fr_pt.FrontierOverflow):
        fr_pt.check(m_pt.cas_register(),
                    _hist(1, ("fn", distinct_crashed_cas)), frontier0=64,
                    max_frontier=64, quotient=False, device="cpu")


@pytest.mark.parametrize("quotient", [True, False],
                         ids=["quotient", "rows"])
def test_abort_gives_unknown(quotient, monkeypatch):
    spec = _gen("cas", 0, 0.1, False)
    res, _ = _pair(spec, "cas_register", quotient, monkeypatch,
                   frontier0=64, should_abort=lambda: True)
    assert res["valid"] == "unknown" and res["cause"] == "aborted"


def test_one_device_only():
    h = fx_pt.gen_history("cas", n_ops=20, processes=3, seed=0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 13"):
        fr_pt.check(m_pt.cas_register(), h, device=["cpu", "cpu"])
    assert fr_pt.check(m_pt.cas_register(), h,
                       device=["cpu"])["valid"] is True


def test_quotient_fault_propagates(monkeypatch):
    """Only the quotient's capacity decline moves on to the rows; any
    other error of the quotient walk propagates."""
    def fail(*a, **k):
        raise RuntimeError("quotient walk failed")

    monkeypatch.setattr(rq_pt, "check_quotient", fail)
    h = _hist(1, ("fn", crash_heavy))
    with pytest.raises(RuntimeError, match="quotient walk failed"):
        fr_pt.check(m_pt.register(), h, device="cpu")

    def decline(*a, **k):
        raise rq_pt.QuotientOverflow("too big")

    monkeypatch.setattr(rq_pt, "check_quotient", decline)
    with obs.capture() as cap:
        res = fr_pt.check(m_pt.register(), h, frontier0=64, device="cpu")
    assert res["valid"] is True and res["frontier-cap"] == 256
    assert [(r["stage"], r["cause"]) for r in cap.ledger] == \
        [("frontier-quotient", "quotient-overflow")]


@pytest.mark.parametrize("error", [RuntimeError, ValueError])
def test_witness_failure_is_never_hidden(monkeypatch, error):
    def fail(*a, **k):
        raise error("witness failed")

    monkeypatch.setattr(fr_pt, "_final_configs", fail)
    bad = _hist(1, _gen("cas", 1, 0.1, True))
    check = lambda: fr_pt.check(m_pt.cas_register(), bad,  # noqa: E731
                                quotient=False, frontier0=64, device="cpu")
    if error is RuntimeError:
        with pytest.raises(RuntimeError, match="witness failed"):
            check()
        return
    with obs.capture() as cap:
        res = check()
    assert res["valid"] is False and "final-configs" not in res
    assert [(r["stage"], r["cause"]) for r in cap.fallbacks()] == \
        [("frontier.witness", "ValueError")]

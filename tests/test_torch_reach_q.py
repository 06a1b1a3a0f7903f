"""The port's crashed-op quotient walks (``checkers/reach_q.py``) against
the reference's, on the CPU.

The histories are the reference's own test shapes (their generators are
copied below): more than 8 crashed groups on the dense product walk, a
burst of distinct concurrent writes on the sparse-live walk, and bursts
of same-value writes, whose live epochs the sparse-live walk's rank
canonicalization collapses at its first capacity rung. Both packages
run ``check_quotient`` on the same memo and event stream; the verdict,
failing op, dead event, witness and the walk's geometry must be equal
exactly. Past every budget both raise ``QuotientOverflow``.
"""
import random

import numpy as np
import pytest
import torch

from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import events as ev_ref
from jepsen_tpu.checkers import reach_q as rq_ref
from jepsen_tpu.models.memo import memo_ops as memo_ref
from jepsen_tpu.op import info as info_ref
from jepsen_tpu.op import invoke as inv_ref
from jepsen_tpu.op import ok as ok_ref
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import events as ev_pt
from jepsen_tpu_torch.checkers import reach_q as rq_pt
from jepsen_tpu_torch.models.memo import memo_ops as memo_pt
from jepsen_tpu_torch.op import info as info_pt
from jepsen_tpu_torch.op import invoke as inv_pt
from jepsen_tpu_torch.op import ok as ok_pt

torch.set_num_threads(1)

KEYS = ("valid", "op", "previous-ok", "dead-event", "max-linearized",
        "final-configs", "product-space", "live-slots", "crash-groups",
        "walk")
REF_OPS = (inv_ref, ok_ref, info_ref)
PT_OPS = (inv_pt, ok_pt, info_pt)


def _many_groups_history(ops, seed, G=11, corrupt=False):
    """More than 8 singleton crashed groups (the dense walk admits 16)."""
    invoke, ok, _info = ops
    rng = random.Random(seed)
    h, state = [], 0
    for g in range(G):
        h.append(invoke(500 + g, "write", 20 + g))
    for i in range(80):
        p = i % 4
        if rng.random() < 0.5:
            v = rng.randrange(4)
            h += [invoke(p, "write", v), ok(p, "write", v)]
            state = v
        else:
            h += [invoke(p, "read"), ok(p, "read", state)]
    h += [invoke(0, "read"), ok(0, "read", 7777 if corrupt else state)]
    return h


def _burst_history(ops, seed, peak=13, corrupt=False):
    """A burst of ``peak`` concurrent distinct-value writes."""
    invoke, ok, _info = ops
    rng = random.Random(seed)
    h, state = [], 0
    for g in range(3):
        h.append(invoke(600 + g, "write", 40 + g))
    for i in range(40):
        p = i % 3
        v = rng.randrange(3)
        h += [invoke(p, "write", v), ok(p, "write", v)]
        state = v
    for p in range(peak):
        h.append(invoke(1000 + p, "write", 10 + p))
    for p in range(peak):
        h.append(ok(1000 + p, "write", 10 + p))
    h += [invoke(0, "read"),
          ok(0, "read", 7777 if corrupt else 10 + peak - 1)]
    return h


def _same_op_burst(ops, peak=24, rounds=1, corrupt=False, crash_k=0,
                   seed=9):
    """``peak`` concurrent same-value live writes a round (one
    invocation window), optional crashed writes on top."""
    invoke, ok, info = ops
    rng = random.Random(seed)
    h = []
    for k in range(crash_k):
        h.append(invoke(2000 + k, "write", 7))
        h.append(info(2000 + k, "write", 7))
    for r in range(rounds):
        procs = [3000 + 100 * r + p for p in range(peak)]
        for p in procs:
            h.append(invoke(p, "write", 5))
        rng.shuffle(procs)
        for p in procs:
            h.append(ok(p, "write", 5))
        h += [invoke(0, "read"), ok(0, "read", 5)]
    h += [invoke(1, "read"),
          ok(1, "read", 9999 if corrupt else 5)]
    return h


def _sustained(ops):
    """20 distinct concurrent writes: ~2^20 reachable masks, past every
    capacity rung."""
    invoke, ok, _info = ops
    h = [invoke(1000 + p, "write", 10 + p) for p in range(20)]
    h += [ok(1000 + p, "write", 10 + p) for p in range(20)]
    return h + [invoke(0, "read"), ok(0, "read", 29)]


def _ref(make, **kw):
    packed = h_ref.pack(h_ref.index(make(REF_OPS)))
    memo = memo_ref(m_ref.register(0), tuple(packed.distinct_ops),
                    max_states=100_000)
    stream = ev_ref.build(packed, memo, max_slots=128)
    return rq_ref.check_quotient(memo, stream, packed, **kw)


def _pt(make, **kw):
    packed = h_pt.pack(h_pt.index(make(PT_OPS)))
    memo = memo_pt(m_pt.register(0), tuple(packed.distinct_ops),
                   max_states=100_000)
    stream = ev_pt.build(packed, memo, max_slots=128)
    return rq_pt.check_quotient(memo, stream, packed, device="cpu", **kw)


def _same(make, **kw):
    a, b = _ref(make, **kw), _pt(make, **kw)
    diff = {k: (a.get(k), b.get(k)) for k in KEYS if a.get(k) != b.get(k)}
    assert not diff, diff
    return b


@pytest.mark.parametrize("corrupt", [False, True])
def test_dense_walk_more_than_8_groups(corrupt):
    res = _same(lambda o: _many_groups_history(o, 1, corrupt=corrupt))
    assert res["walk"] == "dense" and res["crash-groups"] > 8
    assert res["valid"] is (not corrupt)
    if corrupt:
        assert res["final-configs"] and res["previous-ok"]


@pytest.mark.parametrize("corrupt", [False, True])
def test_sparse_live_walk_burst(corrupt):
    """A burst of 11 distinct concurrent writes under a small dense
    budget takes the sparse-live walk (13 in the reference's own test;
    11 keeps the reference's run short here)."""
    with obs.capture() as cap:
        res = _same(lambda o: _burst_history(o, 2, peak=11,
                                             corrupt=corrupt),
                    max_dense=1 << 18)
    assert res["walk"] == "sparse-live"
    assert res["valid"] is (not corrupt)
    c = cap.counters
    assert c["reach_q.returns"] >= 1
    assert c["reach_q.syncs"] >= c["reach_q.returns"]


@pytest.mark.parametrize("corrupt", [False, True])
def test_epoch_canon_same_op_burst(corrupt):
    """A 24-wide same-value live burst: 2^24 raw masks, 25 canonical
    rows, at the first capacity rung."""
    with obs.capture() as cap:
        res = _same(lambda o: _same_op_burst(o, peak=24, corrupt=corrupt),
                    max_dense=1 << 10)
    assert res["walk"] == "sparse-live" and res["live-slots"] >= 24
    assert res["valid"] is (not corrupt)
    assert "reach_q.sparse-live.escalations" not in cap.counters
    if corrupt:
        assert res["op"]["value"] == 9999


@pytest.mark.parametrize("corrupt", [False, True])
def test_epoch_canon_sustained_with_crashes(corrupt):
    """Three 26-wide same-value bursts with 6 crashed writes on top:
    counts and epochs compose, at the first capacity rung."""
    with obs.capture() as cap:
        res = _same(lambda o: _same_op_burst(o, peak=26, rounds=3,
                                             crash_k=6, corrupt=corrupt),
                    max_dense=1 << 10)
    assert res["walk"] == "sparse-live" and res["valid"] is (not corrupt)
    assert res["crash-groups"] >= 1
    assert "reach_q.sparse-live.escalations" not in cap.counters


def test_overflow_past_every_rung():
    with pytest.raises(rq_ref.QuotientOverflow):
        _ref(_sustained, max_dense=1 << 10)
    with obs.capture() as cap:
        with pytest.raises(rq_pt.QuotientOverflow):
            _pt(_sustained, max_dense=1 << 10)
    assert cap.counters["reach_q.sparse-live.escalations"] == \
        len(rq_pt._SQ_CAPS)


def test_overflow_past_max_groups():
    def many(ops):
        invoke, ok, info = ops
        h = [invoke(0, "write", 0), ok(0, "write", 0)]
        for i in range(rq_pt._MAX_GROUPS + 2):
            h += [invoke(50 + i, "write", i + 1),
                  info(50 + i, "write", i + 1)]
        return h

    with pytest.raises(rq_ref.QuotientOverflow):
        _ref(many)
    with pytest.raises(rq_pt.QuotientOverflow, match="crashed groups"):
        _pt(many)


def test_prep_and_epochs_match_reference():
    """The host tables the walks run on, array for array."""
    make = lambda o: _same_op_burst(o, peak=6, rounds=2, crash_k=3)  # noqa
    outs = []
    for h_mod, m_mod, memo_f, ev_mod, rq, ops in (
            (h_ref, m_ref, memo_ref, ev_ref, rq_ref, REF_OPS),
            (h_pt, m_pt, memo_pt, ev_pt, rq_pt, PT_OPS)):
        packed = h_mod.pack(h_mod.index(make(ops)))
        memo = memo_f(m_mod.register(0), tuple(packed.distinct_ops),
                      max_states=100_000)
        stream = ev_mod.build(packed, memo, max_slots=128)
        prep = rq._prep_quotient(memo, stream, packed, max_live=31)
        outs.append(list(prep[:-1]) + list(prep[-1]()))
    for a, b in zip(*outs):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert a == b


def test_aborted_between_segments():
    with pytest.raises(rq_pt.Aborted):
        _pt(lambda o: _many_groups_history(o, 1), should_abort=lambda: True)


def test_witness_failure_is_never_hidden(monkeypatch):
    """A device fault in the witness decode propagates; any other
    failure drops the witness with a ledger record."""
    make = lambda o: _many_groups_history(o, 1, corrupt=True)  # noqa

    def fail(*a, **k):
        raise RuntimeError("decode failed")

    monkeypatch.setattr(rq_pt, "_decode", fail)
    with pytest.raises(RuntimeError, match="decode failed"):
        _pt(make)

    def bad(*a, **k):
        raise ValueError("decode failed")

    monkeypatch.setattr(rq_pt, "_decode", bad)
    with obs.capture() as cap:
        res = _pt(make)
    assert res["valid"] is False and "final-configs" not in res
    assert [(r["stage"], r["cause"]) for r in cap.fallbacks()] == \
        [("reach_q.witness", "ValueError")]

"""The lockstep lanes of ``check_many`` and ``check_batch`` (K2, with K1
refining a dead lane and re-walking a failed key's witness) and the
native keyed lane, against the reference, on the CPU.

K2 and K1 run their plain PyTorch versions on CPU tensors (the keys are
small so that ``batch_walk_plain`` stays quick). The reference's union
prep (``_union_stage_a``, ``_union_pack_group``) is compared array for
array; its ``check_many`` and ``check_batch`` (on the CPU: the vmapped
batch, and each history's own check) give the verdict fields; its
``_union_results_parts`` on the port's dead vector gives every field of
a union lane's result. Every comparison is exact.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.checkers import reach_batch as rb_ref
from jepsen_tpu.op import info as info_ref
from jepsen_tpu.op import invoke as inv_ref
from jepsen_tpu.op import ok as ok_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_batch as rb_pt
from jepsen_tpu_torch.op import info as info_pt
from jepsen_tpu_torch.op import invoke as inv_pt
from jepsen_tpu_torch.op import ok as ok_pt

# tiny tensors: one thread each keeps the parallel test workers from
# crowding each other's cores
torch.set_num_threads(1)

VERDICT = ("valid", "op", "dead-event", "max-linearized", "final-configs",
           "previous-ok")
FIELDS = VERDICT + ("events", "slots", "states", "dropped-crashed-noops",
                    "engine")


@pytest.fixture(autouse=True)
def _cold_memos(monkeypatch):
    """Both packages build every memo cold, so both number the states the
    same way (the witnesses' ``final-configs`` order depends on it)."""
    for r in (reach_ref, reach_pt):      # no seeds, none left over
        monkeypatch.setattr(r, "_seed_union_memo", lambda *a: None)
        r._SUPERSET_SEEDS.clear()
    reach_ref._MEMO_CACHE.clear()
    reach_pt._MEMO_CACHE.clear()


def _packed(fx, h, kind, n_keys, n_ops, processes, bad=(), crash_p=0.0,
            values=5):
    """``n_keys`` packed cas/register histories, keys in ``bad``
    corrupted, key k with ``processes + k % 2`` processes (a ragged
    batch)."""
    out = []
    for k in range(n_keys):
        hk = fx.gen_history(kind, n_ops=n_ops + 7 * (k % 5),
                            processes=processes + k % 2, seed=k,
                            crash_p=crash_p, values=values)
        out.append(h.pack(fx.corrupt(hk, seed=k) if k in bad else hk))
    return out


def _both(*args, **kw):
    return (_packed(fx_ref, h_ref, *args, **kw),
            _packed(fx_pt, h_pt, *args, **kw))


def _dead(results):
    return np.array([-1 if r["valid"] else r["max-linearized"]
                     for r in results if r.get("events")])


def _ref_union(engine, kind, packed, dead, max_slots=20):
    """The reference's ``_union_results_parts`` on ``dead``."""
    model = fx_ref.model_for(kind)
    live = [i for i, p in enumerate(packed) if p.n and p.n_ok]
    sa = reach_ref._union_stage_a(model, packed, live, 100_000)
    g = reach_ref._union_pack_group(sa, range(len(live)), max_slots)
    return reach_ref._union_results_parts(
        engine, model, packed, live, dead, sa.memo_u, g[2], g[3],
        sa.drop_per_key(), 0.0, 100_000, max_slots, 1 << 22)


def _same(got, want, fields):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(want, got)):
        diff = {x: (a.get(x), b.get(x)) for x in fields
                if a.get(x) != b.get(x)}
        assert not diff, (i, diff)


def _routes(cap):
    return [r.get("cause") for r in cap.ledger
            if r["stage"] == "reach-many" and r["event"] == "route"]


def _check_many(kind, ref, pt, engine="reach-lockstep", **kw):
    """Both packages' ``check_many``; the port's results against the
    reference's verdict fields and against its union accounting."""
    want = reach_ref.check_many(fx_ref.model_for(kind), ref)
    with obs.capture() as cap:
        got = reach_pt.check_many(fx_pt.model_for(kind), pt, device="cpu",
                                  **kw)
    _same(got, want, VERDICT)
    _same(got, _ref_union(engine, kind, ref, _dead(got)), FIELDS)
    return got, cap


# -- plan_buckets ------------------------------------------------------------

@pytest.mark.parametrize("seed,n,group", [(0, 200, 32), (1, 37, 8),
                                         (2, 5, 32), (3, 300, 16)])
def test_plan_buckets_is_a_bounded_partition(seed, n, group):
    """Every stream in exactly one group of at most ``group`` lanes; a
    group's lanes walk at most about twice their own length, and the
    lengths up to the block share one group."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 3000, n)
    lens[: n // 4] = rng.integers(1, rb_pt.LOCK_BLOCK, n // 4)
    groups = rb_pt.plan_buckets(lens, group=group)
    flat = sorted(i for g in groups for i in g)
    assert flat == list(range(n))
    for g in groups:
        assert 1 <= len(g) <= group
        eff = [max(int(lens[i]), rb_pt.LOCK_BLOCK) for i in g]
        assert max(eff) < 2 * min(eff)
        R_pad = rb_pt.group_geom(max(eff), rb_pt.LOCK_BLOCK)
        assert R_pad <= 2.25 * min(eff) + rb_pt.LOCK_BLOCK
    short = [i for i in range(n) if lens[i] <= rb_pt.LOCK_BLOCK]
    assert len({tuple(g) for g in groups if set(g) & set(short)}) == \
        -(-len(short) // group)


def test_lock_block_bounds_the_checkpoints():
    """The block is the floor for short or narrow groups, and doubles
    until a long wide group's checkpoints fit the budget."""
    assert rb_pt.lock_block(47, 16, 32 * 8) == rb_pt.LOCK_BLOCK
    assert rb_pt.lock_block(80_000, 32, 32 * 8) == rb_pt.LOCK_BLOCK
    B = rb_pt.lock_block(100_000, 1 << 12, 32 * 32)
    assert B > rb_pt.LOCK_BLOCK and B & (B - 1) == 0
    assert -(-100_000 // B) * (1 << 12) * 32 * 32 * 4 <= rb_pt._CKPT_BYTES


# -- the union prep ----------------------------------------------------------

@pytest.mark.parametrize("kind,n_keys,processes,bad,crash_p", [
    ("cas", 9, 3, (1, 5), 0.0),
    ("cas", 6, 4, (2,), 0.08),
    ("register", 5, 3, (0,), 0.05)])
def test_union_stage_a_and_b_equal_reference(kind, n_keys, processes, bad,
                                             crash_p):
    ref, pt = _both(kind, n_keys, 30, processes, bad, crash_p)
    live = list(range(n_keys))
    a = reach_ref._union_stage_a(fx_ref.model_for(kind), ref, live, 100_000)
    b = reach_pt._union_stage_a(fx_pt.model_for(kind), pt, live, 100_000)
    assert (a.S_pad, a.memo_u.n_states, a.memo_u.n_ops) == \
        (b.S_pad, b.memo_u.n_states, b.memo_u.n_ops)
    np.testing.assert_array_equal(a.noop_op, b.noop_op)
    for f in ("opids", "invs", "rets", "crs"):
        for x, y in zip(getattr(a, f), getattr(b, f)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.drop_per_key(), b.drop_per_key())
    for sel in (live, live[1::2]):
        ga = reach_ref._union_pack_group(a, sel, 20)
        gb = reach_pt._union_pack_group(b, sel, 20)
        for x, y in zip(ga[:5], gb[:5]):
            np.testing.assert_array_equal(x, y)
        assert ga[5] == gb[5]


# -- check_many's lockstep lane -----------------------------------------------

@pytest.mark.parametrize("kind,n_keys,processes,bad,crash_p", [
    ("cas", 10, 3, (1, 4, 8), 0.0),
    ("cas", 8, 4, (3,), 0.06),
    ("register", 7, 3, (0, 6), 0.04)])
def test_check_many_lockstep_matches_reference(kind, n_keys, processes, bad,
                                               crash_p):
    """Route ``lockstep`` (engine ``reach-lockstep``); every key's verdict,
    op, dead event and witness the reference's, every field its union
    accounting's; one K1 refinement a dead lane."""
    ref, pt = _both(kind, n_keys, 40, processes, bad, crash_p)
    got, cap = _check_many(kind, ref, pt)
    assert _routes(cap) == ["lockstep"]
    assert {r["engine"] for r in got} == {"reach-lockstep"}
    assert sorted(i for i, r in enumerate(got) if not r["valid"]) == \
        list(bad)
    for i in bad:
        assert got[i]["final-configs"]


@pytest.mark.parametrize("n_keys,group,bad,crash_p", [
    (12, 3, (2, 9), 0.03),
    (7, 2, (0, 6), 0.0)])
def test_several_groups_match_reference(monkeypatch, n_keys, group, bad,
                                        crash_p):
    """Over several groups every key's result is the reference's, the
    groups partition the keys with all their returns, and group g+1 is
    staged on the card before group g is collected."""
    ref, pt = _both("cas", n_keys, 30, 3, bad, crash_p)
    monkeypatch.setattr(reach_pt, "_BATCH_GROUP", group)
    diag = {}
    got, cap = _check_many("cas", ref, pt, diag=diag)
    assert _routes(cap) == ["lockstep"]
    n_groups = -(-n_keys // group)
    assert len(diag["groups"]) == n_groups
    assert sum(g["H"] for g in diag["groups"]) == n_keys
    assert diag["real_returns"] == sum(p.n_ok for p in pt)
    assert sorted(i for i, r in enumerate(got) if not r["valid"]) == \
        list(bad)
    order = [s["name"] for s in sorted(cap.spans, key=lambda s: s["ts"])
             if s["name"] in ("lockstep.dispatch", "lockstep.collect")]
    assert order == ["lockstep.dispatch"] + [
        "lockstep.dispatch", "lockstep.collect"] * (n_groups - 1) + [
        "lockstep.collect"]


@pytest.mark.parametrize("block", [8, 16, 1024])
def test_verdicts_do_not_depend_on_the_block(monkeypatch, block):
    """The lockstep groups' checkpoint block (and plan_buckets' floor)
    moves the padding, never a verdict or a dead return."""
    ref, pt = _both("cas", 8, 50, 3, (1, 6), 0.0)
    monkeypatch.setattr(rb_pt, "LOCK_BLOCK", block)
    diag = {}
    got, _ = _check_many("cas", ref, pt, diag=diag)
    assert {g["B"] for g in diag["groups"]} == {block}
    assert all(g["R_pad"] % block == 0 for g in diag["groups"])


def test_exact_rescue_past_the_ladder_cap(monkeypatch):
    """A group past the capped ladder (W > 8) whose lane dies takes the
    exact W-pass walk before the K1 refinement, with the reference's
    results."""
    ref, pt = _both("cas", 4, 30, 10, (1,), 0.0)
    diag = {}
    with obs.capture() as cap:
        got, _ = _check_many("cas", ref, pt, diag=diag)
    assert [g["W"] for g in diag["groups"]] == [11]
    assert cap.counters.get("lockstep.exact_rescue", 0) >= 1
    assert [r["valid"] for r in got] == [True, False, True, True]


def _overflow_keys(inv, ok_, info):
    """Key 0 writes 1 and reads it, with crashed ``cas [2, 3]`` ops: a
    no-op in key 0's own states (1 and the initial), so its own prep
    drops them; key 1 writes 2, so in the union ``cas [2, 3]`` is no
    no-op and the crashed ops hold key 0's slots for good."""
    k0 = [inv(0, "write", 1), ok_(0, "write", 1)]
    for p in range(1, 4):
        k0 += [inv(p, "cas", [2, 3]), info(p, "cas", [2, 3])]
    k0 += [inv(9, "read", None), ok_(9, "read", 1)]
    k1 = [inv(0, "write", 2), ok_(0, "write", 2), inv(1, "read", None),
          ok_(1, "read", 2)]
    return [[op.with_(index=i, time=i) for i, op in enumerate(h)]
            for h in (k0, k1)]


def test_union_slot_overflow_falls_through():
    """A key over ``max_slots`` only under the union's coarser no-op
    classification: both union lanes decline (recorded), and the keyed
    route over each key's own prep decides, as the reference does."""
    ref = [h_ref.pack(h) for h in _overflow_keys(inv_ref, ok_ref, info_ref)]
    pt = [h_pt.pack(h) for h in _overflow_keys(inv_pt, ok_pt, info_pt)]
    kw = dict(max_slots=2)
    want = reach_ref.check_many(fx_ref.model_for("cas"), ref, **kw)
    with obs.capture() as cap:
        got = reach_pt.check_many(fx_pt.model_for("cas"), pt, device="cpu",
                                  **kw)
    skipped = {r["stage"]: r["cause"] for r in cap.skipped()}
    assert skipped["reach-lockstep"] == "slots"
    assert skipped["reach-native-keyed"] == "slots"
    assert _routes(cap) == ["keyed"]
    _same(got, want, VERDICT + ("events", "slots", "states"))
    assert [r["valid"] for r in got] == [True, True]


def test_wide_union_and_one_live_key_take_the_keyed_lane():
    """A union of more than 32 states is outside K2's envelope: the
    native keyed lane takes it on K5 (``keyed-wide``); a batch with one
    live key takes it on K3 (``keyed``)."""
    ref, pt = _both("cas", 4, 30, 3, (2,), values=40)
    got, cap = _check_many("cas", ref, pt, engine="reach-keyed")
    assert _routes(cap) == ["keyed-wide"]
    assert {r["stage"]: r["cause"] for r in cap.skipped()}[
        "reach-lockstep"] == "geometry"
    empty = h_pt.pack([])
    ref, pt = _both("cas", 1, 40, 3, (0,))
    got, cap = _check_many("cas", ref + [h_ref.pack([])], pt + [empty],
                           engine="reach-keyed")
    assert _routes(cap) == ["keyed"]
    assert {r["stage"]: r["cause"] for r in cap.skipped()}[
        "reach-lockstep"] == "histories"
    assert got[0]["valid"] is False and got[1]["valid"] is True


@pytest.mark.parametrize("where", [(rb_pt, "dispatch_prepared"),
                                   (rb_pt, "collect_returns_batch"),
                                   (reach_pt, "_union_pack_group")])
def test_lane_fault_propagates(monkeypatch, where):
    """A fault in the lockstep lane, in its union prep, its dispatch or
    its collect, reaches the caller: no other lane hides it."""
    _ref, pt = _both("cas", 6, 30, 3, ())
    monkeypatch.setattr(reach_pt, "_BATCH_GROUP", 2)

    def boom(*a, **k):
        raise RuntimeError("injected lockstep fault")

    monkeypatch.setattr(*where, boom)
    with pytest.raises(RuntimeError, match="injected"):
        reach_pt.check_many(fx_pt.model_for("cas"), pt, device="cpu")


# -- check_batch ---------------------------------------------------------------

def test_check_batch_matches_reference():
    """Several whole histories through one ``check_batch``: each one's
    verdict, op, dead event and witness the reference's ``check_batch``
    (on the CPU each history's own check), every field the reference's
    union accounting."""
    ref, pt = [], []
    for s in range(5):
        a = fx_ref.gen_history("cas", n_ops=120 + 40 * s, processes=4,
                               seed=100 + s, crash_p=0.02 * (s % 2))
        b = fx_pt.gen_history("cas", n_ops=120 + 40 * s, processes=4,
                              seed=100 + s, crash_p=0.02 * (s % 2))
        if s in (1, 3):
            a, b = fx_ref.corrupt(a, seed=s), fx_pt.corrupt(b, seed=s)
        ref.append(h_ref.pack(a))
        pt.append(h_pt.pack(b))
    want = reach_ref.check_batch(fx_ref.model_for("cas"), ref)
    diag = {}
    with obs.capture() as cap:
        got = reach_pt.check_batch(fx_pt.model_for("cas"), pt, diag=diag,
                                   device="cpu")
    assert cap.fallbacks() == []
    assert diag["groups"] and diag["real_returns"] == sum(p.n_ok for p in pt)
    _same(got, want, VERDICT)
    _same(got, _ref_union("reach-lockstep", "cas", ref, _dead(got)), FIELDS)
    assert [r["valid"] for r in got] == [True, False, True, False, True]


def test_check_batch_falls_back_per_history():
    """One history is no batch: the lane declines (``histories``) and the
    history goes through its own check, recorded as the reference records
    it."""
    p = h_pt.pack(fx_pt.gen_history("cas", n_ops=60, processes=3, seed=1))
    with obs.capture() as cap:
        got = reach_pt.check_batch(fx_pt.model_for("cas"),
                                   [p, h_pt.pack([])], device="cpu")
    assert got[0]["valid"] is True and got[0]["engine"] == "reach-lane"
    assert got[1] == {"valid": True, "engine": "reach-lockstep", "events": 0,
                      "time-s": 0.0}
    assert [(r["stage"], r["cause"]) for r in cap.fallbacks()] == \
        [("reach-lockstep", "no-union-prep")]
    assert {r["stage"]: r["cause"] for r in cap.skipped()}[
        "reach-lockstep"] == "histories"


def test_dispatch_and_collect_split():
    """``dispatch_prepared`` queues a group and ``collect_returns_batch``
    answers it with the reference's lockstep walk's dead vector; on the
    CPU nothing is queued, so there is no event to wait on."""
    ref, _pt = _both("cas", 5, 40, 3, (2,))
    model = fx_ref.model_for("cas")
    sa = reach_ref._union_stage_a(model, ref, range(5), 100_000)
    ret, ops, _W, key_R, off, W = reach_ref._union_pack_group(
        sa, range(5), 20)
    rets = [ret[off[k]:off[k + 1]] for k in range(5)]
    opss = [ops[off[k]:off[k + 1]] for k in range(5)]
    P = reach_ref._build_P(sa.memo_u, sa.S_pad)
    prep = rb_pt.prepare_returns_batch(P, rets, opss, 1 << W)
    fl = rb_pt.dispatch_prepared(prep, device="cpu")
    assert fl.event is None
    dead = rb_pt.collect_returns_batch(fl)
    np.testing.assert_array_equal(
        dead, rb_ref.walk_returns_batch(P, rets, opss, 1 << W,
                                        interpret=True))
    assert list(dead >= 0) == [False, False, True, False, False]

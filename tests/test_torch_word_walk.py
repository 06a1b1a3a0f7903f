"""The word-packed post-hoc walk (K11's module, ``checkers/reach_word.py``)
against the reference's ``_walk_words``, on the CPU.

The host helpers are held byte for byte against the reference's; the
plain version ``walk_words_plain`` bit for bit (final words, dead step)
against the reference's jitted ``_walk_words`` and its lane ``vmap`` at
one, two, eight and 32 words a state, on cas streams with crashed ops,
with an injected violation and in ragged lanes; K11's in-place passes
are replayed in numpy against it. ``check_packed(body="word")`` and
``check_many``/``check_batch`` with word groups give the reference's
word route's verdicts, ops, dead events and witnesses (the reference's
route forced by its ``JEPSEN_TPU_WORD_POSTHOC`` gate), and a fault in
the word walk propagates.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu import obs as obs_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.checkers import reach_batch as rb_ref
from jepsen_tpu.checkers import reach_word as rw_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import events as ev_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_word as rw_pt

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")

RESULT = ("valid", "op", "dead-event", "max-linearized", "final-configs",
          "previous-ok", "events", "slots", "states")


@pytest.fixture(autouse=True)
def _cold_memos(monkeypatch):
    """Both packages build every memo cold and number states alike."""
    for r in (reach_ref, reach_pt):
        monkeypatch.setattr(r, "_seed_union_memo", lambda *a: None)
        r._SUPERSET_SEEDS.clear()
        r._MEMO_CACHE.clear()
    for gate in ("JEPSEN_TPU_WORD_POSTHOC", "JEPSEN_TPU_NO_WORD_WALK"):
        monkeypatch.delenv(gate, raising=False)


# -- host helpers -------------------------------------------------------------

@pytest.mark.parametrize("S,M", [(1, 2), (6, 8), (6, 32), (5, 64), (3, 1024)])
def test_pack_words_byte_equal(S, M):
    rng = np.random.default_rng(S * M)
    R = rng.random((S, M)) < 0.3
    w_ref, w_pt = rw_ref.pack_words(R), rw_pt.pack_words(R)
    assert w_pt.dtype == w_ref.dtype and w_pt.tobytes() == w_ref.tobytes()
    assert rw_pt.unpack_words(w_pt, M).tobytes() == \
        rw_ref.unpack_words(w_ref, M).tobytes()
    assert rw_pt.n_words(M) == rw_ref.n_words(M)


@pytest.mark.parametrize("rows,N", [(1, 1), (4, 31), (3, 32), (7, 100)])
def test_pack_rows_byte_equal(rows, N):
    R = np.random.default_rng(rows + N).random((rows, N)) < 0.5
    w = rw_pt.pack_rows(R)
    assert w.tobytes() == rw_ref.pack_rows(R).tobytes()
    assert rw_pt.unpack_rows(w, N).tobytes() == \
        rw_ref.unpack_rows(w, N).tobytes()


def test_tables_masks_and_envelope_equal():
    rng = np.random.default_rng(3)
    P = np.zeros((9, 8, 8), np.float32)
    src, dst = rng.integers(0, 8, 40), rng.integers(0, 8, 40)
    P[rng.integers(0, 8, 40), src, dst] = 1.0
    P[:, :, 1:] *= P.argmax(2)[..., None] == np.arange(1, 8)  # one-hot
    T = rw_pt.table_from_P(P)
    assert T.tobytes() == rw_ref.table_from_P(P).tobytes()
    assert rw_pt.pad_table(T).tobytes() == rw_ref.pad_table(T).tobytes()
    for W in range(0, 12):
        assert rw_pt._cmask32(W).tobytes() == rw_ref._cmask32(W).tobytes()
    for S in (1, 6, 41, 114, 115, 916, 2048, 2049):
        for W in (1, 5, 8, 10, 11):
            assert rw_pt.admits(S, W, 1 << W) == \
                rw_ref.admits(S, W, 1 << W), (S, W)


# -- the plain version against the reference's walk ---------------------------

def _operands(procs, crash_p=0.0, corrupt=False, n_ops=150, seed=None):
    """A cas history's memo table, returns view and M (the port's prep,
    which the port's tests hold equal to the reference's)."""
    seed = procs if seed is None else seed
    hist = fx_pt.gen_history("cas", n_ops=n_ops, processes=procs,
                             seed=seed, crash_p=crash_p)
    if corrupt:
        hist = fx_pt.corrupt(hist, seed=seed)
    memo, stream, _T, _S, M = reach_pt._prep(
        m_pt.cas_register(), h_pt.pack(h_pt.index(hist)),
        max_states=100_000, max_slots=20, max_dense=1 << 22)
    return memo, ev_pt.returns_view(stream), M


def _seed_words(S, M, H=1):
    R0 = np.zeros((H, S, M), bool)
    R0[:, 0, 0] = True
    return np.stack([rw_ref.pack_words(r) for r in R0])


# (processes, crash_p): W = 3 and 5 at one word, 6 at two, 8 at eight and
# 10 at 32 (crashed ops stay pending: W = 5 from 3 processes, 10 from 10)
GEOMS = [(3, 0.0, 3), (3, 0.015, 5), (5, 0.0, 5), (6, 0.0, 6),
         (8, 0.0, 8), (10, 0.015, 10)]


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("procs,crash_p,W", GEOMS)
def test_plain_matches_reference_walk(procs, crash_p, W, corrupt):
    memo, rs, M = _operands(procs, crash_p, corrupt)
    assert rs.slot_ops.shape[1] == W and M == 1 << W
    n = rs.n_returns
    Tpad = rw_ref.pad_table(memo.table)
    R0 = _seed_words(memo.n_states, M)
    ret, ops = rs.ret_slot[:n], rs.slot_ops[:n]
    R_ref, any_dead, first = rw_ref._jitted_walk_words()(
        jnp.asarray(Tpad), jnp.asarray(R0[0]), jnp.asarray(ret),
        jnp.asarray(ops))
    fin, dead = rw_pt.walk_words_plain(
        torch.as_tensor(Tpad), torch.as_tensor(R0.view(np.int32)),
        torch.as_tensor(ret[None]), torch.as_tensor(ops[None]))
    assert fin[0].numpy().view(np.uint32).tobytes() == \
        np.asarray(R_ref).tobytes()
    want = int(first) if bool(any_dead) else -1
    assert int(dead[0]) == want
    assert (want >= 0) == corrupt


def _lanes(procs, crash_p, H, seed):
    """H lanes sharing one table: slices of one cas stream, ragged, each
    from a random non-empty seed set."""
    memo, rs, M = _operands(procs, crash_p)
    rng = np.random.default_rng(seed)
    n = rs.n_returns
    lens = rng.integers(1, n // 2, H)
    lens[0] = n // 2
    starts = rng.integers(0, n - lens.max(), H)
    S = memo.n_states
    R0 = rng.random((H, S, M)) < 0.05
    R0[:, 0, 0] = True
    return memo, rs, M, lens, starts, np.stack(
        [rw_ref.pack_words(r) for r in R0])


@pytest.mark.parametrize("procs,crash_p,W", GEOMS)
def test_plain_lanes_match_reference_vmap(procs, crash_p, W):
    H = 5
    memo, rs, M, lens, starts, R0 = _lanes(procs, crash_p, H, 11 + procs)
    assert M == 1 << W
    Tpad = rw_ref.pad_table(memo.table)
    R_pad = int(lens.max())
    ret = np.full((H, R_pad), -1, np.int32)
    ops = np.full((H, R_pad, W), -1, np.int32)
    for h in range(H):
        ret[h, :lens[h]] = rs.ret_slot[starts[h]:starts[h] + lens[h]]
        ops[h, :lens[h]] = rs.slot_ops[starts[h]:starts[h] + lens[h]]
    R_ref, any_dead, first = rw_ref._jitted_walk_words_batch()(
        jnp.asarray(Tpad), jnp.asarray(R0), jnp.asarray(ret),
        jnp.asarray(ops))
    want = np.where(np.asarray(any_dead), np.asarray(first), -1)
    # the identity-padded layout, and each lane ended at its own count
    # over garbage past it
    junk_ret = ret.copy()
    junk_ops = ops.copy()
    for h in range(H):
        junk_ret[h, lens[h]:] = 0
        junk_ops[h, lens[h]:] = 1
    for r, o, n in ((ret, ops, None),
                    (junk_ret, junk_ops, torch.as_tensor(lens, dtype=torch.int32))):
        fin, dead = rw_pt.walk_words(
            torch.as_tensor(Tpad), torch.as_tensor(R0.view(np.int32)),
            torch.as_tensor(r), torch.as_tensor(o), n)
        assert fin.numpy().view(np.uint32).tobytes() == \
            np.asarray(R_ref).tobytes()
        assert dead.tolist() == want.tolist()


def test_plain_refuses_a_lane_past_the_table():
    """A lane naming an op past the table or a slot past W walks nothing
    (dead -2, its seed kept), as K11; the others walk."""
    memo, rs, M = _operands(5)
    n = 40
    Tpad = rw_ref.pad_table(memo.table)
    R0 = _seed_words(memo.n_states, M, 3)
    ret = np.tile(rs.ret_slot[None, :n], (3, 1))
    ops = np.tile(rs.slot_ops[None, :n], (3, 1, 1))
    ops[1, 5, 2] = Tpad.shape[1]
    ret[2, 9] = 5
    fin, dead = rw_pt.walk_words_plain(
        torch.as_tensor(Tpad), torch.as_tensor(R0.view(np.int32)),
        torch.as_tensor(ret), torch.as_tensor(ops))
    assert dead.tolist()[1:] == [-2, -2] and dead.tolist()[0] >= -1
    assert np.array_equal(fin[1:].numpy(), R0[1:].view(np.int32))
    with pytest.raises(RuntimeError, match="past the table"):
        rw_pt._raise_bad(dead.numpy())


def _k11_replay(Tpad, R0w, ret, ops, order):
    """K11's walk of one lane replayed in numpy: each pass ORs every
    shifted word into the set in place, in the thread order ``order`` of
    the (s, j, w) items, at most the step's pending count of passes,
    ending after the first that adds nothing; the projection into a
    second buffer; emptiness after each projection."""
    S, NW = R0w.shape
    W = ops.shape[1]
    cm = [0xAAAAAAAA, 0xCCCCCCCC, 0xF0F0F0F0, 0xFF00FF00, 0xFFFF0000]
    R = R0w.astype(np.uint64).copy()
    for k in range(len(ret)):
        row = ops[k]
        tgt = np.array([[-1 if row[j] < 0 else Tpad[s, row[j]]
                         for j in range(W)] for s in range(S)])
        for _p in range(int((row >= 0).sum())):
            grew = False
            for i in order(S * W * NW):
                q, w = divmod(i, NW)
                s, j = divmod(q, W)
                t = tgt[s, j]
                if t < 0:
                    continue
                if j < 5:
                    v = ((int(R[s, w]) & ~cm[j]) << (1 << j)) & 0xFFFFFFFF
                else:
                    b = 1 << (j - 5)
                    v = int(R[s, w ^ b]) if w & b else 0
                old = int(R[t, w])
                R[t, w] = old | v
                grew |= (v & ~old) != 0
            if not grew:
                break
        j = int(ret[k])
        if j >= 0:
            X = np.zeros_like(R)
            for s in range(S):
                for w in range(NW):
                    if j < 5:
                        X[s, w] = (int(R[s, w]) & cm[j]) >> (1 << j)
                    else:
                        b = 1 << (j - 5)
                        X[s, w] = 0 if w & b else R[s, w + b]
            R = X
            if not R.any():
                return R.astype(np.uint32), k
    return R.astype(np.uint32), -1


@pytest.mark.parametrize("procs,crash_p,corrupt", [(5, 0.0, True),
                                                   (6, 0.015, False)])
def test_k11_in_place_passes_replayed(procs, crash_p, corrupt):
    """K11's in-place passes, in forward and reverse thread order, end on
    the plain version's set and dead step."""
    memo, rs, M = _operands(procs, crash_p, corrupt, n_ops=80)
    n = rs.n_returns
    Tpad = rw_ref.pad_table(memo.table)
    R0 = _seed_words(memo.n_states, M)
    ret, ops = rs.ret_slot[:n], rs.slot_ops[:n]
    fin, dead = rw_pt.walk_words_plain(
        torch.as_tensor(Tpad), torch.as_tensor(R0.view(np.int32)),
        torch.as_tensor(ret[None]), torch.as_tensor(ops[None]))
    for order in (range, lambda m: range(m - 1, -1, -1)):
        R, d = _k11_replay(Tpad, R0[0], ret, ops, order)
        assert d == int(dead[0])
        assert R.tobytes() == fin[0].numpy().view(np.uint32).tobytes()


def test_wrapper_checks_shapes_device_and_envelope():
    memo, rs, M = _operands(5)
    Tpad = torch.as_tensor(rw_ref.pad_table(memo.table))
    R0 = torch.as_tensor(_seed_words(memo.n_states, M).view(np.int32))
    ret = torch.as_tensor(rs.ret_slot[None, :8].copy())
    ops = torch.as_tensor(rs.slot_ops[None, :8].copy())
    with pytest.raises(ValueError, match="inconsistent shapes"):
        rw_pt.walk_words(Tpad, R0, ret, ops[:, :4])
    with pytest.raises(ValueError, match="unsupported device"):
        rw_pt.walk_words(*(x.to("meta") for x in (Tpad, R0, ret, ops)))
    big = torch.full((2049, 3), -1, dtype=torch.int32)
    R0b = torch.zeros((1, 2049, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="envelope"):
        rw_pt.walk_words(big, R0b, ret, ops)


# -- the single history's word route -------------------------------------------

WORD_GEN = [("cas", 4, 0, False), ("cas", 5, 1, True),
            ("register", 3, 2, True), ("cas", 8, 3, False),
            ("cas", 8, 4, True)]
FIXTURES = [("cas-register-ok-small.edn", "cas_register"),
            ("cas-register-ok-large.edn", "cas_register"),
            ("cas-register-bad.edn", "cas_register"),
            ("cas-register-recorded-bad.edn", "cas_register"),
            ("register-ok.edn", "register"),
            ("register-bad.edn", "register"),
            ("mutex-ok.edn", "mutex"),
            ("multi-register-ok.edn", "multi_register"),
            ("multi-register-bad.edn", "multi_register")]


def _both_word(monkeypatch, model_name, h1, h2):
    monkeypatch.setenv("JEPSEN_TPU_WORD_POSTHOC", "1")
    r_ref = reach_ref.check_packed(getattr(m_ref, model_name)(),
                                   h_ref.pack(h1))
    monkeypatch.delenv("JEPSEN_TPU_WORD_POSTHOC")
    with obs.capture() as cap:
        r_pt = reach_pt.check_packed(getattr(m_pt, model_name)(),
                                     h_pt.pack(h2), body="word",
                                     device="cpu")
    assert r_ref["engine"] == r_pt["engine"] == "reach-word"
    diff = {k: (r_ref.get(k), r_pt.get(k)) for k in RESULT
            if r_ref.get(k) != r_pt.get(k)}
    assert not diff, diff
    assert cap.counters.get("reach.word_walk") == 1
    assert [r["engine"] for r in cap.ledger if r["event"] == "route"] == \
        ["reach-word"]
    assert [s["args"]["engine"] for s in cap.spans
            if s["name"] == "reach.walk"] == ["reach-word"]
    return r_pt


@pytest.mark.parametrize("kind,procs,seed,corrupt", WORD_GEN)
def test_check_packed_word_matches_reference(monkeypatch, kind, procs, seed,
                                             corrupt):
    kw = dict(n_ops=220, processes=procs, seed=seed)
    h1, h2 = fx_ref.gen_history(kind, **kw), fx_pt.gen_history(kind, **kw)
    if corrupt:
        h1 = fx_ref.corrupt(h1, seed=seed + 50)
        h2 = fx_pt.corrupt(h2, seed=seed + 50)
    model = "cas_register" if kind == "cas" else "register"
    res = _both_word(monkeypatch, model, h_ref.index(h1), h_pt.index(h2))
    assert res["valid"] is (not corrupt)
    if corrupt:
        assert res["final-configs"] and res["previous-ok"]


@pytest.mark.parametrize("fname,model_name", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_check_packed_word_fixtures(monkeypatch, fname, model_name):
    path = os.path.join(DATA, fname)
    _both_word(monkeypatch, model_name, h_ref.load_edn(path),
               h_pt.load_edn(path))


def test_word_route_keyword_and_skip_causes():
    """``body="dense"`` keeps the default route; without a keyword or a
    winner the skip cause is ``no-winner``; an abort hook keeps the word
    walk out; an unknown body raises."""
    packed = h_pt.pack(fx_pt.gen_history("cas", n_ops=60, processes=3,
                                         seed=1))
    model = m_pt.cas_register()
    for kw, cause in (({"body": "dense"}, "keyword"), ({}, "no-winner"),
                      ({"body": "word", "should_abort": lambda: False},
                       "abort-hook")):
        with obs.capture() as cap:
            res = reach_pt.check_packed(model, packed, device="cpu", **kw)
        assert res["engine"] == "reach-lane"
        assert {r["stage"]: r["cause"] for r in cap.skipped()}[
            "reach-word"] == cause
    with pytest.raises(ValueError, match="body"):
        reach_pt.check_packed(model, packed, device="cpu", body="fast")


# -- lockstep groups -------------------------------------------------------------

def _force_lockstep(monkeypatch):
    """The reference's lockstep lane on the CPU (its dense batch kernel
    in interpret mode)."""
    monkeypatch.setattr(reach_ref, "_use_pallas", lambda: True)
    monkeypatch.setattr(reach_ref, "_PALLAS_MIN_RETURNS", 0)
    monkeypatch.setattr(rb_ref, "_INTERPRET_DEFAULT", True)


def _ragged(fx, h):
    out = []
    for i, n in enumerate((60, 110, 75, 140, 90, 60)):
        hist = fx.gen_history("cas", n_ops=n, processes=4, seed=100 + i)
        if i % 3 == 1:
            hist = fx.corrupt(hist, seed=i)
        out.append(h.pack(h.index(hist)))
    return out


@pytest.mark.parametrize("entry", ["check_many", "check_batch"])
def test_lockstep_word_groups_match_reference(monkeypatch, entry):
    _force_lockstep(monkeypatch)
    monkeypatch.setenv("JEPSEN_TPU_WORD_POSTHOC", "1")
    with obs_ref.capture() as cap_ref:
        ref = getattr(reach_ref, entry)(m_ref.cas_register(),
                                        _ragged(fx_ref, h_ref))
    monkeypatch.delenv("JEPSEN_TPU_WORD_POSTHOC")
    assert cap_ref.counters.get("lockstep.word_groups", 0) >= 1
    with obs.capture() as cap:
        got = getattr(reach_pt, entry)(m_pt.cas_register(),
                                       _ragged(fx_pt, h_pt), body="word",
                                       device="cpu")
    assert cap.counters.get("lockstep.word_groups", 0) >= 1
    assert not cap.fallbacks()
    for r, g in zip(ref, got):
        for key in ("valid", "op", "dead-event", "final-configs",
                    "previous-ok"):
            assert r.get(key) == g.get(key), key
    assert [r["valid"] for r in got].count(False) == 2


def test_lockstep_word_dead_vector_equals_dense():
    """A word group's dead returns (exact) equal the dense group's (K2's
    plain version, located and refined by K1's)."""
    packed = _ragged(fx_pt, h_pt)
    dead = {}
    for body in ("word", "dense"):
        with obs.capture() as cap:
            res = reach_pt.check_many(m_pt.cas_register(), packed,
                                      body=body, device="cpu")
        dead[body] = [r.get("dead-event") for r in res]
        assert bool(cap.counters.get("lockstep.word_groups")) == \
            (body == "word")
    assert dead["word"] == dead["dense"]


# -- faults propagate ---------------------------------------------------------------

def _boom(*a, **k):
    raise RuntimeError("injected K11 fault")


def test_word_walk_fault_propagates_from_check_packed(monkeypatch):
    monkeypatch.setattr(rw_pt, "walk_words", _boom)
    packed = h_pt.pack(fx_pt.gen_history("cas", n_ops=60, processes=3,
                                         seed=1))
    with obs.capture() as cap:
        with pytest.raises(RuntimeError, match="injected K11 fault"):
            reach_pt.check_packed(m_pt.cas_register(), packed, body="word",
                                  device="cpu")
    assert not cap.fallbacks()


@pytest.mark.parametrize("entry", ["check_many", "stage_check_many"])
def test_word_walk_fault_propagates_from_lockstep(monkeypatch, entry):
    monkeypatch.setattr(rw_pt, "walk_words", _boom)
    packed = _ragged(fx_pt, h_pt)
    with obs.capture() as cap:
        with pytest.raises(RuntimeError, match="injected K11 fault"):
            out = getattr(reach_pt, entry)(m_pt.cas_register(), packed,
                                           body="word", device="cpu")
            out.collect()
    assert not cap.fallbacks()
    assert "lockstep.word_groups" not in cap.counters

"""The port's streaming session engines against the reference's, on the
CPU (``device="cpu"``; the reference under ``JAX_PLATFORMS=cpu``):
``reach.FrontierCarry`` block by block through each of its walks (K1's
plain version, K4's, the torch walk), ``serve.session``'s
``DeviceFrontierEngine`` (ragged and geometry-growth differentials) and
``TxnSessionEngine``, ``txn.infer.IncrementalInfer``,
``txn.cycles.IncrementalClosure`` (K = 3 and K = 4, regrowth, the dense
cap) with its f32 cross-check, and K9's plain version, against a numpy
replay of the reference's join and the product written in numpy (M !=
N, k axes of 1-256 words); the word update against the reference's
``_inc_word_call`` at dirty widths 8-128, and with ``torch.bmm``
raising and no float tensor made.
"""
import contextlib

import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu.checkers import online as on_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.serve import session as ses_ref
from jepsen_tpu.txn import cycles as cyc_ref
from jepsen_tpu.txn import infer as inf_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch import txn as txn_pt
from jepsen_tpu_torch.checkers import events as ev_pt
from jepsen_tpu_torch.checkers import online as on_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_lane as rl_pt
from jepsen_tpu_torch.checkers import reach_pallas as rp_pt
from jepsen_tpu_torch.serve import session as ses_pt
from jepsen_tpu_torch.txn import cycles as cyc_pt
from jepsen_tpu_torch.txn import host_ref as host_pt
from jepsen_tpu_torch.txn import infer as inf_pt
from jepsen_tpu_torch.txn.infer import DepGraph


def _ref_ops(ops):
    from jepsen_tpu.op import Op as OpRef
    return [OpRef.from_dict(o.to_dict()) for o in ops]


def _ragged_blocks(hist, seed: int, n_cuts: int = 4):
    rng = np.random.RandomState(seed)
    cuts = sorted(rng.choice(len(hist), size=n_cuts, replace=False))
    blocks, prev = [], 0
    for c in list(cuts) + [len(hist)]:
        if c > prev:
            blocks.append(hist[prev:c])
            prev = c
    return blocks


# -- the carried frontier --------------------------------------------------

@contextlib.contextmanager
def _cold_memos():
    """Both packages' memos built from cold caches. Each ``_cached_memo``
    first projects from the superset seeds that any earlier
    ``check_many`` in the process left (the same table up to the
    states' numbering), and a disk tier may hold an earlier build. So
    both packages' exact caches and seeds are emptied under their locks,
    persistence is off, and every dict is restored after: no other test
    sees a change."""
    mods = (reach_ref, reach_pt)
    saved = []
    for r in mods:
        with r._MEMO_CACHE_LOCK:
            saved.append((dict(r._MEMO_CACHE), dict(r._SUPERSET_SEEDS)))
            r._MEMO_CACHE.clear()
            r._SUPERSET_SEEDS.clear()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("JEPSEN_TPU_NO_PERSIST", "1")
            yield
    finally:
        for r, old in zip(mods, saved):
            with r._MEMO_CACHE_LOCK:
                for live, o in zip((r._MEMO_CACHE, r._SUPERSET_SEEDS), old):
                    live.clear()
                    live.update(o)


def _carry_memos(kw, seed, n_ops, corrupt):
    """One cas history in both packages: the port's memo and return
    stream, and the reference's memo from a cold cache (the same
    table)."""
    hists = []
    for fx in (fx_pt, fx_ref):
        h = fx.gen_history("cas", n_ops=n_ops, processes=5, seed=seed,
                           **kw)
        hists.append(fx.corrupt(h, seed=seed) if corrupt else h)
    with _cold_memos():
        memo_p, stream_p, _T, _S, M = reach_pt._prep(
            m_pt.cas_register(), h_pt.pack(hists[0]), max_states=100_000,
            max_slots=20, max_dense=1 << 22)
        memo_r, _s, _T, _S, M_r = reach_ref._prep(
            fx_ref.model_for("cas"), h_ref.pack(hists[1]),
            max_states=100_000, max_slots=20, max_dense=1 << 22)
    assert (memo_p.table == memo_r.table).all() and M == M_r
    return memo_p, memo_r, ev_pt.returns_view(stream_p), M


CARRY_CASES = [("cas", {}, "reach-lane"),
               ("wide cas", dict(values=40), "reach-pallas"),
               ("cas", {}, "reach")]


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("label,kw,engine", CARRY_CASES,
                         ids=[c[2] for c in CARRY_CASES])
def test_frontier_carry_against_reference(label, kw, engine, corrupt,
                                          monkeypatch):
    """The port's carry against the reference's, block by block: the
    dead index of every advance and probe, and the ``fetch()``ed set
    after every block, through K1's plain version, K4's and the torch
    walk (the last forced by routing every geometry out of K1 and K4)."""
    if engine == "reach":
        monkeypatch.setattr(rl_pt, "lane_fits", lambda *a: False)
        monkeypatch.setattr(rp_pt, "fits", lambda *a: False)
    n_ops = 500 if engine == "reach-pallas" else 1200
    memo_p, memo_r, rs, M = _carry_memos(kw, 3, n_ops, corrupt)
    W = M.bit_length() - 1
    S = memo_p.n_states
    R0 = np.zeros((S, M), bool)
    R0[0, 0] = True
    with obs.capture() as cap:
        carry = reach_pt.FrontierCarry(memo_p, W, R0, device="cpu")
    assert carry.engine == engine
    assert [d["engine"] for d in cap.ledger
            if d["stage"] == "frontier-carry"] == [engine]
    ref = reach_ref.FrontierCarry(
        None, W, M, R0, table=memo_r.table,
        p_build=lambda: reach_ref._build_P(memo_r, S))
    dead_seen = False
    for b0 in range(0, rs.n_returns, 37):
        js = rs.ret_slot[b0:b0 + 37]
        ops = rs.slot_ops[b0:b0 + 37]
        assert carry.probe(js, ops) == ref.probe(js, ops)
        d = carry.advance(js, ops)
        assert d == ref.advance(js, ops), b0
        assert carry.advanced_returns == ref.advanced_returns
        if d >= 0:
            dead_seen = True
            assert not carry.fetch().any()
            break
        np.testing.assert_array_equal(carry.fetch(), ref.fetch())
    assert dead_seen == corrupt


# histories whose reference table a seeded union memo numbers
# differently from a fresh build
@pytest.mark.parametrize("seed,n_ops", [(2, 40), (5, 30)])
def test_carry_memos_equal_after_a_union_memo_was_seeded(seed, n_ops):
    """The reference's union memo seeded in this process first (as any
    earlier ``check_many`` on the worker leaves it): ``_carry_memos``
    still finds both packages' tables equal element for element, the
    reference's seed dict after it is exactly as it was, and a carry
    of each package walks the history to the same sets."""
    packed = [h_ref.pack(fx_ref.gen_history("cas", n_ops=300, processes=5,
                                            seed=40 + s)) for s in range(8)]
    with _cold_memos():                 # this test's own seeds go after
        reach_ref._seed_union_memo(fx_ref.model_for("cas"), packed,
                                   100_000)
        seeds = dict(reach_ref._SUPERSET_SEEDS)
        assert seeds
        memo_p, memo_r, rs, M = _carry_memos({}, seed, n_ops, False)
        assert reach_ref._SUPERSET_SEEDS == seeds
        assert all(reach_ref._SUPERSET_SEEDS[k] is v
                   for k, v in seeds.items())
    np.testing.assert_array_equal(memo_p.table, memo_r.table)
    W, S = M.bit_length() - 1, memo_p.n_states
    R0 = np.zeros((S, M), bool)
    R0[0, 0] = True
    carry = reach_pt.FrontierCarry(memo_p, W, R0, device="cpu")
    ref = reach_ref.FrontierCarry(
        None, W, M, R0, table=memo_r.table,
        p_build=lambda: reach_ref._build_P(memo_r, S))
    assert carry.advance(rs.ret_slot, rs.slot_ops) == \
        ref.advance(rs.ret_slot, rs.slot_ops)
    np.testing.assert_array_equal(carry.fetch(), ref.fetch())


@pytest.mark.parametrize("seed,n_ops", [(2, 40), (5, 30)])
def test_carry_memos_equal_after_a_port_union_memo_was_seeded(seed, n_ops):
    """The port's union memo seeded first, as its ``check_many`` leaves
    it on a worker: ``_carry_memos`` still finds both packages' tables
    equal element for element, the port's seeds after it are as they
    were, and both carries walk the history to the same sets."""
    packed = [h_pt.pack(fx_pt.gen_history("cas", n_ops=300, processes=5,
                                          seed=40 + s)) for s in range(8)]
    with _cold_memos():                 # this test's own seeds go after
        reach_pt._seed_union_memo(m_pt.cas_register(), packed, 100_000)
        seeds = dict(reach_pt._SUPERSET_SEEDS)
        assert seeds
        memo_p, memo_r, rs, M = _carry_memos({}, seed, n_ops, False)
        assert reach_pt._SUPERSET_SEEDS == seeds
    np.testing.assert_array_equal(memo_p.table, memo_r.table)
    W, S = M.bit_length() - 1, memo_p.n_states
    R0 = np.zeros((S, M), bool)
    R0[0, 0] = True
    carry = reach_pt.FrontierCarry(memo_p, W, R0, device="cpu")
    ref = reach_ref.FrontierCarry(
        None, W, M, R0, table=memo_r.table,
        p_build=lambda: reach_ref._build_P(memo_r, S))
    assert carry.advance(rs.ret_slot, rs.slot_ops) == \
        ref.advance(rs.ret_slot, rs.slot_ops)
    np.testing.assert_array_equal(carry.fetch(), ref.fetch())


@pytest.mark.parametrize("seed,crash_p,corrupt",
                         [(0, 0.0, False), (1, 0.0, True),
                          (2, 0.02, False)])
def test_device_vs_host_frontier_ragged_differential(seed, crash_p,
                                                     corrupt):
    """On ragged append blocks, crashes included: the port's device
    engine (on the CPU), its host engine and the reference's device
    engine give the same violation, witness op and settled count, and
    the one-shot check's verdict on the whole history."""
    hist = fx_pt.gen_history("cas", n_ops=150, processes=4, seed=seed,
                             crash_p=crash_p)
    if corrupt:
        hist = fx_pt.corrupt(hist, seed=seed)
    host = on_pt.NativeStreamEngine(m_pt.cas_register())
    dev = ses_pt.DeviceFrontierEngine(m_pt.cas_register(), device="cpu")
    ref = ses_ref.DeviceFrontierEngine(fx_ref.model_for("cas"))
    vs = [None, None, None]
    for b in _ragged_blocks(hist, seed):
        for i, (eng, ops) in enumerate(((host, b), (dev, b),
                                        (ref, _ref_ops(b)))):
            eng.feed_many(list(ops))
            vs[i] = vs[i] or eng.advance() or eng.tail_alarm()
    vs = [v or eng.advance(run_over=True)
          for v, eng in zip(vs, (host, dev, ref))]
    assert vs[1] == vs[2]
    assert (vs[0] is None) == (vs[1] is None)
    if vs[0] is not None:
        assert vs[0]["op"] == vs[1]["op"]
        assert vs[0]["settled-returns"] == vs[1]["settled-returns"]
    else:
        np.testing.assert_array_equal(dev.host_set(), host.R)
    one = reach_pt.check(m_pt.cas_register(), hist, device="cpu")
    assert (vs[1] is None) == (one["valid"] is True)


def test_geometry_growth_reencodes_carry():
    """Fresh values (memo rebuild) and a third process (slot growth)
    mid-stream reseed the carry from the re-encoded host set; verdicts
    as the reference's."""
    from jepsen_tpu_torch.op import invoke, ok
    ops1 = [invoke(0, "write", 1), ok(0, "write", 1),
            invoke(1, "read"), ok(1, "read", 1)]
    ops2 = [invoke(0, "write", 9), ok(0, "write", 9),
            invoke(2, "write", 3), invoke(1, "read"),
            ok(1, "read", 9), ok(2, "write", 3),
            invoke(0, "read"), ok(0, "read", 3)]
    ops3 = [invoke(1, "read"), ok(1, "read", 777)]
    eng = ses_pt.DeviceFrontierEngine(m_pt.register(), device="cpu")
    ref = ses_ref.DeviceFrontierEngine(fx_ref.model_for("register"))
    eng.feed_many(ops1)
    ref.feed_many(_ref_ops(ops1))
    assert eng.advance() is None and ref.advance() is None
    carry1 = eng._carry
    eng.feed_many(ops2)
    ref.feed_many(_ref_ops(ops2))
    assert eng.advance() is None and ref.advance() is None
    assert eng._carry is not carry1 and eng.W == ref.W == 2
    np.testing.assert_array_equal(eng.host_set(), ref._carry.fetch())
    eng.feed_many(ops3)
    ref.feed_many(_ref_ops(ops3))
    v = eng.advance(run_over=True)
    assert v is not None and v == ref.advance(run_over=True)


def test_tail_alarm_marks_the_violation():
    from jepsen_tpu_torch.op import invoke, ok
    blk = [invoke(9, "write", 7),            # forever pending
           invoke(0, "write", 1), ok(0, "write", 1),
           invoke(1, "read"), ok(1, "read", 2)]   # reads a ghost
    eng = ses_pt.DeviceFrontierEngine(m_pt.register(), device="cpu")
    ref = ses_ref.DeviceFrontierEngine(fx_ref.model_for("register"))
    eng.feed_many(blk)
    ref.feed_many(_ref_ops(blk))
    assert eng.advance() is None
    v = eng.tail_alarm()
    assert v["tail-alarm"] is True and v["valid"] is False
    assert ref.advance() is None and v == ref.tail_alarm()
    assert eng.advance() is v                    # permanent


def test_session_engines_want_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ses_pt.DeviceFrontierEngine(m_pt.register())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ses_pt.TxnSessionEngine()
    with pytest.raises(ValueError):
        cyc_pt.inc_join(torch.zeros((1, 32, 1), dtype=torch.int32),
                        torch.zeros((1, 40, 1), dtype=torch.int32),
                        torch.zeros((1, 32, 1), dtype=torch.int32))
    assert issubclass(ses_pt.SessionClosed, RuntimeError)
    assert issubclass(ses_pt.AdvanceAborted, RuntimeError)
    assert issubclass(ses_pt.TenantSessionCap, RuntimeError)


# -- incremental inference -------------------------------------------------

def _txn_hists(n, keys, processes, seed, block=None):
    out = []
    for fx, hm in ((fx_pt, h_pt), (fx_ref, h_ref)):
        hist = fx.gen_txn_history(n, keys=keys, processes=processes,
                                  seed=seed)
        if block is not None:
            hist = hist + [op.with_(index=-1)
                           for op in fx.txn_anomaly_block(block)]
        out.append(hm.index(hist))
    assert [o.to_dict() for o in out[0]] == [o.to_dict() for o in out[1]]
    return out


@pytest.mark.parametrize("block", [None, "G-single", "G0", "write-skew"])
def test_incremental_infer_matches_reference(block):
    """Block by block the port's edge and commit-order deltas are the
    reference's; at close the graph, counters, direct anomalies and
    intervals are, and the edge set maps onto the post-hoc one."""
    hp, hr = _txn_hists(50, 4, 6, 11, block)
    inc, ref = inf_pt.IncrementalInfer(), inf_ref.IncrementalInfer()
    for i in range(0, len(hp), 37):
        inc.feed_block(hp[i:i + 37])
        ref.feed_block(hr[i:i + 37])
        for a, b in zip(inc.drain_new_edges() + inc.drain_new_cm(),
                        ref.drain_new_edges() + ref.drain_new_cm()):
            np.testing.assert_array_equal(a, b)
        assert inc.pending_reads() == ref.pending_reads()
    inc.resolve_stragglers()
    ref.resolve_stragglers()
    g, gr = inc.graph(), ref.graph()
    assert g.n == gr.n and g.counters == gr.counters
    assert list(g.direct) == list(gr.direct)
    for a, b in ((g.src, gr.src), (g.dst, gr.dst), (g.et, gr.et)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(inc.intervals(), ref.intervals()):
        np.testing.assert_array_equal(a, b)
    if not g.direct:
        txns, fails = txn_pt.ops.collect(hp)
        post = inf_pt.infer(txns, fails)
        pidx = {t.index: t.tid for t in post.txns}
        mapped = {(pidx[g.txns[u].index], pidx[g.txns[v].index], t)
                  for u, v, t in zip(g.src.tolist(), g.dst.tolist(),
                                     g.et.tolist())}
        assert mapped == set(zip(post.src.tolist(), post.dst.tolist(),
                                 post.et.tolist()))


# -- the incremental closure -----------------------------------------------

def _inc_blocks(seed, steps=7, lattice=False):
    rng = np.random.RandomState(seed)
    edges = []
    for step in range(steps):
        n = 5 + step * 9                       # regrows past Np = 32
        k = rng.randint(3, 12)
        new = [(int(rng.randint(0, n)), int(rng.randint(0, n)),
                int(rng.randint(0, 4 if lattice else 3))) for _ in range(k)]
        fresh = [e for e in new if e[0] != e[1] and e not in set(edges)]
        edges.extend(fresh)
        yield n, fresh, list(edges)


def _arrs(fresh):
    return (np.asarray([e[0] for e in fresh], np.int32),
            np.asarray([e[1] for e in fresh], np.int32),
            np.asarray([e[2] for e in fresh], np.int32))


@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("seed", [3, 9])
def test_incremental_closure_against_reference(lattice, seed):
    """Block by block at K = 3 and K = 4: the carried words equal the
    reference's word body's bit for bit, the booleans equal the
    reference's, the f32 cross-check's and (serializable) the host
    SCC's, across regrowths; the counters are the reference's."""
    clo = cyc_pt.IncrementalClosure(lattice=lattice, device="cpu")
    ref = cyc_ref.IncrementalClosure(lattice=lattice)
    C = A = None
    with obs.capture() as cap:
        for n, fresh, edges in _inc_blocks(seed, lattice=lattice):
            src, dst, et = _arrs(fresh)
            got = clo.add_block(n, src, dst, et)
            assert got == ref.add_block(n, src, dst, et), n
            for a, b in zip((clo._Cw, clo._CwT, clo._Arw_w),
                            (ref._Cw, ref._CwT, ref._Arw_w)):
                np.testing.assert_array_equal(
                    a.numpy(), np.asarray(b).view(np.int32))
            ops = [torch.as_tensor(x) for x in cyc_pt.block_operands(
                src, dst, et, clo.Np, lattice)]
            C, A, f = cyc_pt.inc_update_f32(C, A, clo.Np, *ops,
                                            clo.contracts)
            assert [bool(x) for x in f] == list(got.values())
            if not lattice:
                g = DepGraph(n=n, src=np.asarray([e[0] for e in edges]),
                             dst=np.asarray([e[1] for e in edges]),
                             et=np.asarray([e[2] for e in edges], np.int8),
                             txns=())
                assert got == host_pt.classify_booleans(g)
    assert clo.Np == 64 and clo.updates == 7
    c = cap.counters
    assert c["txn.closure.incremental"] == c[
        "txn.closure.incremental_word"] == 7
    assert c["txn.closure.regrow"] == 1
    assert c.get("txn.lattice.incremental", 0) == (7 if lattice else 0)


def test_f32_cross_check_against_reference():
    """``inc_update_f32`` against the reference's ``_inc_call`` on the
    same carried masks, block by block (the lattice stack)."""
    import jax.numpy as jnp
    C = A = None
    Cr = Ar = None
    for n, fresh, _ in _inc_blocks(5, steps=3, lattice=True):
        src, dst, et = _arrs(fresh)
        Np = 32
        ops = cyc_pt.block_operands(src, dst, et, Np, True)
        C, A, f = cyc_pt.inc_update_f32(C, A, Np, *map(torch.as_tensor, ops),
                                        cyc_pt.LATTICE_CONTRACTS)
        if Cr is None:
            Cr = jnp.zeros((4, Np, Np), jnp.float32)
            Ar = jnp.zeros((Np, Np), jnp.float32)
        Cr, Ar, fr = cyc_ref._inc_call(
            Np, len(ops[4]), len(ops[0]), 4, cyc_ref.LATTICE_CONTRACTS)(
            Cr, Ar, *map(jnp.asarray, ops))
        np.testing.assert_array_equal(C.numpy(), np.asarray(Cr))
        np.testing.assert_array_equal(f.numpy(), np.asarray(fr))


def test_closure_overflow_and_session_route():
    clo = cyc_pt.IncrementalClosure(max_dense_txns=40, device="cpu")
    z = np.zeros(0, np.int32)
    clo.add_block(30, z, z, z)
    with pytest.raises(cyc_pt.ClosureOverflow):
        clo.add_block(41, z, z, z)
    # a session over the cap takes the host booleans, a recorded route
    hp, hr = _txn_hists(30, 3, 4, 5, "G-single")
    with obs.capture() as cap:
        eng = ses_pt.TxnSessionEngine(max_dense_txns=16, device="cpu")
        for i in range(0, len(hp), 40):
            eng.advance_block(hp[i:i + 40])
        res = eng.close_incremental()
    assert eng.host_mode
    routes = [d for d in cap.ledger if d["stage"] == "session-advance"]
    assert len(routes) == 1 and routes[0]["cause"].startswith("txn-overflow")
    ref = ses_ref.TxnSessionEngine(max_dense_txns=16)
    for i in range(0, len(hr), 40):
        ref.advance_block(hr[i:i + 40])
    assert res == ref.close_incremental()


# -- the txn session --------------------------------------------------------

@pytest.mark.parametrize("consistency", [None, "all", "serializable"])
@pytest.mark.parametrize("block", [None, "G-single", "G0", "write-skew",
                                   "session-mr"])
def test_txn_session_against_reference(consistency, block):
    """Per-block verdicts and holds, and the close verdict, equal the
    reference's session; the close booleans equal the post-hoc
    ``txn.check_history`` ones (on the CPU), and an invalid close names
    the post-hoc anomalies."""
    hp, hr = _txn_hists(40, 3, 4, 7, block)
    eng = ses_pt.TxnSessionEngine(consistency=consistency, device="cpu")
    ref = ses_ref.TxnSessionEngine(consistency=consistency)
    for i in range(0, len(hp), 24):
        v = eng.advance_block(hp[i:i + 24])
        assert v == ref.advance_block(hr[i:i + 24]), i
        assert eng.booleans == ref.booleans and eng.holds == ref.holds
        assert eng.in_flight() == ref.in_flight()
    res = eng.close_incremental()
    assert res == ref.close_incremental()
    kw = {} if consistency is None else {"consistency": consistency}
    post = txn_pt.check_history(hp, device="cpu", **kw)
    assert (res["valid"] is True) == (post["valid"] is True)
    if res.get("engine") == "session-txn":
        assert res["booleans"] == post["booleans"]
        if res["valid"] is False:
            assert res["anomalies"] == post["anomalies"]


# -- K9's plain version ------------------------------------------------------

def _numpy_join(Cw, thru, right_w):
    """The reference's ``_inc_word_call`` join in numpy (uint32):
    ``Cw | OR_k where(thru[:, :, k], right_w[:, k], 0)`` and the
    transposed update's ``OR_k where(right[:, k, j], thruT_w[:, k], 0)``,
    with thru bool [K, Np, d] and right_w uint32 [K, d, NW]."""
    K, Np, d = thru.shape
    add = np.bitwise_or.reduce(
        np.where(thru[..., None], right_w[:, None], np.uint32(0)), axis=2)
    right = np.unpackbits(right_w.view(np.uint8), axis=-1,
                          bitorder="little").reshape(K, d, Np) != 0
    thruT_w = np.packbits(thru.transpose(0, 2, 1), axis=-1,
                          bitorder="little").view(np.uint32)
    addT = np.bitwise_or.reduce(
        np.where(right.transpose(0, 2, 1)[..., None], thruT_w[:, None],
                 np.uint32(0)), axis=2)
    return add, addT, thruT_w


@pytest.mark.parametrize("seed", range(4))
def test_inc_join_plain_against_numpy_replay(seed):
    """K9's plain version, one call for both of the update's packings,
    against a numpy replay of the reference's join: ``A`` is ``thru``
    packed over the dirty columns and ``B`` ``right``'s transpose packed
    over its rows, so ``prod = thru·right``; then the port's whole word
    update against the reference's ``_inc_word_call`` on a block with
    duplicate edges and padded ``dsel``."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    K, Np, d = 3 + seed % 2, 64, [8, 40, 64, 16][seed]
    NW = Np // 32
    thru = rng.random((K, Np, d)) < 0.3
    thru[:, :, d // 2:] &= seed % 2 == 0        # padded columns, some runs
    right_w = rng.integers(0, 2**32, (K, d, NW), dtype=np.uint64) \
        .astype(np.uint32)
    Cw = rng.integers(0, 2**32, (K, Np, NW), dtype=np.uint64) \
        .astype(np.uint32)
    CwT = rng.integers(0, 2**32, (K, Np, NW), dtype=np.uint64) \
        .astype(np.uint32)
    add, addT, _thruT_w = _numpy_join(Cw, thru, right_w)
    t = torch.from_numpy
    right = np.unpackbits(right_w.view(np.uint8), axis=-1,
                          bitorder="little").reshape(K, d, Np) != 0
    A, B = t(_pack_np(thru)), t(_pack_np(right.transpose(0, 2, 1)))
    for fn in (cyc_pt.inc_join_plain, cyc_pt.inc_join):
        got, gotT = fn(A, B, t(Cw.view(np.int32)), t(CwT.view(np.int32)))
        np.testing.assert_array_equal(got.numpy().view(np.uint32), Cw | add)
        np.testing.assert_array_equal(gotT.numpy().view(np.uint32),
                                      CwT | addT)
        rows, none = fn(A, B, t(Cw.view(np.int32)), rows_only=True)
        assert none is None and torch.equal(rows, got)
    # the whole update: duplicate edges, dsel padded past the dirty set
    lattice = bool(seed % 2)
    e = 24
    src = rng.integers(0, 50, e).astype(np.int32)
    dst = (src + 1 + rng.integers(0, 40, e)).astype(np.int32) % 50
    src, dst = np.concatenate([src, src[:6]]), np.concatenate([dst, dst[:6]])
    if len(np.unique(np.concatenate([src, dst]))) in (16, 32):
        src, dst = np.append(src, 60), np.append(dst, 61)
    et = rng.integers(0, 4 if lattice else 3, len(src)).astype(np.int32)
    ops = cyc_pt.block_operands(src, dst, et, Np, lattice)
    assert (ops[4] < 0).any()                        # padded dsel
    K = 4 if lattice else 3
    contracts = cyc_pt.LATTICE_CONTRACTS if lattice else (1,)
    Cw0 = np.zeros((K, Np, NW), np.uint32)
    Cw0[:, 3, 0] = 1 << 7                         # carried closure bits
    Cw0[:, 7, 1] = 1 << 2
    CwT0 = np.zeros_like(Cw0)
    CwT0[:, 7, 0] = 1 << 3
    CwT0[:, 34, 0] = 1 << 7
    A0 = np.zeros((Np, NW), np.uint32)
    pt = cyc_pt.inc_update_word(t(Cw0.view(np.int32)),
                                t(CwT0.view(np.int32)),
                                t(A0.view(np.int32)),
                                *map(torch.as_tensor, ops), contracts)
    rf = cyc_ref._inc_word_call(Np, len(ops[4]), len(ops[0]), K,
                                contracts)(
        jnp.asarray(Cw0), jnp.asarray(CwT0), jnp.asarray(A0),
        *map(jnp.asarray, ops))
    for a, b in zip(pt[:3], rf[:3]):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))
    np.testing.assert_array_equal(pt[3].numpy(), np.asarray(rf[3]))


def _pack_np(bits):
    """bool [..., n] -> int32 [..., ceil(n / 32)], little bit order."""
    n = bits.shape[-1]
    bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, -n % 32)])
    return np.ascontiguousarray(np.packbits(
        bits, axis=-1, bitorder="little")).view(np.int32)


@pytest.mark.parametrize("K,M,N,KW", [(2, 40, 72, 1), (3, 96, 33, 2),
                                      (1, 64, 130, 8), (2, 48, 20, 256)])
def test_inc_join_plain_shapes(K, M, N, KW):
    """K9's contract at M != N and k axes of 1, 2, 8 and 256 words: the
    plain version (and the CPU wrapper) against the product written in
    numpy, both packings and the rows-only mode, with and without the
    old words."""
    rng = np.random.default_rng(M * N + KW)
    p = (0.5 / (32 * KW)) ** 0.5          # half a common bit a pair
    bits = [rng.random((K, r, 32 * KW)) < p for r in (M, N)]
    A, B = (_pack_np(x) for x in bits)
    prod = (bits[0].astype(np.int64) @ bits[1].transpose(0, 2, 1)
            .astype(np.int64)) > 0
    assert prod.any() and not prod.all()
    C = _pack_np(rng.random((K, M, N)) < 0.1)
    CT = _pack_np(rng.random((K, N, M)) < 0.1)
    t = torch.from_numpy
    for fn in (cyc_pt.inc_join_plain, cyc_pt.inc_join):
        out, outT = fn(t(A), t(B), t(C), t(CT))
        np.testing.assert_array_equal(out.numpy(), C | _pack_np(prod))
        np.testing.assert_array_equal(
            outT.numpy(), CT | _pack_np(prod.transpose(0, 2, 1)))
        bare, bareT = fn(t(A), t(B))
        np.testing.assert_array_equal(bare.numpy(), _pack_np(prod))
        np.testing.assert_array_equal(
            bareT.numpy(), _pack_np(prod.transpose(0, 2, 1)))
        rows, none = fn(t(A), t(B), t(C), rows_only=True)
        assert none is None and torch.equal(rows, out)


@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("width", [8, 40, 64, 128])
def test_inc_update_word_against_reference(width, lattice):
    """The whole word update (gathers and join on K9's plain version,
    the ladder on K8's) against the reference's ``_inc_word_call`` word
    for word, at dirty widths 8, 40, 64 and Np = 128, on carried words
    with both packings of one random graph."""
    import jax.numpy as jnp
    rng = np.random.default_rng(width + lattice)
    Np, K = 128, 4 if lattice else 3
    contracts = cyc_pt.LATTICE_CONTRACTS if lattice else (1,)
    mask = rng.random((K, Np, Np)) < 0.02
    Cw0, CwT0 = _pack_np(mask), _pack_np(mask.transpose(0, 2, 1))
    A0 = _pack_np(rng.random((Np, Np)) < 0.02)
    nodes = rng.permutation(Np)[:width].astype(np.int32)
    extra = rng.integers(0, width, (2, width))
    src = np.concatenate([nodes, nodes[extra[0]], nodes[:4]])
    dst = np.concatenate([np.roll(nodes, 1), nodes[extra[1]],
                          np.roll(nodes, 1)[:4]])
    et = rng.integers(0, 4 if lattice else 3, len(src)).astype(np.int32)
    ops = cyc_pt.block_operands(src, dst, et, Np, lattice)
    assert (ops[4] >= 0).sum() == width
    t = torch.from_numpy
    pt = cyc_pt.inc_update_word(t(Cw0), t(CwT0), t(A0),
                                *map(torch.as_tensor, ops), contracts)
    rf = cyc_ref._inc_word_call(Np, len(ops[4]), len(ops[0]), K,
                                contracts)(
        jnp.asarray(Cw0.view(np.uint32)), jnp.asarray(CwT0.view(np.uint32)),
        jnp.asarray(A0.view(np.uint32)), *map(jnp.asarray, ops))
    for a, b in zip(pt[:3], rf[:3]):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))
    np.testing.assert_array_equal(pt[3].numpy(), np.asarray(rf[3]))


def test_word_update_runs_no_bmm_and_no_float(monkeypatch):
    """``IncrementalClosure.add_block`` runs no matrix product and makes
    no floating-point tensor (every op it dispatches is watched), and a
    lattice ``TxnSessionEngine`` session runs to the reference's
    verdicts with ``torch.bmm`` raising."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops, self.dtypes = set(), set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops.add(func.overloadpacket.__name__)
            self.dtypes |= {x.dtype for x in tree_leaves(out)
                            if isinstance(x, torch.Tensor)}
            return out

    def boom(*a, **k):
        raise AssertionError("a matrix product in the word update")

    for name in ("bmm", "matmul", "mm"):
        monkeypatch.setattr(torch, name, boom)
        monkeypatch.setattr(torch.Tensor, name, boom)
    watch = Watch()
    clo = cyc_pt.IncrementalClosure(lattice=True, device="cpu")
    ref = cyc_ref.IncrementalClosure(lattice=True)
    for n, fresh, _edges in _inc_blocks(11, lattice=True):
        src, dst, et = _arrs(fresh)
        with watch:
            got = clo.add_block(n, src, dst, et)
        assert got == ref.add_block(n, src, dst, et), n
    assert {"index_put_", "bitwise_or", "any"} <= watch.ops
    assert not {"bmm", "mm", "matmul", "baddbmm", "addmm"} & watch.ops
    assert not {torch.float16, torch.bfloat16, torch.float32,
                torch.float64} & watch.dtypes
    hp, hr = _txn_hists(40, 3, 4, 7, "write-skew")
    eng = ses_pt.TxnSessionEngine(consistency="all", device="cpu")
    ses = ses_ref.TxnSessionEngine(consistency="all")
    for i in range(0, len(hp), 24):
        assert eng.advance_block(hp[i:i + 24]) == \
            ses.advance_block(hr[i:i + 24]), i
    res = eng.close_incremental()
    assert res == ses.close_incremental() and res["valid"] is False

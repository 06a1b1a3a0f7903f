"""K10's module on the CPU (``checkers/reach_word.py``): the mega-group
advance's plain version, ``mega_walk_plain``, through
``advance_frontiers_mega`` over the port's carries, held against the
reference's ``advance_frontiers_mega`` over the reference's own carries
(its batched word walk where its carries take it, else its solo
advance) and against L solo ``FrontierCarry.advance`` calls of the port:
every lane's exact dead return and its final set, on ragged blocks, with
injected violations and crashed ops, at K1's and K4's route geometries
and L = 1, 2 and 37. Also the geometry key (the op bucket equals the
reference's), the identity steps of the padding, the launch/collect
split, and the wrapper's refusal of a device it does not take.
"""
import contextlib
import struct

import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.checkers import reach_word as rw_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import events as ev_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_lane as rl_pt
from jepsen_tpu_torch.checkers import reach_pallas as rp_pt
from jepsen_tpu_torch.checkers import reach_word as rw_pt

torch.set_num_threads(1)

# (label, gen_history kwargs, the carry's route)
GEOMS = [("cas", {}, "reach-lane"),
         ("wide cas", dict(values=40), "reach-pallas")]


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


def _stream(kw, seed, n_ops, corrupt=False, crash_p=0.0):
    """One history in both packages, its port prep and return stream,
    and the reference's memo (the same table, from a cold cache)."""
    hists = []
    for fx in (fx_pt, fx_ref):
        h = fx.gen_history("cas", n_ops=n_ops, processes=5, seed=seed,
                           crash_p=crash_p, **kw)
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


def _seed(memo, M):
    R0 = np.zeros((memo.n_states, M), bool)
    R0[0, 0] = True
    return R0


def _ref_carry(memo_r, W, M, R0):
    S = memo_r.n_states
    return reach_ref.FrontierCarry(
        None, W, M, R0, table=memo_r.table,
        p_build=lambda: reach_ref._build_P(memo_r, S))


def _lanes(L, kw, n_ops=240):
    """L lanes, each its own history (every third corrupted, every
    fifth with crashed ops) cut into ragged blocks; all lanes share one
    memo geometry only when their alphabets do, so each lane keeps its
    own stream and carry."""
    lanes = []
    for i in range(L):
        memo_p, memo_r, rs, M = _stream(
            kw, seed=100 + i, n_ops=n_ops, corrupt=i % 3 == 1,
            crash_p=0.01 if i % 5 == 4 else 0.0)
        lanes.append((memo_p, memo_r, rs, M))
    return lanes


def _cuts(n, rng, waves):
    cuts = sorted(rng.choice(np.arange(1, n), size=min(waves - 1, n - 1),
                             replace=False))
    bounds = [0] + list(cuts) + [n]
    return [(bounds[k], bounds[k + 1]) for k in range(len(bounds) - 1)]


@pytest.mark.parametrize("L", [1, 2, 37])
@pytest.mark.parametrize("label,kw,engine", GEOMS, ids=[g[2] for g in GEOMS])
def test_mega_walk_plain_against_solo_and_reference(label, kw, engine, L):
    """Wave by wave: the port's group advance (``mega_walk_plain`` on
    every lane's P), the port's solo advances and the reference's group
    advance (or its solo one where its carries are dense) give each lane
    the same exact dead return, advanced returns and final set."""
    if L == 37 and engine == "reach-pallas":
        L = 9                       # the wide plain walk's time grows
    rng = np.random.RandomState(L)
    lanes = _lanes(L, kw, n_ops=160 if engine == "reach-pallas" else 240)
    groups = {}
    for i, (memo_p, memo_r, rs, M) in enumerate(lanes):
        W = M.bit_length() - 1
        R0 = _seed(memo_p, M)
        solo = reach_pt.FrontierCarry(memo_p, W, R0, device="cpu")
        mega = reach_pt.FrontierCarry(memo_p, W, R0, device="cpu")
        ref = _ref_carry(memo_r, W, M, R0)
        groups.setdefault(rw_pt.mega_geometry(mega), []).append(
            (i, solo, mega, ref, _cuts(rs.n_returns, rng, 4), rs))
    # a short wide history may stay within 32 states: its lane then
    # groups on K1's route
    assert engine in {g[0] for g in groups} and None not in groups
    n_dead = 0
    for geom, members in groups.items():
        ref_geoms = {rw_ref.mega_geometry(m[3]) for m in members}
        for w in range(4):
            live = [m for m in members if w < len(m[4])]
            if not live:
                continue
            blocks = [(m[5].ret_slot[m[4][w][0]:m[4][w][1]],
                       m[5].slot_ops[m[4][w][0]:m[4][w][1]]) for m in live]
            d_mega = rw_pt.advance_frontiers_mega([m[2] for m in live],
                                                  blocks)
            d_solo = [m[1].advance(*b) for m, b in zip(live, blocks)]
            if None not in ref_geoms and len(ref_geoms) == 1:
                d_ref = rw_ref.advance_frontiers_mega(
                    [m[3] for m in live], blocks)
            else:
                d_ref = [m[3].advance(*b) for m, b in zip(live, blocks)]
            assert d_mega == d_solo == d_ref, (geom, w)
            for m in live:
                assert m[2].advanced_returns == m[1].advanced_returns \
                    == m[3].advanced_returns
                np.testing.assert_array_equal(
                    (m[2]._R.numpy() > 0.5).T[:m[2].S],
                    np.asarray(m[3].fetch()))
                assert torch.equal(m[2]._R, m[1]._R)
            n_dead += sum(d >= 0 for d in d_mega)
    if L > 2:
        assert n_dead > 0           # the corrupted lanes died


def test_padding_is_identity_and_deaths_stay_in_their_lane():
    """Direct operands: one lane walks 3 returns in a wave padded to 40
    and more and keeps its set; a lane dying at its last real return
    reports that index, never one from the padding; a lane with no
    returns reports -1 and keeps its seed; an empty seed dies at 0. Each
    final set lands in its lane's out buffer, the sets untouched."""
    memo_p, _r, rs, M = _stream({}, seed=7, n_ops=200, corrupt=True)
    W = M.bit_length() - 1
    carry = reach_pt.FrontierCarry(memo_p, W, _seed(memo_p, M), device="cpu")
    probe = reach_pt.FrontierCarry(memo_p, W, _seed(memo_p, M), device="cpu")
    dead_at = probe.advance(rs.ret_slot, rs.slot_ops)
    assert dead_at > 0
    n = [3, dead_at + 1, 0, 2]
    R0 = [carry._R.clone() for _ in range(4)]
    R0[3] = torch.zeros_like(R0[3])
    lanes = [rw_pt.MegaLane(carry._P, carry._T, r, memo_p.n_ops, True)
             for r in R0]
    blocks = [(rs.ret_slot[:k], rs.slot_ops[:k]) for k in n]
    stage = rw_pt.stage_blocks([ln.packed for ln in lanes], blocks, W)
    ret, _ops = stage.padded()
    assert ret.shape == (4, dead_at + 1) and (ret[0, 3:] == -1).all()
    dead = rw_pt.mega_walk(lanes, stage, narrow=True)
    assert dead.tolist() == [-1, dead_at, -1, 0]
    solo = reach_pt.FrontierCarry(memo_p, W, _seed(memo_p, M), device="cpu")
    assert solo.advance(rs.ret_slot[:3], rs.slot_ops[:3]) == -1
    assert torch.equal(lanes[0].out, solo._R)
    assert not lanes[1].out.any() and not lanes[3].out.any()
    assert torch.equal(lanes[2].out, R0[2])
    assert all(ln.R is r for ln, r in zip(lanes, R0))
    assert torch.equal(R0[0], carry._R)


def test_geometry_key_is_the_reference_op_bucket():
    """The carry pads P's op axis to the reference's bucket
    ``_pad_pow2(O + 1, 8)`` with all-zero rows (the last the sentinel);
    the torch walk's carry joins no group; the tables are built once, at
    the seed, from the padded P."""
    memo_p, memo_r, _rs, M = _stream({}, seed=3, n_ops=300)
    W = M.bit_length() - 1
    R0 = _seed(memo_p, M)
    carry = reach_pt.FrontierCarry(memo_p, W, R0, device="cpu")
    ref = _ref_carry(memo_r, W, M, R0)
    O1 = rw_ref._pad_pow2(memo_p.n_ops + 1, 8)
    assert carry.mega_sig == ("reach-lane", 8, W, O1)
    assert rw_ref.mega_geometry(ref)[1] == O1
    assert carry._P.shape == (O1, 8, 8)
    assert not carry._P[memo_p.n_ops:].any()
    assert torch.equal(carry._T, rl_pt.image_tables_plain(carry._P))


def test_torch_walk_carry_joins_no_group(monkeypatch):
    monkeypatch.setattr(rl_pt, "lane_fits", lambda *a: False)
    monkeypatch.setattr(rp_pt, "fits", lambda *a: False)
    memo_p, _r, _rs, M = _stream({}, seed=3, n_ops=60)
    carry = reach_pt.FrontierCarry(memo_p, M.bit_length() - 1,
                                   _seed(memo_p, M), device="cpu")
    assert carry.engine == "reach" and rw_pt.mega_geometry(carry) is None
    with pytest.raises(ValueError, match="geometry"):
        rw_pt.launch_frontiers_mega([carry], [(np.zeros(1, np.int32),
                                               np.zeros((1, 1), np.int32))])


def test_launch_collect_split_and_counts():
    """``launch_frontiers_mega`` then ``collect_frontiers_mega`` is
    ``advance_frontiers_mega`` and the solo carry's ``advance``; the
    group counts ``reach.mega_walk`` once a
    launch, and the CPU never counts a launch of K10."""
    memo_p, _r, rs, M = _stream({}, seed=11, n_ops=200)
    W = M.bit_length() - 1
    mk = lambda: reach_pt.FrontierCarry(memo_p, W, _seed(memo_p, M),  # noqa
                                        device="cpu")
    a, b, c = mk(), mk(), mk()
    blk = (rs.ret_slot[:50], rs.slot_ops[:50])
    before = rw_pt.KERNEL_LAUNCHES
    with obs.capture() as cap:
        inf = rw_pt.launch_frontiers_mega([a, b], [blk, blk])
        deads = rw_pt.collect_frontiers_mega(inf)
    assert cap.counters.get("reach.mega_walk") == 1
    assert rw_pt.KERNEL_LAUNCHES == before
    assert deads == [c.advance(*blk)] * 2
    assert torch.equal(a._R, c._R) and a.advanced_returns == 50
    assert rw_pt.collect_frontiers_mega(
        rw_pt.launch_frontiers_mega([], [])) == []


def test_wrapper_refuses_other_devices():
    """``mega_walk`` on lanes whose tensors lie on neither the CPU nor the
    card raises ValueError (the meta device)."""
    memo_p, _r, rs, M = _stream({}, seed=2, n_ops=40)
    W = M.bit_length() - 1
    carry = reach_pt.FrontierCarry(memo_p, W, _seed(memo_p, M), device="cpu")
    meta = [t.to("meta") for t in (carry._P, carry._T, carry._R)]
    lane = rw_pt.MegaLane(*meta, memo_p.n_ops, True)
    stage = rw_pt.stage_blocks([lane.packed], [(rs.ret_slot[:1],
                                              rs.slot_ops[:1])], W)
    with pytest.raises(ValueError, match="unsupported device"):
        rw_pt.mega_walk([lane], stage, narrow=True)


def _union_seeded(n=8):
    """Seed the reference's superset memo as its ``check_many`` does,
    over ``n`` packed cas histories; returns a snapshot of the seeds."""
    packed = [h_ref.pack(fx_ref.gen_history("cas", n_ops=300, processes=5,
                                            seed=40 + s)) for s in range(n)]
    reach_ref._seed_union_memo(fx_ref.model_for("cas"), packed, 100_000)
    assert reach_ref._SUPERSET_SEEDS
    return dict(reach_ref._SUPERSET_SEEDS)


# histories whose reference table the seeded union memo numbers
# differently from a fresh build
@pytest.mark.parametrize("seed,n_ops", [(2, 40), (5, 30)])
def test_stream_tables_equal_after_a_union_memo_was_seeded(seed, n_ops):
    """The reference's union memo seeded in this process first (as any
    earlier ``check_many`` on the worker leaves it): ``_stream`` still
    finds both packages' tables equal element for element, and the
    reference's seed dict after it is exactly as it was."""
    with _cold_memos():                 # this test's own seeds go after
        seeds = _union_seeded()
        memo_p, memo_r, _rs, _M = _stream({}, seed=seed, n_ops=n_ops)
        assert reach_ref._SUPERSET_SEEDS == seeds
        assert all(reach_ref._SUPERSET_SEEDS[k] is v
                   for k, v in seeds.items())
    np.testing.assert_array_equal(memo_p.table, memo_r.table)



@pytest.mark.parametrize("seed,n_ops", [(2, 40), (5, 30)])
def test_stream_tables_equal_after_a_port_union_memo_was_seeded(seed,
                                                                 n_ops):
    """The port's union memo seeded first, as its ``check_many`` leaves
    it on a worker: ``_stream`` still finds both packages' tables equal
    element for element, and the port's seeds after it are as they
    were."""
    packed = [h_pt.pack(fx_pt.gen_history("cas", n_ops=300, processes=5,
                                          seed=40 + s)) for s in range(8)]
    with _cold_memos():                 # this test's own seeds go after
        reach_pt._seed_union_memo(m_pt.cas_register(), packed, 100_000)
        seeds = dict(reach_pt._SUPERSET_SEEDS)
        assert seeds
        memo_p, memo_r, _rs, _M = _stream({}, seed=seed, n_ops=n_ops)
        assert reach_pt._SUPERSET_SEEDS == seeds
    np.testing.assert_array_equal(memo_p.table, memo_r.table)

# -- K10's host side: the lane handles and the staging -------------------------

def _per_lane_fill(blocks, W):
    """The padded stream built a lane at a time, as a straightforward
    reading of the layout."""
    L = len(blocks)
    lens = [len(rs) for rs, _ in blocks]
    R_pad = max(lens) if lens else 0
    rs = np.full((L, R_pad), -1, np.int32)
    so = np.full((L, R_pad, W), -1, np.int32)
    for i, (b_rs, b_so) in enumerate(blocks):
        rs[i, :lens[i]] = b_rs
        so[i, :lens[i]] = np.asarray(b_so).reshape(lens[i], W)
    return rs, so


@pytest.mark.parametrize("L", [1, 2, 37])
def test_staging_equals_the_per_lane_fill(L):
    """The staged wave (descriptors, offsets and the ragged stream in one
    buffer) expands to exactly the padded layout a lane-at-a-time fill
    makes, on blocks of 0 to R_pad returns; its counts, offsets, rows and
    the shared slices' cap follow from the lanes."""
    rng = np.random.RandomState(L)
    W, R_pad = 3, 23
    lens = rng.randint(0, R_pad + 1, L)
    lens[rng.randint(L)] = R_pad
    if L > 1:
        lens[rng.randint(L)] = 0
    blocks = [(rng.randint(-1, W, n).astype(np.int32),
               rng.randint(-1, 20, (n, W)).astype(np.int32)) for n in lens]
    rows = [(8 * i, 8 * i + 1, 8 * i + 2, 5 + i % 7, 99) for i in range(L)]
    st = rw_pt.stage_blocks([struct.pack("<5q", *r) for r in rows], blocks,
                            W)
    want_rs, want_so = _per_lane_fill(blocks, W)
    got_rs, got_so = st.padded()
    np.testing.assert_array_equal(got_rs, want_rs)
    np.testing.assert_array_equal(got_so, want_so)
    assert st.R_pad == R_pad and st.n.tolist() == lens.tolist()
    assert st.off.tolist() == [0] + np.cumsum(lens).tolist()
    np.testing.assert_array_equal(st.desc, np.array(rows, np.int64))
    assert st.cap == max(min(r[3], W * n) for r, n in zip(rows, lens))
    np.testing.assert_array_equal(
        st.ret, np.concatenate([b[0] for b in blocks]))


def test_lane_handle_refuses_bad_operands():
    """A lane handle checks its operands once, when it is made or its set
    is rebound: device, type, shape and contiguity; its row holds the
    three addresses, and ``swap`` exchanges set and out."""
    memo_p, _r, _rs, M = _stream({}, seed=3, n_ops=120)
    W = M.bit_length() - 1
    c = reach_pt.FrontierCarry(memo_p, W, _seed(memo_p, M), device="cpu")
    P, T, R = c._P, c._T, c._R
    mk = lambda *a: rw_pt.MegaLane(*a, memo_p.n_ops, True)  # noqa: E731
    with pytest.raises(ValueError):
        mk(P, T, R.to("meta"))                       # another device
    with pytest.raises(ValueError):
        mk(P, T.to(torch.int64), R)                  # type
    with pytest.raises(ValueError):
        mk(P, T, R.double())
    with pytest.raises(ValueError):
        mk(P, T[:-1], R)                             # shape
    with pytest.raises(ValueError):
        mk(P, T, R[:-1])
    with pytest.raises(ValueError):
        mk(P, T, torch.zeros(R.shape[1], R.shape[0]).T)   # contiguity
    with pytest.raises(ValueError):
        rw_pt.MegaLane(P, T, R, P.shape[0], True)    # the sentinel row
    lane = mk(P, T, R)
    assert lane.row[:3] == (T.data_ptr(), R.data_ptr(), lane.out.data_ptr())
    assert lane.packed == struct.pack("<5q", *lane.row)
    with pytest.raises(ValueError):
        lane.rebind(torch.zeros((M // 2, R.shape[1])))
    lane.swap()
    assert lane.R is not R and lane.out is R
    assert lane.row[1:3] == (lane.R.data_ptr(), R.data_ptr())
    assert lane.packed == struct.pack("<5q", *lane.row)
    with pytest.raises(ValueError, match="int32"):   # int64 blocks
        rw_pt.stage_blocks([lane.packed], [(np.zeros(3, np.int64),
                                            np.zeros((3, W), np.int32))], W)


def test_solo_advance_between_waves_is_walked_from_its_new_set():
    """A carry advanced alone between two group advances (its set
    replaced, its lane rebound) is walked by the next wave from that new
    set: every lane's dead returns, set and count equal a carry advanced
    alone through the same blocks, and the reference's."""
    memo_p, memo_r, rs, M = _stream({}, seed=12, n_ops=400)
    W = M.bit_length() - 1
    rng = np.random.RandomState(5)
    members = []
    for i in range(3):
        R0 = _seed(memo_p, M)
        if i == 2:
            R0 |= rng.random_sample(R0.shape) < 0.05
        members.append((reach_pt.FrontierCarry(memo_p, W, R0, device="cpu"),
                        reach_pt.FrontierCarry(memo_p, W, R0, device="cpu"),
                        _ref_carry(memo_r, W, M, R0),
                        _cuts(rs.n_returns, rng, 3)))

    def blk(m, w):
        lo, hi = m[3][w]
        return rs.ret_slot[lo:hi], rs.slot_ops[lo:hi]

    def wave(ms, w):
        d = rw_pt.advance_frontiers_mega([m[0] for m in ms],
                                         [blk(m, w) for m in ms])
        for m, dm in zip(ms, d):
            assert dm == m[1].advance(*blk(m, w)) == m[2].advance(*blk(m, w))
            ln = m[0].lane                       # the row K10 reads
            assert ln.row[1:3] == (m[0]._R.data_ptr(), ln.out.data_ptr())

    wave(members, 0)
    moved = members[1]
    before = moved[0].lane.row
    assert moved[0].advance(*blk(moved, 1)) == \
        moved[1].advance(*blk(moved, 1)) == moved[2].advance(*blk(moved, 1))
    assert moved[0].lane.row[1] != before[1]     # the lane was rebound
    assert moved[0].lane.row[1] == moved[0]._R.data_ptr()
    wave([m for m in members if m is not moved], 1)
    wave(members, 2)
    for m in members:
        assert m[0].advanced_returns == m[1].advanced_returns \
            == m[2].advanced_returns
        assert torch.equal(m[0]._R, m[1]._R)
        np.testing.assert_array_equal(m[0].fetch(), m[2].fetch())

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


def _stream(kw, seed, n_ops, corrupt=False, crash_p=0.0):
    """One history in both packages, its port prep and return stream,
    and the reference's memo (the same table)."""
    hists = []
    for fx in (fx_pt, fx_ref):
        h = fx.gen_history("cas", n_ops=n_ops, processes=5, seed=seed,
                           crash_p=crash_p, **kw)
        hists.append(fx.corrupt(h, seed=seed) if corrupt else h)
    memo_p, stream_p, _T, _S, M = reach_pt._prep(
        m_pt.cas_register(), h_pt.pack(hists[0]), max_states=100_000,
        max_slots=20, max_dense=1 << 22)
    memo_r, _s, _T, _S, M_r = reach_ref._prep(
        fx_ref.model_for("cas"), h_ref.pack(hists[1]), max_states=100_000,
        max_slots=20, max_dense=1 << 22)
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
    """Direct operands: one lane walks 3 returns padded to 40 with
    identity steps and keeps its set; a lane dying at its last real
    return reports that index, never one from the padding; a lane with
    no returns reports -1 and keeps its seed; an empty seed dies at 0."""
    memo_p, _r, rs, M = _stream({}, seed=7, n_ops=200, corrupt=True)
    W = M.bit_length() - 1
    carry = reach_pt.FrontierCarry(memo_p, W, _seed(memo_p, M), device="cpu")
    probe = reach_pt.FrontierCarry(memo_p, W, _seed(memo_p, M), device="cpu")
    dead_at = probe.advance(rs.ret_slot, rs.slot_ops)
    assert dead_at > 0
    n = [3, dead_at + 1, 0, 2]
    R_pad = 40 + dead_at
    ret = np.full((4, R_pad), -1, np.int32)
    ops = np.full((4, R_pad, W), -1, np.int32)
    for i, k in enumerate(n):
        ret[i, :k] = rs.ret_slot[:k]
        ops[i, :k] = rs.slot_ops[:k]
    R0 = [carry._R.clone() for _ in range(4)]
    R0[3] = torch.zeros_like(R0[3])
    final, dead = rw_pt.mega_walk(
        [carry._P] * 4, [carry._T] * 4, R0, torch.as_tensor(ret),
        torch.as_tensor(ops), n, narrow=True)
    assert dead.tolist() == [-1, dead_at, -1, 0]
    solo = reach_pt.FrontierCarry(memo_p, W, _seed(memo_p, M), device="cpu")
    assert solo.advance(rs.ret_slot[:3], rs.slot_ops[:3]) == -1
    assert torch.equal(final[0], solo._R)
    assert not final[1].any() and not final[3].any()
    assert torch.equal(final[2], R0[2])


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
    memo_p, _r, rs, M = _stream({}, seed=2, n_ops=40)
    W = M.bit_length() - 1
    carry = reach_pt.FrontierCarry(memo_p, W, _seed(memo_p, M), device="cpu")
    ret = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    ops = torch.zeros((1, 1, W), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rw_pt.mega_walk([carry._P], [carry._T], [carry._R], ret, ops, [1],
                        narrow=True)

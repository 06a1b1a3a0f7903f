"""The lockstep batch walk (kernel K2's module) against the reference, on
the CPU.

The reference's Pallas batch kernel runs in interpret mode at B=32 in
float32; the port's ``batch_walk`` runs its plain PyTorch version, which
the CUDA kernel is held against bit for bit on the card by
``chip_smoke.py``. Operands are built as the reference's own batch tests
build them (``reach._keyed_operands``, one shared alphabet). Every
comparison is exact: the config sets are 0/1 and the indices integers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu.checkers import events as ev_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.checkers import reach_batch as rb_ref
from jepsen_tpu.history import pack
from jepsen_tpu.op import invoke, ok
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_batch as rb_pt
from jepsen_tpu_torch.checkers import reach_lane as lane_pt

# tiny tensors: one thread each keeps the parallel test workers from
# crowding each other's cores
torch.set_num_threads(1)

B = 32


def _operands(kind, hists):
    """Per-history streams over the union alphabet: ``(P, ret_slots,
    slot_ops, M)``."""
    model = fx_ref.model_for(kind)
    reach_ref._MEMO_CACHE.clear()
    packed = [pack(h) for h in hists]
    preps = [reach_ref._prep(model, p, max_states=100_000, max_slots=20,
                             max_dense=1 << 22) for p in packed]
    W = max(max(p[1].W, 1) for p in preps)
    rss = [ev_ref.returns_view(p[1]) for p in preps]
    P, ret_flat, ops_flat, _key, off, _wide = reach_ref._keyed_operands(
        model, packed, rss, list(range(len(packed))), W, 100_000)
    n = len(packed)
    return (P, [ret_flat[off[k]:off[k + 1]] for k in range(n)],
            [ops_flat[off[k]:off[k + 1]] for k in range(n)], 1 << W)


def _hists(kind, sizes, corrupt=(), processes=4):
    out = []
    for s, n in enumerate(sizes):
        h = fx_ref.gen_history(kind, n_ops=n, processes=processes, seed=s)
        out.append(fx_ref.corrupt(h, seed=s) if s in corrupt else h)
    return out


def _reference_walk(args, n_pass, Mp):
    P, ops, rs, R0 = (a.numpy() for a in args)
    R_pad, H = rs.shape
    S = P.shape[1]
    W = ops.size // (R_pad * H)
    run = rb_ref._batch_call(B, W, Mp, S, H, P.shape[0], R_pad, n_pass,
                             True, "float32")
    ck, fin = run(jnp.asarray(ops), jnp.asarray(rs), jnp.asarray(P),
                  jnp.asarray(R0))
    return np.asarray(ck), np.asarray(fin)


@pytest.mark.parametrize("kind,sizes,corrupt,n_pass", [
    ("cas", (90, 40, 130), (1,), None),       # ragged lanes, one dead
    ("cas", (90, 40, 130), (), 2),            # the capped ladder
    ("register", (60, 100), (0,), None),
    ("mutex", (160, 50, 90), (), 1)])
def test_plain_matches_pallas_interpret(kind, sizes, corrupt, n_pass):
    """ckpt and final of ``batch_walk_plain`` equal the reference kernel's
    ``_batch_call(B=32, ..., interpret=True, dtype="float32")``."""
    P, rs, ops, M = _operands(kind, _hists(kind, sizes, corrupt))
    geom, args, _ = rb_pt.pack_batch_operands(P, rs, ops, M, B=B,
                                              device="cpu")
    W, R_pad = geom[1], geom[6]
    n_pass = W if n_pass is None else n_pass
    ck, fin = rb_pt.batch_walk(*args, B, n_pass)
    ck_ref, fin_ref = _reference_walk(args, n_pass, M)
    assert R_pad // B >= 2                  # more than one checkpoint
    np.testing.assert_array_equal(ck.numpy(), ck_ref)
    np.testing.assert_array_equal(fin.numpy(), fin_ref)


@pytest.mark.parametrize("e_pad,density", [(4, 0.3), (2, 0.8)])
def test_plain_matches_pallas_interpret_seed_groups(e_pad, density):
    """Chunk-lockstep's phase-B shape: ``e_pad·M`` rows per lane, seeded
    with arbitrary sets; fire and projection stay inside each group of
    M rows."""
    P, rs, ops, M = _operands("cas", _hists("cas", (70, 110, 50)))
    _geom, args, _ = rb_pt.pack_batch_operands(P, rs, ops, M, B=B,
                                               device="cpu")
    H, S = len(rs), P.shape[1]
    R0 = np.random.default_rng(e_pad).random((e_pad * M, H * S)) < density
    args = args[:3] + (torch.as_tensor(R0.astype(np.float32)),)
    W = int(ops[0].shape[1])
    ck, fin = rb_pt.batch_walk(*args, B, W)
    ck_ref, fin_ref = _reference_walk(args, W, e_pad * M)
    assert fin.shape == (e_pad * M, H * S) and fin.any()
    np.testing.assert_array_equal(ck.numpy(), ck_ref)
    np.testing.assert_array_equal(fin.numpy(), fin_ref)


@pytest.mark.parametrize("kind,sizes,corrupt", [
    ("cas", (90, 60, 120, 40), (1, 2)),
    ("register", (90, 70), (0,)),
    ("mutex", (60, 90), ())])
def test_walk_returns_batch_matches_reference(kind, sizes, corrupt):
    """Per-lane dead indices equal the reference's lockstep walk."""
    P, rs, ops, M = _operands(kind, _hists(kind, sizes, corrupt))
    d_ref = rb_ref.walk_returns_batch(P, rs, ops, M, interpret=True)
    d_pt = rb_pt.walk_returns_batch(P, rs, ops, M, B=B, device="cpu")
    np.testing.assert_array_equal(d_pt, d_ref)
    assert (d_ref >= 0).sum() == len(corrupt)


def _deep_chain_history(depth: int):
    """A linearizable history whose first return can only fire as a
    ``depth``-long chain of pending ops."""
    h = [invoke(0, "write", 0), ok(0, "write", 0)]
    for p in range(depth - 1):
        h.append(invoke(p, "cas", (p, p + 1)))
    h.append(invoke(depth - 1, "read"))
    h.append(ok(depth - 1, "read", depth - 1))
    for p in range(depth - 1):
        h.append(ok(p, "cas", (p, p + 1)))
    return h


def test_capped_ladder_rescue(monkeypatch):
    """With the ladder capped at 2 passes the deep-chain lane falsely
    dies in the capped walk; the exact rescue revives it, and the truly
    dead lane keeps its index, in both packages."""
    monkeypatch.setattr(rb_ref, "_FAST_PASSES", 2)
    monkeypatch.setattr(rb_pt, "_FAST_PASSES", 2)
    hists = [_deep_chain_history(4),
             fx_ref.corrupt(fx_ref.gen_history("cas", n_ops=60, processes=3,
                                               seed=3), seed=3),
             fx_ref.gen_history("cas", n_ops=50, processes=3, seed=4)]
    P, rs, ops, M = _operands("cas", hists)
    assert M >= 16
    geom, args, _ = rb_pt.pack_batch_operands(P, rs, ops, M, B=B,
                                              device="cpu")
    _, capped = rb_pt.batch_walk(*args, B, 2)
    S = P.shape[1]
    assert not capped.view(M, 3, S)[:, 0].any()    # the capped walk dies
    d_ref = rb_ref.walk_returns_batch(P, rs, ops, M, interpret=True)
    d_pt = rb_pt.walk_returns_batch(P, rs, ops, M, B=B, device="cpu")
    np.testing.assert_array_equal(d_pt, d_ref)
    assert d_pt[0] == -1 and d_pt[1] >= 0 and d_pt[2] == -1


def test_refinement_is_one_k1_launch_a_dead_lane(monkeypatch):
    """Each dead lane's return is found by one K1 walk over its dying
    block, read from the walk's dead return: no torch returns walk
    runs, and the indices equal the reference's."""
    def no_torch_walk(*a, **k):
        raise AssertionError("the torch returns walk ran")

    walks = []
    lane_walk = lane_pt.lane_walk

    def counted(*a):
        walks.append(a[0].shape)
        return lane_walk(*a)

    monkeypatch.setattr(reach_pt, "_walk_returns", no_torch_walk)
    monkeypatch.setattr(lane_pt, "lane_walk", counted)
    P, rs, ops, M = _operands("cas", _hists("cas", (90, 60, 120, 40),
                                            (0, 2)))
    d_ref = rb_ref.walk_returns_batch(P, rs, ops, M, interpret=True)
    d_pt = rb_pt.walk_returns_batch(P, rs, ops, M, B=B, device="cpu")
    np.testing.assert_array_equal(d_pt, d_ref)
    assert (d_pt >= 0).sum() == 2 and len(walks) == 2


def test_refinement_without_a_death_raises():
    """A block whose K1 walk does not die is a fault, not a guess:
    ``_refine_dead`` raises on a valid history's first block."""
    P, rs, ops, _M = _operands("cas", _hists("cas", (60,), ()))
    W, S = ops[0].shape[1], P.shape[1]
    R0 = torch.zeros((1 << W, S))
    R0[0, 0] = 1.0
    with pytest.raises(RuntimeError, match="no death"):
        lane_pt._refine_dead(torch.as_tensor(P), W, rs[0], ops[0], R0, 0,
                             min(B, rs[0].shape[0]), B)


# -- the kernels' walk on P's nibble tables, in numpy --------------------------

def _bits_to_words(sets):
    """bool [..., S] as uint32 words [...]."""
    S = sets.shape[-1]
    return (sets.astype(np.uint64) << np.arange(S, dtype=np.uint64)).sum(
        -1).astype(np.uint32)


def _words_to_sets(words, S):
    return ((words[..., None] >> np.arange(S, dtype=np.uint32)) & 1) \
        .astype(np.float32)


def _table_walk(P, ret, ops, x0, n_pass, B):
    """One walk as K1 and K2 run it, on the image tables
    (``image_tables_plain``): mask m's set a word; per return up to
    ``min(c, n_pass)`` passes, each firing every slot j from the
    pass-start words, a free slot through the sentinel op's (all-zero)
    tables, its image gated by bit j of m, until a pass adds nothing;
    then the projection, and the walk stops at the first empty set.
    ``ret`` [R], ``ops`` [R, W], ``x0`` uint32 [M]. Returns ``(ckpt
    words [R // B, M], final words [M], dead)``."""
    T = lane_pt.image_tables_plain(torch.from_numpy(P)).numpy()
    Tu = T.view(np.uint32)[..., 0]                      # [O1, K, 16]
    O1, K, _ = Tu.shape
    R, W = ops.shape
    M = x0.shape[0]
    masks = np.arange(M)
    x = x0.copy()
    ckpt = np.zeros((R // B, M), np.uint32)
    dead = -1 if x.any() else 0
    for r in range(R if dead < 0 else 0):
        if r % B == 0:
            ckpt[r // B] = x
        o = np.where(ops[r] >= 0, ops[r], O1 - 1)
        for _ in range(min(int((ops[r] >= 0).sum()), n_pass)):
            acc = x.copy()
            for j in range(W):
                y = x[masks ^ (1 << j)]
                img = np.zeros(M, np.uint32)
                for k in range(K):
                    img |= Tu[o[j], k, (y >> np.uint32(4 * k)) & 15]
                acc |= np.where((masks >> j) & 1 == 1, img, np.uint32(0))
            grew = (acc != x).any()
            x = acc
            if not grew:                # the fixpoint: the rest are identity
                break
        if ret[r] >= 0:
            bit = 1 << int(ret[r])
            x = np.where(masks & bit, np.uint32(0), x[masks | bit])
            if not x.any():
                dead = r
                break
    return ckpt, x, dead


@pytest.mark.parametrize("kind,sizes,corrupt,n_pass,e_pad,values", [
    ("cas", (90, 40, 130), (1,), None, 1, 5),     # ragged lanes, one dead
    ("cas", (90, 40, 130), (), 2, 1, 5),          # the capped ladder
    ("cas", (70, 110, 50), (), None, 4, 5),       # four seed groups
    ("cas", (60, 80), (0,), None, 1, 12),         # S = 16: 4 lookups
    ("cas", (60, 80), (), None, 2, 25),           # S = 32: 8 lookups
    ("register", (60, 100), (0,), None, 1, 5),
    ("mutex", (160, 50, 90), (), 1, 1, 5)])
def test_table_walk_matches_batch_walk_plain(kind, sizes, corrupt, n_pass,
                                             e_pad, values):
    """The kernels' walk on the nibble tables (numpy, word by word, with
    the fixpoint exit and each lane gated by its own pending count)
    gives ``batch_walk_plain``'s checkpoints and final sets (the
    reference's batch-max gate), each seed group its own walk."""
    hists = [fx_ref.gen_history(kind, n_ops=n, processes=4, seed=s,
                                values=values) for s, n in enumerate(sizes)]
    hists = [fx_ref.corrupt(h, seed=s) if s in corrupt else h
             for s, h in enumerate(hists)]
    P, rs, ops, M = _operands(kind, hists)
    _geom, args, _ = rb_pt.pack_batch_operands(P, rs, ops, M, B=B,
                                               device="cpu")
    H, S, W = len(rs), P.shape[1], int(ops[0].shape[1])
    if e_pad > 1:
        R0 = np.random.default_rng(e_pad).random((e_pad * M, H * S)) < 0.3
        args = args[:3] + (torch.as_tensor(R0.astype(np.float32)),)
    n_pass = W if n_pass is None else n_pass
    ck, fin = rb_pt.batch_walk(*args, B, n_pass)
    R_pad = args[2].shape[0]
    ret_rh = args[2].numpy()
    ops_rhw = args[1].numpy().reshape(R_pad, H, W)
    x0 = _bits_to_words(args[3].numpy().reshape(e_pad, M, H, S) > 0.5)
    ck_w = np.zeros((R_pad // B, e_pad, M, H), np.uint32)
    fin_w = np.zeros((e_pad, M, H), np.uint32)
    for h in range(H):
        for e in range(e_pad):
            c, f, _ = _table_walk(P, ret_rh[:, h], ops_rhw[:, h],
                                  x0[e, :, h], n_pass, B)
            ck_w[:, e, :, h], fin_w[e, :, h] = c, f
    np.testing.assert_array_equal(
        _words_to_sets(ck_w, S).reshape(ck.shape), ck.numpy())
    np.testing.assert_array_equal(
        _words_to_sets(fin_w, S).reshape(fin.shape), fin.numpy())


@pytest.mark.parametrize("processes,values,seed,corrupt,n_pass", [
    (3, 5, 1, True, None), (3, 5, 2, False, None),
    (4, 25, 3, True, None),             # S = 32: 8 lookups
    (7, 5, 1, False, None),             # W = 7: K1's block form
    (6, 5, 4, True, 2)])                # a capped ladder
def test_table_walk_matches_lane_walk_plain(processes, values, seed,
                                            corrupt, n_pass):
    """The kernels' walk on the nibble tables gives ``lane_walk_plain``'s
    checkpoints, final set and dead return."""
    h = fx_ref.gen_history("cas", n_ops=120, processes=processes,
                           seed=seed, values=values)
    if corrupt:
        h = fx_ref.corrupt(h, seed=seed)
    P, rs, ops, M = _operands("cas", [h])
    R0 = np.zeros((P.shape[1], M), bool)
    R0[0, 0] = True
    args = lane_pt.operands_from_numpy(P, rs[0], ops[0], R0, B=B,
                                       device="cpu")
    W = int(ops[0].shape[1])
    n_pass = W if n_pass is None else n_pass
    ck, fin, dead = lane_pt.lane_walk(*args, B, n_pass)
    c, f, d = _table_walk(P, args[1].numpy(), args[2].numpy(),
                          _bits_to_words(args[3].numpy() > 0.5), n_pass, B)
    S = P.shape[1]
    assert d == int(dead[0])
    if n_pass == W:
        assert (d >= 0) == corrupt
    np.testing.assert_array_equal(_words_to_sets(c, S), ck.numpy())
    np.testing.assert_array_equal(_words_to_sets(f, S), fin.numpy())


def test_group_geom_pads_to_whole_blocks():
    assert rb_pt.group_geom(1, 32) == 32
    assert rb_pt.group_geom(100, 32) == 128
    assert rb_pt.group_geom(2295, 256) % 256 == 0
    assert rb_pt.group_geom(2295, 256) >= 2295


def test_batch_walk_routes_by_device(monkeypatch):
    """``batch_walk`` takes the plain version only for CPU tensors; any
    other device is the kernel's or an error, never the plain version."""
    calls = []
    monkeypatch.setattr(rb_pt, "batch_walk_plain",
                        lambda *a: calls.append("plain"))
    monkeypatch.setattr(rb_pt, "_batch_walk_cuda",
                        lambda *a: calls.append("cuda"))
    t = torch.zeros(1)
    rb_pt.batch_walk(t, t, t, t, 1, 1)
    assert calls == ["plain"]
    with pytest.raises(ValueError):
        rb_pt.batch_walk(t, t, t, torch.zeros(1, device="meta"), 1, 1)
    assert calls == ["plain"]

"""K3's walk on P's nibble image tables, on the CPU.

The keyed CUDA kernel (``csrc/keyed_walk.cu``) runs the table body of
``csrc/walk.cuh`` once a key. :func:`_keyed_table_walk` replays that
walk in numpy, word by word: from each key's one-hot seed, up to
``min(c, n_pass)`` Jacobi passes a return on the image tables, a free
slot skipped, stopping at the first pass that adds nothing, then the
projection, and the key stops at its first empty return. It is held
against the port's plain version (``reach_lane.keyed_walk_plain``,
which ``chip_smoke.py`` holds the kernel against on the card) and the
reference's Pallas keyed kernel in interpret mode: the ``dead`` indices
must be equal exactly.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu.checkers import events as ev_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.checkers import reach_lane as lane_ref
from jepsen_tpu.history import pack
from jepsen_tpu_torch.checkers import reach_lane as lane_pt

# tiny tensors: one thread each keeps the parallel test workers from
# crowding each other's cores
torch.set_num_threads(1)


def _operands(kind, n_keys, n_ops, processes, bad, values=5, crash_p=0.0):
    """The reference's flat keyed operands over the union alphabet:
    ``(P, ret, ops, key_id)``."""
    model = fx_ref.model_for(kind)
    reach_ref._MEMO_CACHE.clear()
    packed = []
    for k in range(n_keys):
        h = fx_ref.gen_history(kind, n_ops=n_ops, processes=processes,
                               seed=k, values=values, crash_p=crash_p)
        packed.append(pack(fx_ref.corrupt(h, seed=k) if k in bad else h))
    preps = [reach_ref._prep(model, p, max_states=100_000, max_slots=20,
                             max_dense=1 << 22) for p in packed]
    W = max(max(p[1].W, 1) for p in preps)
    rss = [ev_ref.returns_view(p[1]) for p in preps]
    P, ret, ops, key, _off, _wide = reach_ref._keyed_operands(
        model, packed, rss, list(range(n_keys)), W, 100_000)
    return P, ret, ops, key


def _keyed_table_walk(P, ret, ops, key_id, n_keys, n_pass):
    """Each key's walk as K3 runs it on the image tables
    (``image_tables_plain``): mask m's set one word; per return up to
    ``min(c, n_pass)`` passes, each firing every pending slot j from the
    pass-start words (a free slot skipped), its image the OR over the
    nibbles k of the partner's set of ``T[op, k, nibble k]``, gated by
    bit j of m, until a pass adds nothing; then the projection, and the
    key's walk stops at its first empty return. Returns ``dead``
    int[n_keys]: the flat index of that return, or -1."""
    T = lane_pt.image_tables_plain(torch.from_numpy(P)).numpy()
    Tu = T.view(np.uint32)[..., 0]                      # [O1, K, 16]
    K = Tu.shape[1]
    W = ops.shape[1]
    M = 1 << W
    masks = np.arange(M)
    lo, hi = lane_pt.key_runs(key_id, n_keys)
    dead = np.full(n_keys, -1)
    for k in range(n_keys):
        x = np.zeros(M, np.uint32)
        x[0] = 1                                        # mask 0, state 0
        for r in range(lo[k], hi[k]):
            pend = np.flatnonzero(ops[r] >= 0)
            for _ in range(min(len(pend), n_pass)):
                acc = x.copy()
                for j in pend:
                    y = x[masks ^ (1 << j)]
                    img = np.zeros(M, np.uint32)
                    for q in range(K):
                        img |= Tu[ops[r, j], q, (y >> np.uint32(4 * q)) & 15]
                    acc |= np.where((masks >> j) & 1 == 1, img, np.uint32(0))
                grew = (acc != x).any()
                x = acc
                if not grew:            # the fixpoint: the rest are identity
                    break
            if ret[r] >= 0:
                bit = 1 << int(ret[r])
                x = np.where(masks & bit, np.uint32(0), x[masks | bit])
                if not x.any():
                    dead[k] = r
                    break
    return dead


def _plain(P, ret, ops, key, n_keys, n_pass):
    t = [torch.as_tensor(np.ascontiguousarray(a, dt)) for a, dt in
         ((P, np.float32), (ret, np.int32), (ops, np.int32),
          (key, np.int32))]
    return lane_pt.keyed_walk_plain(*t, n_keys, n_pass).numpy()


def _all_agree(P, ret, ops, key, n_keys):
    """The replay, the port's plain version and the reference's
    interpret-mode kernel give the same ``dead``; returns it."""
    W = ops.shape[1]
    d_ref = lane_ref.walk_returns_keyed(P, ret, ops, key, n_keys, 1 << W,
                                        interpret=True)
    d_replay = _keyed_table_walk(P, ret, ops, key, n_keys, W)
    np.testing.assert_array_equal(d_replay, d_ref)
    np.testing.assert_array_equal(_plain(P, ret, ops, key, n_keys, W), d_ref)
    np.testing.assert_array_equal(
        lane_pt.walk_returns_keyed(P, ret, ops, key, n_keys, 1 << W,
                                   device="cpu"), d_ref)
    return d_ref


@pytest.mark.parametrize("kind,n_keys,processes,values,bad,crash_p,W,S", [
    ("cas", 6, 2, 3, {1}, 0.0, 2, 4),       # one nibble
    ("cas", 6, 3, 5, {0, 4}, 0.1, 8, 8),    # crashed ops: the block form
    ("cas", 5, 4, 12, {2}, 0.0, 4, 16),     # the independent suite's W
    ("cas", 3, 5, 25, {1}, 0.05, 5, 32),    # 8 lookups: the split pair
    ("cas", 4, 7, 5, {3}, 0.0, 6, 8),       # the block form
    ("register", 5, 3, 5, {0}, 0.0, 3, 8),
    ("mutex", 4, 3, 5, set(), 0.0, 2, 2)])
def test_keyed_table_walk_matches_plain_and_reference(
        kind, n_keys, processes, values, bad, crash_p, W, S):
    P, ret, ops, key = _operands(kind, n_keys, 30, processes, bad, values,
                                 crash_p)
    assert (ops.shape[1], P.shape[1]) == (W, S)
    d = _all_agree(P, ret, ops, key, n_keys)
    assert set(np.flatnonzero(d >= 0)) == bad


@pytest.mark.parametrize("n_pass", [1, 2])
def test_keyed_table_walk_capped_ladder(n_pass):
    """Under a cap below W the fixpoint exit keeps the plain version's
    sets: the same dead indices at ``n_pass`` 1 and 2."""
    P, ret, ops, key = _operands("cas", 6, 30, 4, {2}, crash_p=0.1)
    np.testing.assert_array_equal(
        _keyed_table_walk(P, ret, ops, key, 6, n_pass),
        _plain(P, ret, ops, key, 6, n_pass))


def test_key_with_no_returns():
    """A key with no returns in the stream reports -1."""
    P, ret, ops, key = _operands("cas", 4, 30, 3, {0, 3})
    key = np.where(key >= 2, key + 1, key)              # key 2: no returns
    d = _all_agree(P, ret, ops, key, 5)
    assert d[2] == -1 and d[0] >= 0 and d[4] >= 0


def test_key_dead_on_its_first_return():
    """A key whose first return projects on an op with no image from the
    seed state dies at that return, the others keep their verdicts."""
    P, ret, ops, key = _operands("cas", 4, 30, 3, set())
    lo, _hi = lane_pt.key_runs(key, 4)
    r0 = int(lo[2])
    empty = [o for o in range(P.shape[0] - 1) if not P[o, 0].any()]
    ops = ops.copy()
    ops[r0] = -1
    ops[r0, ret[r0]] = empty[0]
    d = _all_agree(P, ret, ops, key, 4)
    assert list(d) == [-1, -1, r0, -1]


def test_union_alphabet_beyond_shared_memory():
    """A union alphabet whose tables do not fit in shared memory beside
    the set and a stream chunk (K3 reads them from device memory): the
    keys' ops renumbered into copies of the alphabet, key k into copy
    ``k % n``, give the same dead indices as the alphabet itself."""
    P, ret, ops, key = _operands("cas", 8, 30, 3, {2, 5}, values=25)
    O = P.shape[0] - 1                                  # ops, sentinel apart
    n = -(-450 // O)
    P_big = np.concatenate([P[:-1]] * n + [P[-1:]])
    ops_big = np.where(ops >= 0, ops + (key[:, None] % n) * O, -1)
    W, S, O1 = ops.shape[1], P.shape[1], P_big.shape[0]
    assert S == 32 and not lane_pt.tables_shared(W, S, O1)
    assert lane_pt.lane_fits(S, 1 << W, O1 - 1)         # K3 takes it
    d = _all_agree(P_big, ret, ops_big, key, 8)
    np.testing.assert_array_equal(d, _plain(P, ret, ops, key, 8, W))
    assert set(np.flatnonzero(d >= 0)) == {2, 5}


@pytest.mark.parametrize("S,K", [(4, 1), (8, 2), (16, 4), (32, 8)])
def test_tables_scratch_is_k3s_table_shape(S, K):
    """``tables_scratch`` gives the ``T [O1, K, 16]`` words of one word an
    entry that ``jt_keyed_walk`` fills: the plain tables' shape."""
    P = np.zeros((7, S, S), np.float32)
    T = lane_pt.tables_scratch(7, S, "cpu")
    assert T.shape == (7, K, 16, 1) and T.dtype == torch.int32
    assert lane_pt.image_tables_plain(torch.from_numpy(P)).shape == T.shape


def test_key_runs():
    """``key_runs`` finds each key's run on the host; padding (-1) and
    keys with no returns give empty runs; a split run or an id past
    ``n_keys`` is refused."""
    key = np.array([0, 0, 2, 2, 2, 3, -1, -1], np.int32)
    lo, hi = lane_pt.key_runs(key, 5)
    assert list(lo) == [0, 0, 2, 5, 0] and list(hi) == [2, 0, 5, 6, 0]
    assert lo.dtype == hi.dtype == np.int32
    t_lo, t_hi = lane_pt._key_runs(torch.as_tensor(key), 5)
    assert t_lo.tolist() == list(lo) and t_hi.tolist() == list(hi)
    empty = lane_pt.key_runs(np.zeros(0, np.int32), 3)
    assert [list(a) for a in empty] == [[0, 0, 0], [0, 0, 0]]
    with pytest.raises(ValueError, match="contiguous"):
        lane_pt.key_runs(np.array([0, 1, 0]), 2)
    with pytest.raises(ValueError, match="contiguous"):
        lane_pt.key_runs(np.array([0, -1, 0]), 1)
    with pytest.raises(ValueError, match="out of range"):
        lane_pt.key_runs(np.array([0, 3]), 3)

"""The ablation kernels' body (K6 ``csrc/ablate_walk.cu`` and K7
``csrc/ablate_stream.cu``, both ``csrc/ablate.cuh``), replayed on the CPU.

:func:`replay` walks a variant in numpy as the kernels do: the bool sets
as one word a mask, an image as the OR of K nibble-table lookups (K6:
P's tables, as ``pack_tables`` builds them; K7: each return's tables
built from its streamed operand ``G``, or the masked OR over its row
words), the f32 sets as rows summed over s in order; the variant's exact
pass ladder (no fixpoint exit, no skipped pass), its slot order and its
projection (the bit move, or the product through ``PJ``), checkpoints
every B. Each replay is held against the port's plain version
(``ablate_walk_plain``, ``ablate_stream_plain``, which ``chip_smoke.py``
holds the kernels against on the card) and against the reference's
Pallas kernels (``make_call``, ``make_call_stream``) in TPU interpret
mode, exactly (tolerance 0: the sets are integers), on the valid,
corrupted and W = 3 histories of ``test_torch_ablate_lane.py``. The rest
pins the kernels' envelope (``fits``, ``stream_fits``), their layout in
shared memory and the rule that picks their form.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.checkers import reach_lane as lane_pt
from jepsen_tpu_torch.tools import ablate_lane as ab_pt
from tests.test_torch_ablate_lane import (ab_ref, group_operands,
                                          reference_outputs)

torch.set_num_threads(1)

SMEM = 227 * 1024


def _words(sets01: np.ndarray) -> np.ndarray:
    """0/1 rows ``[..., S]`` as uint32 state words."""
    S = sets01.shape[-1]
    bits = (sets01 > 0.5).astype(np.uint64) << np.arange(S, dtype=np.uint64)
    return bits.sum(-1).astype(np.uint32)


def _unpack(x: np.ndarray, S: int) -> np.ndarray:
    return ((x[:, None] >> np.arange(S, dtype=np.uint32)) & 1).astype(
        np.float32)


def _tables(rows: np.ndarray, K: int) -> np.ndarray:
    """Nibble image tables ``[n, K, 16]`` of ``n`` operands' row words
    ``rows [n, S]`` (row s: the target set of state s): entry ``[i, k,
    v]`` ORs the rows 4k + b over the set bits b of v."""
    n, S = rows.shape
    pad = np.zeros((n, 4 * K), np.uint32)
    pad[:, :S] = rows
    out = np.zeros((n, K, 16), np.uint32)
    v = np.arange(16)
    for b in range(4):
        out[:, :, ((v >> b) & 1) == 1] |= pad[:, b::4][:, :, None]
    return out


def _lookup(To: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The images of the sets ``y [M]`` under one operand's tables
    ``To [K, 16]``: K lookups a set, OR-ed."""
    img = np.zeros_like(y)
    for k in range(To.shape[0]):
        img |= To[k][(y >> np.uint32(4 * k)) & np.uint32(15)]
    return img


def _masked_or(rows: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The same images as the OR of the row words of y's set states."""
    img = np.zeros_like(y)
    for s in range(rows.shape[0]):
        img |= np.where((y >> np.uint32(s)) & np.uint32(1), rows[s],
                        np.uint32(0))
    return img


def _pass_count(n_pass, gates, c):
    passes = off = n_pass
    for g in gates:
        if c > off:
            passes += g
        off += g
    return passes


def replay(ret, R0, B, n_pass, gates, rep, order, rev_mask, table, PJ,
           operand, counts):
    """A walk as ``csrc/ablate.cuh`` runs it, in numpy. ``operand(k)``
    gives return k's ``(pending count, per-slot operand)``: for the bool
    body (rep 0) a function ``(j, y) -> images``, for f32 (rep 1 add, 2
    max) slot j's ``[S, S]`` block. Returns ``(ckpt, final)``."""
    R_pad = ret.shape[0]
    M, S = R0.shape
    W = M.bit_length() - 1
    masks = np.arange(M)
    ckpt = np.zeros((R_pad // B, M, S), np.float32)
    x = _words(R0) if rep == 0 else R0.astype(np.float32).copy()
    for k in range(R_pad):
        if k % B == 0:
            ckpt[k // B] = _unpack(x, S) if rep == 0 else x
        c, opnd = operand(k)
        for p in range(_pass_count(n_pass, gates, c)):
            rev = order == 1 or (order == 2 and p < 32
                                 and (rev_mask >> p) & 1)
            acc = x.copy()
            for j in (range(W - 1, -1, -1) if rev else range(W)):
                hb = ((masks >> j) & 1) == 1
                y = x[masks ^ (1 << j)]
                if rep == 0:
                    acc |= np.where(hb, opnd(j, y), np.uint32(0))
                    continue
                f = np.zeros((M, S), np.float32)
                G = opnd(j)
                for s in range(S):
                    f += y[:, s:s + 1] * G[s][None, :]
                merged = acc + f if rep == 1 else np.maximum(acc, f)
                acc = np.where(hb[:, None], merged, acc)
            x = acc
        js = int(ret[k])
        if table:
            pj = PJ[W if js < 0 else js]
            if rep == 0:
                x = np.bitwise_or.reduce(
                    np.where(pj != 0, x[None, :], np.uint32(0)), axis=1)
            else:
                v = np.zeros((M, S), np.float32)
                for m2 in range(M):
                    v += pj[:, m2:m2 + 1] * x[m2][None, :]
                x = v
        elif js >= 0:
            hb = ((masks >> js) & 1) == 1
            up = x[masks | (1 << js)]
            x = np.where(hb if rep == 0 else hb[:, None],
                         np.zeros_like(up), up)
        if counts:
            x = np.minimum(x, np.float32(1.0))
    return ckpt, (_unpack(x, S) if rep == 0 else x)


def walk_operand(P, ops, rep):
    """K6's operand: P's tables (``pack_tables``' entries), or P as f32,
    indexed by return k's ops, the sentinel for a free slot."""
    O1, S, _ = P.shape
    T = _tables(_words(P).reshape(O1, S), lane_pt.n_nibbles(S))

    def operand(k):
        o = ops[k]
        oo = np.where(o < 0, O1 - 1, o)
        if rep == 0:
            return int((o >= 0).sum()), lambda j, y: _lookup(T[oo[j]], y)
        return int((o >= 0).sum()), lambda j: P[oo[j]]
    return operand


def stream_operand(G, rep, masked=False):
    """K7's operand: return k's ``G [S, W·S]`` (widened to f32), as row
    words and their per-return tables (or the masked OR), or as f32
    blocks. No pending count: K7 runs no gates."""
    _R, S, WS = G.shape
    W = WS // S
    K = lane_pt.n_nibbles(S)

    def operand(k):
        g = G[k].astype(np.float32)
        if rep != 0:
            return 0, lambda j: g[:, j * S:(j + 1) * S]
        rows = _words(g.reshape(S, W, S).transpose(1, 0, 2))  # [W, S]
        if masked:
            return 0, lambda j, y: _masked_or(rows[j], y)
        tk = _tables(rows, K)
        return 0, lambda j, y: _lookup(tk[j], y)
    return operand


# one variant per kernel instance of K6: bool forward, by pass from a
# mask, the table projection, unroll 2, add, max; and two instances no
# variant of the ladder takes alone: "rev", the reversed bool body
# (_fire_bool_rev), and "cnt-tree-matmulproj", the f32 table projection
INSTANCES = ["v2-bool-blend", "alt-p3", "bool-matmulproj", "cgate-ladder-u2",
             "cnt-tree-blend", "maxnc-blend", "rev", "cnt-tree-matmulproj"]
STREAMS = ["bool-stream", "bool-stream-i8", "maxnc-stream"]


def _spec(name, W):
    """``(fire port, fire reference, proj, counts, unroll, n_pass,
    cgate)``."""
    if name == "rev":
        return (ab_pt._fire_bool_rev, ab_ref._fire_bool_rev, "blend", False,
                1, min(W, 5), ())
    if name == "cnt-tree-matmulproj":
        return (ab_pt._fire_counts_tree, ab_ref._fire_counts_tree, "matmul",
                True, 1, min(W, 5), ())
    fire, proj, counts, unroll, n_pass, cgate = ab_pt.spec(name, W)
    return (fire, ab_ref.VARIANTS[name][0], proj, counts, unroll, n_pass,
            cgate)


@lru_cache(maxsize=None)
def _walk_reference(name, group):
    geom, runs = group_operands(group)
    B, W, M, S, O1, R_pad = geom
    _f, fire_ref, proj, counts, unroll, n_pass, cgate = _spec(name, W)
    return reference_outputs(
        lambda: ab_ref.make_call(B, W, M, S, O1, R_pad, n_pass, fire_ref,
                                 proj, counts, unroll, cgate or 0),
        runs.values())


def _same(got, want, label):
    for a, b in zip(got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=label)


@pytest.mark.parametrize("group", ["w5", "w3"])
@pytest.mark.parametrize("name", INSTANCES)
def test_walk_replay_matches_plain_and_make_call(name, group):
    """K6's body replayed on P's tables (bool) or P as f32, with the
    variant's pass ladder, order and projection, equals the plain
    version and the reference's make_call on every history of the
    group, checkpoints and final set."""
    geom, runs = group_operands(group)
    B, W, M, S, O1, R_pad = geom
    fire, _fr, proj, counts, unroll, n_pass, cgate = _spec(name, W)
    rep, order, rev_mask = ab_pt._body(fire, counts, n_pass + sum(cgate))
    for (hist, (ret, ops, P, PJ, R0)), ref in zip(
            runs.items(), _walk_reference(name, group)):
        got = replay(ret, R0, B, n_pass, cgate, rep, order, rev_mask,
                     proj == "matmul", PJ, walk_operand(P, ops, rep), counts)
        plain = ab_pt.ablate_walk_plain(
            *(torch.as_tensor(a) for a in (P, ret, ops, PJ, R0)), B, n_pass,
            fire, proj, counts, unroll, cgate)
        _same(got, plain, f"{name} on {hist}: replay against plain")
        _same(got, ref, f"{name} on {hist}: replay against make_call")


@lru_cache(maxsize=None)
def _stream_reference(name, group):
    geom, runs = group_operands(group)
    B, W, M, S, O1, R_pad = geom
    fire, proj, counts, _u, n_pass = ab_ref.VARIANTS[name][:5]
    return reference_outputs(
        lambda: ab_ref.make_call_stream(
            B, W, M, S, O1, R_pad, min(W, 5) if n_pass is None else n_pass,
            fire, counts,
            g_dtype="int8" if proj == "stream-i8" else "float32"),
        runs.values())


@pytest.mark.parametrize("group", ["w5", "w3"])
@pytest.mark.parametrize("name", STREAMS)
def test_stream_replay_matches_plain_and_make_call_stream(name, group):
    """K7's body replayed on ``stream_operand``'s G: the bool variants on
    each return's tables built from its row words, and on the masked OR
    that the block form takes where the tables do not fit; maxnc on G's
    f32 blocks. Each equals the plain version and the reference's
    make_call_stream, in f32 and int8."""
    geom, runs = group_operands(group)
    B, W, M, S, O1, R_pad = geom
    fire, proj, counts, _u, n_pass, _g = ab_pt.spec(name, W)
    g_dtype = ab_pt._STREAM_DTYPE[proj]
    rep = ab_pt._body(fire, counts, n_pass)[0]
    for (hist, (ret, ops, P, PJ, R0)), ref in zip(
            runs.items(), _stream_reference(name, group)):
        G = ab_pt.stream_operand(torch.as_tensor(P), torch.as_tensor(ops),
                                 g_dtype)
        plain = ab_pt.ablate_stream_plain(torch.as_tensor(ret), G,
                                          torch.as_tensor(R0), B, n_pass,
                                          fire, counts)
        for masked in ((False, True) if rep == 0 else (False,)):
            got = replay(ret, R0, B, n_pass, (), rep, 0, 0, False, None,
                         stream_operand(G.numpy(), rep, masked), counts)
            label = f"{name} on {hist} (masked OR: {masked})"
            _same(got, plain, label + ": replay against plain")
            _same(got, ref, label + ": replay against make_call_stream")


def test_tables_are_pack_tables_entries():
    """The replay's tables of P equal the port's plain ``pack_tables``
    (``image_tables_plain``), and a return's tables built from G's row
    words equal P's tables of the slot's op: K7 builds what K6 reads."""
    geom, runs = group_operands("w5")
    _B, W, _M, S, O1, _R = geom
    ret, ops, P, _PJ, _R0 = runs["corrupted"]
    K = lane_pt.n_nibbles(S)
    T = _tables(_words(P), K)
    plain = lane_pt.image_tables_plain(torch.as_tensor(P)).numpy()
    np.testing.assert_array_equal(T, plain.view(np.uint32)[..., 0])
    G = ab_pt.stream_operand(torch.as_tensor(P), torch.as_tensor(ops))
    for k in (0, 5, 40):
        rows = _words(G[k].numpy().reshape(S, W, S).transpose(1, 0, 2))
        oo = np.where(ops[k] < 0, O1 - 1, ops[k])
        np.testing.assert_array_equal(_tables(rows, K), T[oo])


def _first_body_bytes(W, S, O1, counts, table=False, stream=False,
                      g_int8=False):
    """The shared memory of the kernels' first body (its ``layout``),
    written out here: the envelope ``fits`` and ``stream_fits`` keep."""
    M = 1 << W
    n = 2 * (-(-S * W * S * (1 if g_int8 else 4) // 16) * 16) if stream \
        else 0
    n += 4 * (2 * M * S if counts else 2 * M)
    if table:
        n += 4 * (W + 1) * M * M
    if not stream:
        n += 4 * (O1 * S * S if counts else O1 * S)
    elif not counts:
        n += 4 * W * S
    elif g_int8:
        n += 4 * S * W * S
    return n + 4 * 256 * (1 if stream else W + 1)


GRID_S = list(range(1, 33)) + [40, 64, 96, 128]
GRID_O1 = (1, 2, 23, 37, 442, 1000, 1600, 3000, 7000)


def test_fits_take_the_first_bodys_geometries():
    """``fits`` and ``stream_fits`` take exactly the geometries of the
    first body's formula, over a grid of W, S, O1, projection, counts
    and dtype; and wherever they do, the new layout fits in one block's
    shared memory (K7's bool warp form always with its tables, its ring
    at least two stages deep when it bulk-copies)."""
    taken = 0
    for W in range(1, 17):
        M = 1 << W
        for S in GRID_S:
            for counts in (False, True):
                for O1 in GRID_O1:
                    for proj in ("blend", "matmul"):
                        want = (counts or S <= 32) and _first_body_bytes(
                            W, S, O1, counts, proj == "matmul") <= SMEM
                        assert ab_pt.fits(W, M, S, O1, proj, counts) == want
                        if want:
                            taken += 1
                            assert ab_pt.walk_layout(
                                W, S, O1, counts, proj == "matmul")[2] <= SMEM
                for dt in (torch.float32, torch.int8):
                    i8 = dt == torch.int8
                    want = (counts or S <= 32) and _first_body_bytes(
                        W, S, 1, counts, stream=True, g_int8=i8) <= SMEM
                    assert ab_pt.stream_fits(W, M, S, counts, dt) == want
                    if want:
                        taken += 1
                        warp, n, tables, bulk, nb = ab_pt.stream_layout(
                            W, S, counts, i8)
                        assert nb <= SMEM and n >= (2 if bulk else 1)
                        assert tables or counts or not warp
    assert taken > 5000
    assert not ab_pt.fits(5, 31, 8, 23, "blend", False)        # M != 2^W
    assert not ab_pt.stream_fits(5, 32, 8, False, torch.float16)


def test_form_rule_on_its_boundaries():
    """The warp form at W <= 5 (bool while P's tables fit in shared
    memory, f32 at S = 8 and 16), the block form at W = 6; the tables in
    device memory when they do not fit beside the block form's set."""
    assert ab_pt.walk_layout(5, 8, 37, False)[:2] == (True, True)
    assert ab_pt.walk_layout(6, 8, 37, False)[:2] == (False, True)
    assert ab_pt.walk_layout(5, 32, 37, False, True)[:2] == (True, True)
    # 512 bytes of tables an op at S = 32: 400 ops fit, 450 do not
    assert ab_pt.walk_layout(5, 32, 400, False)[:2] == (True, True)
    assert ab_pt.walk_layout(5, 32, 450, False)[:2] == (False, False)
    for S, warp in ((4, False), (7, False), (8, True), (9, False),
                    (16, True), (32, False)):
        assert ab_pt.walk_layout(5, S, 37, True)[0] == warp, S
        assert ab_pt.stream_layout(5, S, True)[0] == warp, S
    assert not ab_pt.walk_layout(6, 8, 37, True)[0]
    assert ab_pt.stream_layout(5, 8, False)[:4] == (True, 8, True, True)
    assert ab_pt.stream_layout(6, 8, False)[:4] == (False, 8, True, True)
    # G of 3·1·3 = 9 int8 bytes a return: a per-thread copy, one stage
    assert ab_pt.stream_layout(1, 3, False, True)[1:4] == (1, True, False)
    assert ab_pt.describe(ab_pt.design(5, 8, 37, False), False) == \
        "warp tables=shared"
    assert ab_pt.describe(ab_pt.design(6, 8, 37, False, stream=True),
                          False) == "block ring=8 bulk tables"
    assert ab_pt.describe(ab_pt.design(5, 8, 37, True, stream=True),
                          True) == "warp ring=8 bulk"


@pytest.mark.parametrize("geom,want", [
    # K6, bool, warp form: tables 37·2·16·4, the projection table, a chunk
    ((5, 8, 37, False, True, False, False), 4736 + 24576 + 6144),
    # K6, bool, block form at W = 6: the set, tables, the table, a chunk
    ((6, 8, 37, False, True, False, False), 512 + 4736 + 114688 + 7168),
    # K6, bool, block form with the tables in device memory
    ((5, 32, 450, False, False, False, False), 256 + 6144),
    # K6, add, warp form: P as f32 and a chunk
    ((5, 8, 37, True, False, False, False), 37 * 256 + 6144),
    # K7, bool, warp form: 8 stages of 1,280 bytes, the barriers, row
    # words, two returns' tables, a chunk
    ((5, 8, 1, False, False, True, False), 8 * 1280 + 64 + 160 + 1280 + 512),
    # K7, max, int8, warp form: 8 stages of 320 bytes
    ((5, 8, 1, True, False, True, True), 8 * 320 + 64 + 512),
])
def test_smem_bytes_of_the_layout(geom, want):
    """``smem_bytes`` at six geometries, tables in and out of shared
    memory, K6 and K7: what ``jt_ablate_walk_smem`` and
    ``jt_ablate_stream_smem`` return (checked on the card by
    ``chip_smoke.py``), region by region."""
    assert ab_pt.smem_bytes(*geom) == want

"""K8's body (``csrc/txn_closure.cu``), replayed in numpy on the CPU.

K8 computes one squaring of the transactional closure on the single-bit
tensor cores: ``prod[b, i, k] = sum_w popcount(Cw[b, i, w] & CwT[b, k,
w]) > 0``, then ``Cw | pack_rows(prod)`` and ``CwT | pack_rows(prodᵀ)``.
:func:`replay` runs the kernel's maps block by block, as the card runs
them, for each of its two tile forms:

- the ring: which shared-memory byte each packed word of a stage goes
  to (``load_stage``: the 16-byte copies of the aligned path, a
  quarter-warp a core matrix, and the 4-byte copies of the others,
  zero past ``Np`` and ``NW``);
- the MMA: each warpgroup's A rows and the tile's B rows read back from
  those bytes through the ``wgmma`` descriptors (K-major, no swizzle:
  core matrices of 8 rows of 16 bytes, 128 bytes apart along K and 256
  along the rows), ANDed and popcounted over each 256-bit k-step;
- the counts in the accumulator layout (``d[4j + 2h + e]`` of lane
  ``(g, q)`` of warp ``w`` is row ``16w + g + 8h``, column ``8j + 2q +
  e``), and their ``> 0``;
- the epilogue: each lane's 8 bits of a row word, the quad's two
  xor-shuffles, the flags in shared memory, the row-packed words, and
  the transpose-packed words by the five butterfly stages of a 32 x 32
  block.

Each replay is held against the port's plain version
(``square_step_plain``, which ``chip_smoke.py`` holds the kernel against
on the card) and against one squaring of the reference's word body
(``jepsen_tpu/txn/cycles.py`` ``_lattice_word_call``: its ``any(... !=
0)`` over the word axis, the reference's ``_pack_rows``), and the
replayed ladder's verdict against the reference's whole program, exactly
(tolerance 0: every output is bits). The cases take ``CwT`` that is not
``Cw``'s transpose and saturated masks (every count up to ``Np``).
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.txn import cycles as cyc_ref
from jepsen_tpu_torch.txn import cycles as cyc_pt

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(cyc_pt.__file__), os.pardir, "csrc",
                   "txn_closure.cu")
SMEM_MAX = 227 * 1024


def _const(name: str) -> int:
    with open(SRC) as f:
        return int(re.search(rf"constexpr int {name} = (\d+)", f.read())
                   .group(1))


KS, RING = _const("KS"), _const("RING")      # k-steps a stage, ring slots
SW = 8 * KS                                  # words of a row a stage
FORMS = sorted(cyc_pt.SQUARE_TILES)


def _tile(form):
    BM, BN = cyc_pt.SQUARE_TILES[form]
    return BM, BN, 2 * BM                    # threads: 128 a warpgroup


# -- the ring -------------------------------------------------------------

def swz_off(row, j):
    """Byte offset of word ``j`` of row ``row`` in a tile of a stage: the
    128-byte swizzle (16-byte chunk ``j // 4`` at chunk ``(j // 4) ^ (row
    % 8)`` of the row's 128 bytes), as TMA writes it into a 1,024-byte
    aligned slot and as the 4-byte copies write it by hand."""
    return row * 128 + ((((j >> 2) ^ row) & 7) << 4) + (j & 3) * 4


def tma_box(words, r0, w0, rows, Np, NW):
    """A TMA box of ``rows`` rows x :data:`SW` words of one lane's words,
    zero past ``Np`` rows and ``NW`` words, in the slot's byte layout."""
    out = np.zeros(rows * SW, np.uint32)
    r = np.arange(rows)[:, None]
    j = np.arange(SW)[None, :]
    ok = (r0 + r < Np) & (w0 + j < NW)
    val = words[np.minimum(r0 + r, Np - 1), np.minimum(w0 + j, NW - 1)]
    out[swz_off(r, j) // 4] = np.where(ok, val, 0)
    return out


def copy_map(form):
    """The 4-byte copies' map (rows whose stride TMA cannot take): ``(row,
    word, byte offset in the slot, thread)`` for each word of a stage,
    the BM Cw rows first."""
    BM, BN, threads = _tile(form)
    c = np.arange((BM + BN) * SW)
    row, j = c // SW, c % SW
    off = np.where(row < BM, swz_off(row, j), BM * 128 + swz_off(row - BM, j))
    return np.stack([row, j, off, c % threads], 1)


def fill_slot(form, tma, cw, cwt, i0, k0, st, Np, NW):
    """A ring slot after stage ``st``'s copies, as ``uint32`` words: two
    TMA boxes, or the 4-byte copies."""
    BM, BN, _ = _tile(form)
    if tma:
        return np.concatenate([tma_box(cw, i0, st * SW, BM, Np, NW),
                               tma_box(cwt, k0, st * SW, BN, Np, NW)])
    slot = np.zeros((BM + BN) * SW, np.uint32)
    row, j, off, _t = copy_map(form).T
    g = np.where(row < BM, i0 + row, k0 + row - BM)
    w = st * SW + j
    ok = (g < Np) & (w < NW)
    src = np.where((row < BM)[:, None], cw[np.minimum(g, Np - 1)],
                   cwt[np.minimum(g, Np - 1)])
    slot[off // 4] = np.where(ok, src[np.arange(len(j)),
                                      np.minimum(w, NW - 1)], 0)
    return slot


def desc_rows(slot, start, kk, n):
    """``n`` rows of k-step ``kk`` read through a wgmma descriptor of the
    K-major 128-byte swizzle at byte ``start`` (1,024-byte aligned; the
    start advanced by 32 bytes a k-step, 1,024 bytes between 8-row
    atoms, the swizzle applied to the address): ``uint32 [n, 8]``."""
    r = np.arange(n)[:, None]
    u = np.arange(8)[None, :]
    off = start + r * 128 + ((((2 * kk + (u >> 2)) ^ r) & 7) << 4) + \
        (u & 3) * 4
    return slot[off // 4]


def _popc(x):
    x = x.astype(np.uint64)
    return np.unpackbits(x.view(np.uint8), axis=-1).reshape(
        x.shape + (64,)).sum(-1).astype(np.int64)


def schedule(tiles, grid, S):
    """The persistent blocks' stage sequences: for each block, ``(n,
    tile, stage, slot, parity)`` of its n-th stage, block ``x`` taking
    tiles ``x, x + grid, ..``."""
    out = []
    for x in range(min(grid, tiles)):
        mine = list(range(x, tiles, grid))
        out.append([(n, mine[n // S], n % S, n % RING, (n // RING) & 1)
                    for n in range(len(mine) * S)])
    return out


# -- the accumulators and the epilogue ------------------------------------

def acc_map(form):
    """Row and column of ``d[j]`` of each thread: ``[threads, BN / 2]``."""
    BM, BN, threads = _tile(form)
    t = np.arange(threads)[:, None]
    j = np.arange(BN // 2)[None, :]
    warp, lane = t // 32, t % 32
    g, q = lane // 4, lane % 4
    jj, h, e = j // 4, (j // 2) % 2, j % 2
    return 16 * warp + g + 8 * h, 8 * jj + 2 * q + e


def epilogue(form, count):
    """The flags ``uint32 [BM, BN / 32]`` from the tile's counts ``[BM,
    BN]`` as the kernel builds them: each lane's bits of a row word, OR
    over its quad by xor-shuffles 1 and 2, lane q = 0 storing."""
    BM, BN, threads = _tile(form)
    rows, cols = acc_map(form)
    d = count[rows, cols]                             # [threads, BN / 2]
    t = np.arange(threads)
    lane, warp = t % 32, t // 32
    g, q = lane // 4, lane % 4
    CW = BN // 32
    flags = np.zeros((BM, CW), np.uint32)
    for h in range(2):
        for c in range(CW):
            p = np.zeros(threads, np.uint32)
            for jj in range(4):
                for e in range(2):
                    bit = (d[:, 4 * (4 * c + jj) + 2 * h + e] != 0)
                    p |= bit.astype(np.uint32) << (8 * jj + 2 * q + e) \
                        .astype(np.uint32)
            for s in (1, 2):
                p = p | p[t ^ s]
            ra = 16 * warp + g + 8 * h
            flags[ra[q == 0], c] = p[q == 0]
    return flags


LO = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333,
      1: 0x55555555}


def butterfly(x):
    """Five shuffle stages on one warp's 32 words: lane l ends with bit
    r = bit l of word r."""
    lane = np.arange(32)
    x = x.astype(np.uint32).copy()
    for s in (16, 8, 4, 2, 1):
        lo = np.uint32(LO[s])
        hi = np.uint32(~LO[s] & 0xFFFFFFFF)
        y = x[lane ^ s]
        x = np.where(lane & s, (x & hi) | ((y & hi) >> np.uint32(s)),
                     (x & lo) | ((y & lo) << np.uint32(s)))
    return x


def replay(form, Cw, CwT):
    """One squaring by K8's maps in ``form``: ``(Cw_out, CwT_out)``."""
    K, Np, NW = Cw.shape
    BM, BN, _ = _tile(form)
    Cw = Cw.view(np.uint32)
    CwT = CwT.view(np.uint32)
    out, outT = Cw.copy(), CwT.copy()
    S = -(-NW // SW)
    tma = NW % 4 == 0
    for b in range(K):
        for i0 in range(0, Np, BM):
            for k0 in range(0, Np, BN):
                count = np.zeros((BM, BN), np.int64)
                for st in range(S):
                    slot = fill_slot(form, tma, Cw[b], CwT[b], i0, k0, st,
                                     Np, NW)
                    for kk in range(KS):
                        B = desc_rows(slot, BM * 128, kk, BN)
                        for wg in range(BM // 64):
                            A = desc_rows(slot, wg * 64 * 128, kk, 64)
                            count[64 * wg:64 * wg + 64] += _popc(
                                A[:, None, :] & B[None, :, :]).sum(-1)
                flags = epilogue(form, count)
                for r in range(BM):
                    for c in range(BN // 32):
                        gi, gw = i0 + r, (k0 >> 5) + c
                        if gi < Np and gw < NW:
                            out[b, gi, gw] |= flags[r, c]
                for rb in range(BM // 32):
                    for cb in range(BN // 32):
                        x = butterfly(flags[32 * rb:32 * rb + 32, cb])
                        gw = (i0 >> 5) + rb
                        for lane in range(32):
                            gk = k0 + 32 * cb + lane
                            if gk < Np and gw < NW:
                                outT[b, gk, gw] |= x[lane]
    return out.view(np.int32), outT.view(np.int32)


# -- cases ----------------------------------------------------------------

def _pack(a):
    return cyc_ref._pack_rows(a).view(np.int32)


def _operands(K, Np, kind, seed):
    """``(Cw, CwT)`` int32: sparse random lanes with an unrelated CwT,
    or saturated ones (every entry set: counts equal to Np)."""
    rng = np.random.default_rng(seed)
    if kind == "full":
        a = np.ones((K, Np, Np), bool)
        return _pack(a), _pack(a)
    p = {"sparse": 2.0 / Np, "dense": 0.5}[kind]
    a = rng.random((K, Np, Np)) < p
    b = rng.random((K, Np, Np)) < p
    return _pack(a), _pack(b)


def _reference_step(Cw, CwT):
    """One iteration of the reference's word body, its expression in
    ``jax.numpy`` on the reference's ``uint32`` words, packed by the
    reference's ``_pack_rows``."""
    a = jnp.asarray(Cw.view(np.uint32))
    b = jnp.asarray(CwT.view(np.uint32))
    prod = np.asarray(jnp.any((a[:, :, None, :] & b[:, None, :, :]) != 0,
                              axis=-1))
    return (Cw | _pack(prod), CwT | _pack(np.swapaxes(prod, 1, 2)))


CASES = [(K, Np, kind) for K in (1, 3, 4) for Np in (32, 64, 96, 256)
         for kind in ("sparse", "dense")] + \
    [(K, Np, "full") for K in (1, 3) for Np in (32, 96, 256)] + \
    [(1, 544, "sparse"), (1, 1024, "dense"), (1, 1024, "full")]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("K,Np,kind", CASES)
def test_replay_matches_plain_and_reference(form, K, Np, kind):
    Cw, CwT = _operands(K, Np, kind, seed=K * Np + len(kind))
    got = replay(form, Cw, CwT)
    plain = cyc_pt.square_step_plain(torch.from_numpy(Cw),
                                      torch.from_numpy(CwT))
    ref = _reference_step(Cw, CwT)
    for g, p, r in zip(got, plain, ref):
        np.testing.assert_array_equal(g, p.numpy())
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("K,Np", [(3, 32), (4, 64), (4, 96)])
def test_replayed_ladder_matches_reference_program(K, Np):
    rng = np.random.default_rng(Np)
    masks = np.zeros((K, Np, Np), bool)
    masks[0] = rng.random((Np, Np)) < 1.5 / Np
    for b in range(1, K):
        masks[b] = masks[b - 1] | (rng.random((Np, Np)) < 1.5 / Np)
    rw = rng.random((Np, Np)) < 1.5 / Np
    contracts = (1,) if K == 3 else cyc_ref.LATTICE_CONTRACTS
    Cw = cyc_ref._pack_rows(masks)
    CwT = cyc_ref._pack_rows(np.swapaxes(masks, 1, 2))
    Arw = cyc_ref._pack_rows(rw)
    want = np.asarray(cyc_ref._lattice_word_call(Np, K, contracts)(
        Cw, CwT, Arw))
    Cw, CwT = Cw.view(np.int32), CwT.view(np.int32)
    form = cyc_pt.square_form(Np)
    for _ in range(cyc_pt.n_iter(Np)):
        Cw, CwT = replay(form, Cw, CwT)
    got = cyc_pt.word_verdict(torch.from_numpy(Cw), torch.from_numpy(CwT),
                              torch.from_numpy(Arw.view(np.int32)),
                              contracts).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("form", FORMS)
def test_ring_copies_tile_the_slot(form):
    """Both load paths give a stage's words the same places: each word
    lands once, the slot has no gap, and the 4-byte copies put each word
    where the TMA box's swizzle does."""
    BM, BN, _ = _tile(form)
    row, j, off, _t = copy_map(form).T
    assert sorted(off) == list(range(0, (BM + BN) * SW * 4, 4))
    rng = np.random.default_rng(form)
    Np, NW = 512, 16
    cw = rng.integers(0, 1 << 32, (Np, NW), dtype=np.uint64).astype(
        np.uint32)
    cwt = rng.integers(0, 1 << 32, (Np, NW), dtype=np.uint64).astype(
        np.uint32)
    for i0, k0, st in ((0, 0, 0), (Np - BM // 2, Np - 32, 0)):
        np.testing.assert_array_equal(
            fill_slot(form, True, cw, cwt, i0, k0, st, Np, NW),
            fill_slot(form, False, cw, cwt, i0, k0, st, Np, NW))
    # the descriptor reads back each row's words in its own order
    r = np.arange(BM)[:, None]
    slot = fill_slot(form, True, cw, cwt, 0, 0, 0, Np, NW)
    got = np.concatenate([desc_rows(slot, 0, kk, BM) for kk in range(KS)],
                         1)
    j = np.arange(SW)[None, :]
    np.testing.assert_array_equal(
        got, np.where(j < NW, cw[r, np.minimum(j, NW - 1)], 0))


@pytest.mark.parametrize("tiles,grid,S", [(8192, 132, 8), (96, 132, 1),
                                          (768, 132, 1), (7, 3, 5)])
def test_persistent_schedule(tiles, grid, S):
    """Every tile runs once; a block's stage n reads slot n % RING in
    phase (n // RING) & 1, each slot's uses alternating phases; the slot
    refilled after stage n (with stage n + RING - 1) is the one stage n
    - 1 read, done by then, and at most RING - 1 stages are in flight."""
    seen = []
    for seq in schedule(tiles, grid, S):
        seen += sorted({t for _n, t, _s, _sl, _p in seq})
        uses = {}
        for n, _t, _st, slot, parity in seq:
            assert parity == uses.get(slot, 0) & 1
            uses[slot] = uses.get(slot, 0) + 1
            refill = n + RING - 1
            if refill < len(seq):
                assert seq[refill][3] == (n - 1) % RING
    assert sorted(seen) == list(range(tiles))


@pytest.mark.parametrize("form", FORMS)
def test_accumulator_map_covers_the_tile(form):
    BM, BN, _ = _tile(form)
    rows, cols = acc_map(form)
    cells = rows * BN + cols
    assert sorted(cells.ravel()) == list(range(BM * BN))


def store_map(form):
    """The epilogue's stores, warpgroup by warpgroup: ``(wg, row, word)``
    of each row-packed word (``it = wt + 128 u``: row ``64 wg + it //
    CW``, word ``it % CW``) and ``(wg, rb, cb, lane)`` of each transposed
    one (block ``blk = wi + 4 u``: ``rb = 2 wg + blk % 2``, ``cb = blk //
    2``)."""
    BM, BN, threads = _tile(form)
    CW = BN // 32
    rows, cols = [], []
    for t in range(threads):
        wg, wt, wi, lane = t // 128, t % 128, (t // 32) % 4, t % 32
        for u in range(64 * CW // 128):
            it = wt + 128 * u
            rows.append((wg, 64 * wg + it // CW, it % CW))
        for u in range(2 * CW // 4):
            blk = wi + 4 * u
            cols.append((wg, 2 * wg + blk % 2, blk // 2, lane))
    return rows, cols


@pytest.mark.parametrize("form", FORMS)
def test_epilogue_stores_cover_the_tile(form):
    """Each word of the tile is stored once, by the warpgroup whose rows
    hold its flags (so a warpgroup's own barrier orders the epilogue)."""
    BM, BN, _ = _tile(form)
    rows, cols = store_map(form)
    assert sorted((r, c) for _w, r, c in rows) == \
        [(r, c) for r in range(BM) for c in range(BN // 32)]
    assert all(r // 64 == wg for wg, r, _c in rows)
    assert sorted((rb, cb, ln) for _w, rb, cb, ln in cols) == \
        [(rb, cb, ln) for rb in range(BM // 32) for cb in range(BN // 32)
         for ln in range(32)]
    assert all(rb // 2 == wg for wg, rb, _c, _l in cols)


def test_butterfly_transposes():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 32, 32, dtype=np.uint64).astype(np.uint32)
    bits = (x[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    y = butterfly(x)
    np.testing.assert_array_equal(
        (y[:, None] >> np.arange(32, dtype=np.uint32)) & 1, bits.T)


def test_form_rule_and_tiles():
    """The big tile from 1,024 up, the small one below; each tile's ring
    and flags fit a block's shared memory, and the kernel launches
    exactly the tiles the wrapper names."""
    assert cyc_pt.square_form(32) == cyc_pt.square_form(992) == 0
    assert cyc_pt.square_form(1024) == cyc_pt.square_form(8192) == 1
    with open(SRC) as f:
        src = f.read()
    for form, (BM, BN) in cyc_pt.SQUARE_TILES.items():
        assert f"launch<{BM // 64}, {BN}>" in src
        assert RING * (BM + BN) * 128 + BM * (BN // 32 + 1) * 4 + 1024 \
            <= SMEM_MAX

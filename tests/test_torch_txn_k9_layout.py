"""K9's body (``csrc/txn_inc_join.cu``), replayed in numpy on the CPU.

K9 computes ``prod[b, i, j] = any_k (A[b, i, k] & B[b, j, k])`` over the
packed k words of ``A`` [K, M, KW] and ``B`` [K, N, KW] on the single-bit
tensor cores, then ``C | pack_rows(prod)`` and, unless it runs rows
only, ``CT | pack_rows(prodᵀ)``. :func:`replay` runs the kernel's maps
tile by tile, as the card runs them, for each of its two tile forms:

- the ring: the TMA boxes (zero past M, N and KW) or the 4-byte copies
  of the stage's k-steps only, the words past them left as whatever the
  slot held before (:func:`fill_slot` seeds it with noise);
- the k-steps a stage issues (``ksteps``: all four, or ``ceil(left /
  8)`` on a short or ragged last stage), each warpgroup's A rows and the
  tile's B rows read back through the K-major, 128-byte-swizzle
  descriptors, ANDed and popcounted;
- the epilogue: the counts in the accumulator layout, each quad's row
  word, and the 32 x 32 butterfly for the transposed words, stored only
  inside ``[M, OW]`` and ``[N, TW]``.

Each replay is held against the port's plain version
(``inc_join_plain``, which ``chip_smoke.py`` holds the kernel against on
the card) and against the product written directly in numpy, exactly
(every output is bits): ragged k axes (KW = 1, 2, 3, 4, 12, 36), the
rows-only mode, M != N with either side ragged against the tile and 32.
"""
import os
import re

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.txn import cycles as cyc_pt

SRC = os.path.join(os.path.dirname(cyc_pt.__file__), os.pardir, "csrc",
                   "txn_inc_join.cu")
SMEM_MAX = 227 * 1024


def _const(name: str) -> int:
    with open(SRC) as f:
        return int(re.search(rf"constexpr int {name} = (\d+)", f.read())
                   .group(1))


KS, RING = _const("KS"), _const("RING")      # k-steps a stage, ring slots
SW = 8 * KS                                  # words of a row a stage
FORMS = sorted(cyc_pt.SQUARE_TILES)
LO = {16: 0x0000FFFF, 8: 0x00FF00FF, 4: 0x0F0F0F0F, 2: 0x33333333,
      1: 0x55555555}


def _tile(form):
    BM, BN = cyc_pt.SQUARE_TILES[form]
    return BM, BN, 2 * BM                    # threads: 128 a warpgroup


def ksteps(KW, st):
    """The k-steps stage ``st`` issues: those that hold words."""
    left = KW - st * SW
    return KS if left >= SW else (left + 7) // 8


def swz_off(row, j):
    return row * 128 + ((((j >> 2) ^ row) & 7) << 4) + (j & 3) * 4


def fill_slot(form, tma, a, b, i0, k0, st, M, N, KW, rng):
    """A ring slot after stage ``st``'s copies (uint32 words): two TMA
    boxes of 32 words a row, zero past the operand; or the 4-byte copies
    of the stage's k-steps, ``c`` over ``(BM + BN) * 8 * ks`` words, the
    rest of the slot left as it was (noise here)."""
    BM, BN, threads = _tile(form)
    slot = rng.integers(0, 1 << 32, (BM + BN) * SW, dtype=np.uint64) \
        .astype(np.uint32)
    jw = SW if tma else 8 * ksteps(KW, st)
    c = np.arange((BM + BN) * jw)
    row, j = c // jw, c % jw
    in_a = row < BM
    g = np.where(in_a, i0 + row, k0 + row - BM)
    w = st * SW + j
    ok = (g < np.where(in_a, M, N)) & (w < KW)
    src = np.where(in_a, a[np.minimum(g, M - 1), np.minimum(w, KW - 1)],
                   b[np.minimum(g, N - 1), np.minimum(w, KW - 1)])
    off = np.where(in_a, swz_off(row, j), BM * 128 + swz_off(row - BM, j))
    assert len(np.unique(off)) == len(off)     # each word lands once
    slot[off // 4] = np.where(ok, src, 0)
    return slot


def desc_rows(slot, start, kk, n):
    """``n`` rows of k-step ``kk`` through a K-major 128-byte-swizzle
    wgmma descriptor at byte ``start``: ``uint32 [n, 8]``."""
    r = np.arange(n)[:, None]
    u = np.arange(8)[None, :]
    off = start + r * 128 + ((((2 * kk + (u >> 2)) ^ r) & 7) << 4) + \
        (u & 3) * 4
    return slot[off // 4]


def _popc(x):
    x = x.astype(np.uint64)
    return np.unpackbits(x.view(np.uint8), axis=-1).reshape(
        x.shape + (64,)).sum(-1).astype(np.int64)


def flags_of(form, count):
    """The flags ``uint32 [BM, BN / 32]`` from a tile's counts by the
    accumulator layout (``d[4j + 2h + e]`` of lane ``(g, q)`` of warp
    ``w`` is row ``16w + g + 8h``, column ``8j + 2q + e``) and the quad's
    two xor-shuffles."""
    BM, BN, threads = _tile(form)
    t = np.arange(threads)
    warp, lane = t // 32, t % 32
    g, q = lane // 4, lane % 4
    flags = np.zeros((BM, BN // 32), np.uint32)
    for h in range(2):
        for c in range(BN // 32):
            p = np.zeros(threads, np.uint32)
            for jj in range(4):
                for e in range(2):
                    bit = count[16 * warp + g + 8 * h,
                                8 * (4 * c + jj) + 2 * q + e] != 0
                    p |= bit.astype(np.uint32) << (8 * jj + 2 * q + e) \
                        .astype(np.uint32)
            for s in (1, 2):
                p = p | p[t ^ s]
            ra = 16 * warp + g + 8 * h
            flags[ra[q == 0], c] = p[q == 0]
    return flags


def butterfly(x):
    lane = np.arange(32)
    x = x.astype(np.uint32).copy()
    for s in (16, 8, 4, 2, 1):
        lo = np.uint32(LO[s])
        hi = np.uint32(~LO[s] & 0xFFFFFFFF)
        y = x[lane ^ s]
        x = np.where(lane & s, (x & hi) | ((y & hi) >> np.uint32(s)),
                     (x & lo) | ((y & lo) << np.uint32(s)))
    return x


def replay(form, A, B, C=None, CT=None, rows_only=False, seed=0):
    """One K9 launch by its maps in ``form``: ``(out, outT)``, int32."""
    K, M, KW = A.shape
    N = B.shape[1]
    BM, BN, _ = _tile(form)
    OW, TW = -(-N // 32), -(-M // 32)
    A, B = A.view(np.uint32), B.view(np.uint32)
    out = np.zeros((K, M, OW), np.uint32) if C is None else \
        C.view(np.uint32).copy()
    outT = np.zeros((K, N, TW), np.uint32) if CT is None else \
        CT.view(np.uint32).copy()
    S = -(-KW // SW)
    tma = KW % 4 == 0
    rng = np.random.default_rng(seed)
    for b in range(K):
        for i0 in range(0, M, BM):
            for k0 in range(0, N, BN):
                count = np.zeros((BM, BN), np.int64)
                for st in range(S):
                    slot = fill_slot(form, tma, A[b], B[b], i0, k0, st, M,
                                     N, KW, rng)
                    for kk in range(ksteps(KW, st)):
                        Bk = desc_rows(slot, BM * 128, kk, BN)
                        for wg in range(BM // 64):
                            Ak = desc_rows(slot, wg * 64 * 128, kk, 64)
                            count[64 * wg:64 * wg + 64] += _popc(
                                Ak[:, None, :] & Bk[None, :, :]).sum(-1)
                flags = flags_of(form, count)
                for r in range(BM):
                    for c in range(BN // 32):
                        gi, gw = i0 + r, (k0 >> 5) + c
                        if gi < M and gw < OW:
                            out[b, gi, gw] |= flags[r, c]
                if rows_only:
                    continue
                for rb in range(BM // 32):
                    for cb in range(BN // 32):
                        x = butterfly(flags[32 * rb:32 * rb + 32, cb])
                        gw = (i0 >> 5) + rb
                        for lane in range(32):
                            gk = k0 + 32 * cb + lane
                            if gk < N and gw < TW:
                                outT[b, gk, gw] |= x[lane]
    return out.view(np.int32), None if rows_only else outT.view(np.int32)


def _words(rng, shape, p):
    """int32 words of bits set with probability ``p``."""
    bits = rng.random(shape + (32,)) < p
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)) \
        .sum(-1).astype(np.uint32).view(np.int32)


def _numpy_product(A, B, C, CT):
    """The product written directly: ``any`` over the words, packed by
    ``np.packbits`` (little bit order) and ORed into C and CT."""
    prod = ((A.view(np.uint32)[:, :, None, :] & B.view(np.uint32)
             [:, None, :, :]) != 0).any(-1)

    def pack(bits):
        n = bits.shape[-1]
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, -n % 32)])
        return np.ascontiguousarray(np.packbits(
            bits, axis=-1, bitorder="little")).view(np.int32)

    return C | pack(prod), CT | pack(prod.transpose(0, 2, 1))


# (K, M, N, KW, density of A's bits): ragged k axes on both load paths,
# M != N ragged against the tiles and 32, a saturated case
CASES = [(1, 64, 64, 1, 0.3), (2, 96, 40, 2, 0.2), (1, 70, 130, 3, 0.1),
         (3, 64, 32, 4, 0.05), (2, 33, 100, 12, 0.02),
         (1, 130, 72, 36, 0.01), (1, 40, 264, 8, 1.0)]


@pytest.mark.parametrize("rows_only", [False, True])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("K,M,N,KW,p", CASES)
def test_replay_matches_plain_and_numpy(K, M, N, KW, p, form, rows_only):
    rng = np.random.default_rng(K * M + N * KW)
    A, B = _words(rng, (K, M, KW), p), _words(rng, (K, N, KW), p)
    C = _words(rng, (K, M, -(-N // 32)), 0.05)
    CT = None if rows_only else _words(rng, (K, N, -(-M // 32)), 0.05)
    got = replay(form, A, B, C, CT, rows_only, seed=KW)
    t = torch.from_numpy
    plain = cyc_pt.inc_join_plain(t(A), t(B), t(C),
                                  None if CT is None else t(CT), rows_only)
    want = _numpy_product(A, B, C, CT if CT is not None else
                          np.zeros((K, N, -(-M // 32)), np.int32))
    np.testing.assert_array_equal(got[0], plain[0].numpy())
    np.testing.assert_array_equal(got[0], want[0])
    if rows_only:
        assert got[1] is None and plain[1] is None
    else:
        np.testing.assert_array_equal(got[1], plain[1].numpy())
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("KW", [1, 2, 3, 7, 8, 9, 31, 32, 33, 64, 100])
def test_ksteps_cover_the_k_axis(KW):
    """The stages' k-steps hold every word of the k axis, and a k-step
    left out holds none: skipping it changes no count."""
    S = -(-KW // SW)
    words = [st * SW + 8 * kk + u for st in range(S)
             for kk in range(ksteps(KW, st)) for u in range(8)]
    assert set(range(KW)) <= set(words)
    assert all(w < KW + 7 for w in words)
    assert all(1 <= ksteps(KW, st) <= KS for st in range(S))


def test_zero_fill_ends_each_row():
    """A short k axis on the TMA path: the box's words past KW are zero,
    so the k-steps past ``ksteps`` add nothing; on the copy path the
    slot's words past the issued k-steps are never read."""
    rng = np.random.default_rng(3)
    for KW, tma in ((4, True), (12, True), (1, False), (3, False)):
        a = _words(rng, (64, KW), 0.5).view(np.uint32)
        b = _words(rng, (64, KW), 0.5).view(np.uint32)
        slot = fill_slot(0, tma, a, b, 0, 0, 0, 64, 64, KW, rng)
        ks = ksteps(KW, 0)
        got = np.concatenate([desc_rows(slot, 0, kk, 64)
                              for kk in range(ks)], 1)
        j = np.arange(8 * ks)
        np.testing.assert_array_equal(
            got, np.where(j[None, :] < KW, a[:, np.minimum(j, KW - 1)], 0))
        if tma:
            rest = np.concatenate([desc_rows(slot, 0, kk, 64)
                                   for kk in range(ks, KS)] or
                                  [np.zeros((64, 0), np.uint32)], 1)
            assert not rest.any()


def test_forms_and_envelope():
    """K9 takes K8's two tiles, picked by the longer side; each tile's
    ring and flags fit a block's shared memory; the entry point checks
    the limits the wrapper states."""
    assert cyc_pt.join_form(992, 32) == cyc_pt.join_form(64, 992) == 0
    assert cyc_pt.join_form(8192, 32) == cyc_pt.join_form(64, 1024) == 1
    with open(SRC) as f:
        src = f.read()
    for form, (BM, BN) in cyc_pt.SQUARE_TILES.items():
        for ragged in ("true", "false"):         # KW % 32 != 0, or not
            assert f"launch<{BM // 64}, {BN}, {ragged}>" in src
        assert RING * (BM + BN) * 128 + BM * (BN // 32 + 1) * 4 + 1024 \
            <= SMEM_MAX
    z = torch.zeros
    with pytest.raises(ValueError, match="rows-only"):
        cyc_pt.inc_join(z((1, 32, 1), dtype=torch.int32),
                        z((1, 32, 1), dtype=torch.int32),
                        CT=z((1, 32, 1), dtype=torch.int32), rows_only=True)
    with pytest.raises(ValueError):
        cyc_pt.inc_join(z((1, 32, 2), dtype=torch.int32),
                        z((1, 32, 1), dtype=torch.int32))

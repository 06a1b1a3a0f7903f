"""The device half of the transactional checker: dependency-cycle
search as batched boolean squaring on the card.

The inferred COO edges become dense adjacency masks on the device, the
edge-type-restricted graphs of the anomaly taxonomy (``ww`` for G0,
``ww ∪ wr`` for G1c, the full graph; the lattice adds ``ww ∪ wr ∪ cm``),
stacked ``[K, Np, Np]`` and closed by repeated boolean squaring
(Fischer–Meyer: ``C ← C ∨ C·C``, ``⌈log2 Np⌉`` times, no early exit).
Diagonal hits are the cycle verdicts; the G-single (and G-SIb)
predicate is one more contraction, ``any(A_rw ∧ (C_Lᵀ ∨ I))``.

The closure body is the reference's word-packed one
(``jepsen_tpu/txn/cycles.py``, ``_lattice_word_call``): each closure
row as ``Np/32`` 32-bit words (bit ``k & 31`` of word ``k >> 5`` is the
edge ``i → k``), kept both row-packed (``Cw``) and transpose-packed
(``CwT``), so a squaring is a word-wise AND reduced over the word axis.
Each squaring is one launch of the hand-written kernel K8
(``csrc/txn_closure.cu``) on the card, or :func:`square_step_plain` on
the CPU (:func:`square_step`); masks, packing and the verdict are torch
ops on the same device, so only the COO edges (and the lattice's txn
intervals) cross to the card. The words are ``int32`` with the reference's
``uint32`` bits (this torch has no shifts for ``torch.uint32`` on the
CPU). The reference's f32 body, ``torch.bmm`` on 0/1 float32 masks
(:func:`f32_verdict`, :func:`_f32_booleans`), stays as a cross-check
that the tests and ``chip_smoke.py`` call directly; no route takes it.

Spans: ``txn.closure.masks`` (COO to dense masks on the device),
``txn.closure.pack`` (the packing) and ``txn.closure.ladder`` (the
squarings, the verdict and its fetch). They are host times: device work
queued in one span may finish in the ladder's fetch.

Geometry: ``Np`` pads to the next power of two, at least 32 (a word).
Graphs past the dense envelope (:func:`admits`) are Kahn-trimmed to
their cyclic core by the caller; a core still past it goes to the host
SCC reference (a recorded route). A fault here propagates: the port
takes the host only by decision.

A streaming session closes its graph block by block instead
(:class:`IncrementalClosure`, the reference's ``_inc_word_call``): the
closed words stay on the device, and each block's new edges re-close
only the dirty rows and columns, all on packed words: the dirty block's
ladder on K8, the gathers, the left join and the join of the closure
through the dirty block on the hand-written kernel K9
(``csrc/txn_inc_join.cu``, :func:`inc_join`; plain version
:func:`inc_join_plain`), a single-bit product that writes both
packings in one launch. The reference's f32 update, ``_inc_call``, is
:func:`inc_update_f32`, a cross-check the tests and ``chip_smoke.py``
call directly.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.txn.infer import CM, RW, WR, WW, DepGraph

# dense closure envelope: Np*Np f32 intermediates, 4 lanes (the
# reference's default; ``max_dense_txns`` overrides it per call)
_MAX_DENSE_DEFAULT = 8192

# K8 launches (one a squaring), counted where the wrapper launches it
KERNEL_LAUNCHES = 0
# K9 launches (four an append block), counted where the wrapper launches
# it
INC_JOIN_LAUNCHES = 0

# the plain step's largest [K, rows, Np, NW] intermediate, in elements
_PLAIN_ELEMS = 1 << 25

# K8's two tile forms (rows x columns of prod a block): the big one from
# this Np up, the small one below it (tools/txn_tiles.py times both)
_BIG_NP = 1024
SQUARE_TILES = {0: (64, 64), 1: (128, 256)}


def max_dense() -> int:
    return _MAX_DENSE_DEFAULT


def admits(n: int, cap: Optional[int] = None) -> bool:
    return n <= (cap if cap is not None else max_dense())


def _pad_n(n: int) -> int:
    return max(8, 1 << max(0, (n - 1)).bit_length())


_WORD_NP_FLOOR = 32                      # words pack 32 columns


def _pad_n_words(n: int) -> int:
    return max(_WORD_NP_FLOOR, _pad_n(n))


def n_iter(Np: int) -> int:
    """Squarings of the fixed ladder: paths of length up to ``Np``."""
    return max(1, math.ceil(math.log2(Np)))


def _masks(graph: DepGraph, Np: int, dev: torch.device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """COO -> stacked dense masks bool[3, Np, Np] (ww / ww∪wr / full)
    and the rw mask bool[Np, Np], built on ``dev``."""
    src = torch.from_numpy(graph.src.astype(np.int64)).to(dev)
    dst = torch.from_numpy(graph.dst.astype(np.int64)).to(dev)
    et = torch.from_numpy(graph.et.astype(np.int64)).to(dev)
    masks = torch.zeros((3, Np, Np), dtype=torch.bool, device=dev)
    lane = et == WW
    for b, t in enumerate((None, WR, RW)):
        if t is not None:
            lane = lane | (et == t)
        masks[b, src[lane], dst[lane]] = True
    rw = torch.zeros((Np, Np), dtype=torch.bool, device=dev)
    rw_m = et == RW
    rw[src[rw_m], dst[rw_m]] = True
    return masks, rw


# -- the word-packed body -------------------------------------------------

def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def pack_rows_torch(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., Np] (Np % 32 == 0) -> int32 [..., Np/32], bit ``k &
    31`` of word ``k >> 5`` = bits[..., k] (the reference's ``uint32``
    words, viewed as ``int32``; distinct bits summed: an OR)."""
    lead, n = bits.shape[:-1], bits.shape[-1]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = bits.reshape(*lead, n // 32, 32).to(torch.int64) << shifts
    return _to_int32(w.sum(-1))


def pack_lanes(masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bool[K, Np, Np] -> (Cw, CwT): each lane row-packed and
    transpose-packed, int32[K, Np, Np/32], on the masks' device (one lane
    at a time, so the int64 intermediate stays one lane's)."""
    Cw = torch.stack([pack_rows_torch(m) for m in masks])
    CwT = torch.stack([pack_rows_torch(m.T) for m in masks])
    return Cw, CwT


def square_step_plain(Cw: torch.Tensor, CwT: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8's step in torch ops: ``prod[b, i, k] = any_w (Cw[b, i, w] &
    CwT[b, k, w])``, then ``Cw | pack_rows(prod)`` and ``CwT |
    pack_rows(prodᵀ)`` in fresh tensors. Chunked over rows so the
    ``[K, rows, Np, NW]`` intermediate stays at most
    :data:`_PLAIN_ELEMS` elements."""
    K, Np, NW = Cw.shape
    rows = max(1, _PLAIN_ELEMS // (K * Np * NW))
    prod = torch.empty((K, Np, Np), dtype=torch.bool, device=Cw.device)
    for r0 in range(0, Np, rows):
        blk = Cw[:, r0:r0 + rows, None, :] & CwT[:, None, :, :]
        prod[:, r0:r0 + rows] = (blk != 0).any(-1)
    return (Cw | pack_rows_torch(prod),
            CwT | pack_rows_torch(prod.transpose(1, 2)))


def square_form(Np: int) -> int:
    """K8's tile form for width ``Np``: 1, the big tile (two
    warpgroups, 128 x 256), from :data:`_BIG_NP` up, else 0, the small
    one (one warpgroup, 64 x 64)."""
    return 1 if Np >= _BIG_NP else 0


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("txn_closure")
        lib.jt_txn_square_step.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.jt_txn_square_step.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _square_step_cuda(Cw: torch.Tensor, CwT: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    global KERNEL_LAUNCHES
    dev = Cw.device
    for name, t in (("Cw", Cw), ("CwT", CwT)):
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous() or t.dim() != 3:
            raise ValueError(f"txn square_step: {name} must be a "
                             f"contiguous int32 [K, Np, NW] tensor on {dev}")
    K, Np, NW = Cw.shape
    if CwT.shape != Cw.shape or Np % 32 or NW != Np // 32:
        raise ValueError(f"txn square_step: inconsistent shapes "
                         f"Cw{tuple(Cw.shape)} CwT{tuple(CwT.shape)}")
    lib = _lib()
    Cw_out = torch.empty_like(Cw)
    CwT_out = torch.empty_like(CwT)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_txn_square_step(Cw.data_ptr(), CwT.data_ptr(),
                                     Cw_out.data_ptr(), CwT_out.data_ptr(),
                                     K, Np, square_form(Np), stream)
    if err != 0:
        raise RuntimeError(f"txn square_step kernel launch failed: CUDA "
                           f"error {err}")
    KERNEL_LAUNCHES += 1
    return Cw_out, CwT_out


def square_step(Cw: torch.Tensor, CwT: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One squaring with :func:`square_step_plain`'s contract: K8 for
    tensors on the card (asynchronous, on the current stream), the plain
    version for tensors on the CPU."""
    if Cw.device.type == "cuda":
        return _square_step_cuda(Cw, CwT)
    if Cw.device.type == "cpu":
        return square_step_plain(Cw, CwT)
    raise ValueError(f"txn square_step: unsupported device {Cw.device}")


def word_verdict(Cw: torch.Tensor, CwT: torch.Tensor, Arw_w: torch.Tensor,
                 contracts: Tuple[int, ...]) -> torch.Tensor:
    """``K + len(contracts)`` bools from the closed words: each lane's
    diagonal, then ``any(Arw_w & (CwT[L] | eye_w))`` for each lane ``L``
    in ``contracts``."""
    Np = Cw.shape[1]
    i = torch.arange(Np, device=Cw.device)
    shift = (i & 31).to(torch.int32)
    dwords = Cw[:, i, i >> 5]                               # [K, Np]
    cyc = ((dwords >> shift) & 1).ne(0).any(1)
    eye_w = torch.zeros((Np, Np // 32), dtype=torch.int32, device=Cw.device)
    eye_w[i, i >> 5] = _to_int32(torch.ones_like(i) << (i & 31))
    gs = [(Arw_w & (CwT[L] | eye_w)).ne(0).any()[None] for L in contracts]
    return torch.cat([cyc] + gs)


def _word_booleans(masks: torch.Tensor, rw: torch.Tensor,
                   contracts: Tuple[int, ...]) -> np.ndarray:
    """The word ladder on the masks' device (``Np`` a multiple of 32):
    pack (:func:`pack_lanes`), square ``n_iter`` times
    (:func:`square_step`), take the verdict and fetch it."""
    K, Np = masks.shape[0], masks.shape[1]
    with obs.span("txn.closure.pack", Np=Np, K=K):
        Cw, CwT = pack_lanes(masks)
        Arw_w = pack_rows_torch(rw)
    with obs.span("txn.closure.ladder", Np=Np, K=K):
        for _ in range(n_iter(Np)):
            Cw, CwT = square_step(Cw, CwT)
        return word_verdict(Cw, CwT, Arw_w, contracts).cpu().numpy()


# -- the f32 cross-check --------------------------------------------------

def f32_verdict(A: torch.Tensor, Arw: torch.Tensor,
                contracts: Tuple[int, ...]) -> torch.Tensor:
    """The reference's f32 ladder on 0/1 float32 masks ``A [K, Np, Np]``:
    ``C ← where(C·C > 0, 1, C)`` ``n_iter`` times by ``torch.bmm`` (the
    counts stay below 2^24, so exact in float32 and in TF32), then the
    diagonals and ``sum(Arw ∘ max(C[L], I)ᵀ) > 0`` for each contraction."""
    Np = A.shape[1]
    C = A
    for _ in range(n_iter(Np)):
        C = torch.where(torch.bmm(C, C) > 0, 1.0, C)
    cyc = C.diagonal(dim1=1, dim2=2).sum(-1) > 0
    eye = torch.eye(Np, dtype=torch.float32, device=A.device)
    gs = [((Arw * torch.maximum(C[L], eye).T).sum() > 0)[None]
          for L in contracts]
    return torch.cat([cyc] + gs)


def _f32_booleans(masks: torch.Tensor, rw: torch.Tensor,
                  contracts: Tuple[int, ...]) -> np.ndarray:
    """:func:`_word_booleans`' answer by the f32 body, on the masks'
    device: the cross-check, no route of the checker."""
    return f32_verdict(masks.float(), rw.float(), contracts).cpu().numpy()


def closure_booleans(graph: DepGraph, device: _device.DeviceLike = None
                     ) -> Dict[str, bool]:
    """The four cycle predicates from the closure on ``device`` (default:
    the card). The caller counts it (``txn.closure.word``). A fault
    propagates."""
    dev = _device.resolve(device)
    with obs.span("txn.closure.masks", txns=graph.n):
        masks, rw = _masks(graph, _pad_n_words(graph.n), dev)
    out = _word_booleans(masks, rw, (1,))
    return {"cyc_ww": bool(out[0]), "cyc_wwwr": bool(out[1]),
            "cyc_full": bool(out[2]), "gsingle": bool(out[3])}


# -- consistency-lattice closure -----------------------------------------

# lattice lane stack: 0 = ww, 1 = ww∪wr, 2 = ww∪wr∪rw (full),
# 3 = ww∪wr∪cm (the SI start/commit lane); contractions on lane 1
# (G-single) and lane 3 (G-SIb: an rw edge closing a commit-order
# cycle — write skew between non-overlapping txns)
LATTICE_K = 4
LATTICE_CONTRACTS = (1, 3)
LATTICE_KEYS = ("cyc_ww", "cyc_wwwr", "cyc_full", "cyc_si",
                "gsingle", "gsib")


def commit_mask(starts: np.ndarray, ends: np.ndarray, dev: torch.device
                ) -> torch.Tensor:
    """The SI lane's commit order bool[n, n] on ``dev``: ``cm[i, j]``
    when txn ``i`` committed strictly before txn ``j`` began (``ends[i]
    < starts[j]`` over history op indices), no self edge (the
    reference's ``infer.commit_mask`` and ``lattice._cm_from``). Crashed
    txns (``ends == -1``) have no commit point and emit no cm edge. cm
    is transitive by construction (every txn's start precedes its own
    commit), so the lane that mixes it with ww/wr needs no extra
    pass."""
    s = torch.from_numpy(np.asarray(starts, np.int64)).to(dev)
    e = torch.from_numpy(np.asarray(ends, np.int64)).to(dev)
    cm = (e >= 0)[:, None] & (e[:, None] < s[None, :])
    return cm.fill_diagonal_(False)


def _lattice_masks(graph: DepGraph, Np: int, cm: torch.Tensor,
                   dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """COO + commit mask -> stacked dense lane masks bool[4, Np, Np]
    (ww / ww∪wr / full / ww∪wr∪cm) and the rw mask bool[Np, Np], built
    on ``dev``."""
    masks3, rw = _masks(graph, Np, dev)
    si = masks3[1].clone()
    si[:cm.shape[0], :cm.shape[1]] |= cm.to(dev)
    return torch.cat([masks3, si[None]]), rw


def lattice_booleans(graph: DepGraph, starts: np.ndarray, ends: np.ndarray,
                     device: _device.DeviceLike = None) -> Dict[str, bool]:
    """The six lattice cycle predicates from ONE closure of the four
    lanes on ``device``, the commit order from the txn intervals
    ``starts``/``ends``: checking every consistency level costs one
    squaring ladder. The caller counts it (``txn.lattice.word``). A
    fault propagates."""
    dev = _device.resolve(device)
    with obs.span("txn.closure.masks", txns=graph.n):
        cm = commit_mask(starts, ends, dev)
        masks, rw = _lattice_masks(graph, _pad_n_words(graph.n), cm, dev)
    out = _word_booleans(masks, rw, LATTICE_CONTRACTS)
    return {k: bool(out[i]) for i, k in enumerate(LATTICE_KEYS)}


# -- incremental closure (streaming check sessions) -----------------------
#
# A txn session keeps the closed lane masks on the device across appends
# and re-closes only the dirty row and column blocks of each append
# batch: every path a new edge enables decomposes as old reach ->
# (a junction path within the dirty node set D) -> old reach, because
# each new edge's endpoints are in D and C was already closed. So one
# append costs
#
#   1. scatter the new edges into the words (Cw, CwT, Arw_w);
#   2. close H = C[D, D], a [d, d] squaring ladder over the dirty block
#      (K8, on H's words gathered from the columns D by K9);
#   3. the skinny join thru = (C v I)[:, D] . H (K9, rows only);
#   4. C' = C v thru . (C v I)[D, :], straight into the words of both
#      packings (one K9);
#   5. the verdict, as for the one-shot closure.
#
# Geometry: Np pads to powers of two (at least a word) and regrows by
# copying words; |D| and the edge count pad to powers of two, as the
# reference pads them for its compile cache.


class ClosureOverflow(RuntimeError):
    """The session's graph outgrew the dense closure envelope; the
    caller routes its verdicts to the host SCC reference."""


def _pow2_at_least(n: int, floor: int = 8) -> int:
    return max(floor, 1 << max(0, (n - 1)).bit_length())


def block_operands(src: np.ndarray, dst: np.ndarray, et: np.ndarray,
                   Np: int, lattice: bool):
    """One append batch's update operands, padded as the reference pads
    them: ``(esrc, edst, elane, erw, dsel)``, numpy, with ``esrc`` and
    ``edst`` int32[e_pad] (-1 padding), ``elane`` f32[K, e_pad] each
    edge's weight in each lane (ww / ww∪wr / full, and for the lattice
    ww∪wr∪cm, where lane 2 leaves out the cm rows), ``erw`` f32[e_pad]
    and ``dsel`` int32[d_pad], the dirty nodes (-1 padding)."""
    e = len(src)
    e_pad = _pow2_at_least(max(e, 1))
    d_ids = (np.unique(np.concatenate([src, dst])) if e
             else np.zeros(0, np.int64))
    d_pad = min(Np, _pow2_at_least(max(len(d_ids), 1)))
    if len(d_ids) > d_pad:              # cannot happen: |D| <= Np
        d_pad = _pow2_at_least(len(d_ids))
    K = LATTICE_K if lattice else 3
    esrc = np.full(e_pad, -1, np.int32)
    edst = np.full(e_pad, -1, np.int32)
    esrc[:e] = src
    edst[:e] = dst
    elane = np.zeros((K, e_pad), np.float32)
    erw = np.zeros(e_pad, np.float32)
    elane[0, :e] = (et == WW)
    elane[1, :e] = (et == WW) | (et == WR)
    if lattice:
        elane[2, :e] = (et != CM)
        elane[3, :e] = (et == WW) | (et == WR) | (et == CM)
    else:
        elane[2, :e] = 1.0
    erw[:e] = (et == RW)
    dsel = np.full(d_pad, -1, np.int32)
    dsel[:len(d_ids)] = d_ids
    return esrc, edst, elane, erw, dsel


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool [..., n] -> int32 [..., ceil(n / 32)] (:func:`pack_rows_torch`
    after zero padding to whole words)."""
    n = bits.shape[-1]
    pad = -n % 32
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    return pack_rows_torch(bits)


def join_form(M: int, N: int) -> int:
    """K9's tile form for an ``M x N`` product: K8's rule
    (:func:`square_form`) on the longer side. A skinny product at Np =
    8,192 is faster on the big tile, half of whose columns may lie past
    ``N`` (``chip_smoke.py`` times both forms at the session's shapes)."""
    return square_form(max(M, N))


def inc_join_plain(A: torch.Tensor, B: torch.Tensor,
                   C: Optional[torch.Tensor] = None,
                   CT: Optional[torch.Tensor] = None,
                   rows_only: bool = False
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K9's product in torch ops: ``prod[b, i, j] = any_k (A[b, i, k] &
    B[b, j, k])`` over the packed k words of ``A`` int32[K, M, KW] and
    ``B`` int32[K, N, KW], then ``(C | pack_bits(prod), CT |
    pack_bits(prodᵀ))`` in fresh tensors (``C`` [K, M, ceil(N/32)] and
    ``CT`` [K, N, ceil(M/32)] zero when None; the second None with
    ``rows_only``). Chunked over rows so the ``[K, rows, N, KW]``
    intermediate stays at most :data:`_PLAIN_ELEMS` elements."""
    K, M, KW = A.shape
    N = B.shape[1]
    rows = max(1, _PLAIN_ELEMS // (K * N * KW))
    prod = torch.empty((K, M, N), dtype=torch.bool, device=A.device)
    for r0 in range(0, M, rows):
        blk = A[:, r0:r0 + rows, None, :] & B[:, None, :, :]
        prod[:, r0:r0 + rows] = (blk != 0).any(-1)
    out = pack_bits(prod)
    if C is not None:
        out = C | out
    if rows_only:
        return out, None
    outT = pack_bits(prod.transpose(1, 2))
    return out, (outT if CT is None else CT | outT)


def _check_join(A: torch.Tensor, B: torch.Tensor, C: Optional[torch.Tensor],
                CT: Optional[torch.Tensor], rows_only: bool) -> None:
    dev = A.device
    named = [("A", A), ("B", B), ("C", C), ("CT", CT)]
    for name, t in named:
        if t is not None and (t.device != dev or t.dtype != torch.int32
                              or not t.is_contiguous() or t.dim() != 3):
            raise ValueError(f"txn inc_join: {name} must be a contiguous "
                             f"int32 [K, rows, words] tensor on {dev}")
    K, M, KW = A.shape
    N = B.shape[1]
    want = {"B": (K, N, KW), "C": (K, M, -(-N // 32)),
            "CT": (K, N, -(-M // 32))}
    if rows_only and CT is not None:
        raise ValueError("txn inc_join: CT given in rows-only mode")
    if min(K, M, N, KW) < 1 or any(
            t is not None and tuple(t.shape) != want[name]
            for name, t in named[1:]):
        shapes = " ".join(f"{name}{tuple(t.shape)}" for name, t in named
                          if t is not None)
        raise ValueError(f"txn inc_join: inconsistent shapes {shapes}")


_INC_LIB = None


def _inc_lib():
    global _INC_LIB
    if _INC_LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("txn_inc_join")
        lib.jt_txn_inc_join.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.jt_txn_inc_join.restype = ctypes.c_int
        _INC_LIB = lib
    return _INC_LIB


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _inc_join_cuda(A: torch.Tensor, B: torch.Tensor,
                   C: Optional[torch.Tensor], CT: Optional[torch.Tensor],
                   rows_only: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    global INC_JOIN_LAUNCHES
    K, M, KW = A.shape
    N = B.shape[1]
    lib = _inc_lib()
    out = torch.empty((K, M, -(-N // 32)), dtype=torch.int32,
                      device=A.device)
    outT = None if rows_only else torch.empty(
        (K, N, -(-M // 32)), dtype=torch.int32, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_txn_inc_join(A.data_ptr(), B.data_ptr(), _ptr(C),
                                  _ptr(CT), out.data_ptr(), _ptr(outT), K,
                                  M, N, KW, join_form(M, N), stream)
    if err != 0:
        raise RuntimeError(f"txn inc_join kernel launch failed: CUDA "
                           f"error {err}")
    INC_JOIN_LAUNCHES += 1
    return out, outT


def inc_join(A: torch.Tensor, B: torch.Tensor,
             C: Optional[torch.Tensor] = None,
             CT: Optional[torch.Tensor] = None, rows_only: bool = False
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The product with :func:`inc_join_plain`'s contract: K9 for tensors
    on the card (one launch writes both packings; asynchronous, on the
    current stream), the plain version for tensors on the CPU."""
    _check_join(A, B, C, CT, rows_only)
    if A.device.type == "cuda":
        return _inc_join_cuda(A, B, C, CT, rows_only)
    if A.device.type == "cpu":
        return inc_join_plain(A, B, C, CT, rows_only)
    raise ValueError(f"txn inc_join: unsupported device {A.device}")


def _scatter_bits(words: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``words`` int32[..., Np, NW] with bit ``cols & 31`` of word
    ``[..., rows, cols >> 5]`` set for each kept entry (``keep`` bool
    over the leading axes and the entries), in a fresh tensor. Entries
    are deduplicated first, so summing their distinct bits into each
    touched word is an OR."""
    lead = words.shape[:-2]
    Np, NW = words.shape[-2:]
    L = int(np.prod(lead)) if lead else 1
    keep = keep.reshape(L, -1)
    lane = torch.arange(L, device=words.device)[:, None].expand_as(keep)
    lin = ((lane * Np + rows[None, :]) * NW * 32 + cols[None, :])[keep]
    lin = torch.unique(lin)
    out = words.clone()
    if lin.numel():
        uw, inv = torch.unique(lin >> 5, return_inverse=True)
        add = torch.zeros(uw.numel(), dtype=torch.int64,
                          device=words.device)
        add.index_add_(0, inv, torch.ones_like(lin) << (lin & 31))
        flat = out.view(-1)
        flat[uw] |= _to_int32(add)
    return out


def inc_update_word(Cw: torch.Tensor, CwT: torch.Tensor,
                    Arw_w: torch.Tensor, esrc: torch.Tensor,
                    edst: torch.Tensor, elane: torch.Tensor,
                    erw: torch.Tensor, dsel: torch.Tensor,
                    contracts: Tuple[int, ...]):
    """One append batch on the carried words (the reference's
    ``_inc_word_call``, on the words' device): returns ``(Cw, CwT, Arw_w,
    verdict)``, fresh tensors, the verdict ``K + len(contracts)`` bools
    as :func:`word_verdict` gives them. Operands as
    :func:`block_operands` gives them, as tensors on the same device
    (``elane`` and ``erw`` of any type: nonzero is an edge). ``CwT``
    must be ``Cw``'s transpose packing, as the carried state keeps it:
    the rows ``(C ∨ I)[D, :]`` are read from it.

    Every step is on packed words, a boolean product on K8 or K9: with
    ``D = dsel``'s valid nodes and ``S[m, l] = [m == D[l]]``, the
    gathers ``(C ∨ I)[:, D]`` and ``((C ∨ I)[D, :])ᵀ`` (K9 against
    ``Sᵀ``, then ``S`` ORed in), the dirty block ``H = C[D, D]`` closed
    by ``n_iter(|dsel|)`` squarings (K8; at least a word wide), ``thru =
    (C ∨ I)[:, D]·H*`` (K9, rows only) and the join ``C ∨ thru·(C ∨
    I)[D, :]`` in both packings (one K9)."""
    K, Np, NW = Cw.shape
    dev = Cw.device
    s = esrc.clamp(min=0).long()
    d = edst.clamp(min=0).long()
    el = elane != 0
    Cw = _scatter_bits(Cw, s, d, el)
    CwT = _scatter_bits(CwT, d, s, el)
    Arw_w = _scatter_bits(Arw_w, s, d, erw != 0)
    nd = len(dsel)
    Dp = _pad_n_words(nd)                      # K8 squares whole words
    DW = Dp // 32
    dd = dsel.clamp(min=0).long()
    valid = dsel >= 0
    vl = torch.arange(nd, device=dev)[valid]
    vd = dd[valid]
    # St_w: row l of Sᵀ, bit D[l] (rows past the valid ones zero); S_w:
    # row m of S, bit l where m = D[l] (D's nodes are distinct)
    St_w = torch.zeros((Dp, NW), dtype=torch.int32, device=dev)
    St_w[vl, vd >> 5] = _to_int32(torch.ones_like(vd) << (vd & 31))
    S_w = torch.zeros((Np, DW), dtype=torch.int32, device=dev)
    S_w[vd, vl >> 5] = _to_int32(torch.ones_like(vl) << (vl & 31))
    sel = St_w.expand(K, Dp, NW).contiguous()
    cols, _ = inc_join(Cw, sel, rows_only=True)      # C[i, D[l]]
    rows, _ = inc_join(CwT, sel, rows_only=True)     # C[D[l], j], row j
    # the dirty block, row- and transpose-packed: rows D of each gather
    keep = valid.to(torch.int32)[None, :, None]
    Hw = torch.zeros((K, Dp, DW), dtype=torch.int32, device=dev)
    HwT = torch.zeros_like(Hw)
    Hw[:, :nd] = cols[:, dd] * keep
    HwT[:, :nd] = rows[:, dd] * keep
    for _ in range(n_iter(max(nd, 2))):
        Hw, HwT = square_step(Hw, HwT)
    # thru = left·H*, packed over D; then C ∨ thru·right in both packings
    thru_w, _ = inc_join(cols | S_w, HwT, rows_only=True)
    Cw, CwT = inc_join(thru_w, rows | S_w, Cw, CwT)
    return Cw, CwT, Arw_w, word_verdict(Cw, CwT, Arw_w, contracts)


def inc_update_f32(C: Optional[torch.Tensor], Arw: Optional[torch.Tensor],
                   Np: int, esrc: torch.Tensor, edst: torch.Tensor,
                   elane: torch.Tensor, erw: torch.Tensor,
                   dsel: torch.Tensor, contracts: Tuple[int, ...]):
    """The reference's f32 update, ``_inc_call``, in torch on 0/1
    float32 masks ``C`` [K, Np, Np] and ``Arw`` [Np, Np]: a cross-check
    of :class:`IncrementalClosure`, which the tests and ``chip_smoke.py``
    call directly (no route takes it). ``C`` and ``Arw`` may be None or
    narrower than ``Np``: they are zero-embedded first. Returns ``(C,
    Arw, verdict)``, the verdict's bools in :func:`word_verdict`'s
    order."""
    K = elane.shape[0]
    dev = esrc.device
    if C is None or C.shape[1] < Np:
        C2 = torch.zeros((K, Np, Np), dtype=torch.float32, device=dev)
        A2 = torch.zeros((Np, Np), dtype=torch.float32, device=dev)
        if C is not None:
            n = C.shape[1]
            C2[:, :n, :n] = C
            A2[:n, :n] = Arw
        C, Arw = C2, A2
    s = esrc.clamp(min=0).long()
    d = edst.clamp(min=0).long()
    lin = s * Np + d
    C = C.clone()
    for lane in range(K):
        C[lane].view(-1).scatter_reduce_(0, lin, elane[lane], "amax")
    Arw = Arw.clone()
    Arw.view(-1).scatter_reduce_(0, lin, erw, "amax")
    dd = dsel.clamp(min=0).long()
    vf = (dsel >= 0).float()
    H = C[:, dd][:, :, dd] * vf[None, :, None] * vf[None, None, :]
    for _ in range(n_iter(max(len(dd), 2))):
        H = torch.where(torch.bmm(H, H) > 0, 1.0, H)
    eyeD = (torch.arange(Np, device=dev)[:, None] == dd[None, :]).float() \
        * vf[None, :]
    left = torch.maximum(C[:, :, dd] * vf[None, None, :], eyeD[None])
    right = torch.maximum(C[:, dd, :] * vf[None, :, None], eyeD.T[None])
    add = torch.bmm(torch.bmm(left, H), right)
    C = torch.where(add > 0, 1.0, C)
    del add, left, right
    cyc = C.diagonal(dim1=1, dim2=2).sum(-1) > 0
    eye = torch.eye(Np, dtype=torch.float32, device=dev)
    gs = [((Arw * torch.maximum(C[L], eye).T).sum() > 0)[None]
          for L in contracts]
    return C, Arw, torch.cat([cyc] + gs)


class IncrementalClosure:
    """Device-resident incremental transitive closure for one txn
    session. ``add_block(n_txns, src, dst, et)`` folds an append batch's
    new edges in and returns the four cycle booleans (the
    :func:`closure_booleans` keys), or with ``lattice=True`` the six of
    :data:`LATTICE_KEYS`, where the carried stack grows the ``ww∪wr∪cm``
    lane and ``et`` may carry :data:`~jepsen_tpu_torch.txn.infer.CM`
    rows. The carried state is K8's layout: ``Cw``, ``CwT`` int32[K, Np,
    Np/32] and ``Arw_w`` int32[Np, Np/32] on ``device`` (default: the
    card). Raises :class:`ClosureOverflow` past the dense envelope; any
    other fault propagates."""

    def __init__(self, *, max_dense_txns: Optional[int] = None,
                 lattice: bool = False,
                 device: _device.DeviceLike = None) -> None:
        self._cap = (max_dense_txns if max_dense_txns is not None
                     else max_dense())
        self.device = _device.resolve(device)
        self.Np = 0
        self.lattice = lattice
        self.K = LATTICE_K if lattice else 3
        self.contracts = LATTICE_CONTRACTS if lattice else (1,)
        self._Cw: Optional[torch.Tensor] = None
        self._CwT: Optional[torch.Tensor] = None
        self._Arw_w: Optional[torch.Tensor] = None
        self.updates = 0

    def _regrow(self, n: int) -> None:
        """Re-embed the carried words into the next power-of-two geometry
        (new nodes have no edges, so the closure holds): the old Np is a
        multiple of 32, so its columns are whole words of the new one."""
        if n > self._cap:
            raise ClosureOverflow(
                f"session graph {n} txns > dense cap {self._cap}")
        Np2 = _pad_n_words(n)
        NW2 = Np2 // 32
        Cw = torch.zeros((self.K, Np2, NW2), dtype=torch.int32,
                         device=self.device)
        CwT = torch.zeros_like(Cw)
        Aw = torch.zeros((Np2, NW2), dtype=torch.int32, device=self.device)
        if self._Cw is not None:
            NW = self._Cw.shape[2]
            Cw[:, :self.Np, :NW] = self._Cw
            CwT[:, :self.Np, :NW] = self._CwT
            Aw[:self.Np, :NW] = self._Arw_w
            obs.count("txn.closure.regrow")
        self.Np = Np2
        self._Cw, self._CwT, self._Arw_w = Cw, CwT, Aw

    def add_block(self, n_txns: int, src: np.ndarray, dst: np.ndarray,
                  et: np.ndarray) -> Dict[str, bool]:
        """Fold one append batch's new edges into the carried closure and
        return the cycle booleans."""
        if n_txns > self._cap:
            raise ClosureOverflow(
                f"session graph {n_txns} txns > dense cap {self._cap}")
        if self._Cw is None or n_txns > self.Np:
            self._regrow(max(n_txns, 1))
        esrc, edst, elane, erw, dsel = block_operands(
            np.asarray(src), np.asarray(dst), np.asarray(et), self.Np,
            self.lattice)
        ops = [torch.as_tensor(a, device=self.device) for a in
               (esrc, edst, elane != 0, erw != 0, dsel)]
        self._Cw, self._CwT, self._Arw_w, out = inc_update_word(
            self._Cw, self._CwT, self._Arw_w, *ops, self.contracts)
        self.updates += 1
        obs.count("txn.closure.incremental")
        obs.count("txn.closure.incremental_word")
        o = out.cpu().numpy()
        if self.lattice:
            obs.count("txn.lattice.incremental")
            return {k: bool(o[i]) for i, k in enumerate(LATTICE_KEYS)}
        return {"cyc_ww": bool(o[0]), "cyc_wwwr": bool(o[1]),
                "cyc_full": bool(o[2]), "gsingle": bool(o[3])}

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
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.txn.infer import RW, WR, WW, DepGraph

# dense closure envelope: Np*Np f32 intermediates, 4 lanes (the
# reference's default; ``max_dense_txns`` overrides it per call)
_MAX_DENSE_DEFAULT = 8192

# K8 launches (one a squaring), counted where the wrapper launches it
KERNEL_LAUNCHES = 0

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

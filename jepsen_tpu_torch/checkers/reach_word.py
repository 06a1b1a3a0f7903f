"""The word-packed walks: the post-hoc returns walk on the hand-written
CUDA kernel K11 (``csrc/word_walk.cu``), and the mega-group advance of
streaming sessions on K10 (``csrc/mega_walk.cu``). The counterparts of
the reference package's ``checkers/reach_word.py``, whose walks are XLA
programs (``_walk_words``, a ``lax.scan``, and its ``vmap`` over lanes).

**The post-hoc word walk (K11).** A set of configurations is ``R[S,
NW]`` 32-bit words, ``NW = max(1, M >> 5)``: bit ``m & 31`` of word
``m >> 5`` of row ``s`` is the configuration (state s, mask m). Firing
pending slot ``j < 5`` moves the bit-j-clear half of every word up by
``2**j`` bits (``(R & ~cmask[j]) << 2**j``); slot ``j >= 5`` moves whole
words (word w with bit ``j - 5`` set receives word ``w ^ 1 << (j -
5)``). Each shifted word is OR-ed into row ``T[s, op_j]`` of the set
(target -1: discarded). A return's passes run to their fixpoint, then
the projection on the returning slot keeps the bit-set half (the inverse
shift, or the word permutation down; slot -1 is the identity). The
first return after which the set is empty is exact, so no refinement
follows. :func:`walk_words` walks H lanes that share one table, each
from its own set through its own stream, ragged lanes ending at their
own count; on CPU tensors it runs the plain version
(:func:`walk_words_plain`), on CUDA tensors it launches K11 or raises.
:func:`walk_returns_words` is the single history's entry. The host
helpers (:func:`pack_words`, :func:`pack_rows`, :func:`table_from_P`,
:func:`pad_table`, :func:`admits`) are the reference's, byte for byte.

**The mega-group advance (K10).** Many sessions' carried
frontiers (:class:`.reach.FrontierCarry`), each walked through one
append block of its own, in one launch of the hand-written CUDA kernel
K10 (``csrc/mega_walk.cu``). The counterparts of the reference
package's ``mega_geometry``, ``launch_frontiers_mega``,
``MegaInflight``, ``collect_frontiers_mega`` and
``advance_frontiers_mega``, whose batched walk is an XLA program (a
``vmap`` of the word walk over the session axis).

A group is the carries of one geometry, :func:`mega_geometry`
``(engine, S_pad, W, O1)``: K1's route or K4's, the padded state count,
the slots, and P's op axis padded to the reference's bucket. Each lane
keeps its own P, its own nibble image tables (built once when the carry
was seeded) and its own set. Its operands are a :class:`MegaLane`,
checked once when the carry is seeded, whose descriptor row K10 reads:
the tables', the set's and an out buffer's addresses. K10 writes each
lane's final set to its out buffer and the collect swaps set and out,
so a row stays valid from wave to wave; a solo advance that replaces
the set rebinds the lane (:meth:`MegaLane.rebind`). A wave's host work
is a pointer and a count a lane: :func:`stage_blocks` puts the
descriptors and the lanes' returns, back to back with no padding, into
one buffer (pinned for the card) that one asynchronous copy sends.
Ragged blocks are the padded ``[L, R_pad]`` layout's identity steps
(``ret_slot = -1``, every op -1), which change nothing, so each lane's
walk ends at its own count and its dead return is its own exact index
(-1: survived). There is no lane padding: the card compiles nothing per
group width.

On CPU tensors :func:`mega_walk` runs the plain version,
:func:`mega_walk_plain`, on the padded layout (:meth:`MegaStage.padded`);
on CUDA tensors it launches K10 or raises.
"""
from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import reach_lane

#: launches of K10 (not of its plain version) in this process
KERNEL_LAUNCHES = 0

#: launches of K11, the post-hoc word walk (not of its plain version), in
#: this process
WORD_LAUNCHES = 0

#: int64 words of a lane's descriptor row: its tables', set's and out's
#: addresses, the op rows its returns can name, and its geometry key
DESC_WORDS = 5

#: K10's table placement: the named ops' slices in shared memory where
#: they fit and take at most twice the rounds of resident blocks that
#: device memory takes ("auto"), always ("shared"), or the tables in
#: device memory
PLACES = {"auto": 0, "shared": 1, "global": 2}


def mega_geometry(carry) -> Optional[tuple]:
    """The geometry a carry contributes to a mega-group, ``(engine,
    S_pad, W, O1)``, or None when it cannot join one (the torch returns
    walk). Members of a group agree on it; their tables, sets and blocks
    are their own. Fixed when the carry is seeded (growth seeds a new
    carry)."""
    return carry.mega_sig


def _geometry_key(narrow: bool, S: int, W: int, O1: int) -> int:
    return (int(narrow) << 62) | (S << 40) | (W << 32) | O1


class MegaLane:
    """One lane's operands for K10, checked once when made: ``P`` f32
    ``[O1, S, S]`` (the plain version's), its nibble image tables ``T``
    i32 ``[O1, K, 16, NT]`` (16-byte aligned), its set ``R`` f32 ``[M,
    S]`` and an ``out`` buffer of the same shape, all contiguous on one
    device, and ``n_ops``, the rows of P its returns can name (the rest
    are zero padding and the sentinel). ``row`` is its descriptor:
    ``(T, R, out)`` addresses, ``n_ops`` and the geometry key;
    ``packed`` the same as :data:`DESC_WORDS` little-endian int64 bytes,
    as a wave stages it."""

    __slots__ = ("P", "T", "R", "out", "n_ops", "narrow", "row", "packed",
                 "_key", "_swapped")

    def __init__(self, P: torch.Tensor, T: torch.Tensor, R: torch.Tensor,
                 n_ops: int, narrow: bool) -> None:
        O1, S, _ = P.shape
        dev = T.device
        t_shape = (O1, reach_lane.n_nibbles(S), 16, reach_lane.table_words(S))
        reach_lane._check_operands("MegaLane", dev,
                                   (("P", P, torch.float32),
                                    ("T", T, torch.int32)))
        if tuple(P.shape) != (O1, S, S) or tuple(T.shape) != t_shape:
            raise ValueError(f"MegaLane: P{tuple(P.shape)} "
                             f"T{tuple(T.shape)}, want T{t_shape}")
        if T.data_ptr() % 16:
            raise ValueError("MegaLane: T must be 16-byte aligned")
        if not 0 <= n_ops < O1:
            raise ValueError(f"MegaLane: {n_ops} ops in {O1} rows")
        self.P, self.T, self.n_ops, self.narrow = P, T, int(n_ops), narrow
        self._key = _geometry_key(narrow, S, int(R.shape[0]).bit_length()
                                  - 1, O1)
        self.out = None
        self.rebind(R)

    def rebind(self, R: torch.Tensor) -> None:
        """Make ``R`` the lane's set (a solo advance replaced it), after
        the same checks; the out buffer stays the lane's own."""
        M, S = R.shape if R.dim() == 2 else (0, 0)
        reach_lane._check_operands("MegaLane", self.T.device,
                                   (("R", R, torch.float32),))
        if S != self.P.shape[1] or M < 2 or M & (M - 1) or \
                _geometry_key(self.narrow, S, M.bit_length() - 1,
                              self.P.shape[0]) != self._key:
            raise ValueError(f"MegaLane: R{tuple(R.shape)} is not this "
                             f"lane's [M, {self.P.shape[1]}]")
        if self.out is None or self.out.data_ptr() == R.data_ptr():
            self.out = torch.empty_like(R)
        self.R = R
        t, r, o = self.T.data_ptr(), R.data_ptr(), self.out.data_ptr()
        rows = [(t, r, o, self.n_ops, self._key),
                (t, o, r, self.n_ops, self._key)]
        self.row, swapped = rows
        self.packed = struct.pack("<5q", *self.row)
        self._swapped = (swapped, struct.pack("<5q", *swapped))

    def swap(self) -> None:
        """After a wave: the out buffer, K10's final set, becomes the set
        and the old set the next wave's out."""
        self.R, self.out = self.out, self.R
        now = (self.row, self.packed)
        self.row, self.packed = self._swapped
        self._swapped = now


class MegaStage:
    """One wave's operands on the host, in one buffer ``buf`` (pinned when
    bound for the card): the lanes' descriptor rows ``desc`` int64 ``[L,
    DESC_WORDS]``, the offsets ``off`` int32 ``[L + 1]`` of their returns
    in the stream, the stream ``ret`` int32 ``[N]`` and ``ops`` int32
    ``[N, W]`` (each lane's real returns, back to back), and room for the
    dead returns ``dead`` int32 ``[L]``. ``n`` the lanes' counts, ``R_pad``
    the longest, ``cap`` the most ops a lane can name (its ``n_ops`` or
    ``W`` a return, the smaller): K10 sizes its shared slices by it."""

    __slots__ = ("L", "W", "N", "R_pad", "cap", "n", "buf", "desc", "off",
                 "ret", "ops", "spans")

    def padded(self) -> Tuple[np.ndarray, np.ndarray]:
        """The padded layout of the plain version: ``ret_slot`` int32
        ``[L, R_pad]`` and ``slot_ops`` int32 ``[L, R_pad, W]``, each
        lane's returns then identity steps (-1), by one scatter."""
        L, R, W = self.L, self.R_pad, self.W
        ret = np.full((L, R), -1, np.int32)
        ops = np.full((L, R, W), -1, np.int32)
        at = np.arange(self.N) + np.repeat(
            np.arange(L) * R - self.off[:-1], self.n)
        ret.reshape(-1)[at] = self.ret
        ops.reshape(-1, W)[at] = self.ops
        return ret, ops


def _align(n: int, to: int = 16) -> int:
    return -(-n // to) * to


def stage_blocks(packed, blocks, W: int, pin: bool = False) -> MegaStage:
    """Stage one wave: ``packed`` the lanes' descriptor rows as bytes
    (:attr:`MegaLane.packed`) and ``blocks`` their ``(ret_slot int32[n],
    slot_ops int32[n, W])`` pairs (C-contiguous), aligned. The rows, the
    offsets and the lanes' returns are one join of their bytes, copied
    into the buffer once: no loop over lanes past a pointer and a count
    each."""
    L = len(blocks)
    if len(packed) != L:
        raise ValueError(f"stage_blocks: {len(packed)} lanes, {L} blocks")
    rets = [b[0] for b in blocks]
    opss = [b[1] for b in blocks]
    n = np.fromiter(map(len, rets), np.int64, L)
    N = int(n.sum())
    off = np.zeros(L + 1, np.int32)
    np.cumsum(n, out=off[1:])
    spans, pads = [], []
    at = 0
    for words, dt in ((L * DESC_WORDS, np.int64), (L + 1, np.int32),
                      (N, np.int32), (N * W, np.int32), (L, np.int32)):
        spans.append((at, words, dt))
        end = at + words * np.dtype(dt).itemsize
        at = _align(end)
        pads.append(bytes(at - end))
    data = bytearray().join([*packed, pads[0], off.tobytes(), pads[1],
                             *rets, pads[2], *opss, pads[3]])
    if len(data) != spans[4][0]:
        raise ValueError(f"stage_blocks: {len(data)} bytes of rows and "
                         f"returns where {spans[4][0]} go (int32 blocks "
                         f"of width W = {W})")
    buf = torch.empty(max(at, 16), dtype=torch.uint8, pin_memory=pin)
    raw = buf.numpy()
    raw[:len(data)] = np.frombuffer(data, np.uint8)
    views = [raw[a:a + w * np.dtype(dt).itemsize].view(dt)
             for a, w, dt in spans]
    st = MegaStage()
    st.L, st.W, st.N, st.n, st.buf, st.spans = L, W, N, n, buf, spans
    st.desc = views[0].reshape(L, DESC_WORDS)
    st.off = views[1]
    st.ret = views[2]
    st.ops = views[3].reshape(N, W)
    st.R_pad = int(n.max()) if L else 0
    st.cap = int(np.minimum(st.desc[:, 3], W * n).max()) if L else 0
    return st


# -- the kernel's plain version -----------------------------------------------

def mega_walk_plain(P: Sequence[torch.Tensor], R0: Sequence[torch.Tensor],
                    ret_slot: torch.Tensor, slot_ops: torch.Tensor,
                    n) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk of :func:`mega_walk` in PyTorch ops, on any device: the
    L lanes in lockstep, lane i from its set ``R0[i]`` f32 ``[M, S]`` on
    its own ``P[i]`` f32 ``[O1, S, S]`` (row O1-1 the all-zero
    sentinel). ``ret_slot`` i32 ``[L, R_pad]`` and ``slot_ops`` i32
    ``[L, R_pad, W]`` are the lanes' blocks, each padded past its ``n[i]``
    real returns with identity steps (-1). Each return runs as many
    Jacobi fire passes as its lanes' largest pending count (at most W;
    a pass past a lane's fixpoint is the identity), then each lane's
    projection on its returning slot. Returns ``(final f32[L, M, S],
    dead i32[L])``: each lane's set after its block, and the first of
    its real returns after which its set is empty, or -1. An empty set
    stays empty, so a dead lane's final set is empty."""
    L, R_pad, W = slot_ops.shape
    M, S = R0[0].shape
    dev = ret_slot.device
    Pst = torch.stack([p.to(dev) for p in P])            # [L, O1, S, S]
    O1 = Pst.shape[1]
    R = torch.stack([r.to(dev) for r in R0]).clone()      # [L, M, S]
    lanes = torch.arange(L, device=dev)
    m = torch.arange(M, device=dev)
    j = torch.arange(W, device=dev)
    partner = m[None, :] ^ (1 << j)[:, None]              # [W, M]
    gate = ((m[None, :] >> j[:, None]) & 1).to(R.dtype)[None, :, :, None]
    ops = torch.where(slot_ops < 0, O1 - 1, slot_ops).long()
    passes = (slot_ops >= 0).sum(2).amax(0).clamp(max=W).tolist()
    js = ret_slot.long()
    alive = torch.empty((R_pad, L), dtype=torch.bool, device=dev)
    for r in range(R_pad):
        if passes[r]:
            G = Pst[lanes[:, None], ops[:, r]]            # [L, W, S, S]
            for _ in range(passes[r]):
                img = (R[:, partner] @ G).clamp(max=1.0)  # [L, W, M, S]
                R = torch.maximum(R, (img * gate).amax(1))
        bit = torch.where(js[:, r] >= 0, 1 << js[:, r].clamp(min=0), 0)
        src = (m[None, :] | bit[:, None])                 # [L, M]
        keep = ((m[None, :] & bit[:, None]) == 0).to(R.dtype)
        R = R.gather(1, src[..., None].expand(L, M, S)) * keep[..., None]
        alive[r] = R.flatten(1).amax(1) > 0.5
    real = torch.arange(R_pad, device=dev)[:, None] < torch.as_tensor(
        np.asarray(n, np.int64), device=dev)[None, :]
    died = ~alive & real
    dead = torch.where(died.any(0), died.int().argmax(0), -1)
    return R.contiguous(), dead.to(torch.int32)


# -- the kernel ---------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("mega_walk")
        lib.jt_mega_walk.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
        lib.jt_mega_walk.restype = ctypes.c_int
        lib.jt_mega_design.argtypes = [ctypes.c_int] * 8 + \
            [ctypes.POINTER(ctypes.c_int)]
        lib.jt_mega_design.restype = ctypes.c_int
        lib.jt_smem_round_trip.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.jt_smem_round_trip.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _geometry(lanes, stage: MegaStage):
    """``(S, O1)`` of a wave whose lanes all have the first one's
    geometry key (one vectorised test of the descriptor rows)."""
    if len(lanes) != stage.L or stage.L == 0:
        raise ValueError(f"mega_walk: {len(lanes)} lanes, {stage.L} staged")
    keys = stage.desc[:, 4]
    if (keys != keys[0]).any():
        raise ValueError("mega_walk: lane geometry mismatch")
    O1, S, _ = lanes[0].P.shape
    if lanes[0].R.shape[0] != 1 << stage.W:
        raise ValueError(f"mega_walk: sets of {lanes[0].R.shape[0]} masks, "
                         f"W = {stage.W}")
    return S, O1


def _mega_walk_cuda(lanes, stage: MegaStage, narrow: bool, place: str,
                    events) -> torch.Tensor:
    global KERNEL_LAUNCHES
    S, O1 = _geometry(lanes, stage)
    dev = lanes[0].T.device
    if not stage.buf.is_pinned():
        raise ValueError("mega_walk: the stage for the card is pinned")
    lib = _lib()
    with torch.cuda.device(dev):
        dbuf = torch.empty(stage.buf.numel(), dtype=torch.uint8, device=dev)
        dbuf.copy_(stage.buf, non_blocking=True)
        base = dbuf.data_ptr()
        ptrs = [base + a for a, _w, _dt in stage.spans]
        evs = [None, None]
        if events is not None:
            for k, e in enumerate(events):
                if not e.cuda_event:
                    e.record()                 # made at its first record
                evs[k] = e.cuda_event
        err = lib.jt_mega_walk(
            ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4], stage.L,
            stage.R_pad, stage.W, S, O1, int(narrow), stage.cap,
            PLACES[place], torch.cuda.current_stream().cuda_stream, *evs)
    if err != 0:
        raise RuntimeError(f"mega_walk kernel launch failed: CUDA error "
                           f"{err}")
    KERNEL_LAUNCHES += 1
    a, w, _dt = stage.spans[4]
    return dbuf[a:a + 4 * w].view(torch.int32)


def mega_walk(lanes: Sequence[MegaLane], stage: MegaStage, narrow: bool,
              place: str = "auto", events=None) -> torch.Tensor:
    """One wave: lane i of ``lanes`` (all of one geometry) walked from its
    set through its staged returns (:func:`stage_blocks`), its final set
    written to its ``out`` buffer. Returns the dead returns i32 ``[L]``
    (-1: survived; -2: K10 found an op past the lane's tables, or more
    named ops than the stage's cap, and walked nothing) on the lanes'
    device. K10 for lanes on the card
    (asynchronous, on the current stream; K1's forms when ``narrow``,
    else K4's; ``place`` as in :data:`PLACES`; ``events``, two
    ``torch.cuda.Event(enable_timing=True)``, are recorded by the C entry
    point right around the launch: their interval is the kernel's own
    device time), the plain version for lanes on the CPU. Any other
    device raises ValueError, a failed launch RuntimeError."""
    dev = lanes[0].T.device if len(lanes) else torch.device("cpu")
    if dev.type == "cuda":
        return _mega_walk_cuda(lanes, stage, narrow, place, events)
    if dev.type != "cpu":
        raise ValueError(f"mega_walk: unsupported device {dev}")
    _geometry(lanes, stage)
    ret, ops = stage.padded()
    final, dead = mega_walk_plain(
        [ln.P for ln in lanes], [ln.R for ln in lanes],
        torch.from_numpy(ret), torch.from_numpy(ops), stage.n)
    for ln, f in zip(lanes, final):
        ln.out.copy_(f)
    return dead


def mega_design(stage: MegaStage, S: int, O1: int, narrow: bool,
                place: str = "auto") -> dict:
    """The launch :func:`mega_walk` makes of this stage on the card: the
    table place, threads and dynamic shared memory a block, the blocks
    one SM holds at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    the SMs, the form and the returns staged at a time."""
    out = (ctypes.c_int * 7)()
    err = _lib().jt_mega_design(stage.L, stage.R_pad, stage.W, S, O1,
                                int(narrow), stage.cap, PLACES[place], out)
    if err != 0:
        raise RuntimeError(f"mega_design: CUDA error {err}")
    return {"place": "shared" if out[0] else "global", "threads": out[1],
            "smem": out[2], "blocks_per_sm": out[3], "sms": out[4],
            "form": "warp" if out[5] else "block", "chunk": out[6]}


def smem_round_trip(steps: int = 4096) -> Tuple[float, float]:
    """One shared-memory load's round trip on the card, ``(cycles, ns)``:
    a warp's chase of ``steps`` dependent loads, at the SM clock rate."""
    scratch = torch.empty(2, dtype=torch.int64, device="cuda")
    cyc, ns = ctypes.c_float(), ctypes.c_float()
    err = _lib().jt_smem_round_trip(steps, scratch.data_ptr(),
                                    ctypes.byref(cyc), ctypes.byref(ns))
    if err != 0:
        raise RuntimeError(f"smem_round_trip: CUDA error {err}")
    return cyc.value, ns.value


# -- the group advance ----------------------------------------------------------

class MegaInflight:
    """A launched, uncollected group advance: K10 queued on the card, no
    result read back. :func:`collect_frontiers_mega` consumes it."""

    __slots__ = ("carries", "lanes", "n", "dead")

    def __init__(self, carries, lanes, n, dead):
        self.carries = carries
        self.lanes = lanes
        self.n = n
        self.dead = dead


def launch_frontiers_mega(carries, blocks) -> MegaInflight:
    """Queue one K10 launch advancing every carry of a same-geometry
    group through its block (``blocks``: ``(ret_slot int[n], slot_ops
    int[n, W])`` pairs aligned with ``carries``). The host stages the
    group's descriptors and returns in one buffer and copies it once;
    nothing is read back."""
    if not carries:
        return MegaInflight([], [], None, None)
    lanes = [c.lane for c in carries]
    if None in lanes:
        raise ValueError("mega-group geometry mismatch: "
                         f"{[mega_geometry(c) for c in carries]}")
    narrow = carries[0].engine == "reach-lane"
    stage = stage_blocks([ln.packed for ln in lanes], blocks, carries[0].W,
                         pin=lanes[0].T.device.type == "cuda")
    dead = mega_walk(lanes, stage, narrow=narrow)
    obs.count("reach.mega_walk")
    return MegaInflight(carries, lanes, stage.n, dead)


def collect_frontiers_mega(inf: MegaInflight) -> List[int]:
    """Read the group's dead returns (one copy), make each lane's out
    buffer its set and count its advanced returns as its own
    :meth:`~.reach.FrontierCarry.advance` would. Returns the per-member
    exact first dead return indices (-1: survived)."""
    if not inf.carries:
        return []
    deads = inf.dead.cpu().numpy()
    if (deads < -1).any():
        raise RuntimeError(f"mega_walk: lanes {np.flatnonzero(deads < -1)} "
                           f"name an op outside their tables")
    adv = np.where(deads < 0, inf.n, deads + 1).tolist()
    for c, ln, a in zip(inf.carries, inf.lanes, adv):
        ln.swap()
        c.advanced_returns += a
    return deads.tolist()


def advance_frontiers_mega(carries, blocks) -> List[int]:
    """:func:`launch_frontiers_mega` then :func:`collect_frontiers_mega`:
    one blocking group advance."""
    return collect_frontiers_mega(launch_frontiers_mega(carries, blocks))


# -- the post-hoc word walk: host helpers (the reference's, byte for byte) --

# geometry admission: a fire pass touches [S, S, W, NW] words in the
# reference's body; the same envelope keeps K11's set and its step in
# one block's shared memory (at most 2 x 3,648 words, W = 10, S = 114)
_MAX_GATHER_ELEMS = 1 << 22
_MAX_WORDS = 32                          # NW <= 32  ==>  W <= 10


def n_words(M: int) -> int:
    """uint32 words a state for a mask axis of ``M = 2**W``."""
    return max(1, int(M) >> 5)


def admits(S: int, W: int, M: int) -> bool:
    """The word walk's envelope: at most 32 words a state and
    ``S * S * W * NW <= 2**22``."""
    nw = n_words(M)
    return (nw <= _MAX_WORDS
            and S * S * max(W, 1) * nw <= _MAX_GATHER_ELEMS)


def pack_words(R: np.ndarray) -> np.ndarray:
    """bool [S, M] -> uint32 [S, NW]; bit ``m & 31`` of word ``m >> 5``
    = R[s, m]. For M < 32 the high bits are never set."""
    S, M = R.shape
    if M < 32:
        R = np.concatenate(
            [R, np.zeros((S, 32 - M), bool)], axis=1)
    packed = np.packbits(np.ascontiguousarray(R, np.uint8),
                         axis=1, bitorder="little")
    return packed.view(np.uint32).reshape(S, -1)


def unpack_words(words: np.ndarray, M: int) -> np.ndarray:
    """uint32 [S, NW] -> bool [S, M] (inverse of :func:`pack_words`)."""
    S = words.shape[0]
    b = np.unpackbits(words.view(np.uint8).reshape(S, -1),
                      axis=1, bitorder="little")
    return b[:, :M].astype(bool)


def pack_rows(R: np.ndarray) -> np.ndarray:
    """bool [rows, N] -> uint32 [rows, ceil(N/32)], any N: the row
    packing of :func:`pack_words` past power-of-two widths."""
    rows, N = R.shape
    pad = (-N) % 32
    if pad:
        R = np.concatenate([R, np.zeros((rows, pad), bool)], axis=1)
    packed = np.packbits(np.ascontiguousarray(R, np.uint8),
                         axis=1, bitorder="little")
    return packed.view(np.uint32).reshape(rows, (N + pad) // 32)


def unpack_rows(words: np.ndarray, N: int) -> np.ndarray:
    """uint32 [rows, NW] -> bool [rows, N] (inverse of
    :func:`pack_rows`)."""
    rows, NW = words.shape
    b = np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8)
        .reshape(rows, NW * 4),
        axis=1, bitorder="little")
    return b[:, :N].astype(bool)


def table_from_P(P: np.ndarray) -> np.ndarray:
    """The flat transition table of a per-op transition tensor ``P[o,
    s, t]`` (one-hot rows, all-zero = no transition): ``T[s, o]`` =
    target state or -1. The lockstep groups carry only P."""
    O1, S, _ = P.shape
    tgt = P.argmax(axis=2).astype(np.int32)          # [O1, S]
    has = P.max(axis=2) > 0.5
    T = np.where(has, tgt, -1).astype(np.int32)      # [O1, S]
    return np.ascontiguousarray(T.T)                 # [S, O1]


def pad_table(table: np.ndarray) -> np.ndarray:
    """Append the -1 sentinel column (slot op -1 reads it and
    discards)."""
    S = table.shape[0]
    return np.concatenate(
        [table, -np.ones((S, 1), table.dtype)], axis=1) \
        .astype(np.int32)


def _cmask32(W: int) -> np.ndarray:
    """32-bit within-word masks: bit m of ``cmask32[j]`` set iff mask
    position ``m`` has bit j set (j < 5; the pattern repeats every 32
    mask positions, so one word serves every word of the vector)."""
    m = np.arange(32)
    return np.array(
        [sum(1 << int(x) for x in m[(m >> j) & 1 == 1])
         for j in range(min(W, 5))] or [0], np.uint32)


# -- the post-hoc word walk: the plain version --------------------------------

_LOW32 = 0xFFFFFFFF


def _as_words(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2**32) (the shifts are
    not implemented for torch.uint32 on the CPU)."""
    return x.long() & _LOW32


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> their int32 bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _word_lanes_bad(ret_slot: torch.Tensor, slot_ops: torch.Tensor,
                    live: torch.Tensor, O1p: int) -> torch.Tensor:
    """Lanes whose walked steps name a slot past W or an op past the
    table: K11 walks none of them (dead -2, the set left as it was)."""
    W = slot_ops.shape[2]
    return (((slot_ops >= O1p) & live[..., None]).flatten(1).any(1)
            | ((ret_slot >= W) & live).any(1))


def walk_words_plain(Tpad: torch.Tensor, R0: torch.Tensor,
                     ret_slot: torch.Tensor, slot_ops: torch.Tensor,
                     n: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk of :func:`walk_words` in PyTorch ops, on any device: the
    reference's ``_walk_words`` over a lane axis, the table shared.

    ``Tpad`` i32 ``[S, O1p]`` (its last column the -1 sentinel), ``R0``
    i32 ``[H, S, NW]`` (the uint32 words' bit patterns), ``ret_slot``
    i32 ``[H, R]``, ``slot_ops`` i32 ``[H, R, W]``, ``n`` each lane's
    count of real steps (default R; the steps past it are the identity).
    Each step fires its slots (target ``S`` discards) in Jacobi passes,
    each ``R | fired(R)``, as many as its lanes' largest pending count
    (they reach the fixpoint, so the rest of the reference's W passes
    are the identity), then projects on its slot. Returns ``(final i32 [H, S, NW], dead i32
    [H])``: each lane's set after its steps and the first step after
    which it is empty, or -1; -2 for a lane whose steps name a slot
    past W or an op past the table (it walks nothing, as K11)."""
    H, S, NW = R0.shape
    R_len, W = slot_ops.shape[1], slot_ops.shape[2]
    dev = R0.device
    O1 = Tpad.shape[1] - 1
    R = _as_words(R0)
    T = Tpad.long()
    js = ret_slot.long()
    ops = slot_ops.long()
    steps = torch.arange(R_len, device=dev)
    live = steps[None, :] < (torch.full((H,), R_len, device=dev)
                             if n is None else n.to(dev).long())[:, None]
    bad = _word_lanes_bad(js, ops, live, Tpad.shape[1])
    live &= ~bad[:, None]
    js = torch.where(live, js, -1)
    ops = torch.where(live[..., None], ops, -1)
    Wc = min(W, 5)
    cm = torch.as_tensor(_cmask32(W).astype(np.int64), device=dev)
    within = torch.arange(Wc, device=dev)
    w_idx = torch.arange(NW, device=dev)
    bits = torch.arange(32, device=dev)
    # slot jj >= 5: word w with bit jj - 5 set takes word w ^ (1 << jj - 5)
    cross_src = torch.stack([w_idx ^ (1 << jb) for jb in range(W - 5)])         if W > 5 else w_idx[None, :0]
    cross_on = torch.stack([(w_idx >> jb) & 1 for jb in range(W - 5)])         if W > 5 else w_idx[None, :0]
    dead = torch.full((H,), -1, dtype=torch.long, device=dev)
    dead[bad] = -2
    # past every lane's count the steps are the identity
    R_len = int(live.sum(1).max()) if H else 0
    passes = (ops[:, :R_len] >= 0).sum(2).amax(0).tolist()

    # slot j < 5: keep the bit-j-clear half, shift it up by 2**j
    up_keep = (~cm[:Wc] & _LOW32)[None, None, :, None]
    up_by = (1 << within)[None, None, :, None]

    def fired(R, tgt):
        """OR of every slot's shifted rows into their targets."""
        up = (R[:, :, None, :] & up_keep) << up_by           # [H, S, Wc, NW]
        if W > 5:
            moved = R[:, :, cross_src] * cross_on[None, None]  # [H, S, W-5, NW]
            up = torch.cat([up, moved], 2)
        sh = ((up[..., None] >> bits) & 1).to(torch.uint8)  # [H, S, W, NW, 32]
        idx = tgt.reshape(H, S * W, 1).expand(H, S * W, NW * 32)
        acc = torch.zeros((H, S + 1, NW * 32), dtype=torch.uint8,
                          device=dev)
        acc.scatter_reduce_(1, idx, sh.reshape(H, S * W, NW * 32), "amax")
        return (acc[:, :S].view(H, S, NW, 32).long() << bits).sum(3)

    for r in range(R_len):
        o = torch.where(ops[:, r] < 0, O1, ops[:, r])          # [H, W]
        tgt = T[:, o].permute(1, 0, 2)                         # [H, S, W]
        tgt = torch.where(tgt < 0, S, tgt)
        for _ in range(passes[r]):
            R = R | fired(R, tgt)
        j = js[:, r]
        jw = j.clamp(0, max(Wc - 1, 0))
        proj_in = (R & cm[jw][:, None, None]) >> (1 << jw)[:, None, None]
        jb = (j - 5).clamp(min=0)
        src = (w_idx[None, :] | (1 << jb)[:, None]).clamp(max=NW - 1)
        keep = ((w_idx[None, :] >> jb[:, None]) & 1) == 0       # [H, NW]
        proj_x = R.gather(2, src[:, None, :].expand(H, S, NW)) * \
            keep[:, None, :]
        proj = torch.where((j < 5)[:, None, None], proj_in, proj_x)
        R = torch.where((j >= 0)[:, None, None], proj, R)
        died = (dead == -1) & ~(R != 0).flatten(1).any(1) & live[:, r]
        dead = torch.where(died, r, dead)
    R = torch.where(bad[:, None, None], _as_words(R0), R)
    return _as_int32(R).contiguous(), dead.to(torch.int32)


# -- the post-hoc word walk: the kernel ---------------------------------------

_WORD_LIB = None


def _word_lib():
    global _WORD_LIB
    if _WORD_LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("word_walk")
        lib.jt_word_walk.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
        lib.jt_word_walk.restype = ctypes.c_int
        lib.jt_word_design.argtypes = [ctypes.c_int] * 4 + \
            [ctypes.POINTER(ctypes.c_int)]
        lib.jt_word_design.restype = ctypes.c_int
        _WORD_LIB = lib
    return _WORD_LIB


def _word_shapes(Tpad, R0, ret_slot, slot_ops, n):
    """``(H, R, S, NW, W, O1p)`` of consistent operands, else
    ValueError."""
    H, S, NW = R0.shape if R0.dim() == 3 else (0, 0, 0)
    R = ret_slot.shape[1] if ret_slot.dim() == 2 else -1
    W = slot_ops.shape[2] if slot_ops.dim() == 3 else 0
    if (H < 1 or Tpad.dim() != 2 or Tpad.shape[0] != S
            or Tpad.shape[1] < 1 or tuple(ret_slot.shape) != (H, R)
            or tuple(slot_ops.shape) != (H, R, W) or not 1 <= W <= 10
            or NW != n_words(1 << W)
            or (n is not None and tuple(n.shape) != (H,))):
        raise ValueError(
            f"walk_words: inconsistent shapes Tpad{tuple(Tpad.shape)} "
            f"R0{tuple(R0.shape)} ret_slot{tuple(ret_slot.shape)} "
            f"slot_ops{tuple(slot_ops.shape)}"
            f"{'' if n is None else f' n{tuple(n.shape)}'}")
    if not admits(S, W, 1 << W):
        raise ValueError(f"walk_words: S={S} W={W} is past the word "
                         f"walk's envelope (admits)")
    return H, R, S, NW, W, Tpad.shape[1]


def _walk_words_cuda(Tpad, R0, ret_slot, slot_ops, n, events, stats):
    global WORD_LAUNCHES
    dev = R0.device
    H, R, S, NW, W, O1p = _word_shapes(Tpad, R0, ret_slot, slot_ops, n)
    if n is None:
        n = torch.full((H,), R, dtype=torch.int32, device=dev)
    reach_lane._check_operands(
        "walk_words", dev,
        (("Tpad", Tpad, torch.int32), ("R0", R0, torch.int32),
         ("ret_slot", ret_slot, torch.int32),
         ("slot_ops", slot_ops, torch.int32), ("n", n, torch.int32))
        + (() if stats is None else (("stats", stats, torch.int32),)))
    if stats is not None and tuple(stats.shape) != (H, 2):
        raise ValueError(f"walk_words: stats{tuple(stats.shape)}, want "
                         f"({H}, 2)")
    final = torch.empty_like(R0)
    dead = torch.empty(H, dtype=torch.int32, device=dev)
    lib = _word_lib()
    with torch.cuda.device(dev):
        evs = [None, None]
        if events is not None:
            for k, e in enumerate(events):
                if not e.cuda_event:
                    e.record()                 # made at its first record
                evs[k] = e.cuda_event
        err = lib.jt_word_walk(
            Tpad.data_ptr(), R0.data_ptr(), ret_slot.data_ptr(),
            slot_ops.data_ptr(), n.data_ptr(), final.data_ptr(),
            dead.data_ptr(), None if stats is None else stats.data_ptr(),
            H, R, S, O1p, W, NW,
            torch.cuda.current_stream().cuda_stream, *evs)
    if err != 0:
        raise RuntimeError(f"word_walk kernel launch failed: CUDA error "
                           f"{err}")
    WORD_LAUNCHES += 1
    return final, dead


def walk_words(Tpad: torch.Tensor, R0: torch.Tensor, ret_slot: torch.Tensor,
               slot_ops: torch.Tensor, n: Optional[torch.Tensor] = None,
               events=None, stats: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """H lanes' word walks with :func:`walk_words_plain`'s contract: K11
    for operands on the card (asynchronous, on the current stream, a
    block a lane; ``events``, two ``torch.cuda.Event(enable_timing=True)``,
    are recorded by the C entry point right around the launch; ``stats``,
    i32 ``[H, 2]`` on the card, receives each lane's fire passes and
    steps walked), the plain version for operands on the CPU. Any other
    device raises ValueError, a failed launch RuntimeError; there is no
    fallback."""
    dev = R0.device
    if dev.type == "cuda":
        return _walk_words_cuda(Tpad, R0, ret_slot, slot_ops, n, events,
                                stats)
    if dev.type != "cpu":
        raise ValueError(f"walk_words: unsupported device {dev}")
    _word_shapes(Tpad, R0, ret_slot, slot_ops, n)
    return walk_words_plain(Tpad, R0, ret_slot, slot_ops, n)


def word_design(S: int, W: int, R: int) -> dict:
    """The launch K11 makes for one lane of this geometry: threads a
    block, dynamic shared memory (bytes) and the returns staged at a
    time."""
    out = (ctypes.c_int * 3)()
    err = _word_lib().jt_word_design(S, W, n_words(1 << W), R, out)
    if err != 0:
        raise RuntimeError(f"word_design: CUDA error {err}")
    return {"threads": out[0], "smem": out[1], "chunk": out[2]}


def _raise_bad(dead: np.ndarray) -> None:
    if (dead < -1).any():
        raise RuntimeError(f"walk_words: lanes {np.flatnonzero(dead < -1)} "
                           f"name a slot past W or an op past the table")


def walk_returns_words(table: np.ndarray, ret_slot: np.ndarray,
                       slot_ops: np.ndarray, M: int, *,
                       device=None) -> Tuple[int, np.ndarray]:
    """The single history's post-hoc word walk on ``device`` (default:
    the card) from state 0, mask 0: ``table`` i32 ``[S, O]`` (the
    memo's, no sentinel column: it is appended here). Returns ``(dead,
    final_words)``: the exact first dead return (-1: linearizable),
    clamped to the stream, and the final set uint32 ``[S, NW]``. One K11
    launch on the card, no padding of the stream."""
    from jepsen_tpu_torch import device as _device

    dev = _device.resolve(device)
    n = int(ret_slot.shape[0])
    R0w = np.zeros((1, int(table.shape[0]), n_words(M)), np.int32)
    R0w[0, 0, 0] = 1
    final, dead = walk_words(
        torch.as_tensor(pad_table(table), device=dev),
        torch.as_tensor(R0w, device=dev),
        torch.as_tensor(np.ascontiguousarray(ret_slot, np.int32)[None],
                        device=dev),
        torch.as_tensor(np.ascontiguousarray(slot_ops, np.int32)[None],
                        device=dev))
    obs.count("reach.word_walk")
    d = dead.cpu().numpy()
    _raise_bad(d)
    words = final[0].cpu().numpy().view(np.uint32)
    if d[0] < 0:
        return -1, words
    return min(int(d[0]), max(n - 1, 0)), words

"""The mega-group advance of streaming sessions: many sessions' carried
frontiers (:class:`.reach.FrontierCarry`), each walked through one
append block of its own, in one launch of the hand-written CUDA kernel
K10 (``csrc/mega_walk.cu``). The counterparts of the reference
package's ``mega_geometry``, ``launch_frontiers_mega``,
``MegaInflight``, ``collect_frontiers_mega`` and
``advance_frontiers_mega`` (``jepsen_tpu/checkers/reach_word.py``),
whose batched walk is an XLA program (a ``vmap`` of the word walk over
the session axis).

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

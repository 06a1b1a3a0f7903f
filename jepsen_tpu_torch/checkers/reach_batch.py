"""Lockstep batch walk: H independent return streams advance through
the dense-reachability returns walk together, one return index per
step — the engine under chunk-lockstep (:mod:`.reach_chunklock`) and
under the lockstep lane of :func:`reach.check_many` and
:func:`reach.check_batch`.

:func:`batch_walk` runs the whole walk as one launch of the
hand-written CUDA kernel in ``csrc/batch_walk.cu`` (counterpart of the
reference package's Pallas batch kernel, ``reach_batch._batch_call``).
The config sets live side by side as ``R [E·M, H·S]``: lane h owns
columns ``h·S .. h·S+S-1`` and, within a lane, seed group e owns rows
``e·M .. e·M+M-1``. On the card each (lane, group) is one thread
block; on CPU tensors :func:`batch_walk_plain` runs the same walk in
PyTorch ops, following the reference's gate literally.

:func:`plan_buckets` packs a ragged batch (the ``independent`` keys,
or :func:`reach.check_batch`'s histories) into groups of lanes of like
length; each group is marshalled on the host
(:func:`prepare_returns_batch`), copied and queued as one K2 launch
with nothing fetched (:func:`dispatch_prepared`), and collected
(:func:`collect_returns_batch`) as the reference's split dispatch: the
capped ladder, the exact ``W``-pass rescue when a lane dies, and each
dead lane located at its first empty block checkpoint and refined by
:func:`reach_lane._refine_dead`, one K1 launch over the dying block.
Verdicts and dead indices are those of H single-history walks.

A group's walk body is ``dense`` (K2, above) or ``word``: the word-packed
walk K11 over its H lanes, one launch with the table derived from P
(:func:`_dispatch_words`), whose dead returns are exact, so its collect
reads them and refines nothing. :func:`_lockstep_body` picks it: the
group's pinned ``body``, else a recorded ``lockstep`` winner of
:mod:`.autotune` for the group's geometry, else ``dense``; ``word`` only
where :func:`reach_word.admits` the geometry. A fault in K11 propagates:
no group is walked again on K2.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import autotune, reach_lane, reach_word
from jepsen_tpu_torch.checkers.reach_lane import _FAST_PASSES

#: launches of the CUDA kernel (not of the plain version) in this process
KERNEL_LAUNCHES = 0


def group_geom(R_max: int, B: int) -> int:
    """Padded lockstep step count for a group whose longest stream has
    ``R_max`` returns: whole blocks of ``B``, bucketed."""
    from jepsen_tpu_torch.checkers.reach import _bucket

    return max(B, _bucket(-(-max(int(R_max), 1) // B) * B, B))


#: K2's envelope: the narrow walks' (K1, K3), :func:`reach_lane.lane_fits`
fits = reach_lane.lane_fits


def batch_walk_plain(P: torch.Tensor, slot_ops: torch.Tensor,
                     ret_slot_rh: torch.Tensor, R0: torch.Tensor, B: int,
                     n_pass: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk of :func:`batch_walk` in PyTorch ops, on any device.

    ``P`` f32[O1, S, S] (row O1-1 the all-zero sentinel for slot -1);
    ``slot_ops`` i32[R_pad·H·W], return-major, then lane, then slot;
    ``ret_slot_rh`` i32[R_pad, H]; ``R0`` f32[E·M, H·S]. Returns
    ``(ckpt f32[R_pad // B, E·M, H·S], final f32[E·M, H·S])``: the sets
    at the start of each block of ``B`` steps, and after the last. Step
    k runs ``max(1, min(pendmax_k, n_pass))`` fire passes on every lane,
    ``pendmax_k`` the largest pending count over the lanes, as the
    reference does; then each lane's projection."""
    R_pad, H = ret_slot_rh.shape
    W = slot_ops.numel() // (R_pad * H)
    Mp, HS = R0.shape
    S = HS // H
    O1 = P.shape[0]
    ops = slot_ops.view(R_pad, H, W)
    idx = torch.where(ops < 0, O1 - 1, ops).long()
    pendmax = (ops >= 0).sum(2).amax(1).tolist()
    ckpt = torch.empty((R_pad // B, Mp, HS), dtype=R0.dtype,
                       device=R0.device)
    R = R0.reshape(Mp, H, S).clone()
    for k in range(R_pad):
        if k % B == 0:
            ckpt[k // B] = R.reshape(Mp, HS)
        G = P[idx[k]]                                       # [H, W, S, S]
        for _ in range(max(1, min(pendmax[k], n_pass))):
            R = reach_lane._fire_lanes(R, G, W)
        R = reach_lane._project_lanes(R, ret_slot_rh[k])
    return ckpt, R.reshape(Mp, HS)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("batch_walk")
        lib.jt_batch_walk.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 9 + [ctypes.c_void_p]
        lib.jt_batch_walk.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _batch_walk_cuda(P, slot_ops, ret_slot_rh, R0, B: int, n_pass: int,
                     warp: bool = True):
    """Launch the kernel, one block per (lane, seed group), after one
    ``pack_tables`` launch for P's tables; ``warp=False`` takes the
    block form at every W."""
    global KERNEL_LAUNCHES
    dev = R0.device
    reach_lane._check_operands(
        "batch_walk", dev,
        (("P", P, torch.float32), ("slot_ops", slot_ops, torch.int32),
         ("ret_slot_rh", ret_slot_rh, torch.int32),
         ("R0", R0, torch.float32)))
    R_pad, H = ret_slot_rh.shape
    Mp, HS = R0.shape
    O1, S, _ = P.shape
    W = slot_ops.numel() // max(1, R_pad * H)
    E = Mp >> W
    if (slot_ops.numel() != R_pad * H * W or HS != H * S
            or P.shape[1:] != (S, S) or W < 1 or Mp != E << W or E < 1
            or R_pad % B):
        raise ValueError(f"batch_walk: inconsistent shapes P"
                         f"{tuple(P.shape)} slot_ops{tuple(slot_ops.shape)} "
                         f"ret_slot_rh{tuple(ret_slot_rh.shape)} R0"
                         f"{tuple(R0.shape)} B={B}")
    if not reach_lane._kernel_takes(W, S, O1):
        raise ValueError(f"batch_walk: the kernel does not take W={W} "
                         f"S={S} O1={O1} (see reach_lane.lane_fits)")
    ckpt = torch.empty((R_pad // B, Mp, HS), dtype=torch.float32,
                       device=dev)
    final = torch.empty((Mp, HS), dtype=torch.float32, device=dev)
    T = reach_lane.tables_scratch(O1, S, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_batch_walk(
            P.data_ptr(), T.data_ptr(), ret_slot_rh.data_ptr(),
            slot_ops.data_ptr(), R0.data_ptr(), ckpt.data_ptr(),
            final.data_ptr(), R_pad, H, E, W, S, O1, B, n_pass, int(warp),
            stream)
    if err != 0:
        raise RuntimeError(f"batch_walk kernel launch failed: CUDA error "
                           f"{err}")
    KERNEL_LAUNCHES += 1
    return ckpt, final


def batch_walk(P: torch.Tensor, slot_ops: torch.Tensor,
               ret_slot_rh: torch.Tensor, R0: torch.Tensor, B: int,
               n_pass: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lockstep walk with :func:`batch_walk_plain`'s contract: the
    CUDA kernel for tensors on the card (asynchronous, on the current
    stream), the plain version for tensors on the CPU."""
    if R0.device.type == "cuda":
        return _batch_walk_cuda(P, slot_ops, ret_slot_rh, R0, B, n_pass)
    if R0.device.type == "cpu":
        return batch_walk_plain(P, slot_ops, ret_slot_rh, R0, B, n_pass)
    raise ValueError(f"batch_walk: unsupported device {R0.device}")


# the checkpoint block of the lockstep groups (the independent keys and
# check_batch's histories), and plan_buckets' floor: a group walks whole
# blocks, so a small block keeps the padding of short keys small (a
# group of 47-return keys walks 64 steps, not 1,024); K2 takes any block
LOCK_BLOCK = 64
# the bytes a group's block checkpoints may take on the card: past them
# the block doubles (a long, wide group)
_CKPT_BYTES = 1 << 28


def lock_block(R_max: int, M: int, HS: int) -> int:
    """The checkpoint block of a lockstep group whose longest stream has
    ``R_max`` returns and whose sets are ``[M, HS]`` f32:
    :data:`LOCK_BLOCK`, doubled while the checkpoints would pass
    :data:`_CKPT_BYTES`."""
    B = LOCK_BLOCK
    while B < R_max and -(-R_max // B) * M * HS * 4 > _CKPT_BYTES:
        B *= 2
    return B


def plan_buckets(R_lens, *, group: int = 32) -> List[List[int]]:
    """Length-bucketed lane packing: partition a ragged batch of return
    streams into lockstep groups of at most ``group`` lanes such that no
    stream walks more than about twice its own length. Streams go to
    power-of-two length buckets, each bucket chunked longest first; the
    lengths up to :data:`LOCK_BLOCK`, the block every group pads to,
    share one floor bucket. Groups come longest bucket first. Returns a
    partition of ``range(len(R_lens))``."""
    order = sorted(range(len(R_lens)), key=lambda i: (-int(R_lens[i]), i))
    buckets: dict = {}
    for i in order:
        eff = max(int(R_lens[i]), LOCK_BLOCK, 1)
        buckets.setdefault((eff - 1).bit_length(), []).append(i)
    groups: List[List[int]] = []
    for key in sorted(buckets, reverse=True):
        idxs = buckets[key]
        for j in range(0, len(idxs), group):
            groups.append(idxs[j:j + group])
    return groups


def group_diag(geom, R_lens) -> dict:
    """One lockstep group's geometry and packing: real returns against
    the ``H · R_pad`` steps its lanes walk."""
    B, W, M, S, H, O1, R_pad = geom
    return {"H": H, "B": B, "W": W, "S": S, "R_pad": R_pad,
            "real_returns": int(sum(int(r) for r in R_lens)),
            "padded_returns": H * R_pad}


class BatchPrepared:
    """A group's operands marshalled on the host: ``geom`` is ``(B, W, M,
    S, H, O1, R_pad)``, ``host`` the arrays ``(P, slot_ops, ret_slot_rh,
    R0)`` of :func:`batch_walk`, ``R_lens`` each lane's real returns,
    ``body`` the walk body the caller pinned (``"word"``, ``"dense"``, or
    None: :func:`_lockstep_body` picks it at dispatch)."""
    __slots__ = ("geom", "host", "R_lens", "body")

    def __init__(self, geom, host, R_lens, body=None):
        self.geom = geom
        self.host = host
        self.R_lens = R_lens
        self.body = body


def prepare_returns_batch(P: np.ndarray, ret_slots: List[np.ndarray],
                          slot_ops: List[np.ndarray], M: int, *,
                          B: Optional[int] = None,
                          body: Optional[str] = None) -> BatchPrepared:
    """Marshal H return streams into the lockstep layout on the host: all
    padded with identity steps (slot -1) to one bucketed ``R_pad`` and
    interleaved return-major, ``slot_ops[(r·H + h)·W + j]`` and
    ``ret_slot_rh[r, h]``; each lane seeded one-hot at mask 0, state 0.
    ``B`` defaults to :func:`lock_block`; ``body`` pins the walk body."""
    O1, S, _ = P.shape
    H = len(ret_slots)
    W = max(int(so.shape[1]) for so in slot_ops)
    R_max = max(1, max(int(r.shape[0]) for r in ret_slots))
    if B is None:
        B = lock_block(R_max, M, H * S)
    R_pad = group_geom(R_max, B)
    rs_rh = np.full((R_pad, H), -1, np.int32)
    ops_rhw = np.full((R_pad, H, W), -1, np.int32)
    for h in range(H):
        n = int(ret_slots[h].shape[0])
        rs_rh[:n, h] = ret_slots[h]
        ops_rhw[:n, h, :slot_ops[h].shape[1]] = slot_ops[h]
    R0 = np.zeros((M, H * S), np.float32)
    R0[0, ::S] = 1.0                         # mask 0, state 0 per lane
    host = (np.ascontiguousarray(P, np.float32), ops_rhw.reshape(-1), rs_rh,
            R0)
    return BatchPrepared((B, W, M, S, H, O1, R_pad), host,
                         [int(r.shape[0]) for r in ret_slots], body)


class BatchInflight:
    """A group whose walk is queued and not fetched: the operands on the
    card, the capped walk's outputs, each lane's alive bit reduced on the
    card, and an event recorded after them (None on the CPU, where
    everything has run). ``body`` is the walk body the group took; a
    ``word`` group's ``final`` and ``alive`` are K11's final words and
    dead returns (``args`` and ``ckpt`` None). Produced by
    :func:`dispatch_prepared`, consumed by :func:`collect_returns_batch`."""
    __slots__ = ("prep", "args", "ckpt", "final", "alive", "event", "body")

    def __init__(self, prep, args, ckpt, final, alive, event, body="dense"):
        self.prep = prep
        self.args = args
        self.ckpt = ckpt
        self.final = final
        self.alive = alive
        self.event = event
        self.body = body


def _alive_lanes(final: torch.Tensor, H: int, S: int) -> torch.Tensor:
    """Each lane's alive bit, on the set's device."""
    return (final.view(-1, H, S) > 0.5).any(2).any(0)


def _record_event(dev):
    if dev.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def _lockstep_body(prep: BatchPrepared, dev) -> str:
    """A group's walk body: ``word`` (K11) or ``dense`` (K2). The pinned
    ``prep.body`` first, then the recorded ``lockstep`` winner for the
    group's padded geometry on ``dev``'s backend
    (:func:`autotune.lockstep_key`), else ``dense``; ``word`` only where
    :func:`reach_word.admits` the geometry."""
    _B, W, M, S, H, _O1, _R_pad = prep.geom
    if not reach_word.admits(S, W, M):
        return "dense"
    if prep.body is not None:
        return prep.body
    w = autotune.winner("lockstep", autotune.lockstep_key(S, W, M, H),
                        backend_name=dev.type)
    return w if w in ("word", "dense") else "dense"


def word_operands(prep: BatchPrepared):
    """A group's operands for :func:`reach_word.walk_words`, on the host:
    the table derived from P (:func:`reach_word.table_from_P`,
    :func:`reach_word.pad_table`), each lane's seed words (state 0, mask
    0), its stream lane-major (``ret`` i32 ``[H, R_pad]``, ``ops`` i32
    ``[H, R_pad, W]``) and its count of returns."""
    _B, W, M, S, H, _O1, R_pad = prep.geom
    P, ops_flat, rs_rh, _R0 = prep.host
    Tpad = reach_word.pad_table(reach_word.table_from_P(P))
    R0w = np.zeros((H, S, reach_word.n_words(M)), np.int32)
    R0w[:, 0, 0] = 1                         # mask 0, state 0 per lane
    rs_hr = np.ascontiguousarray(rs_rh.T)
    so_hrw = np.ascontiguousarray(
        np.swapaxes(ops_flat.reshape(R_pad, H, W), 0, 1))
    return Tpad, R0w, rs_hr, so_hrw, np.asarray(prep.R_lens, np.int32)


def _dispatch_words(prep: BatchPrepared, dev) -> BatchInflight:
    """Queue a group's word walk (:func:`word_operands`): all H lanes in
    one K11 launch, each walked to its own length; nothing is fetched."""
    final, dead = reach_word.walk_words(
        *(torch.as_tensor(a, device=dev) for a in word_operands(prep)))
    obs.count("lockstep.word_groups")
    return BatchInflight(prep, None, None, final, dead, _record_event(dev),
                         body="word")


def dispatch_prepared(prep: BatchPrepared, *, device=None,
                      P_dev: Optional[torch.Tensor] = None) -> BatchInflight:
    """Copy a prepared group to ``device`` (default: the card) and queue
    its walk, one K2 launch, or one K11 launch where the group's body is
    ``word`` (:func:`_lockstep_body`), on the current stream; nothing is
    fetched and nothing waits. ``P_dev`` is the group's P already on
    ``device`` (the groups of one batch share it), else P is copied
    too. Pair with :func:`collect_returns_batch`."""
    dev = _device.resolve(device)
    if _lockstep_body(prep, dev) == "word":
        return _dispatch_words(prep, dev)
    B, W, M, S, H, O1, R_pad = prep.geom
    if P_dev is None:
        P_dev = torch.as_tensor(prep.host[0], device=dev)
    args = (P_dev,) + tuple(torch.as_tensor(a, device=dev)
                            for a in prep.host[1:])
    ckpt, final = batch_walk(*args, B, min(W, _FAST_PASSES))
    alive = _alive_lanes(final, H, S)
    return BatchInflight(prep, args, ckpt, final, alive, _record_event(dev))


def collect_returns_batch(fl: BatchInflight) -> np.ndarray:
    """Wait for a queued group and return ``dead[H]``: per stream the
    first return index at which its config set emptied, or -1 if
    linearizable. The capped walk's alive bits come first (a surviving
    lane is valid); when a lane dies and ``W`` is past the cap, the exact
    ``W``-pass walk decides; each dead lane is located at its first empty
    block checkpoint, and one K1 launch over the block before it gives
    the exact return. A ``word`` group's dead returns are K11's, exact,
    each clamped to its lane's returns."""
    B, W, M, S, H, O1, R_pad = fl.prep.geom
    if fl.event is not None:
        fl.event.synchronize()
    if fl.body == "word":
        dead = fl.alive.cpu().numpy().astype(np.int64)
        reach_word._raise_bad(dead)
        lens = np.maximum(np.asarray(fl.prep.R_lens, np.int64) - 1, 0)
        return np.where(dead < 0, -1, np.minimum(dead, lens))
    alive = fl.alive.cpu().numpy()               # the one round trip
    ckpt = fl.ckpt
    if not alive.all() and min(W, _FAST_PASSES) < W:
        # capped-ladder deaths may be false: decide with the exact walk
        obs.count("lockstep.exact_rescue")
        ckpt, final = batch_walk(*fl.args, B, W)
        alive = _alive_lanes(final, H, S).cpu().numpy()
    dead = np.full(H, -1, np.int64)
    if alive.all():
        return dead
    lanes = np.nonzero(~alive)[0]
    n_blocks = R_pad // B
    ck = ckpt.view(n_blocks, M, H, S)
    occ = (ck[:, :, torch.as_tensor(lanes, device=ck.device)] > 0.5) \
        .any(3).any(1).cpu().numpy()              # [blocks, dead lanes]
    _P, ops_host, rs_host, _R0 = fl.prep.host
    ops_rhw = ops_host.reshape(R_pad, H, W)
    for i, h in enumerate(lanes):
        first_empty = int(np.argmin(occ[:, i])) if not occ[:, i].all() \
            else n_blocks
        blk = max(0, first_empty - 1)
        dead[h] = reach_lane._refine_dead(
            fl.args[0], W, rs_host[:, h], ops_rhw[:, h], ck[blk, :, h],
            blk * B, min(B, max(1, fl.prep.R_lens[h] - blk * B)), B)
    return dead


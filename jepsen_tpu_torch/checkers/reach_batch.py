"""Lockstep batch walk: H independent return streams advance through
the dense-reachability returns walk together, one return index per
step — the engine under chunk-lockstep (:mod:`.reach_chunklock`).

:func:`batch_walk` runs the whole walk as one launch of the
hand-written CUDA kernel in ``csrc/batch_walk.cu`` (counterpart of the
reference package's Pallas batch kernel, ``reach_batch._batch_call``).
The config sets live side by side as ``R [E·M, H·S]``: lane h owns
columns ``h·S .. h·S+S-1`` and, within a lane, seed group e owns rows
``e·M .. e·M+M-1``. On the card each (lane, group) is one thread
block; on CPU tensors :func:`batch_walk_plain` runs the same walk in
PyTorch ops, following the reference's gate literally.

:func:`walk_returns_batch` is the host side, as the reference's
blocking dispatch and collect: the capped ladder, the exact ``W``-pass
rescue when a lane dies, and each dead lane located at its first empty
block checkpoint and refined by :func:`reach_lane._refine_dead`, one K1
launch over the dying block.
Verdicts and dead indices are those of H single-history walks.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch.checkers import reach_lane
from jepsen_tpu_torch.checkers.reach_lane import _BLOCK, _FAST_PASSES

#: launches of the CUDA kernel (not of the plain version) in this process
KERNEL_LAUNCHES = 0


def group_geom(R_max: int, B: int) -> int:
    """Padded lockstep step count for a group whose longest stream has
    ``R_max`` returns: whole blocks of ``B``, bucketed."""
    from jepsen_tpu_torch.checkers.reach import _bucket

    return max(B, _bucket(-(-max(int(R_max), 1) // B) * B, B))


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


def pack_batch_operands(P: np.ndarray, ret_slots: List[np.ndarray],
                        slot_ops: List[np.ndarray], M: int, *,
                        B: int = _BLOCK, device=None):
    """Marshal H return streams into the lockstep layout on ``device``:
    all padded with identity steps (slot -1) to one bucketed ``R_pad``
    and interleaved return-major, ``slot_ops[(r·H + h)·W + j]`` and
    ``ret_slot_rh[r, h]``; each lane seeded one-hot at mask 0, state 0.
    Returns ``(geom, args, R_lens)``: ``geom`` is
    ``(B, W, M, S, H, O1, R_pad)`` and ``args`` feed :func:`batch_walk`."""
    dev = _device.resolve(device)
    O1, S, _ = P.shape
    H = len(ret_slots)
    W = max(int(so.shape[1]) for so in slot_ops)
    R_max = max(1, max(int(r.shape[0]) for r in ret_slots))
    R_pad = group_geom(R_max, B)
    rs_rh = np.full((R_pad, H), -1, np.int32)
    ops_rhw = np.full((R_pad, H, W), -1, np.int32)
    for h in range(H):
        n = int(ret_slots[h].shape[0])
        rs_rh[:n, h] = ret_slots[h]
        ops_rhw[:n, h, :slot_ops[h].shape[1]] = slot_ops[h]
    R0 = np.zeros((M, H * S), np.float32)
    R0[0, ::S] = 1.0                         # mask 0, state 0 per lane
    args = tuple(torch.as_tensor(a, device=dev) for a in (
        np.ascontiguousarray(P, np.float32), ops_rhw.reshape(-1), rs_rh,
        R0))
    geom = (B, W, M, S, H, O1, R_pad)
    return geom, args, [int(r.shape[0]) for r in ret_slots]


def walk_returns_batch(P: np.ndarray, ret_slots: List[np.ndarray],
                       slot_ops: List[np.ndarray], M: int, *,
                       B: int = _BLOCK, device=None) -> np.ndarray:
    """Walk H independent return streams in lockstep on ``device``
    (default: the card); returns ``dead[H]``, per stream the first
    return index at which its config set emptied, or -1 if
    linearizable. The capped ladder runs first (a surviving lane is
    valid); when a lane dies and ``W`` is past the cap, the exact
    ``W``-pass walk decides; each dead lane is located at its first
    empty block checkpoint, and one K1 launch over the block before it
    gives the exact return."""
    geom, args, R_lens = pack_batch_operands(P, ret_slots, slot_ops, M,
                                             B=B, device=device)
    B, W, M, S, H, O1, R_pad = geom
    n_fast = min(W, _FAST_PASSES)

    def alive_of(final):
        return (final.view(M, H, S) > 0.5).any(2).any(0).cpu().numpy()

    ckpt, final = batch_walk(*args, B, n_fast)
    alive = alive_of(final)                      # the one round trip
    if not alive.all() and n_fast < W:
        # capped-ladder deaths may be false: decide with the exact walk
        ckpt, final = batch_walk(*args, B, W)
        alive = alive_of(final)
    dead = np.full(H, -1, np.int64)
    if alive.all():
        return dead
    P_t, ops_t, rs_t, _R0 = args
    n_blocks = R_pad // B
    ck = ckpt.view(n_blocks, M, H, S)
    for h in np.nonzero(~alive)[0]:
        occ = (ck[:, :, h] > 0.5).reshape(n_blocks, -1).any(1).cpu().numpy()
        first_empty = int(np.argmin(occ)) if not occ.all() else n_blocks
        blk = max(0, first_empty - 1)
        dead[h] = reach_lane._refine_dead(
            P_t, W, rs_t[:, h].cpu().numpy(),
            ops_t.view(R_pad, H, W)[:, h].cpu().numpy(), ck[blk, :, h],
            blk * B, min(B, max(1, R_lens[h] - blk * B)), B)
    return dead

"""The single-history returns walk on the card — the check's hot path.

:func:`lane_walk` runs the whole walk over the dense config set
``R[mask, state]`` as one launch of the hand-written CUDA kernel in
``csrc/lane_walk.cu`` (counterpart of the reference package's Pallas
lane kernel, ``reach_lane._lane_call``). On CPU tensors it runs
:func:`lane_walk_plain`, the same arithmetic in PyTorch ops; on CUDA
tensors it launches the kernel or raises.

The host side mirrors the reference: :func:`pack_operands` pads the
return stream to whole blocks of ``B`` returns on the device;
:func:`walk_returns` runs the pending-count gate ladder capped at :data:`_FAST_PASSES`
passes, then, for ``W > _FAST_PASSES``, the exact ``W``-pass rescue
when the capped walk dies (sound: fewer passes under-approximate the
config set, and emptiness is monotone); a death is located at the
first empty block checkpoint and refined one return at a time by
:func:`_refine_dead`. Semantics are identical to
:func:`jepsen_tpu_torch.checkers.reach._walk_returns`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import device as _device

_BLOCK = 1024
# ladder cap for the fast walk: gates above a return's pending count
# are untaken, so W <= 8 walks are exact in one launch; W > 8 runs the
# capped walk plus an exact rescue on death
_FAST_PASSES = 8
# returns per launch when a should_abort hook is supplied: the walk
# then runs segment by segment with the config set carried, checking
# the hook between segments
_ABORT_SEG = 32768
# the kernel's limits: 1 <= W <= 16 slots, S <= 32 states (one 32-bit
# word per mask), and R plus P in one block's shared memory (Hopper:
# 227 KB per block)
_MAX_W = 16
_MAX_S = 32
_SMEM_BYTES = 227 * 1024

#: launches of the CUDA kernel (not of the plain version) in this process
KERNEL_LAUNCHES = 0


class Aborted(RuntimeError):
    """The caller's ``should_abort`` fired between segments."""


_CHUNK = 256                    # returns staged per refill (kChunk)


def smem_bytes(W: int, S: int, O1: int, warp: bool = True) -> int:
    """Shared memory one walk takes, for routing without a card. It
    mirrors ``jt_lane_walk_smem`` in ``csrc/lane_walk.cu``, the layout's
    one source, and ``chip_smoke.py`` checks that the two agree: P as
    ``[O1, S]`` target-set words, a chunk of the return stream, and
    unless the warp kernel holds the set in registers (``warp`` and
    W <= 5) R as one 32-bit state word per mask, double-buffered
    ``[2, M]``."""
    R = 0 if warp and W <= 5 else 2 * (1 << W)
    return 4 * (R + _CHUNK * (W + 1) + O1 * S)


def _kernel_takes(W: int, S: int, O1: int) -> bool:
    return 1 <= W <= _MAX_W and 1 <= S <= _MAX_S \
        and smem_bytes(W, S, O1) <= _SMEM_BYTES


def lane_fits(S_pad: int, M: int, n_ops: int) -> bool:
    """Whether the kernel takes this geometry: at most 32 states and 16
    slots, with R and P in one block's shared memory."""
    return _kernel_takes(M.bit_length() - 1, S_pad, n_ops + 1)


# -- the kernel and its plain version ---------------------------------------

def _one_fire_pass(R, G_all, W: int, M: int, S: int):
    """One Jacobi fire pass: one ``[M,S]@[S,W·S]`` product gives every
    config's image under every slot's op, computed from the pass-start
    set; each slot's images then land in the bit-set half of the mask
    axis by a half-split max with a ``> 0.5`` threshold."""
    F = R @ G_all
    R = R.clone()
    for jj in range(W):
        half, blk = M >> (jj + 1), 1 << jj
        Rr = R.view(half, 2, blk, S)
        Fr = F[:, jj * S:(jj + 1) * S].reshape(half, 2, blk, S)
        Rr[:, 1] = torch.maximum(Rr[:, 1], (Fr[:, 0] > 0.5).to(R.dtype))
    return R


def _project(R, j: int, W: int, M: int, S: int):
    """Projection on the returning slot ``j``: keep configs that fired
    slot j, clearing the bit; ``j = -1`` (padding) is the identity."""
    if j < 0:
        return R
    half, blk = M >> (j + 1), 1 << j
    taken = R.view(half, 2, blk, S)[:, 1]
    return torch.stack([taken, torch.zeros_like(taken)], 1).reshape(M, S)


def lane_walk_plain(P: torch.Tensor, ret_slot: torch.Tensor,
                    slot_ops: torch.Tensor, R0: torch.Tensor, B: int,
                    n_pass: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk of :func:`lane_walk` in PyTorch ops, on any device.

    ``P`` f32[O1, S, S] (row O1-1 the all-zero sentinel for slot -1);
    ``ret_slot`` i32[R_pad]; ``slot_ops`` i32[R_pad, W]; ``R0``
    f32[M, S]. Returns ``(ckpt f32[R_pad // B, M, S], final f32[M, S])``:
    the set at the start of each block of ``B`` returns, and after the
    last. Each return runs ``min(c_r, n_pass)`` fire passes (``c_r`` its
    pending count), then the projection. (The reference runs at least
    one pass; with ``c_r = 0`` every op is -1 and a pass is the
    identity, so the two agree bit for bit.)"""
    R_pad, W = slot_ops.shape
    M, S = R0.shape
    O1 = P.shape[0]
    idx = torch.where(slot_ops < 0, O1 - 1, slot_ops).long()
    pend = (slot_ops >= 0).sum(1).tolist()
    js = ret_slot.tolist()
    ckpt = torch.empty((R_pad // B, M, S), dtype=R0.dtype,
                       device=R0.device)
    R = R0.clone()
    for b0 in range(0, R_pad, B):
        ckpt[b0 // B] = R
        # the block's fire operands G_all[r] = [S, W*S], gathered at once
        G = P[idx[b0:b0 + B]].permute(0, 2, 1, 3).reshape(-1, S, W * S)
        for k in range(G.shape[0]):
            r = b0 + k
            for _ in range(min(pend[r], n_pass)):
                R = _one_fire_pass(R, G[k], W, M, S)
            R = _project(R, js[r], W, M, S)
    return ckpt, R


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("lane_walk")
        lib.jt_lane_walk.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.jt_lane_walk.restype = ctypes.c_int
        lib.jt_lane_walk_smem.argtypes = [ctypes.c_int] * 4
        lib.jt_lane_walk_smem.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


def _lane_walk_cuda(P, ret_slot, slot_ops, R0, B: int, n_pass: int,
                    warp: bool = True):
    """Launch the kernel; ``warp=False`` takes the shared-memory kernel
    at every W (``chip_smoke.py`` times the two)."""
    global KERNEL_LAUNCHES
    R_pad, W = slot_ops.shape
    M, S = R0.shape
    O1 = P.shape[0]
    for name, t, dt in (("P", P, torch.float32),
                        ("ret_slot", ret_slot, torch.int32),
                        ("slot_ops", slot_ops, torch.int32),
                        ("R0", R0, torch.float32)):
        if t.device != R0.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"lane_walk: {name} must be a contiguous "
                             f"{dt} tensor on {R0.device}")
    if P.shape[1:] != (S, S) or ret_slot.shape != (R_pad,) \
            or M != 1 << W or R_pad % B:
        raise ValueError(f"lane_walk: inconsistent shapes P{tuple(P.shape)} "
                         f"ret_slot{tuple(ret_slot.shape)} slot_ops"
                         f"{tuple(slot_ops.shape)} R0{tuple(R0.shape)} B={B}")
    if not _kernel_takes(W, S, O1):
        raise ValueError(f"lane_walk: the kernel does not take W={W} "
                         f"S={S} O1={O1} (see lane_fits)")
    lib = _lib()
    ckpt = torch.empty((R_pad // B, M, S), dtype=torch.float32,
                       device=R0.device)
    final = torch.empty((M, S), dtype=torch.float32, device=R0.device)
    with torch.cuda.device(R0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_lane_walk(
            P.data_ptr(), ret_slot.data_ptr(), slot_ops.data_ptr(),
            R0.data_ptr(), ckpt.data_ptr(), final.data_ptr(),
            R_pad, W, S, O1, B, n_pass, int(warp), stream)
    if err != 0:
        raise RuntimeError(f"lane_walk kernel launch failed: CUDA error "
                           f"{err}")
    KERNEL_LAUNCHES += 1
    return ckpt, final


def lane_walk(P: torch.Tensor, ret_slot: torch.Tensor,
              slot_ops: torch.Tensor, R0: torch.Tensor, B: int,
              n_pass: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The returns walk with :func:`lane_walk_plain`'s contract: the
    CUDA kernel for tensors on the card (asynchronous, on the current
    stream), the plain version for tensors on the CPU."""
    if R0.device.type == "cuda":
        return _lane_walk_cuda(P, ret_slot, slot_ops, R0, B, n_pass)
    if R0.device.type == "cpu":
        return lane_walk_plain(P, ret_slot, slot_ops, R0, B, n_pass)
    raise ValueError(f"lane_walk: unsupported device {R0.device}")


# -- host side ---------------------------------------------------------------

def _padded(ret_slot: np.ndarray, slot_ops: np.ndarray, B: int):
    """Pad the stream with identity rows (slot -1, no pending ops) to a
    bucketed whole number of blocks."""
    from jepsen_tpu_torch.checkers.reach import _bucket

    R_real = int(ret_slot.shape[0])
    R_pad = max(B, _bucket(-(-max(R_real, 1) // B) * B, B))
    if R_pad != R_real:
        ret_slot = np.pad(ret_slot, (0, R_pad - R_real), constant_values=-1)
        slot_ops = np.pad(slot_ops, ((0, R_pad - R_real), (0, 0)),
                          constant_values=-1)
    return ret_slot, slot_ops


def operands_from_numpy(P: np.ndarray, ret_slot: np.ndarray,
                        slot_ops: np.ndarray, R0_sm: np.ndarray, *,
                        B: int = _BLOCK, device=None):
    """The reference's host operands (``_build_P``'s f32[O1, S, S],
    ``returns_view``'s i32[R] ``ret_slot`` and i32[R, W] ``slot_ops``,
    and a bool[S, M] seed) as this walk's tensors on ``device``:
    ``(P, ret_slot, slot_ops, R0)`` with the stream padded to whole
    blocks of ``B`` and the seed in the ``[M, S]`` layout."""
    dev = _device.resolve(device)
    ret_slot, slot_ops = _padded(ret_slot, slot_ops, B)
    return (torch.as_tensor(np.ascontiguousarray(P, np.float32),
                            device=dev),
            torch.as_tensor(np.ascontiguousarray(ret_slot, np.int32),
                            device=dev),
            torch.as_tensor(np.ascontiguousarray(slot_ops, np.int32),
                            device=dev),
            torch.as_tensor(np.ascontiguousarray(R0_sm.T, np.float32),
                            device=dev))


def pack_operands(P: np.ndarray, ret_slot: np.ndarray,
                  slot_ops: np.ndarray, R0_sm: np.ndarray, *,
                  B: int = _BLOCK, device=None):
    """Marshal host operands for the walk. Returns ``(geometry,
    args)``: ``geometry`` is ``(B, W, M, S, O1, R_pad)`` and ``args``
    (:func:`operands_from_numpy`) feed :func:`lane_walk`."""
    O1, S, _ = P.shape
    args = operands_from_numpy(P, ret_slot, slot_ops, R0_sm, B=B,
                               device=device)
    W = int(slot_ops.shape[1])
    M = int(R0_sm.shape[1])
    return (B, W, M, S, O1, int(args[1].shape[0])), args


def _refine_dead(P: torch.Tensor, W: int, M: int, ret_slot: np.ndarray,
                 slot_ops: np.ndarray, R0_blk_sm: torch.Tensor, start: int,
                 n: int) -> int:
    """Exact dead return index within ``[start, start + n)``: re-walk
    that block one return at a time with the torch walk from the
    block-start config set (bool ``[S, M]``)."""
    from jepsen_tpu_torch.checkers import reach

    dev = P.device
    xc, bm = reach._xor_bitmask(W, M)
    ptr1, _, alive, _ = reach._walk_returns(
        P, torch.as_tensor(xc, device=dev), torch.as_tensor(bm, device=dev),
        torch.as_tensor(np.ascontiguousarray(ret_slot[start:start + n],
                                             np.int32), device=dev),
        torch.as_tensor(np.ascontiguousarray(slot_ops[start:start + n],
                                             np.int32), device=dev),
        R0_blk_sm, unroll=1)
    if alive:                           # shouldn't happen; be conservative
        return start + n - 1
    return start + ptr1 - 1


def _locate_dead(ckpt: torch.Tensor, P, W: int, M: int, B: int,
                 ret_slot, slot_ops, base: int, R_real: int) -> int:
    """First empty block checkpoint → the block before it holds the
    death; refine it one return at a time."""
    occupied = ckpt.reshape(ckpt.shape[0], -1).any(1).cpu().numpy()
    first_empty = int(np.argmin(occupied)) if not occupied.all() \
        else int(ckpt.shape[0])
    blk = max(0, first_empty - 1)
    start = base + blk * B
    return _refine_dead(P, W, M, ret_slot, slot_ops, ckpt[blk].T > 0.5,
                        start, min(B, max(1, R_real - start)))


def prefix_set(P: np.ndarray, ret_slot: np.ndarray, slot_ops: np.ndarray,
               R0_sm: np.ndarray, n: int, *, device=None,
               B: int = _BLOCK) -> np.ndarray:
    """The exact config set (bool ``[S, M]``) after the first ``n``
    returns: one walk with the full ``W``-pass ladder."""
    W = int(slot_ops.shape[1])
    args = operands_from_numpy(P, ret_slot[:n], slot_ops[:n], R0_sm, B=B,
                               device=device)
    _, final = lane_walk(*args, B, W)
    return (final.cpu().numpy() > 0.5).T


def _walk_segmented(args, geom, n_pass: int, should_abort):
    """Abortable drive: segments of about :data:`_ABORT_SEG` returns with
    the config set carried, the hook checked between segments. Returns
    ``(ckpt, base, final)``: on a death, the dying segment's checkpoints
    and start; raises :class:`Aborted` when the hook fires."""
    B, W, M, S, O1, R_pad = geom
    P, rs_t, so_t, R_cur = args
    seg_len = max(B, _ABORT_SEG // B * B)
    base = 0
    while base < R_pad:
        if should_abort():
            raise Aborted()
        seg = min(seg_len, R_pad - base)
        ckpt, R_cur = lane_walk(P, rs_t[base:base + seg],
                                so_t[base:base + seg], R_cur, B, n_pass)
        if not bool(R_cur.any()):
            return ckpt, base, R_cur
        base += seg
    return None, base, R_cur


def walk_returns(P: np.ndarray, ret_slot: np.ndarray,
                 slot_ops: np.ndarray, R0_sm: np.ndarray, *,
                 device=None, B: int = _BLOCK, fetch_R: bool = True,
                 should_abort=None) -> Tuple[int, Optional[np.ndarray]]:
    """Run the full returns walk on ``device`` (default: the card).

    ``P`` f32[O1, S, S] (last row the all-zero sentinel); ``ret_slot``
    i32[R]; ``slot_ops`` i32[R, W]; ``R0_sm`` bool[S, M]. Returns
    ``(dead, R_final)``: ``dead`` is the first return index at which the
    config set emptied (-1 if linearizable) and ``R_final`` the final
    config set as bool[S, M] (``None`` on invalid histories or with
    ``fetch_R=False``). With ``should_abort`` the walk runs in
    :data:`_ABORT_SEG`-return segments and raises :class:`Aborted` when
    the hook fires between them."""
    R_real = int(ret_slot.shape[0])
    geom, args = pack_operands(P, ret_slot, slot_ops, R0_sm, B=B,
                               device=device)
    B, W, M, S, O1, R_pad = geom
    n_fast = min(W, _FAST_PASSES)

    def run(n_pass: int):
        if should_abort is not None:
            return _walk_segmented(args, geom, n_pass, should_abort)
        ckpt, final = lane_walk(*args, B, n_pass)
        return ckpt, 0, final

    ckpt, base, final = run(n_fast)
    alive = bool(final.any())               # the one device round trip
    if n_fast < W and (not alive or fetch_R):
        # a capped death may be false, and a capped surviving set may
        # be an under-approximation: decide (and decode) exactly
        ckpt, base, final = run(W)
        alive = bool(final.any())
    if alive:
        return -1, (final.cpu().numpy() > 0.5).T if fetch_R else None
    return _locate_dead(ckpt, args[0], W, M, B, ret_slot, slot_ops, base,
                        R_real), None

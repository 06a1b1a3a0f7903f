"""The single-history returns walk on the card — the check's hot path.

:func:`lane_walk` runs the whole walk over the dense config set
``R[mask, state]`` as one launch of the hand-written CUDA kernel in
``csrc/lane_walk.cu`` (counterpart of the reference package's Pallas
lane kernel, ``reach_lane._lane_call``), on P's nibble image tables
(:func:`image_tables_plain` is their plain version; built by one launch
of the kernels' ``pack_tables``, then copied into shared memory when
they fit, :func:`tables_shared`, else read from device memory). The
kernel also reports the exact dead return, the first after which the
set is empty. On CPU tensors it runs
:func:`lane_walk_plain`, the same arithmetic in PyTorch ops; on CUDA
tensors it launches the kernel or raises.

The host side mirrors the reference: :func:`pack_operands` pads the
return stream to whole blocks of ``B`` returns on the device;
:func:`walk_returns` runs the pending-count gate ladder capped at
:data:`_FAST_PASSES` passes, then, for ``W > _FAST_PASSES``, the exact
``W``-pass rescue when the capped walk dies (sound: fewer passes
under-approximate the config set, and emptiness is monotone); the
death is the walk's own dead return. Semantics are identical to
:func:`jepsen_tpu_torch.checkers.reach._walk_returns`.

:func:`keyed_walk` walks many keys' streams concatenated into one flat
stream, one launch of ``csrc/keyed_walk.cu`` (counterpart of
``reach_lane._keyed_call``) on the same tables, one thread block a key,
and :func:`walk_returns_keyed` is its host side (the keys' runs found in
numpy, :func:`key_runs`); :func:`keyed_walk_plain` is its plain
version.
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
# the kernels' limits: 1 <= W <= 16 slots, S <= 32 states (one 32-bit
# word per mask), and the narrow walks' envelope (keyed_smem_bytes) in
# one block's shared memory (Hopper: 227 KB per block)
_MAX_W = 16
_MAX_S = 32
_SMEM_BYTES = 227 * 1024

#: launches of the CUDA kernel (not of the plain version) in this process
KERNEL_LAUNCHES = 0
#: launches of the keyed CUDA kernel (K3) in this process
KEYED_LAUNCHES = 0


class Aborted(RuntimeError):
    """The caller's ``should_abort`` fired between segments."""


_CHUNK = 256                    # returns staged per refill (kChunk)
# the warp form: at most 5 slots (M <= 32 masks), and for the wide walks
# at most 8 words a mask (kWarpMaxW, kWarpMaxNW)
_WARP_MAX_W = 5
_WARP_MAX_NW = 8


def n_words(S: int) -> int:
    """32-bit words a mask's set of ``S`` states takes."""
    return -(-S // 32)


def _pow2_at_least(n: int) -> int:
    return 1 << (n - 1).bit_length()


def n_nibbles(S: int) -> int:
    """Nibbles (groups of 4 states) an image table holds, ``K``:
    ``ceil(S / 4)``, rounded up to a power of two where the warp form may
    take ``S`` (at most 8 words; the padding nibbles' entries are zero).
    ``n_nibbles`` in ``csrc/walk.cuh``."""
    K = -(-S // 4)
    return K if n_words(S) > _WARP_MAX_NW else _pow2_at_least(K)


def table_words(S: int) -> int:
    """Words an image table's entry takes, ``NT``: ``NW`` rounded up to a
    power of two up to 8 words (the warp form reads an entry as one
    vector), else ``NW``; one word at most 32 states."""
    NW = n_words(S)
    return NW if NW > _WARP_MAX_NW else _pow2_at_least(NW)


def table_bytes(S: int, O1: int) -> int:
    """Bytes of P's image tables ``[O1, K, 16, NT]``."""
    return 4 * O1 * n_nibbles(S) * 16 * table_words(S)


def _smem_base(W: int, warp: bool) -> int:
    R = 0 if warp and W <= _WARP_MAX_W else 2 * (1 << W)
    return 4 * (R + _CHUNK * (W + 1))


def tables_shared(W: int, S: int, O1: int, warp: bool = True) -> bool:
    """Whether K1, K2 and K3 keep P's image tables in each block's shared
    memory, beside the set and a chunk of the stream (else in device
    memory); ``t_shared`` in ``csrc/walk.cuh``."""
    return _smem_base(W, warp) + table_bytes(S, O1) <= _SMEM_BYTES


def smem_bytes(W: int, S: int, O1: int, warp: bool = True) -> int:
    """Shared memory one K1, K2 or K3 block takes. It mirrors
    ``lane_smem`` in ``csrc/walk.cuh`` (exported as ``jt_lane_walk_smem``
    and ``jt_keyed_walk_smem``), and ``chip_smoke.py`` checks that they
    agree: P's image tables when
    they fit (:func:`tables_shared`), a chunk of the return stream, and
    unless the warp form holds the set in registers (``warp`` and
    W <= 5) R as one 32-bit state word per mask, double-buffered
    ``[2, M]``."""
    T = table_bytes(S, O1) if tables_shared(W, S, O1, warp) else 0
    return _smem_base(W, warp) + T


def keyed_smem_bytes(W: int, S: int, O1: int, warp: bool = True) -> int:
    """The envelope of the three narrow walks (K1, K2, K3), as bytes: P
    as ``[O1, S]`` target-set words beside :func:`smem_bytes`'s set and
    chunk must fit in one block's shared memory. It is no kernel's
    layout (the walks keep P's image tables, in shared memory where they
    fit, :func:`smem_bytes`); it fixes which geometries
    :func:`lane_fits` takes, so that the routes do not move."""
    return _smem_base(W, warp) + 4 * O1 * S


def _kernel_takes(W: int, S: int, O1: int) -> bool:
    return 1 <= W <= _MAX_W and 1 <= S <= _MAX_S \
        and keyed_smem_bytes(W, S, O1) <= _SMEM_BYTES


def lane_fits(S_pad: int, M: int, n_ops: int) -> bool:
    """Whether the narrow walk kernels (K1, K2 and K3) take this
    geometry: at most 32 states and 16 slots, within the envelope
    :func:`keyed_smem_bytes` (each walk keeps its tables in device
    memory where they do not fit beside the set)."""
    return _kernel_takes(M.bit_length() - 1, S_pad, n_ops + 1)


#: the keyed kernel's envelope is the lane kernel's
keyed_fits = lane_fits


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


def _fire_lanes(R, G, W: int):
    """One Jacobi fire pass over independent lanes walked in lockstep
    (the plain versions of K2 and K3). ``R`` f32[M', H, S]: lane h's
    configs, row ``e*M + m`` for mask m of seed group e; ``G``
    f32[H, W, S, S]: each lane's pending-op matrices (the zero sentinel
    for a free slot). Every slot fires from the pass-start set into the
    bit-set half of its mask axis, which never leaves a group of M
    rows."""
    Mp, H, S = R.shape
    F = torch.einsum("mhs,hjst->mhjt", R, G)
    R = R.clone()
    for j in range(W):
        half, blk = Mp >> (j + 1), 1 << j
        Rr = R.view(half, 2, blk, H, S)
        Fr = F[:, :, j].reshape(half, 2, blk, H, S)
        Rr[:, 1] = torch.maximum(Rr[:, 1], (Fr[:, 0] > 0.5).to(R.dtype))
    return R


def _project_lanes(R, js):
    """Each lane's projection on its returning slot: ``js`` int[H], -1
    the identity. Row r of lane h keeps row ``r | 1 << js[h]`` when bit
    ``js[h]`` of r is clear, and is cleared when it is set."""
    Mp, H, S = R.shape
    rows = torch.arange(Mp, device=R.device)[:, None]
    js = js.long()[None, :]
    bit = torch.where(js >= 0, torch.ones_like(js) << js.clamp(min=0), 0)
    src = (rows | bit).expand(Mp, H)
    keep = ((rows & bit) == 0).to(R.dtype)
    return R.gather(0, src[..., None].expand(Mp, H, S)) * keep[..., None]


def lane_walk_plain(P: torch.Tensor, ret_slot: torch.Tensor,
                    slot_ops: torch.Tensor, R0: torch.Tensor, B: int,
                    n_pass: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The walk of :func:`lane_walk` in PyTorch ops, on any device.

    ``P`` f32[O1, S, S] (row O1-1 the all-zero sentinel for slot -1);
    ``ret_slot`` i32[R_pad]; ``slot_ops`` i32[R_pad, W]; ``R0``
    f32[M, S]. Returns ``(ckpt f32[R_pad // B, M, S], final f32[M, S],
    dead i32[1])``: the set at the start of each block of ``B`` returns,
    the set after the last, and the first return after which the set is
    empty, or -1. Each return runs ``min(c_r, n_pass)`` fire passes
    (``c_r`` its pending count), then the projection. (The reference runs
    at least one pass; with ``c_r = 0`` every op is -1 and a pass is the
    identity, so the two agree bit for bit.) An empty set stays empty, so
    the checkpoints past the death and the final set are empty."""
    R_pad, W = slot_ops.shape
    M, S = R0.shape
    O1 = P.shape[0]
    idx = torch.where(slot_ops < 0, O1 - 1, slot_ops).long()
    pend = (slot_ops >= 0).sum(1).tolist()
    js = ret_slot.tolist()
    ckpt = torch.empty((R_pad // B, M, S), dtype=R0.dtype,
                       device=R0.device)
    alive = []                  # per return: is the set after it nonempty
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
            alive.append(R.any())
    alive = torch.stack(alive)
    dead = -1 if bool(alive.all()) else int(torch.argmin(alive.int()))
    return ckpt, R, torch.tensor([dead], dtype=torch.int32,
                                 device=R0.device)


def image_tables_plain(P: torch.Tensor) -> torch.Tensor:
    """P's nibble image tables in PyTorch ops, on any device: the plain
    version of the kernels' ``pack_tables`` (``csrc/walk.cuh``; K1 and
    K2 at most 32 states, K4 and K5 at any).
    ``P`` f32[O1, S, S] 0/1. Returns i32[O1, K, 16, NT] (K =
    :func:`n_nibbles`, NT = :func:`table_words`): entry ``[o, k, v]``
    holds the image under op o of the states ``4k + b`` for the set bits
    b of v, as NT words of 32 target states (bit i of word w: state
    32w + i; words past ``ceil(S/32)`` are zero), each word's bits as a
    signed int32."""
    O1, S, _ = P.shape
    K, NT = n_nibbles(S), table_words(S)
    rows = torch.zeros(O1, 4 * K, 32 * NT, dtype=P.dtype, device=P.device)
    rows[:, :S, :S] = (P > 0.5).to(P.dtype)
    sel = ((torch.arange(16, device=P.device)[:, None]
            >> torch.arange(4, device=P.device)) & 1).to(P.dtype)
    # [16, 4] @ [O1, K, 4, 32·NT]: how many of v's states reach each target
    hit = (sel @ rows.view(O1, K, 4, 32 * NT)) > 0.5
    shift = torch.arange(32, device=P.device)
    words = (hit.view(O1, K, 16, NT, 32).long() << shift).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


_LIB = None
_KEYED_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("lane_walk")
        lib.jt_lane_walk.argtypes = [ctypes.c_void_p] * 8 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.jt_lane_walk.restype = ctypes.c_int
        lib.jt_lane_walk_smem.argtypes = [ctypes.c_int] * 4
        lib.jt_lane_walk_smem.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


def _keyed_lib():
    global _KEYED_LIB
    if _KEYED_LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("keyed_walk")
        lib.jt_keyed_walk.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.jt_keyed_walk.restype = ctypes.c_int
        lib.jt_keyed_walk_smem.argtypes = [ctypes.c_int] * 4
        lib.jt_keyed_walk_smem.restype = ctypes.c_size_t
        _KEYED_LIB = lib
    return _KEYED_LIB


def _check_operands(kernel: str, dev, tensors) -> None:
    """Every operand a contiguous tensor of its type on ``dev``."""
    for name, t, dt in tensors:
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous {dt} "
                             f"tensor on {dev}")


def tables_scratch(O1: int, S: int, dev) -> torch.Tensor:
    """Device memory for P's image tables ``[O1, K, 16, NT]``, which the
    table walks (K1-K5) build first (``pack_tables``)."""
    return torch.empty((O1, n_nibbles(S), 16, table_words(S)),
                       dtype=torch.int32, device=dev)


def _lane_walk_cuda(P, ret_slot, slot_ops, R0, B: int, n_pass: int,
                    warp: bool = True):
    """Launch the kernel; ``warp=False`` takes the block form at every W
    (``chip_smoke.py`` times the two). ``ckpt`` and ``final`` start
    zeroed: the walk stops at its death, and the plain version's sets
    from there on are empty."""
    global KERNEL_LAUNCHES
    R_pad, W = slot_ops.shape
    M, S = R0.shape
    O1 = P.shape[0]
    _check_operands("lane_walk", R0.device,
                    (("P", P, torch.float32),
                     ("ret_slot", ret_slot, torch.int32),
                     ("slot_ops", slot_ops, torch.int32),
                     ("R0", R0, torch.float32)))
    if P.shape[1:] != (S, S) or ret_slot.shape != (R_pad,) \
            or M != 1 << W or R_pad % B:
        raise ValueError(f"lane_walk: inconsistent shapes P{tuple(P.shape)} "
                         f"ret_slot{tuple(ret_slot.shape)} slot_ops"
                         f"{tuple(slot_ops.shape)} R0{tuple(R0.shape)} B={B}")
    if not _kernel_takes(W, S, O1):
        raise ValueError(f"lane_walk: the kernel does not take W={W} "
                         f"S={S} O1={O1} (see lane_fits)")
    lib = _lib()
    dev = R0.device
    ckpt = torch.zeros((R_pad // B, M, S), dtype=torch.float32, device=dev)
    final = torch.zeros((M, S), dtype=torch.float32, device=dev)
    dead = torch.empty(1, dtype=torch.int32, device=dev)
    T = tables_scratch(O1, S, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_lane_walk(
            P.data_ptr(), T.data_ptr(), ret_slot.data_ptr(),
            slot_ops.data_ptr(), R0.data_ptr(), ckpt.data_ptr(),
            final.data_ptr(), dead.data_ptr(), R_pad, W, S, O1, B, n_pass,
            int(warp), stream)
    if err != 0:
        raise RuntimeError(f"lane_walk kernel launch failed: CUDA error "
                           f"{err}")
    KERNEL_LAUNCHES += 1
    return ckpt, final, dead


def lane_walk(P: torch.Tensor, ret_slot: torch.Tensor,
              slot_ops: torch.Tensor, R0: torch.Tensor, B: int,
              n_pass: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The returns walk with :func:`lane_walk_plain`'s contract: the
    CUDA kernel for tensors on the card (asynchronous, on the current
    stream), the plain version for tensors on the CPU."""
    if R0.device.type == "cuda":
        return _lane_walk_cuda(P, ret_slot, slot_ops, R0, B, n_pass)
    if R0.device.type == "cpu":
        return lane_walk_plain(P, ret_slot, slot_ops, R0, B, n_pass)
    raise ValueError(f"lane_walk: unsupported device {R0.device}")


def key_runs(key_id: np.ndarray, n_keys: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """``(lo, hi)`` int32[n_keys]: key k's returns are ``[lo[k], hi[k])``
    of the flat stream (``key_id`` int[N], -1 marks padding); a key with
    no returns gets ``lo = hi = 0``. Raises unless every id is below
    ``n_keys`` and every key's returns form one contiguous run."""
    k = np.asarray(key_id).reshape(-1)
    lo = np.zeros(n_keys, np.int32)
    hi = np.zeros(n_keys, np.int32)
    if not k.size:
        return lo, hi
    # the runs of one id: two passes over the stream, the rest per run
    starts = np.concatenate(([0], np.flatnonzero(k[1:] != k[:-1]) + 1))
    ends = np.append(starts[1:], k.size)
    ids = k[starts]
    if int(ids.max()) >= n_keys:
        raise ValueError(f"keyed_walk: key id {int(ids.max())} out of range "
                         f"for {n_keys} keys")
    real = ids >= 0
    ids, starts, ends = ids[real], starts[real], ends[real]
    if np.unique(ids).size != ids.size:
        raise ValueError("keyed_walk: every key's returns must form one "
                         "contiguous run of the stream")
    lo[ids], hi[ids] = starts, ends
    return lo, hi


def _key_runs(key_id: torch.Tensor, n_keys: int):
    """:func:`key_runs` of a tensor, as int32 tensors on its device."""
    lo, hi = key_runs(key_id.cpu().numpy(), n_keys)
    return (torch.as_tensor(lo, device=key_id.device),
            torch.as_tensor(hi, device=key_id.device))


def keyed_walk_plain(P: torch.Tensor, ret_slot: torch.Tensor,
                     slot_ops: torch.Tensor, key_id: torch.Tensor,
                     n_keys: int, n_pass: int) -> torch.Tensor:
    """The walk of :func:`keyed_walk` in PyTorch ops, on any device: all
    keys advance in lockstep, one return each per step, padded with
    identity steps to the longest key.

    ``P`` f32[O1, S, S]; ``ret_slot`` i32[N]; ``slot_ops`` i32[N, W];
    ``key_id`` i32[N] (-1 marks padding). Returns ``dead`` i32[n_keys]:
    the flat index of the first return after which key k's set (seeded
    one-hot at mask 0, state 0) is empty, or -1. Each step runs
    ``min(max_k c_k, n_pass)`` passes for every key, ``c_k`` key k's
    pending count: as many as the reference's per-return gate or more,
    and passes past a key's closure change nothing."""
    lo, hi = _key_runs(key_id, n_keys)
    dev = P.device
    W = slot_ops.shape[1]
    O1, S, _ = P.shape
    M = 1 << W
    lo, cnt = lo.long(), (hi - lo).long()
    L = int(cnt.max()) if n_keys else 0
    t = torch.arange(L, device=dev)
    valid = t[None, :] < cnt[:, None]                          # [K, L]
    pos = torch.where(valid, lo[:, None] + t[None, :], 0)
    js = torch.where(valid, ret_slot.long()[pos], -1)
    ops = torch.where(valid[..., None], slot_ops.long()[pos], -1)  # [K,L,W]
    passes = (ops >= 0).sum(2).amax(0).clamp(max=n_pass).tolist() \
        if n_keys else []
    idx = torch.where(ops < 0, O1 - 1, ops)
    R = torch.zeros((M, n_keys, S), dtype=P.dtype, device=dev)
    R[0, :, 0] = 1.0
    dead = torch.full((n_keys,), -1, dtype=torch.long, device=dev)
    for s in range(L):
        G = P[idx[:, s]]                                       # [K, W, S, S]
        for _ in range(passes[s]):
            R = _fire_lanes(R, G, W)
        R = _project_lanes(R, js[:, s])
        empty = ~(R > 0.5).any(2).any(0)
        dead = torch.where(empty & (dead < 0) & valid[:, s], lo + s, dead)
    return dead.int()


def _keyed_launch(P, ret_slot, slot_ops, lo, hi, n_pass: int,
                  warp: bool = True):
    """Launch the keyed kernel over the key runs ``[lo[k], hi[k])``
    (:func:`key_runs`); ``warp=False`` takes the block form at every
    W."""
    global KEYED_LAUNCHES
    dev = P.device
    N, W = slot_ops.shape
    O1, S, _ = P.shape
    n_keys = lo.shape[0]
    _check_operands("keyed_walk", dev,
                    (("P", P, torch.float32),
                     ("ret_slot", ret_slot, torch.int32),
                     ("slot_ops", slot_ops, torch.int32),
                     ("lo", lo, torch.int32), ("hi", hi, torch.int32)))
    if P.shape[1:] != (S, S) or ret_slot.shape != (N,) \
            or hi.shape != (n_keys,):
        raise ValueError(f"keyed_walk: inconsistent shapes P{tuple(P.shape)} "
                         f"ret_slot{tuple(ret_slot.shape)} slot_ops"
                         f"{tuple(slot_ops.shape)} lo{tuple(lo.shape)} "
                         f"hi{tuple(hi.shape)}")
    if not _kernel_takes(W, S, O1):
        raise ValueError(f"keyed_walk: the kernel does not take W={W} "
                         f"S={S} O1={O1} (see keyed_fits)")
    dead = torch.empty(n_keys, dtype=torch.int32, device=dev)
    if n_keys == 0:
        return dead
    lib = _keyed_lib()
    T = tables_scratch(O1, S, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_keyed_walk(
            P.data_ptr(), T.data_ptr(), ret_slot.data_ptr(),
            slot_ops.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            dead.data_ptr(), n_keys, W, S, O1, n_pass, int(warp), stream)
    if err != 0:
        raise RuntimeError(f"keyed_walk kernel launch failed: CUDA error "
                           f"{err}")
    KEYED_LAUNCHES += 1
    return dead


def keyed_walk(P: torch.Tensor, ret_slot: torch.Tensor,
               slot_ops: torch.Tensor, key_id: torch.Tensor, n_keys: int,
               n_pass: int) -> torch.Tensor:
    """The keyed walk with :func:`keyed_walk_plain`'s contract: the CUDA
    kernel for tensors on the card (one thread block per key), the plain
    version for tensors on the CPU."""
    if P.device.type == "cuda":
        lo, hi = _key_runs(key_id, n_keys)
        return _keyed_launch(P, ret_slot, slot_ops, lo, hi, n_pass)
    if P.device.type == "cpu":
        return keyed_walk_plain(P, ret_slot, slot_ops, key_id, n_keys,
                                n_pass)
    raise ValueError(f"keyed_walk: unsupported device {P.device}")


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


def _refine_dead(P: torch.Tensor, W: int, ret_slot: np.ndarray,
                 slot_ops: np.ndarray, R0: torch.Tensor, start: int, n: int,
                 B: int) -> int:
    """Exact dead return index within ``[start, start + n)``, whose
    block-start set ``R0`` (f32 ``[M, S]`` on ``P``'s device) a
    checkpoint gave: one K1 launch over that block, with the exact
    ``W``-pass ladder, reading its dead return. The block's own walk
    died in it, so a launch that finds no death raises."""
    rs, so = _padded(ret_slot[start:start + n], slot_ops[start:start + n],
                     B)
    dev = P.device
    _, _, dead = lane_walk(
        P, torch.as_tensor(np.ascontiguousarray(rs, np.int32), device=dev),
        torch.as_tensor(np.ascontiguousarray(so, np.int32), device=dev),
        R0.contiguous(), B, W)
    d = int(dead[0])
    if d < 0:
        raise RuntimeError(f"K1 finds no death in returns [{start}, "
                           f"{start + n}), where the block's walk died")
    return start + d


def prefix_set(P: np.ndarray, ret_slot: np.ndarray, slot_ops: np.ndarray,
               R0_sm: np.ndarray, n: int, *, device=None,
               B: int = _BLOCK) -> np.ndarray:
    """The exact config set (bool ``[S, M]``) after the first ``n``
    returns: one walk with the full ``W``-pass ladder."""
    W = int(slot_ops.shape[1])
    args = operands_from_numpy(P, ret_slot[:n], slot_ops[:n], R0_sm, B=B,
                               device=device)
    _, final, _ = lane_walk(*args, B, W)
    return (final.cpu().numpy() > 0.5).T


def _walk_segmented(args, geom, n_pass: int, should_abort):
    """Abortable drive: segments of about :data:`_ABORT_SEG` returns with
    the config set carried, the hook checked between segments. Returns
    ``(dead, final)``, ``dead`` offset by its segment's start; raises
    :class:`Aborted` when the hook fires."""
    B, W, M, S, O1, R_pad = geom
    P, rs_t, so_t, R_cur = args
    seg_len = max(B, _ABORT_SEG // B * B)
    base = 0
    while base < R_pad:
        if should_abort():
            raise Aborted()
        seg = min(seg_len, R_pad - base)
        _, R_cur, dead = lane_walk(P, rs_t[base:base + seg],
                                   so_t[base:base + seg], R_cur, B, n_pass)
        dead = int(dead[0])
        if dead >= 0:
            return base + dead, R_cur
        base += seg
    return -1, R_cur


def walk_returns(P: np.ndarray, ret_slot: np.ndarray,
                 slot_ops: np.ndarray, R0_sm: np.ndarray, *,
                 device=None, B: int = _BLOCK, fetch_R: bool = True,
                 should_abort=None) -> Tuple[int, Optional[np.ndarray]]:
    """Run the full returns walk on ``device`` (default: the card).

    ``P`` f32[O1, S, S] (last row the all-zero sentinel); ``ret_slot``
    i32[R]; ``slot_ops`` i32[R, W]; ``R0_sm`` bool[S, M]. Returns
    ``(dead, R_final)``: ``dead`` is the first return index at which the
    config set emptied (-1 if linearizable), as the walk reports it, and
    ``R_final`` the final config set as bool[S, M] (``None`` on invalid
    histories or with ``fetch_R=False``). With ``should_abort`` the walk
    runs in :data:`_ABORT_SEG`-return segments and raises
    :class:`Aborted` when the hook fires between them."""
    geom, args = pack_operands(P, ret_slot, slot_ops, R0_sm, B=B,
                               device=device)
    B, W, M, S, O1, R_pad = geom
    n_fast = min(W, _FAST_PASSES)

    def run(n_pass: int):
        if should_abort is not None:
            return _walk_segmented(args, geom, n_pass, should_abort)
        _, final, dead = lane_walk(*args, B, n_pass)
        return int(dead[0]), final          # the one device round trip

    dead, final = run(n_fast)
    if n_fast < W and (dead >= 0 or fetch_R):
        # a capped death may be false, and a capped surviving set may
        # be an under-approximation: decide (and decode) exactly
        dead, final = run(W)
    if dead >= 0:
        return dead, None
    return -1, (final.cpu().numpy() > 0.5).T if fetch_R else None


def walk_returns_keyed(P: np.ndarray, ret_slot: np.ndarray,
                       slot_ops: np.ndarray, key_id: np.ndarray,
                       n_keys: int, M: int, *, device=None) -> np.ndarray:
    """Walk ``n_keys`` return streams concatenated into one flat stream,
    in one launch on ``device`` (default: the card), with the exact
    ``W``-pass ladder gated by each return's pending count.

    ``P`` f32[O1, S, S] (last row the all-zero sentinel); ``ret_slot``
    i32[N]; ``slot_ops`` i32[N, W]; ``key_id`` i32[N], each key's
    returns one contiguous run; ``M`` = 2^W. Returns ``dead``
    int32[n_keys]: the flat index of key k's first return after which
    its config set is empty, -1 if the key is linearizable."""
    W = int(slot_ops.shape[1])
    if M != 1 << W:
        raise ValueError(f"walk_returns_keyed: M={M} is not 2^W, W={W}")
    dev = _device.resolve(device)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=dev)

    args = (put(P, np.float32), put(ret_slot, np.int32),
            put(slot_ops.reshape(-1, W), np.int32))
    if dev.type == "cuda":
        # the keys' runs found on the host, with no device sync, and sent
        # in one copy
        runs = put(np.stack(key_runs(key_id, n_keys)), np.int32)
        dead = _keyed_launch(*args, runs[0], runs[1], W)
    else:
        dead = keyed_walk(*args, put(key_id, np.int32), n_keys, W)
    return dead.cpu().numpy()

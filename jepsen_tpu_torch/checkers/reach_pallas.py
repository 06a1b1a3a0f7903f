"""The first-generation returns walks on the card — the route of wide
state sets, where a model has more than 32 states.

:func:`walk` runs one history's whole walk as one launch of the
hand-written CUDA kernel K4 in ``csrc/wide_walk.cu`` (counterpart of the
reference package's Pallas kernel ``reach_pallas._walk_call``), and
:func:`keyed_walk` many keys' walks, concatenated into one flat stream,
as one launch of K5 in ``csrc/wide_keyed.cu`` (counterpart of
``reach_pallas._keyed_call``). Both keep a mask's states as
``ceil(S / 32)`` words, so they take any number of states
(:func:`fits`); the lane kernels of :mod:`.reach_lane` take at most 32.
Each launch first builds P's nibble image tables (:func:`image_tables`;
plain version :func:`image_tables_plain`), then walks in the warp form
(:func:`warp_form`: the set in one warp's registers) or the block form.
On CPU tensors the wrappers run the plain versions, :func:`walk_plain`
and :func:`keyed_walk_plain`; on CUDA tensors they launch the kernel or
raise.

The host side keeps the reference's contracts: :func:`walk_returns`
gives the exact first dead return and the final set in one launch (no
checkpoints, no refinement), :func:`walk_returns_keyed` each key's flat
dead index. Nothing recompiles on the card, so the stream is not
padded, and there is no packed-wire retry (a workaround for the TPU's
host link).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch.checkers import reach_lane
# P's image tables are the narrow walks' (csrc/walk.cuh): one layout and
# one builder at any number of states
from jepsen_tpu_torch.checkers.reach_lane import (  # noqa: F401
    image_tables_plain, n_nibbles, n_words, table_bytes, table_words)

# the kernels' limits (csrc/wide_walk.cuh): 1 <= W <= 20 slots; the warp
# form for W <= 5 and at most 8 words a mask, else the block form with
# the set R [2, M, NW] words in one block's shared memory (Hopper: 227 KB
# a block) beside a chunk of the stream; P's image tables join them
# there when they fit, else they stay in device memory
_MAX_W = 20
_WARP_MAX_W = reach_lane._WARP_MAX_W
_WARP_MAX_NW = reach_lane._WARP_MAX_NW
_CHUNK = reach_lane._CHUNK
_SMEM_BYTES = reach_lane._SMEM_BYTES

#: launches of the K4 CUDA kernel (not of the plain version) in this process
KERNEL_LAUNCHES = 0
#: launches of the K5 CUDA kernel in this process
KEYED_LAUNCHES = 0


def warp_form(W: int, S: int) -> bool:
    """Whether a walk of this geometry takes the warp form (the set in
    one warp's registers), else the block form; ``wide_warp_form`` in
    ``csrc/wide_walk.cuh``, exported as ``jt_wide_walk_form``."""
    return W <= _WARP_MAX_W and n_words(S) <= _WARP_MAX_NW


def _smem_base(W: int, S: int) -> int:
    R = 0 if warp_form(W, S) else 2 * (1 << W) * n_words(S)
    return 4 * (R + _CHUNK * (W + 1))


def p_shared(W: int, S: int, O1: int) -> bool:
    """Whether P's image tables join the set and the stream's chunk in
    shared memory."""
    return _smem_base(W, S) + table_bytes(S, O1) <= _SMEM_BYTES


def smem_bytes(W: int, S: int, O1: int) -> int:
    """Shared memory one K4 or K5 block takes, for routing without a
    card. It mirrors ``wide_smem`` in ``csrc/wide_walk.cuh`` (exported
    as ``jt_wide_walk_smem``), and ``chip_smoke.py`` checks that the two
    agree: R as ``[2, M, NW]`` words in the block form, a chunk of the
    return stream, and P's image tables when all of it fits."""
    T = table_bytes(S, O1) if p_shared(W, S, O1) else 0
    return _smem_base(W, S) + T


def _kernel_takes(W: int, S: int, O1: int) -> bool:
    return 1 <= W <= _MAX_W and S >= 1 and O1 >= 1 \
        and smem_bytes(W, S, O1) <= _SMEM_BYTES


def fits(S_pad: int, M: int, n_ops: int) -> bool:
    """Whether K4 and K5 take this geometry: at most 20 slots, with the
    set and a chunk of the stream in one block's shared memory (P's
    tables may stay in device memory). At S_pad = 64 that is up to 2^13
    masks."""
    return _kernel_takes(M.bit_length() - 1, S_pad, n_ops + 1)


# -- the kernels' plain versions ----------------------------------------------

def _fire_pass(R, G_all, partner, bit_set):
    """One Jacobi fire pass (the reference's ``_one_fire_pass``): one
    ``[M,S]@[S,W·S]`` product gives every config's image under every
    slot's op, from the pass-start set; slot j's images of the bit-clear
    masks land in their bit-set partners (``partner`` [M·W] selects row
    ``(m ^ 1 << j)·W + j`` of the images, ``bit_set`` [M, W, 1] keeps
    masks with bit j set), and a max adds them. The reference adds slot
    after slot, each by a max with the same pass-start images; a max is
    order-free. The products count 0/1 terms, so clamping them at 1 is
    the reference's ``> 0.5``."""
    M, S = R.shape
    F = (R @ G_all).view(-1, S).index_select(0, partner).view(M, -1, S)
    return torch.maximum(R, (F * bit_set).amax(1).clamp(max=1.0))


def _fire_and_project(R, G_all, j: int, W: int, partner, bit_set):
    """One return (the reference's ``_fire_and_project``): with W <= 2,
    W passes; else two passes, then more while the popcount grows, W in
    all. Then the projection on the returning slot ``j``: the reference
    blends the W static projections by 0/1 indicators of ``j``, exactly
    one of them hot (none for ``j = -1``, the identity); with ``j`` on
    the host that blend is the hot projection itself."""
    M, S = R.shape
    if W <= 2:
        for _ in range(W):
            R = _fire_pass(R, G_all, partner, bit_set)
    else:
        R = _fire_pass(R, G_all, partner, bit_set)
        prev = float(R.sum())
        R = _fire_pass(R, G_all, partner, bit_set)
        it = 2
        while it < W:
            s = float(R.sum())
            if not s > prev:
                break
            prev, R, it = s, _fire_pass(R, G_all, partner, bit_set), it + 1
    return reach_lane._project(R, j, W, M, S)


def _pass_index(W: int, M: int, dtype, dev):
    """:func:`_fire_pass`'s ``partner`` rows and ``bit_set`` factors."""
    m = torch.arange(M, device=dev)[:, None]
    j = torch.arange(W, device=dev)[None, :]
    partner = ((m ^ (1 << j)) * W + j).reshape(-1)
    return partner, ((m >> j) & 1).to(dtype)[..., None]


_GATHER = 256               # returns whose operands are gathered at once


def walk_plain(P: torch.Tensor, ret_slot: torch.Tensor,
               slot_ops: torch.Tensor, R0: torch.Tensor,
               rlim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk of :func:`walk` in PyTorch ops, on any device, as the
    reference's kernel runs it.

    ``P`` f32[O1, S, S] (row O1-1 the all-zero sentinel for slot -1);
    ``ret_slot`` i32[R]; ``slot_ops`` i32[R, W]; ``R0`` f32[M, S].
    Returns ``(dead i32[1], R_final f32[M, S])``: the first return
    ``r < rlim`` after which the set is empty (-1 if none), and the set
    after the last return. An empty set stays empty (firing adds only
    images of members, the projection only moves or drops them), so the
    walk stops at the first empty return with the set, and ``R_final``,
    empty."""
    R_len, W = slot_ops.shape
    M, S = R0.shape
    O1 = P.shape[0]
    dev = R0.device
    idx = torch.where(slot_ops < 0, O1 - 1, slot_ops).long()
    js = ret_slot.tolist()
    partner, bit_set = _pass_index(W, M, R0.dtype, dev)
    R = R0.clone()
    dead = 0 if R_len and not bool(R.any()) else -1
    b0 = 0
    while dead < 0 and b0 < R_len:
        # G_all[r] = [S, W·S], the pending ops' matrices side by side
        G = P[idx[b0:b0 + _GATHER]].permute(0, 2, 1, 3).reshape(-1, S, W * S)
        for k in range(G.shape[0]):
            R = _fire_and_project(R, G[k], js[b0 + k], W, partner, bit_set)
            if not bool(R.any()):
                dead = b0 + k
                break
        b0 += _GATHER
    dead = dead if dead < rlim else -1
    return torch.tensor([dead], dtype=torch.int32, device=dev), R


def keyed_walk_plain(P: torch.Tensor, ret_slot: torch.Tensor,
                     slot_ops: torch.Tensor, key_id: torch.Tensor,
                     n_keys: int) -> torch.Tensor:
    """The walk of :func:`keyed_walk` in PyTorch ops, on any device: the
    keys in lockstep (:func:`reach_lane.keyed_walk_plain` with the full
    ``W``-pass ladder, gated by the step's largest pending count). Each
    key's set reaches its fixpoint before its projection, as in the
    reference's popcount loop, so the dead indices are the same.
    Returns ``dead`` i32[n_keys], flat indices, -1 for a live key."""
    return reach_lane.keyed_walk_plain(P, ret_slot, slot_ops, key_id,
                                       n_keys, int(slot_ops.shape[1]))


# -- the kernels ---------------------------------------------------------------

_LIB = None
_KEYED_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("wide_walk")
        lib.jt_wide_walk.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.jt_wide_walk.restype = ctypes.c_int
        lib.jt_wide_walk_smem.argtypes = [ctypes.c_int] * 3
        lib.jt_wide_walk_smem.restype = ctypes.c_size_t
        lib.jt_wide_walk_form.argtypes = [ctypes.c_int] * 2
        lib.jt_wide_walk_form.restype = ctypes.c_int
        lib.jt_wide_tables.argtypes = [ctypes.c_void_p] * 2 + \
            [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.jt_wide_tables.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _keyed_lib():
    global _KEYED_LIB
    if _KEYED_LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("wide_keyed")
        lib.jt_wide_keyed.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.jt_wide_keyed.restype = ctypes.c_int
        _KEYED_LIB = lib
    return _KEYED_LIB


def _shapes(kernel: str, P, ret_slot, slot_ops):
    """``(N, W, S, O1)`` of the operands, checked against the kernel."""
    N, W = slot_ops.shape
    O1, S, _ = P.shape
    if P.shape[1:] != (S, S) or ret_slot.shape != (N,):
        raise ValueError(f"{kernel}: inconsistent shapes P{tuple(P.shape)} "
                         f"ret_slot{tuple(ret_slot.shape)} slot_ops"
                         f"{tuple(slot_ops.shape)}")
    if not _kernel_takes(W, S, O1):
        raise ValueError(f"{kernel}: the kernel does not take W={W} S={S} "
                         f"O1={O1} (see reach_pallas.fits)")
    return N, W, S, O1


def _launched(kernel: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err}")


def image_tables(P: torch.Tensor) -> torch.Tensor:
    """P's image tables with :func:`image_tables_plain`'s contract: the
    kernels' ``pack_tables`` alone for a tensor on the card
    (``jt_wide_tables``; ``chip_smoke.py`` holds it against the plain
    version), the plain version for a tensor on the CPU."""
    if P.device.type == "cpu":
        return image_tables_plain(P)
    if P.device.type != "cuda":
        raise ValueError(f"image_tables: unsupported device {P.device}")
    reach_lane._check_operands("image_tables", P.device,
                               (("P", P, torch.float32),))
    O1, S, _ = P.shape
    if P.shape[1:] != (S, S) or O1 < 1 or S < 1:
        raise ValueError(f"image_tables: P{tuple(P.shape)} is not "
                         f"[O1, S, S]")
    T = reach_lane.tables_scratch(O1, S, P.device)
    with torch.cuda.device(P.device):
        err = _lib().jt_wide_tables(
            P.data_ptr(), T.data_ptr(), O1, S,
            torch.cuda.current_stream().cuda_stream)
    _launched("image_tables", err)
    return T


def _walk_cuda(P, ret_slot, slot_ops, R0, rlim: int):
    global KERNEL_LAUNCHES
    dev = R0.device
    reach_lane._check_operands("wide_walk", dev,
                               (("P", P, torch.float32),
                                ("ret_slot", ret_slot, torch.int32),
                                ("slot_ops", slot_ops, torch.int32),
                                ("R0", R0, torch.float32)))
    N, W, S, O1 = _shapes("wide_walk", P, ret_slot, slot_ops)
    if R0.shape != (1 << W, S):
        raise ValueError(f"wide_walk: R0{tuple(R0.shape)} is not "
                         f"[2^W, S] with W={W} S={S}")
    lib = _lib()
    T = reach_lane.tables_scratch(O1, S, dev)
    dead = torch.empty(1, dtype=torch.int32, device=dev)
    final = torch.empty_like(R0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_wide_walk(
            P.data_ptr(), T.data_ptr(), ret_slot.data_ptr(),
            slot_ops.data_ptr(), R0.data_ptr(), final.data_ptr(),
            dead.data_ptr(), N, int(rlim), W, S, O1, stream)
    _launched("wide_walk", err)
    KERNEL_LAUNCHES += 1
    return dead, final


def walk(P: torch.Tensor, ret_slot: torch.Tensor, slot_ops: torch.Tensor,
         R0: torch.Tensor, rlim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The returns walk with :func:`walk_plain`'s contract: the CUDA
    kernel K4 for tensors on the card (asynchronous, on the current
    stream), the plain version for tensors on the CPU."""
    if R0.device.type == "cuda":
        return _walk_cuda(P, ret_slot, slot_ops, R0, rlim)
    if R0.device.type == "cpu":
        return walk_plain(P, ret_slot, slot_ops, R0, rlim)
    raise ValueError(f"wide_walk: unsupported device {R0.device}")


def _keyed_launch(P, ret_slot, slot_ops, lo, hi):
    """Launch K5 over the key runs ``[lo[k], hi[k])``
    (:func:`reach_lane._key_runs`)."""
    global KEYED_LAUNCHES
    dev = P.device
    reach_lane._check_operands("wide_keyed", dev,
                               (("P", P, torch.float32),
                                ("ret_slot", ret_slot, torch.int32),
                                ("slot_ops", slot_ops, torch.int32),
                                ("lo", lo, torch.int32),
                                ("hi", hi, torch.int32)))
    N, W, S, O1 = _shapes("wide_keyed", P, ret_slot, slot_ops)
    n_keys = lo.shape[0]
    if hi.shape != (n_keys,):
        raise ValueError(f"wide_keyed: lo{tuple(lo.shape)} and "
                         f"hi{tuple(hi.shape)} differ")
    dead = torch.empty(n_keys, dtype=torch.int32, device=dev)
    if n_keys == 0:
        return dead
    lib = _keyed_lib()
    T = reach_lane.tables_scratch(O1, S, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_wide_keyed(
            P.data_ptr(), T.data_ptr(), ret_slot.data_ptr(),
            slot_ops.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            dead.data_ptr(), n_keys, W, S, O1, stream)
    _launched("wide_keyed", err)
    KEYED_LAUNCHES += 1
    return dead


def keyed_walk(P: torch.Tensor, ret_slot: torch.Tensor,
               slot_ops: torch.Tensor, key_id: torch.Tensor,
               n_keys: int) -> torch.Tensor:
    """The keyed walk with :func:`keyed_walk_plain`'s contract: the CUDA
    kernel K5 for tensors on the card (one thread block per key), the
    plain version for tensors on the CPU."""
    if P.device.type == "cuda":
        lo, hi = reach_lane._key_runs(key_id, n_keys)
        return _keyed_launch(P, ret_slot, slot_ops, lo, hi)
    if P.device.type == "cpu":
        return keyed_walk_plain(P, ret_slot, slot_ops, key_id, n_keys)
    raise ValueError(f"wide_keyed: unsupported device {P.device}")


# -- host side -------------------------------------------------------------------

def operands_from_numpy(P: np.ndarray, ret_slot: np.ndarray,
                        slot_ops: np.ndarray, R0_sm: np.ndarray, *,
                        device=None):
    """The reference's host operands (``_build_P``'s f32[O1, S, S],
    ``returns_view``'s i32[R] and i32[R, W], a bool[S, M] seed) as
    :func:`walk`'s tensors on ``device``: ``(P, ret_slot, slot_ops, R0)``
    with the seed in the ``[M, S]`` layout; the stream is not padded."""
    dev = _device.resolve(device)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=dev)

    return (put(P, np.float32), put(ret_slot, np.int32),
            put(slot_ops, np.int32), put(R0_sm.T, np.float32))


def walk_returns(P: np.ndarray, ret_slot: np.ndarray,
                 slot_ops: np.ndarray, R0_sm: np.ndarray, *,
                 device=None, fetch_R: bool = True,
                 should_abort=None) -> Tuple[int, Optional[np.ndarray]]:
    """Run the full returns walk on ``device`` (default: the card), in
    one launch of K4.

    ``P`` f32[O1, S, S] (last row the all-zero sentinel); ``ret_slot``
    i32[R]; ``slot_ops`` i32[R, W]; ``R0_sm`` bool[S, M]. Returns
    ``(dead, R_final)``: ``dead`` is the first return index at which the
    config set emptied, or -1 if the history is linearizable, and
    ``R_final`` the final set as bool[S, M] (``None`` with
    ``fetch_R=False``). With ``should_abort`` the walk runs in segments
    of :data:`reach_lane._ABORT_SEG` returns, the set carried from one
    to the next as its seed, and raises :class:`reach_lane.Aborted` when
    the hook fires between them."""
    Pt, rs_t, so_t, R_cur = operands_from_numpy(P, ret_slot, slot_ops,
                                                R0_sm, device=device)
    R_len = int(rs_t.shape[0])
    seg = reach_lane._ABORT_SEG if should_abort is not None else R_len
    dead, base = -1, 0
    while True:
        if should_abort is not None and should_abort():
            raise reach_lane.Aborted()
        n = min(seg, R_len - base)
        d, R_cur = walk(Pt, rs_t[base:base + n], so_t[base:base + n], R_cur,
                        n)
        d = int(d[0])                       # the one device round trip
        if d >= 0:
            dead = base + d
        base += n
        if dead >= 0 or base >= R_len:
            break
    return dead, (R_cur.cpu().numpy() > 0.5).T if fetch_R else None


def walk_returns_keyed(P: np.ndarray, ret_slot: np.ndarray,
                       slot_ops: np.ndarray, key_id: np.ndarray,
                       n_keys: int, M: int, *, device=None) -> np.ndarray:
    """Walk ``n_keys`` return streams concatenated into one flat stream,
    in one launch of K5 on ``device`` (default: the card).

    ``P`` f32[O1, S, S] (last row the all-zero sentinel); ``ret_slot``
    i32[N]; ``slot_ops`` i32[N, W]; ``key_id`` i32[N], each key's
    returns one contiguous run; ``M`` = 2^W. Returns ``dead``
    int32[n_keys]: for each key the flat index of the first return at
    which its config set emptied, or -1 if that key is linearizable."""
    W = int(slot_ops.shape[1])
    if M != 1 << W:
        raise ValueError(f"walk_returns_keyed: M={M} is not 2^W, W={W}")
    dev = _device.resolve(device)

    def put(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=dev)

    dead = keyed_walk(put(P, np.float32), put(ret_slot, np.int32),
                      put(slot_ops.reshape(-1, W), np.int32),
                      put(key_id, np.int32), n_keys)
    return dead.cpu().numpy()

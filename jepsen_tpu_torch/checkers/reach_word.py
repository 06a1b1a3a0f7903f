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
was seeded) and its own set; :func:`mega_walk` reaches them through a
device array of per-lane addresses, so a wave stacks no P and no set.
Ragged blocks pad to the group's longest with identity steps
(``ret_slot = -1``, every op -1), which cannot empty a set, and each
lane's dead return is its own exact index (-1: survived). There is no
lane padding: the card compiles nothing per group width.

On CPU tensors :func:`mega_walk` runs the plain version,
:func:`mega_walk_plain`; on CUDA tensors it launches K10 or raises.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import reach_lane

#: launches of K10 (not of its plain version) in this process
KERNEL_LAUNCHES = 0


def mega_geometry(carry) -> Optional[tuple]:
    """The geometry a carry contributes to a mega-group, ``(engine,
    S_pad, W, O1)``, or None when it cannot join one (the torch returns
    walk). Members of a group agree on it; their tables, sets and blocks
    are their own. Fixed when the carry is seeded (growth seeds a new
    carry)."""
    return carry.mega_sig


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
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.jt_mega_walk.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _mega_walk_cuda(T, R0, ret_slot, slot_ops, n, narrow: bool):
    global KERNEL_LAUNCHES
    L, R_pad, W = slot_ops.shape
    M, S = R0[0].shape
    O1 = T[0].shape[0]
    dev = ret_slot.device
    reach_lane._check_operands("mega_walk", dev,
                               (("ret_slot", ret_slot, torch.int32),
                                ("slot_ops", slot_ops, torch.int32)))
    if len(T) != L or len(R0) != L or ret_slot.shape != (L, R_pad) \
            or M != 1 << W:
        raise ValueError(f"mega_walk: inconsistent shapes: {len(T)} tables, "
                         f"{len(R0)} sets, ret_slot{tuple(ret_slot.shape)} "
                         f"slot_ops{tuple(slot_ops.shape)} R0[0]"
                         f"{tuple(R0[0].shape)}")
    t_shape = (O1, reach_lane.n_nibbles(S), 16, reach_lane.table_words(S))
    desc = np.empty((L, 3), np.int64)
    for i in range(L):
        reach_lane._check_operands("mega_walk", dev,
                                   (("T", T[i], torch.int32),
                                    ("R0", R0[i], torch.float32)))
        if tuple(T[i].shape) != t_shape or R0[i].shape != (M, S):
            raise ValueError(f"mega_walk: lane {i}: T{tuple(T[i].shape)} "
                             f"R0{tuple(R0[i].shape)}, want T{t_shape} "
                             f"R0{(M, S)}")
        desc[i] = (T[i].data_ptr(), R0[i].data_ptr(), int(n[i]))
    if desc[:, 2].min() < 0 or desc[:, 2].max() > R_pad:
        raise ValueError(f"mega_walk: a lane's returns exceed R_pad={R_pad}")
    lib = _lib()
    lanes = torch.as_tensor(desc, device=dev)
    final = torch.empty((L, M, S), dtype=torch.float32, device=dev)
    dead = torch.empty(L, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.jt_mega_walk(
            lanes.data_ptr(), ret_slot.data_ptr(), slot_ops.data_ptr(),
            final.data_ptr(), dead.data_ptr(), L, R_pad, W, S, O1,
            int(narrow), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mega_walk kernel launch failed: CUDA error "
                           f"{err}")
    KERNEL_LAUNCHES += 1
    return final, dead


def mega_walk(P: Sequence[torch.Tensor], T: Sequence[torch.Tensor],
              R0: Sequence[torch.Tensor], ret_slot: torch.Tensor,
              slot_ops: torch.Tensor, n, narrow: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mega-group walk with :func:`mega_walk_plain`'s contract: K10
    for tensors on the card (asynchronous, on the current stream; lane
    i's nibble image tables ``T[i]`` as :func:`reach_pallas.image_tables`
    builds them from ``P[i]``, K1's forms when ``narrow``, else K4's),
    the plain version on ``P`` for tensors on the CPU."""
    if ret_slot.device.type == "cuda":
        return _mega_walk_cuda(T, R0, ret_slot, slot_ops, n, narrow)
    if ret_slot.device.type == "cpu":
        return mega_walk_plain(P, R0, ret_slot, slot_ops, n)
    raise ValueError(f"mega_walk: unsupported device {ret_slot.device}")


# -- the group advance ----------------------------------------------------------

class MegaInflight:
    """A launched, uncollected group advance: K10 queued on the card, no
    result read back. :func:`collect_frontiers_mega` consumes it."""

    __slots__ = ("carries", "lens", "final", "dead")

    def __init__(self, carries, lens, final, dead):
        self.carries = carries
        self.lens = lens
        self.final = final
        self.dead = dead


def launch_frontiers_mega(carries, blocks) -> MegaInflight:
    """Queue one K10 launch advancing every carry of a same-geometry
    group through its block (``blocks``: ``(ret_slot, slot_ops)`` pairs
    aligned with ``carries``). The host builds the group's padded stream
    ``[L, R_pad]`` and copies it once; nothing is read back."""
    L = len(carries)
    if L == 0:
        return MegaInflight([], [], None, None)
    sig = mega_geometry(carries[0])
    if sig is None or any(mega_geometry(c) != sig for c in carries[1:]):
        raise ValueError("mega-group geometry mismatch: "
                         f"{[mega_geometry(c) for c in carries]}")
    W = carries[0].W
    lens = [len(rs) for rs, _ in blocks]
    R_pad = max(1, max(lens))
    rs = np.full((L, R_pad), -1, np.int32)
    so = np.full((L, R_pad, W), -1, np.int32)
    for i, (b_rs, b_so) in enumerate(blocks):
        rs[i, :lens[i]] = b_rs
        so[i, :lens[i]] = np.asarray(b_so).reshape(lens[i], W)
    dev = carries[0]._R.device
    final, dead = mega_walk(
        [c._P for c in carries], [c._T for c in carries],
        [c._R for c in carries], torch.as_tensor(rs, device=dev),
        torch.as_tensor(so, device=dev), lens,
        narrow=sig[0] == "reach-lane")
    obs.count("reach.mega_walk")
    return MegaInflight(carries, lens, final, dead)


def collect_frontiers_mega(inf: MegaInflight) -> List[int]:
    """Read the group's dead returns (one copy), give each carry its
    lane's final set and count its advanced returns as its own
    :meth:`~.reach.FrontierCarry.advance` would. Returns the per-member
    exact first dead return indices (-1: survived)."""
    if not inf.carries:
        return []
    deads = inf.dead.cpu().tolist()
    for i, c in enumerate(inf.carries):
        c._R = inf.final[i]
        c.advanced_returns += inf.lens[i] if deads[i] < 0 else deads[i] + 1
    return deads


def advance_frontiers_mega(carries, blocks) -> List[int]:
    """:func:`launch_frontiers_mega` then :func:`collect_frontiers_mega`:
    one blocking group advance."""
    return collect_frontiers_mega(launch_frontiers_mega(carries, blocks))

"""Ablation harness for the single-history returns walk, on the card.

Builds the cas-100k operand set once, then times variants of the walk's
body (:data:`VARIANTS`): pass semantics (boolean, counts, max without
the compare), pass count and the pending-count gate ladder ("cgate"),
slot order, the projection as a bit move or a table product, unroll,
and the fire operand streamed from device memory instead of gathered
in the kernel. Each variant runs as one launch of a hand-written CUDA
kernel: K6 (``csrc/ablate_walk.cu``, :func:`ablate_walk`) or, for the
streamed variants, K7 (``csrc/ablate_stream.cu``, :func:`ablate_stream`).
Beside each is its plain PyTorch version (:func:`ablate_walk_plain`,
:func:`ablate_stream_plain`), which the wrappers run for tensors on the
CPU; on CUDA tensors they launch the kernel or raise.

Variants run in interleaved rounds, one launch each a round, so that
drift hits every variant alike; each launch is timed by CUDA events.
Every variant's final set is compared with the exact one, K1's walk
with the full pass ladder (``match``), and ``alive`` says whether it is
non-empty.

Usage::

    python -m jepsen_tpu_torch.tools.ablate_lane [--ops N] \\
        [--variants a,b,...] [--repeat N] [--device cuda|cpu]

It runs on the card unless ``--device cpu`` asks for the plain
versions, and raises when there is no card.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import sys
import time
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import device as _device

_BLOCK = 1024
# the kernels' limits (csrc/ablate.cuh): 1 <= W <= 16 slots, S <= 32
# states for the bool body (one word a mask), at most 8 deep gates, and
# everything in one block's shared memory (Hopper: 227 KB)
_MAX_W = 16
_MAX_GATES = 8
_CHUNK = 256
_SMEM_BYTES = 227 * 1024

#: launches of the K6 kernel (not of its plain version) in this process
ABLATE_LAUNCHES = 0
#: launches of the K7 kernel in this process
STREAM_LAUNCHES = 0


# -- pass bodies -------------------------------------------------------------
# Each takes the set R f32[M, S] and the fire operand G_all f32[S, W·S]
# and returns the set after one pass. F = R @ G_all is taken once, from
# the pass-start set; each slot's images land in the bit-set half of the
# mask axis.

def _fire_bool(R, G_all, W: int, M: int, S: int):
    """Round-2 pass: boolean compare+cast, serial max merge."""
    F = R @ G_all
    for jj in range(W):
        Fj = F[:, jj * S:(jj + 1) * S]
        half, blk = M >> (jj + 1), 1 << jj
        Rr = R.reshape(half, 2, blk, S)
        Fr = Fj.reshape(half, 2, blk, S)
        hi = torch.maximum(Rr[:, 1], (Fr[:, 0] > 0.5).to(torch.float32))
        R = torch.stack([Rr[:, 0], hi], dim=1).reshape(M, S)
    return R


def _fire_counts_tree(R, G_all, W: int, M: int, S: int):
    """Counts, balanced add tree."""
    F = R @ G_all
    vals = [R]
    for jj in range(W):
        Fj = F[:, jj * S:(jj + 1) * S]
        half, blk = M >> (jj + 1), 1 << jj
        lo = Fj.reshape(half, 2, blk, S)[:, 0]
        vals.append(torch.stack([torch.zeros_like(lo), lo],
                                dim=1).reshape(M, S))
    while len(vals) > 1:
        nxt = [vals[i] + vals[i + 1] for i in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            nxt.append(vals[-1])
        vals = nxt
    return vals[0]


def _fire_counts_gs(R, G_all, W: int, M: int, S: int):
    """Counts, Gauss-Seidel-shaped serial merge (add replaces max,
    compare+cast dropped)."""
    F = R @ G_all
    for jj in range(W):
        Fj = F[:, jj * S:(jj + 1) * S]
        half, blk = M >> (jj + 1), 1 << jj
        Rr = R.reshape(half, 2, blk, S)
        Fr = Fj.reshape(half, 2, blk, S)
        hi = Rr[:, 1] + Fr[:, 0]
        R = torch.stack([Rr[:, 0], hi], dim=1).reshape(M, S)
    return R


def _fire_bool_rev(R, G_all, W: int, M: int, S: int):
    """The round-2 pass with the slot sweep reversed."""
    F = R @ G_all
    for jj in reversed(range(W)):
        Fj = F[:, jj * S:(jj + 1) * S]
        half, blk = M >> (jj + 1), 1 << jj
        Rr = R.reshape(half, 2, blk, S)
        Fr = Fj.reshape(half, 2, blk, S)
        hi = torch.maximum(Rr[:, 1], (Fr[:, 0] > 0.5).to(torch.float32))
        R = torch.stack([Rr[:, 0], hi], dim=1).reshape(M, S)
    return R


def _fire_maxnc(R, G_all, W: int, M: int, S: int):
    """Round-2 structure with the compare+cast dropped: max against the
    raw f32 contraction (values grow at most S-fold a pass; the clamp
    of each return's projection restores the 0/1 scale, since zero and
    non-zero are preserved)."""
    F = R @ G_all
    for jj in range(W):
        Fj = F[:, jj * S:(jj + 1) * S]
        half, blk = M >> (jj + 1), 1 << jj
        Rr = R.reshape(half, 2, blk, S)
        Fr = Fj.reshape(half, 2, blk, S)
        hi = torch.maximum(Rr[:, 1], Fr[:, 0])
        R = torch.stack([Rr[:, 0], hi], dim=1).reshape(M, S)
    return R


# -- projection bodies -------------------------------------------------------

def _proj_blend(R, j: int, W: int, M: int, S: int, counts: bool):
    """Projection on the returning slot ``j`` as a blend of bit moves:
    each slot's move weighted by ``j == jj``, the identity by ``j < 0``;
    clamped to 1 with ``counts``."""
    acc = R * float(j < 0)
    for jj in range(W):
        half, blk = M >> (jj + 1), 1 << jj
        taken = R.reshape(half, 2, blk, S)[:, 1]
        p = torch.stack([taken, torch.zeros_like(taken)],
                        dim=1).reshape(M, S)
        acc = acc + p * float(j == jj)
    return torch.clamp(acc, max=1.0) if counts else acc


def _proj_table_np(W: int, M: int) -> np.ndarray:
    """The projection as a table: ``PJ[j] @ R`` moves each mask with bit
    j clear to the row of its bit-set twin (``PJ[W]``, the identity, for
    slot -1)."""
    PJ = np.zeros((W + 1, M, M), np.float32)
    m = np.arange(M)
    for j in range(W):
        clear = (m & (1 << j)) == 0
        PJ[j, m[clear], (m | (1 << j))[clear]] = 1.0
    PJ[W] = np.eye(M, dtype=np.float32)
    return PJ


def _gather_G(slot_ops, P, k: int, W: int, O1: int):
    """The ``[S, W·S]`` fire operand of return ``k``: its W pending ops'
    transition matrices side by side (slot -1 → the all-zero sentinel
    row ``O1 - 1``)."""
    o = slot_ops[k].long()
    o = torch.where(o < 0, O1 - 1, o)
    S = P.shape[1]
    return P.index_select(0, o).permute(1, 0, 2).reshape(S, W * S)


# -- K6: the walk with the fire operand gathered in the kernel ---------------

def _gates(cgate) -> Tuple[int, ...]:
    return tuple(cgate) if cgate else ()


def _walk_shapes(kernel: str, P, ret_slot, slot_ops, R0, B: int, PJ=None):
    """The operand shapes both versions take; raises ValueError."""
    R_pad, W = slot_ops.shape
    M, S = R0.shape
    if P.dim() != 3 or P.shape[1:] != (S, S) or ret_slot.shape != (R_pad,) \
            or M != 1 << W or B < 1 or R_pad % B \
            or (PJ is not None and PJ.shape != (W + 1, M, M)):
        raise ValueError(
            f"{kernel}: inconsistent shapes P{tuple(P.shape)} ret_slot"
            f"{tuple(ret_slot.shape)} slot_ops{tuple(slot_ops.shape)} R0"
            f"{tuple(R0.shape)}"
            + ("" if PJ is None else f" PJ{tuple(PJ.shape)}") + f" B={B}")


def ablate_walk_plain(P: torch.Tensor, ret_slot: torch.Tensor,
                      slot_ops: torch.Tensor, PJ: torch.Tensor,
                      R0: torch.Tensor, B: int, n_pass: int, fire,
                      proj: str, counts: bool, unroll: int = 1,
                      cgate=()) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk of a variant in PyTorch ops, on any device, step by step
    as the harness's kernel runs it.

    ``P`` f32[O1, S, S] (row O1-1 the all-zero sentinel); ``ret_slot``
    i32[R_pad]; ``slot_ops`` i32[R_pad, W]; ``PJ`` f32[W+1, M, M]
    (:func:`_proj_table_np`); ``R0`` f32[M, S]. For each return: gather
    its fire operand, run ``n_pass`` passes of ``fire`` (cycling through
    it when it is a tuple), then for each deep gate ``g`` of ``cgate``
    ``g`` more while the return's pending count exceeds the passes run
    so far, then project by the table (``proj="matmul"``) or the blend,
    clamped with ``counts``. Each block of ``B`` returns runs its first
    ``B // unroll * unroll``. Returns ``(ckpt f32[R_pad // B, M, S],
    final f32[M, S])``: the set at the start of each block, and after
    the last."""
    _walk_shapes("ablate_walk", P, ret_slot, slot_ops, R0, B, PJ)
    if proj not in ("blend", "matmul"):
        raise ValueError(f"ablate_walk: projection {proj!r} is not "
                         f"'blend' or 'matmul'")
    R_pad, W = slot_ops.shape
    M, S = R0.shape
    O1 = P.shape[0]
    fires = fire if isinstance(fire, tuple) else (fire,)
    js = ret_slot.tolist()
    extra = (slot_ops >= 0).sum(1).tolist()
    ckpt = torch.empty((R_pad // B, M, S), dtype=torch.float32,
                       device=R0.device)
    R = R0
    for b0 in range(0, R_pad, B):
        ckpt[b0 // B] = R
        for k in range(b0, b0 + B // unroll * unroll):
            G_all = _gather_G(slot_ops, P, k, W, O1)
            for p in range(n_pass):
                R = fires[p % len(fires)](R, G_all, W, M, S)
            off = n_pass
            for g in _gates(cgate):
                if extra[k] > off:
                    for p in range(g):
                        R = fires[(off + p) % len(fires)](R, G_all, W, M, S)
                off += g
            if proj == "matmul":
                R = PJ[W if js[k] < 0 else js[k]] @ R
                if counts:
                    R = torch.clamp(R, max=1.0)
            else:
                R = _proj_blend(R, js[k], W, M, S, counts)
    return ckpt, R


# the kernel's body for each pass: (representation and merge, slot order)
# as csrc/ablate.cuh numbers them: 0 bool words, 1 f32 add, 2 f32 max;
# 0 forward, 1 reversed, 2 by pass from a mask
_BODY = {_fire_bool: (0, 0), _fire_bool_rev: (0, 1),
         _fire_counts_tree: (1, 0), _fire_counts_gs: (1, 0),
         _fire_maxnc: (2, 0)}


def _body(fire, counts: bool, n_total: int) -> Tuple[int, int, int]:
    """``(rep, order, rev_mask)`` of the kernel instance that runs
    ``fire`` over ``n_total`` passes a return at most; raises ValueError
    when no instance does."""
    fires = fire if isinstance(fire, tuple) else (fire,)
    if not fires or any(f not in _BODY for f in fires):
        raise ValueError(f"ablate_walk: the kernel has no body for {fire}")
    reps = {_BODY[f][0] for f in fires}
    if len(reps) != 1:
        raise ValueError("ablate_walk: the kernel does not mix bool and "
                         "count passes in one walk")
    rep = reps.pop()
    if (rep != 0) != bool(counts):
        raise ValueError("ablate_walk: the kernel runs bool passes without "
                         "counts and count passes with counts")
    revs = [_BODY[f][1] for f in fires]
    if not any(revs):
        return rep, 0, 0
    if all(revs):
        return rep, 1, 0
    if n_total > 31:
        raise ValueError(f"ablate_walk: {n_total} passes of alternating "
                         f"order; the kernel takes at most 31")
    return rep, 2, sum(revs[p % len(revs)] << p for p in range(n_total))


def smem_bytes(W: int, S: int, O1: int, counts: bool, table: bool = False,
               stream: bool = False, g_int8: bool = False) -> int:
    """Shared memory one walk takes, for the fits checks without a card.
    It mirrors ``layout`` in ``csrc/ablate.cuh`` (exported as
    ``jt_ablate_walk_smem`` and ``jt_ablate_stream_smem``), and
    ``chip_smoke.py`` checks that the two agree: K7's G of two returns
    (each 16-byte aligned), the set double-buffered (one word a mask, or
    f32 ``[M, S]`` with ``counts``), the projection table, the fire
    operand (K6: P as words or f32; K7: one return's G as words, or
    widened to f32 from int8) and a chunk of the return stream."""
    M = 1 << W
    n = 2 * (-(-S * W * S * (1 if g_int8 else 4) // 16) * 16) if stream \
        else 0
    n += 4 * (2 * M * S if counts else 2 * M)
    if table:
        n += 4 * (W + 1) * M * M
    if not stream:
        n += 4 * (O1 * S * S if counts else O1 * S)
    elif not counts:
        n += 4 * W * S
    elif g_int8:
        n += 4 * S * W * S
    n += 4 * _CHUNK * (1 if stream else W + 1)
    return n


def fits(W: int, M: int, S: int, O1: int, proj: str, counts: bool) -> bool:
    """Whether K6 takes this geometry: M = 2^W with 1 <= W <= 16, at
    most 32 states for the bool body, and everything in one block's
    shared memory — the table alone is ``(W+1)·M²·4`` bytes (24 KB at
    W = 5, 114 KB at W = 6, too large from W = 7), the f32 set
    ``2·M·S·4``."""
    return (1 <= W <= _MAX_W and M == 1 << W and S >= 1 and O1 >= 1
            and (counts or S <= 32) and proj in ("blend", "matmul")
            and smem_bytes(W, S, O1, counts, proj == "matmul")
            <= _SMEM_BYTES)


_WALK_LIB = None
_STREAM_LIB = None


def _walk_lib():
    global _WALK_LIB
    if _WALK_LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("ablate_walk")
        lib.jt_ablate_walk.argtypes = [ctypes.c_void_p] * 7 + \
            [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)] + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.jt_ablate_walk.restype = ctypes.c_int
        lib.jt_ablate_walk_smem.argtypes = [ctypes.c_int] * 5
        lib.jt_ablate_walk_smem.restype = ctypes.c_size_t
        _WALK_LIB = lib
    return _WALK_LIB


def _stream_lib():
    global _STREAM_LIB
    if _STREAM_LIB is None:
        from jepsen_tpu_torch import _build
        lib = _build.load("ablate_stream")
        lib.jt_ablate_stream.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.jt_ablate_stream.restype = ctypes.c_int
        lib.jt_ablate_stream_smem.argtypes = [ctypes.c_int] * 4
        lib.jt_ablate_stream_smem.restype = ctypes.c_size_t
        _STREAM_LIB = lib
    return _STREAM_LIB


def _ablate_walk_cuda(P, ret_slot, slot_ops, PJ, R0, B: int, n_pass: int,
                      fire, proj: str, counts: bool, unroll: int, cgate):
    global ABLATE_LAUNCHES
    from jepsen_tpu_torch.checkers.reach_lane import _check_operands

    _walk_shapes("ablate_walk", P, ret_slot, slot_ops, R0, B, PJ)
    _check_operands("ablate_walk", R0.device,
                    (("P", P, torch.float32),
                     ("ret_slot", ret_slot, torch.int32),
                     ("slot_ops", slot_ops, torch.int32),
                     ("PJ", PJ, torch.float32), ("R0", R0, torch.float32)))
    R_pad, W = slot_ops.shape
    M, S = R0.shape
    O1 = P.shape[0]
    gates = _gates(cgate)
    if not fits(W, M, S, O1, proj, counts):
        raise ValueError(f"ablate_walk: the kernel does not take W={W} "
                         f"S={S} O1={O1} proj={proj} counts={counts} "
                         f"(see fits)")
    if unroll not in (1, 2) or B % unroll or n_pass < 0 \
            or len(gates) > _MAX_GATES or min(gates, default=0) < 0:
        raise ValueError(f"ablate_walk: the kernel takes unroll 1 or 2 "
                         f"dividing B, n_pass >= 0 and at most "
                         f"{_MAX_GATES} gates (unroll={unroll} B={B} "
                         f"n_pass={n_pass} cgate={gates})")
    rep, order, rev_mask = _body(fire, counts, n_pass + sum(gates))
    lib = _walk_lib()
    ckpt = torch.empty((R_pad // B, M, S), dtype=torch.float32,
                       device=R0.device)
    final = torch.empty((M, S), dtype=torch.float32, device=R0.device)
    garr = (ctypes.c_int * _MAX_GATES)(*gates)
    with torch.cuda.device(R0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_ablate_walk(
            ret_slot.data_ptr(), slot_ops.data_ptr(), P.data_ptr(),
            PJ.data_ptr(), R0.data_ptr(), ckpt.data_ptr(), final.data_ptr(),
            R_pad, W, S, O1, B, n_pass, garr, len(gates), rep, order,
            rev_mask, int(proj == "matmul"), int(counts), unroll, stream)
    if err != 0:
        raise RuntimeError(f"ablate_walk kernel launch failed: CUDA error "
                           f"{err}")
    ABLATE_LAUNCHES += 1
    return ckpt, final


def ablate_walk(P: torch.Tensor, ret_slot: torch.Tensor,
                slot_ops: torch.Tensor, PJ: torch.Tensor, R0: torch.Tensor,
                B: int, n_pass: int, fire, proj: str, counts: bool,
                unroll: int = 1, cgate=()) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """A variant's walk with :func:`ablate_walk_plain`'s contract: the
    K6 kernel for tensors on the card (asynchronous, on the current
    stream; PJ 0/1 with at most one 1 a row, as
    :func:`_proj_table_np` builds it), the plain version for tensors on
    the CPU."""
    if R0.device.type == "cuda":
        return _ablate_walk_cuda(P, ret_slot, slot_ops, PJ, R0, B, n_pass,
                                 fire, proj, counts, unroll, cgate)
    if R0.device.type == "cpu":
        return ablate_walk_plain(P, ret_slot, slot_ops, PJ, R0, B, n_pass,
                                 fire, proj, counts, unroll, cgate)
    raise ValueError(f"ablate_walk: unsupported device {R0.device}")


# -- K7: the walk with the fire operand streamed from device memory ---------

def stream_operand(P: torch.Tensor, slot_ops: torch.Tensor,
                   g_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Every return's fire operand at once, ``G [R_pad, S, W·S]`` in
    ``g_dtype``: one indexing op on the operands' device, outside the
    kernel."""
    R_pad, W = slot_ops.shape
    O1, S, _ = P.shape
    o = torch.where(slot_ops < 0, O1 - 1, slot_ops).long()
    return P[o].permute(0, 2, 1, 3).reshape(R_pad, S, W * S).to(g_dtype)


def _stream_shapes(ret_slot, G, R0, B: int) -> int:
    """W of the streamed walk; raises ValueError on shapes it does not
    take."""
    R_pad, S, WS = G.shape
    M = R0.shape[0]
    W = WS // S
    if W * S != WS or R0.shape != (M, S) or M != 1 << W \
            or ret_slot.shape != (R_pad,) or B < 1 or R_pad % B \
            or G.dtype not in (torch.float32, torch.int8):
        raise ValueError(f"ablate_stream: inconsistent operands G"
                         f"{tuple(G.shape)} {G.dtype} ret_slot"
                         f"{tuple(ret_slot.shape)} R0{tuple(R0.shape)} "
                         f"B={B}")
    return W


def ablate_stream_plain(ret_slot: torch.Tensor, G: torch.Tensor,
                        R0: torch.Tensor, B: int, n_pass: int, fire,
                        counts: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streamed variant's walk in PyTorch ops, on any device: for
    each return, its operand ``G[k]`` (widened to f32 from int8),
    ``n_pass`` passes of ``fire``, and the blend projection. Returns
    ``(ckpt f32[R_pad // B, M, S], final f32[M, S])``."""
    W = _stream_shapes(ret_slot, G, R0, B)
    R_pad, S, _ = G.shape
    M = R0.shape[0]
    js = ret_slot.tolist()
    ckpt = torch.empty((R_pad // B, M, S), dtype=torch.float32,
                       device=R0.device)
    R = R0
    for b0 in range(0, R_pad, B):
        ckpt[b0 // B] = R
        for k in range(b0, b0 + B):
            G_all = G[k] if G.dtype == torch.float32 else G[k].float()
            for _ in range(n_pass):
                R = fire(R, G_all, W, M, S)
            R = _proj_blend(R, js[k], W, M, S, counts)
    return ckpt, R


def stream_fits(W: int, M: int, S: int, counts: bool,
                g_dtype: torch.dtype = torch.float32) -> bool:
    """Whether K7 takes this geometry: as :func:`fits`, with two
    returns' G staged in shared memory instead of P."""
    return (1 <= W <= _MAX_W and M == 1 << W and S >= 1
            and (counts or S <= 32)
            and g_dtype in (torch.float32, torch.int8)
            and smem_bytes(W, S, 1, counts, stream=True,
                           g_int8=g_dtype == torch.int8) <= _SMEM_BYTES)


def _ablate_stream_cuda(ret_slot, G, R0, B: int, n_pass: int, fire,
                        counts: bool):
    global STREAM_LAUNCHES
    from jepsen_tpu_torch.checkers.reach_lane import _check_operands

    W = _stream_shapes(ret_slot, G, R0, B)
    _check_operands("ablate_stream", R0.device,
                    (("ret_slot", ret_slot, torch.int32), ("G", G, G.dtype),
                     ("R0", R0, torch.float32)))
    R_pad, S, _ = G.shape
    M = R0.shape[0]
    if fire not in (_fire_bool, _fire_counts_tree, _fire_counts_gs,
                    _fire_maxnc) or n_pass < 0 \
            or not stream_fits(W, M, S, counts, G.dtype) \
            or G.data_ptr() % 16:
        raise ValueError(f"ablate_stream: the kernel does not take fire="
                         f"{getattr(fire, '__name__', fire)} n_pass="
                         f"{n_pass} W={W} S={S} G {G.dtype} (see "
                         f"stream_fits; G 16-byte aligned)")
    rep = _body(fire, counts, n_pass)[0]
    lib = _stream_lib()
    ckpt = torch.empty((R_pad // B, M, S), dtype=torch.float32,
                       device=R0.device)
    final = torch.empty((M, S), dtype=torch.float32, device=R0.device)
    with torch.cuda.device(R0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.jt_ablate_stream(
            ret_slot.data_ptr(), G.data_ptr(), R0.data_ptr(),
            ckpt.data_ptr(), final.data_ptr(), R_pad, W, S, B, n_pass, rep,
            int(counts), int(G.dtype == torch.int8), stream)
    if err != 0:
        raise RuntimeError(f"ablate_stream kernel launch failed: CUDA "
                           f"error {err}")
    STREAM_LAUNCHES += 1
    return ckpt, final


def ablate_stream(ret_slot: torch.Tensor, G: torch.Tensor, R0: torch.Tensor,
                  B: int, n_pass: int, fire, counts: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streamed variant's walk with :func:`ablate_stream_plain`'s
    contract: the K7 kernel for tensors on the card, the plain version
    for tensors on the CPU."""
    if R0.device.type == "cuda":
        return _ablate_stream_cuda(ret_slot, G, R0, B, n_pass, fire, counts)
    if R0.device.type == "cpu":
        return ablate_stream_plain(ret_slot, G, R0, B, n_pass, fire, counts)
    raise ValueError(f"ablate_stream: unsupported device {R0.device}")


# -- the ladder --------------------------------------------------------------

VARIANTS = {
    # name: (fire, proj, counts, unroll, n_pass or None=min(W,5)[, cgate])
    "v2-bool-blend": (_fire_bool, "blend", False, 1, None),
    "cnt-tree-blend": (_fire_counts_tree, "blend", True, 1, None),
    "maxnc-blend": (_fire_maxnc, "blend", True, 1, None),
    "bool-matmulproj": (_fire_bool, "matmul", False, 1, None),
    "bool-stream": (_fire_bool, "stream", False, 1, None),
    "maxnc-stream": (_fire_maxnc, "stream", True, 1, None),
    "bool-stream-i8": (_fire_bool, "stream-i8", False, 1, None),
    "v2-p4": (_fire_bool, "blend", False, 1, 4),
    "v2-p3": (_fire_bool, "blend", False, 1, 3),
    "v2-p2": (_fire_bool, "blend", False, 1, 2),
    "alt-p2": ((_fire_bool, _fire_bool_rev), "blend", False, 1, 2),
    "alt-p3": ((_fire_bool, _fire_bool_rev), "blend", False, 1, 3),
    "alt-p4": ((_fire_bool, _fire_bool_rev), "blend", False, 1, 4),
    # exact per-return pass gating: the pending count c_r bounds the
    # closure depth, so n_pass unconditional passes + (5 - n_pass) passes
    # under gates for the rare c_r > n_pass returns
    "cgate4+1": (_fire_bool, "blend", False, 1, 4, (1,)),
    "cgate3+2": (_fire_bool, "blend", False, 1, 3, (2,)),
    "cgate2+3": (_fire_bool, "blend", False, 1, 2, (3,)),
    "cgate3+1+1": (_fire_bool, "blend", False, 1, 3, (1, 1)),
    "cgate2+1+1+1": (_fire_bool, "blend", False, 1, 2, (1, 1, 1)),
    "cgate2+2+1": (_fire_bool, "blend", False, 1, 2, (2, 1)),
    "cgate1+1+1+1+1": (_fire_bool, "blend", False, 1, 1, (1, 1, 1, 1)),
    "cgate-ladder-u2": (_fire_bool, "blend", False, 2, 1, (1, 1, 1, 1)),
    "cgate-ladder-alt": ((_fire_bool, _fire_bool_rev), "blend", False, 1,
                         1, (1, 1, 1, 1)),
}

_STREAM_DTYPE = {"stream": torch.float32, "stream-i8": torch.int8}


def spec(name: str, W: int):
    """``(fire, proj, counts, unroll, n_pass, cgate)`` of variant
    ``name`` at ``W`` slots."""
    s = VARIANTS[name]
    fire, proj, counts, unroll, n_pass = s[:5]
    return (fire, proj, counts, unroll, min(W, 5) if n_pass is None
            else n_pass, _gates(s[5] if len(s) > 5 else ()))


def passes(name: str, W: int) -> int:
    """The most passes a return runs in variant ``name``."""
    _f, _p, _c, _u, n_pass, cgate = spec(name, W)
    return n_pass + sum(cgate)


def exact(name: str, W: int) -> bool:
    """Whether the variant reaches every return's closure: a return of
    pending count c needs at most c <= W passes, and the gates run only
    for returns past the passes before them."""
    return passes(name, W) >= W


def variant(name: str, geom, dev: torch.device) -> Callable:
    """Variant ``name`` at ``geom`` as a function of the operands
    ``(ret_slot, slot_ops, P, PJ, R0)`` giving ``(ckpt, final)``, through
    :func:`ablate_walk` or, with the operand streamed,
    :func:`stream_operand` and :func:`ablate_stream`. On the card it
    raises ValueError when the variant's kernel does not take the
    geometry."""
    B, W, M, S, O1, _R_pad = geom
    fire, proj, counts, unroll, n_pass, cgate = spec(name, W)
    if proj in _STREAM_DTYPE:
        g_dtype = _STREAM_DTYPE[proj]
        if dev.type == "cuda" and not stream_fits(W, M, S, counts, g_dtype):
            raise ValueError(f"ablate_stream: the kernel does not take W={W} "
                             f"S={S} counts={counts} {g_dtype}")

        def run(ret_slot, slot_ops, P, PJ, R0):
            return ablate_stream(ret_slot, stream_operand(P, slot_ops,
                                                          g_dtype),
                                 R0, B, n_pass, fire, counts)
        return run
    if dev.type == "cuda":
        if not fits(W, M, S, O1, proj, counts):
            raise ValueError(f"ablate_walk: the kernel does not take W={W} "
                             f"S={S} O1={O1} proj={proj} counts={counts}")
        _body(fire, counts, n_pass + sum(cgate))

    def run(ret_slot, slot_ops, P, PJ, R0):
        return ablate_walk(P, ret_slot, slot_ops, PJ, R0, B, n_pass, fire,
                           proj, counts, unroll, cgate)
    return run


def operands(ops: int = 100_000, *, seed: int = 42, processes: int = 5,
             B: int = _BLOCK, device=None):
    """The ladder's operands: a cas history of ``ops`` operations
    (``processes`` processes, ``seed``), its return stream padded to
    whole blocks of ``B`` and the projection table, on ``device``
    (default: the card). Returns ``(geometry, (ret_slot, slot_ops, P,
    PJ, R0), returns)`` with geometry ``(B, W, M, S, O1, R_pad)``."""
    from jepsen_tpu_torch import fixtures, history, models
    from jepsen_tpu_torch.checkers import events as ev
    from jepsen_tpu_torch.checkers import reach, reach_lane

    dev = _device.resolve(device)
    hist = fixtures.gen_history("cas", n_ops=ops, processes=processes,
                                seed=seed)
    memo, stream, _T, S, M = reach._prep(
        models.cas_register(), history.pack(hist), max_states=100_000,
        max_slots=20, max_dense=1 << 22)
    rs = ev.returns_view(stream)
    R0 = np.zeros((S, M), bool)
    R0[0, 0] = True
    geom, (P, ret_slot, slot_ops, R0_t) = reach_lane.pack_operands(
        reach._build_P(memo, S), rs.ret_slot, rs.slot_ops, R0, B=B,
        device=dev)
    PJ = torch.as_tensor(_proj_table_np(geom[1], geom[2]), device=dev)
    return geom, (ret_slot, slot_ops, P, PJ, R0_t), rs.n_returns


def timed(run: Callable, args) -> Tuple[float, Tuple[torch.Tensor,
                                                       torch.Tensor]]:
    """One run: ``(milliseconds, result)``, by CUDA events around the
    launch on the card, by the host clock on the CPU."""
    if args[0].device.type == "cuda":
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = run(*args)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1), out
    t0 = time.perf_counter()
    out = run(*args)
    return 1e3 * (time.perf_counter() - t0), out


def ladder(names: Sequence[str], geom, args, repeat: int = 2,
           log: Callable = print) -> Dict[str, Tuple[float, torch.Tensor]]:
    """Run each named variant ``repeat`` times in interleaved rounds, one
    launch a round, on the operands' device. Returns ``{name: (best ms,
    final set)}``; a variant whose kernel does not take the geometry gets
    a ``BUILD FAILED`` line through ``log`` and no entry. Any other
    failure raises."""
    if repeat < 1:
        raise ValueError(f"ladder: repeat={repeat}, want at least 1")
    if args[0].device.type == "cuda":
        _walk_lib(), _stream_lib()          # built before any timing
    runs = {}
    for name in names:
        try:
            runs[name] = variant(name, geom, args[0].device)
        except ValueError as e:
            log(f"{name:22s} BUILD FAILED: ValueError: {str(e)[:120]}")
    best = {name: math.inf for name in runs}
    final = {}
    for _ in range(repeat):
        for name, run in runs.items():
            ms, (_ckpt, final[name]) = timed(run, args)
            best[name] = min(best[name], ms)
    return {name: (best[name], final[name]) for name in runs}


_NOT_PORTED = {
    "bodies": "--bodies sweeps the word-packed post-hoc walk against the "
              "dense one and records the winner in the autotune table; the "
              "word-packed bodies and the table are not ported yet (ROADMAP "
              "queue 1, item 5: reach_word.py and checkers/autotune.py)",
    "pipeline": "--pipeline sweeps the serve-lane in-flight depth over "
                "reach.stage_check_many; it is not ported yet (ROADMAP "
                "queue 1, items 1-2: native host prep and the lockstep "
                "batch routes with stage_check_many)",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.tools.ablate_lane",
        description="Time the returns walk's body variants (K6, K7) on "
                    "the cas-100k operand set.")
    ap.add_argument("--ops", type=int, default=100_000)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the card; 'cpu' runs the plain "
                         "PyTorch versions")
    ap.add_argument("--bodies", action="store_true",
                    help="not ported: the word-packed vs dense body sweep")
    ap.add_argument("--pipeline", action="store_true",
                    help="not ported: the serve-lane depth sweep")
    args = ap.parse_args(argv)
    for mode in ("pipeline", "bodies"):
        if getattr(args, mode):
            print(f"ablate_lane: {_NOT_PORTED[mode]}", file=sys.stderr)
            return 2
    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    if args.repeat < 1:
        ap.error("--repeat must be at least 1")
    dev = _device.resolve(args.device)
    from jepsen_tpu_torch.checkers import reach_lane

    geom, opnds, n_ret = operands(args.ops, device=dev)
    B, W, M, S, O1, R_pad = geom
    print(f"geometry B={B} W={W} M={M} S={S} O1={O1} R_pad={R_pad} "
          f"returns={n_ret}", flush=True)
    ret_slot, slot_ops, P, _PJ, R0 = opnds
    # the exact set: K1 with the full W-pass ladder
    want = reach_lane.lane_walk(P, ret_slot, slot_ops, R0, B, W)[1] > 0
    for name, (ms, final) in ladder(names, geom, opnds, args.repeat).items():
        fin = final > 0
        print(f"{name:22s} {ms:10.3f} ms {1e6 * ms / max(n_ret, 1):9.1f} "
              f"ns/ret  match={torch.equal(fin, want)} "
              f"alive={bool(fin.any())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

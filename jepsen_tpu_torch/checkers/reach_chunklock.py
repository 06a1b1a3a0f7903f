"""Chunk-lockstep engine: one history's return stream cut into C
chunks that are walked together by the lockstep batch kernel (K2,
:mod:`.reach_batch`), in place of one serial walk over the whole
stream.

1. **Bound pass** (phase A): chunk c's boundary set ``v_c`` is
   over-approximated by walking the last ``L`` returns of chunk c-1
   from the full config set ⊤. The walk is monotone, so
   ``v̂_c = F_suffix(⊤) ⊇ v_c``: a sound bound for ``L`` lockstep steps,
   all suffixes in one launch. Projections contract ⊤ quickly, so the
   bound is tight in practice.
2. **Seed glue**: each ``v̂_c``'s configs are ranked and dealt
   round-robin into ``e_pad`` seed groups — single configs when
   ``|v̂_c| <= e_pad``, else unions, still sound because the walk is
   linear over the boolean semiring (``F(A ∪ B) = F(A) ∪ F(B)``).
3. **Restricted transfer pass** (phase B): one K2 launch walks every
   chunk's returns once, one lane per chunk, with ``e_pad·M`` rows:
   rows ``e·M + m`` carry seed e's set.
4. **Fold**: ``v_{c+1} = ∪ {image[c, e] : seed e meets v_c}``, C small
   steps. Exact when every selected seed lies inside ``v_c`` (always
   for single-config seeds); otherwise the chunk is flagged and the
   host refolds from the first flagged chunk, re-walking such chunks
   with K1 (:func:`_host_fold`, the ``rescues`` count). A death is
   located by re-walking its chunk with K1 from the exact boundary set.

Phases A, glue, B and fold are queued on the walk's device; the host
syncs once, on the fold's output. Verdicts and dead indices are those of
the single serial walk (:func:`reach_lane.walk_returns`).

Port of the reference package's ``reach_chunklock`` (single-process;
its multi-host sharding is not ported), with ``device=`` in place of
``interpret=``: on the CPU the kernels' plain versions run.
"""
from __future__ import annotations

import time as _time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch.checkers import reach_batch, reach_lane
from jepsen_tpu_torch.checkers.reach_lane import _FAST_PASSES

# the reference's constants, kept at its values so that chunks, seed
# groups and suffixes (and with them `chunks`, `rescues` and
# `basis-max`) match its results: C chunks (fewer on long or
# state-rich histories), e_pad seed groups per chunk (one union seed
# on long histories) and the bound pass's suffix length
_CHUNKS = 32
_CHUNKS_LONG = 16
_LONG_RETURNS = 1 << 20
_E_PAD = 8
_EPAD_SMALL = 1 << 18
_SUFFIX = 256
_SUFFIX_LONG = 512

# engine floor: below this many returns the single walk (K1) is taken
MIN_RETURNS = 32768

# K2's step block. It sets only the checkpoint granularity (chunk-
# lockstep reads no checkpoints) and the padding of each chunk to whole
# blocks, so it is kept small
_BLOCK = 256


class ChunklockUnfit(RuntimeError):
    """Geometry outside this engine's envelope."""


def _auto_chunks(S: int, Rn: int) -> int:
    c = _CHUNKS_LONG if Rn >= _LONG_RETURNS else _CHUNKS
    while c > 8 and c * S > 512:
        c //= 2
    return c


def admits(S: int, M: int, W: int, Rn: int) -> bool:
    """The router's gate: would the engine, with the geometry
    :func:`launch_chunklock` derives (auto chunks, the ``e_pad`` rule),
    take this history? (The alphabet's share of shared memory is
    :func:`reach_lane.lane_fits`'s to check.)"""
    if W > _FAST_PASSES or Rn < MIN_RETURNS:
        return False
    c = max(2, min(_auto_chunks(S, Rn), Rn))
    e = _E_PAD if Rn < _EPAD_SMALL else 1
    return fits(S, M, W, c, e)


def fits(S: int, M: int, W: int, C: int, e_pad: int) -> bool:
    """Whether K2 takes both phases and K1 the rescues: at most 32
    states (a mask's states are one 32-bit word) and ``_FAST_PASSES``
    slots (every pass of the exact ladder runs in one launch), with the
    walk's set in one block's shared memory at the ``P``-free minimum.
    ``C`` chunks and ``e_pad`` groups only set the grid, which holds
    far more blocks than any chunking takes."""
    return (1 <= S <= reach_lane._MAX_S and 1 <= W <= _FAST_PASSES
            and M == 1 << W and C >= 2 and e_pad >= 1
            and reach_lane.smem_bytes(W, S, 1) <= reach_lane._SMEM_BYTES)


def _glue_call(final_a: torch.Tensor, C: int, M: int, S: int, e_pad: int):
    """Seed extraction from phase A's final sets ``[M, C·S]``: per-chunk
    seed masks bool[C, e_pad, M·S] (configs flattened ``m·S + s``,
    ranked and dealt round-robin), phase B's initial rows
    f32[e_pad·M, C·S], and the bound sizes int32[C]. Boolean and integer
    ops only."""
    MS = M * S
    flat = (final_a.view(M, C, S) > 0.5).permute(1, 0, 2).reshape(C, MS)
    cnt = flat.sum(1, dtype=torch.int32)
    rank = torch.cumsum(flat.int(), 1) - flat.int()
    grp = rank % e_pad
    seeds = flat[:, None, :] & (
        grp[:, None, :] == torch.arange(e_pad, device=flat.device)[None, :,
                                                                   None])
    r0b = seeds.view(C, e_pad, M, S).permute(1, 2, 0, 3)
    return seeds, r0b.reshape(e_pad * M, C * S).float(), cnt


def _fold_call(final_b: torch.Tensor, seeds: torch.Tensor, cnt: torch.Tensor,
               C: int, M: int, S: int, e_pad: int) -> torch.Tensor:
    """The fold over phase B's images, on their device. Returns one
    int32 array (a single fetch decides the happy path): row 0 =
    ``[dead_chunk, inexact[0..C), count[0..C)]``, rows 1..C+1 = the
    boundary sets v_0..v_C. Boolean ops only."""
    dev = final_b.device
    MS = M * S
    images = (final_b.view(e_pad, M, C, S) > 0.5).permute(2, 0, 1, 3) \
        .reshape(C, e_pad, MS)
    v = torch.zeros(MS, dtype=torch.bool, device=dev)
    v[0] = True
    all_v = [v]
    inexact = []
    dead = torch.full((), -1, dtype=torch.int32, device=dev)
    for c in range(C):
        sc = seeds[c]                                   # [e_pad, MS]
        active = (sc & v).any(1)                        # [e_pad]
        sel = (sc & active[:, None]).any(0)             # [MS]
        inexact.append((sel & ~v).any())
        v = (images[c] & active[:, None]).any(0)
        dead = torch.where((dead < 0) & ~v.any(), c, dead)
        all_v.append(v)
    HW = max(MS, 1 + 2 * C)
    out = torch.zeros((C + 2, HW), dtype=torch.int32, device=dev)
    out[0, 0] = dead
    out[0, 1:1 + C] = torch.stack(inexact).int()
    out[0, 1 + C:1 + 2 * C] = cnt
    out[1:, :MS] = torch.stack(all_v).int()
    return out


def _chunk_operands(ret_slot: np.ndarray, slot_ops: np.ndarray, C: int,
                    per: int, per_pad: int, L: int, L_pad: int
                    ) -> Tuple[np.ndarray, ...]:
    """The return stream in the two lockstep layouts (int32): phase A
    rows = each boundary's suffix, front-padded with identity rows
    (harmless from ⊤); phase B rows = the chunks themselves."""
    Rn = int(ret_slot.shape[0])
    W = int(slot_ops.shape[1])
    rs_a = np.full((L_pad, C), -1, np.int32)
    ops_a = np.full((L_pad, C, W), -1, np.int32)
    for c in range(1, C):
        end = min(c * per, Rn)
        lo = max(0, end - L)
        n = end - lo
        if n > 0:
            rs_a[L_pad - n:, c] = ret_slot[lo:end]
            ops_a[L_pad - n:, c] = slot_ops[lo:end]
    rs_b = np.full((per_pad, C), -1, np.int32)
    ops_b = np.full((per_pad, C, W), -1, np.int32)
    for c in range(C):
        lo, hi = c * per, min((c + 1) * per, Rn)
        if hi > lo:
            rs_b[:hi - lo, c] = ret_slot[lo:hi]
            ops_b[:hi - lo, c] = slot_ops[lo:hi]
    return rs_a, ops_a, rs_b, ops_b


def _localize(P: np.ndarray, ret_slot: np.ndarray, slot_ops: np.ndarray,
              M: int, v_entry: np.ndarray, c: int, per: int, device,
              should_abort=None) -> Tuple[int, Optional[np.ndarray]]:
    """Re-walk chunk ``c`` with K1 from its exact boundary set (bool
    ``[M·S]``): ``(global_dead_or_-1, exit_set_or_None)``."""
    Rn = int(ret_slot.shape[0])
    S = P.shape[1]
    lo, hi = c * per, min((c + 1) * per, Rn)
    dead, r_final = reach_lane.walk_returns(
        P, ret_slot[lo:hi], slot_ops[lo:hi], v_entry.reshape(M, S).T,
        device=device, should_abort=should_abort)
    if dead >= 0:
        return lo + dead, None
    return -1, r_final.T.reshape(M * S)


def _host_fold(P: np.ndarray, ret_slot: np.ndarray, slot_ops: np.ndarray,
               M: int, seeds_np: np.ndarray, images_np: np.ndarray,
               v: np.ndarray, start: int, C: int, per: int, device,
               diag: Dict[str, Any], should_abort=None) -> int:
    """Exact fold on the host over the per-chunk seeds and images
    (bool), from chunk ``start`` and its exact boundary set ``v``: a
    chunk whose selected union seeds escape ``v`` is re-walked with K1
    (:func:`_localize`, counted in ``diag["rescues"]``). Returns the
    global dead return index, -1 = linearizable."""
    for c in range(start, C):
        _poll(should_abort)
        active = (seeds_np[c] & v).any(1)
        sel = (seeds_np[c] & active[:, None]).any(0)
        if not (sel & ~v).any():
            vn = (images_np[c] & active[:, None]).any(0)
        else:
            diag["rescues"] += 1
            dead, vn = _localize(P, ret_slot, slot_ops, M, v, c, per,
                                 device, should_abort)
            if dead >= 0:
                return dead
        if not vn.any():
            dead, _ = _localize(P, ret_slot, slot_ops, M, v, c, per, device,
                                should_abort)
            if dead < 0:
                raise ChunklockUnfit("fold death not confirmed by re-walk")
            return dead
        v = vn
    return -1


class ChunklockInflight:
    """A launched walk whose fold output has not been fetched: phases A,
    glue, B and the fold are queued on the device. Consumed by
    :func:`collect_chunklock`."""

    __slots__ = ("packed", "final_b", "seeds", "P", "ret_slot",
                 "slot_ops", "M", "C", "e_pad", "per", "device")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


def phase_operands(P: np.ndarray, ret_slot: np.ndarray,
                   slot_ops: np.ndarray, M: int, *,
                   n_chunks: Optional[int] = None,
                   e_pad: Optional[int] = None,
                   suffix: Optional[int] = None, device=None):
    """The geometry and the K2 operands of both phases on ``device``:
    ``(C, e_pad, per, phase_a, phase_b)``. ``phase_a`` is ``(P, slot_ops,
    ret_slot_rh, R0, B)`` for :func:`reach_batch.batch_walk`;
    ``phase_b`` is the same without ``R0``, which the glue derives from
    phase A's final sets."""
    dev = _device.resolve(device)
    O1, S, _ = P.shape
    Rn = int(ret_slot.shape[0])
    W = int(slot_ops.shape[1])
    if W > _FAST_PASSES:
        raise ChunklockUnfit(f"W={W} beyond exact-ladder cap")
    if e_pad is None:
        e_pad = _E_PAD if Rn < _EPAD_SMALL else 1
    if suffix is None:
        suffix = _SUFFIX if Rn < _EPAD_SMALL else _SUFFIX_LONG
    C = n_chunks if n_chunks is not None else _auto_chunks(S, Rn)
    C = max(2, min(C, Rn))
    if not (fits(S, M, W, C, e_pad) and reach_lane.lane_fits(S, M, O1 - 1)):
        raise ChunklockUnfit("geometry outside the walk kernels' envelope")
    per = -(-Rn // C)
    per_pad = -(-per // _BLOCK) * _BLOCK
    L = max(1, min(suffix, per))
    b_a = min(_BLOCK, L)
    L_pad = -(-L // b_a) * b_a
    rs_a, ops_a, rs_b, ops_b = _chunk_operands(ret_slot, slot_ops, C, per,
                                               per_pad, L, L_pad)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    # phase A seeds: chunk 0 walks nothing from the exact one-hot v_0;
    # chunks 1.. walk their suffix from ⊤, padded states included
    r0_a = np.ones((M, C * S), np.float32)
    r0_a[:, :S] = 0.0
    r0_a[0, 0] = 1.0
    P_t = put(P.astype(np.float32))
    phase_a = (P_t, put(ops_a.reshape(-1)), put(rs_a), put(r0_a), b_a)
    phase_b = (P_t, put(ops_b.reshape(-1)), put(rs_b), _BLOCK)
    return C, e_pad, per, phase_a, phase_b


def launch_chunklock(P: np.ndarray, ret_slot: np.ndarray,
                     slot_ops: np.ndarray, M: int, *,
                     n_chunks: Optional[int] = None,
                     e_pad: Optional[int] = None,
                     suffix: Optional[int] = None,
                     device=None) -> ChunklockInflight:
    """Queue phases A, glue, B and the fold on ``device`` (default: the
    card) without fetching anything. Phase A and phase B are one K2
    launch each, both with the exact closure (``n_pass = W``):
    soundness needs the full sets."""
    C, e_pad, per, (P_t, ops_a, rs_a, r0_a, b_a), \
        (_, ops_b, rs_b, b_b) = phase_operands(
            P, ret_slot, slot_ops, M, n_chunks=n_chunks, e_pad=e_pad,
            suffix=suffix, device=device)
    S = int(P.shape[1])
    W = int(slot_ops.shape[1])
    _ck_a, final_a = reach_batch.batch_walk(P_t, ops_a, rs_a, r0_a, b_a, W)
    seeds, r0_b, cnt = _glue_call(final_a, C, M, S, e_pad)
    _ck_b, final_b = reach_batch.batch_walk(P_t, ops_b, rs_b, r0_b, b_b, W)
    packed = _fold_call(final_b, seeds, cnt, C, M, S, e_pad)
    return ChunklockInflight(
        packed=packed, final_b=final_b, seeds=seeds, P=P,
        ret_slot=ret_slot, slot_ops=slot_ops, M=M, C=C, e_pad=e_pad,
        per=per, device=P_t.device)


def _poll(should_abort) -> None:
    if should_abort is not None and should_abort():
        raise reach_lane.Aborted()


def collect_chunklock(inf: ChunklockInflight, should_abort=None
                      ) -> Tuple[int, Dict[str, Any]]:
    """Fetch the fold's output (the one sync) and decide: a happy path
    needs nothing more; a death is located with K1; flagged chunks are
    refolded on the host (:func:`_host_fold`). ``should_abort`` is
    polled after the sync, before each chunk of the host fold and
    between the K1 re-walks' segments; it raises
    :class:`reach_lane.Aborted`."""
    P, ret_slot, slot_ops = inf.P, inf.ret_slot, inf.slot_ops
    M, C, e_pad, per, dev = inf.M, inf.C, inf.e_pad, inf.per, inf.device
    S = int(P.shape[1])
    MS = M * S
    out = inf.packed.cpu().numpy()                   # the one sync
    _poll(should_abort)
    dead_chunk = int(out[0, 0])
    inexact = out[0, 1:1 + C] > 0
    counts = out[0, 1 + C:1 + 2 * C].astype(np.int64)
    all_v = out[1:, :MS] > 0                         # [C+1, MS]
    diag = {"chunks": C, "basis-max": int(counts.max(initial=0)),
            "rescues": 0}
    last = C if dead_chunk < 0 else dead_chunk
    if not inexact[:last].any():
        if dead_chunk < 0:
            return -1, diag
        # a death under an exact entry set is a true death: locate the
        # return inside the chunk
        dead, _ = _localize(P, ret_slot, slot_ops, M, all_v[dead_chunk],
                            dead_chunk, per, dev, should_abort)
        if dead < 0:
            raise ChunklockUnfit("fold death not confirmed by re-walk")
        return dead, diag
    seeds_np = inf.seeds.cpu().numpy()               # [C, e_pad, MS]
    images_np = (inf.final_b > 0.5).view(e_pad, M, C, S) \
        .permute(2, 0, 1, 3).reshape(C, e_pad, MS).cpu().numpy()
    start = int(np.nonzero(inexact)[0][0])
    dead = _host_fold(P, ret_slot, slot_ops, M, seeds_np, images_np,
                      all_v[start], start, C, per, dev, diag, should_abort)
    return dead, diag


def walk_chunklock(P: np.ndarray, ret_slot: np.ndarray,
                   slot_ops: np.ndarray, M: int, *,
                   n_chunks: Optional[int] = None,
                   e_pad: Optional[int] = None,
                   suffix: Optional[int] = None,
                   should_abort=None,
                   device=None) -> Tuple[int, Dict[str, Any]]:
    """Chunk-lockstep returns walk over one history on ``device``
    (default: the card). Returns ``(dead, diag)``: ``dead`` is the first
    return index at which the exact config set emptied (-1 =
    linearizable), as :func:`reach_lane.walk_returns` gives it; ``diag``
    holds ``chunks``, ``basis-max`` (the largest bound) and
    ``rescues``. ``should_abort`` is polled before the launch and
    between the phases that follow it (:func:`collect_chunklock`); it
    raises :class:`reach_lane.Aborted`. The launched phases are two K2
    walks over chunks of ``Rn / C`` returns each, so a poll waits at
    most for them."""
    _poll(should_abort)
    return collect_chunklock(launch_chunklock(
        P, ret_slot, slot_ops, M, n_chunks=n_chunks, e_pad=e_pad,
        suffix=suffix, device=device), should_abort)


def check_packed(model, packed, *, max_states: int = 100_000,
                 max_slots: int = 20, max_dense: int = 1 << 22,
                 n_chunks: Optional[int] = None,
                 e_pad: Optional[int] = None,
                 suffix: Optional[int] = None,
                 device=None) -> Dict[str, Any]:
    """The ``chunklock`` algorithm: prep, the chunk-lockstep walk on
    ``device`` (default: the card) and a knossos-style verdict and
    witness. Raises :class:`ChunklockUnfit`,
    :class:`reach.DenseOverflow` and the like when the history is
    outside the envelope."""
    from jepsen_tpu_torch.checkers import events as ev
    from jepsen_tpu_torch.checkers import reach

    dev = _device.resolve(device)
    t0 = _time.monotonic()
    if packed.n == 0 or packed.n_ok == 0:
        return {"valid": True, "engine": "reach-chunklock", "events": 0,
                "time-s": 0.0}
    memo, stream, _T, S_pad, M = reach._prep(
        model, packed, max_states=max_states, max_slots=max_slots,
        max_dense=max_dense)
    W = max(stream.W, 1)
    if not reach._fast_ok(S_pad, W, M, memo.n_ops):
        raise ChunklockUnfit("outside fast-path budget")
    rs = ev.returns_view(stream)
    if rs.n_returns < 2:
        raise ChunklockUnfit("too few returns")
    P_np = reach._build_P(memo, S_pad)
    dead, diag = walk_chunklock(P_np, rs.ret_slot, rs.slot_ops, M,
                                n_chunks=n_chunks, e_pad=e_pad,
                                suffix=suffix, device=dev)
    out = reach._lane_verdict("reach-chunklock", dead,
                              _time.monotonic() - t0, stream, memo, packed,
                              rs, P_np, S_pad, M, W, dev)
    out.update(diag)
    return out

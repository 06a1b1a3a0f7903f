"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``jepsen_tpu_torch/csrc`` (K1
``lane_walk``, K2 ``batch_walk``, K3 ``keyed_walk``, K4 ``wide_walk``,
K5 ``wide_keyed``, K6 ``ablate_walk``, K7 ``ablate_stream``, K8
``txn_closure``), holds each
kernel bit for bit against its plain PyTorch version on the card at the
shapes the main path gives it, then drives the main path through the
user's entry points and checks the results:

- ``Linearizable(cas_register()).check`` on a 100,000-op history
  (chunk-lockstep: two K2 launches), valid and corrupted (the corrupted
  one against the CPU run and against K1, with no torch returns walk:
  K1 reports the dead return itself; its walk split stage by stage,
  ``tools/walk_split.py``), and on a 1,000,000-op one;
- the same on a 30,000-op history, below chunk-lockstep's floor (K1);
  K1 and K2 walk P's nibble image tables, built by one
  ``pack_tables`` launch and copied into each block's shared memory
  or, for a many-op alphabet at 32 states, read from device memory;
  each K1 launch is held against its plain version in its dead return
  too;
- the C++ host prep (``native/preproc.cpp``, built by ``g++``): its slot
  assignment and returns view against the plain Python scans, array for
  array, at cas-100k and cas-1M;
- ``independent.checker(Linearizable(cas_register()))`` on 2,000 keys of
  50 ops and on 200 keys of 1,000 ops (the lockstep lane: one union
  prep, a K2 launch a group of up to 32 keys, K1 for each failed key),
  and on one key of 30,000 ops (the native keyed lane, one K3 launch),
  each against the CPU run; K2 at the lockstep group's geometry against
  its plain version, and both lanes' walks after one shared union prep
  (the lockstep scheduler, and K3), which must agree key for key; K3 walks P's nibble image tables as K1 and K2 do,
  in the warp form and in the block form (held bit for bit against its
  plain version and the host replay at W = 4, 6 and 8 and at the long
  keys, and timed beside K5 on the same keys);
- ``reach.check_batch`` on 32 cas-100k histories from
  ``fixtures.gen_packed`` (one K2 launch) and on 8 cas-30k histories, two
  corrupted, each history's result against its own ``check_packed`` on
  the card;
- more than 32 states: a 100,000-op cas history over 40 values and a
  100,000-op multi-register history (``algorithm="reach"``, the dense
  engine alone; one K4 launch each), the corrupted
  cas one against the CPU run, and 2,000 keys over 40 values (one K5
  launch) against the CPU run; K4 and K5 build P's nibble image tables
  first (held bit for bit against their plain version on both
  alphabets), each of their launches logs the form it took (the set in
  one warp's registers, or the block form), and small histories reach
  the warp form's other instances (entries of 1 to 8 words); the wide
  independent shape takes the native keyed lane, its union outside K2's
  envelope;
- the ablation harness (``jepsen_tpu_torch.tools.ablate_lane``): its 22
  variants of the walk's body (19 on K6, 3 on K7), and the two kernel
  instances no variant takes alone, on its cas-100k stream, each held
  bit for bit against its plain version and the host replay on the first
  block of 1,024 returns, with the form, table place and ring its launch
  takes; the block form on a cas history of 6 processes (one case per
  kernel instance, the projection table at its largest, both of K7's
  dtypes); then the full ladder through the harness's own function,
  every exact variant ending on K1's final set;
- the ``auto`` chain past the dense engine (:func:`phase_chain`), each
  check against the port's own CPU run and the expected verdict: the
  C++ WGL search on a 5,000-op register history with 129 crashed ops
  (75 pending at once); the frontier's dense-product quotient under a
  tight config budget on a 2,000-op one (W = 33) and its corrupted twin
  (dead event 562, with the witness); the reference's scaling row
  through the quotient and through the sparse rows (capacity 2,048),
  and its corrupted twin; the sparse-live quotient walk on bursts of
  same-value and of distinct writes; ``Linearizable(multi_register())``
  on a 20,000-op history over 8 keys × 5 values (the per-key
  decomposition on the lockstep lane, K2, with K1 for the failed keys)
  and its corrupted twin, and a transactional history through the
  restricted product (K4); then a probe of the frontier alone, bounded
  by a 60 s time limit, on the corrupted twin of the 5,000-op history.
  Each prints its wall time, the stage selected, the returns walked,
  host reads a return, ms a return and ``frontier-cap``;
- the transactional checker (:func:`phase_txn`): K8, one squaring of the
  word-packed closure on the single-bit tensor cores, bit for bit
  against its plain version at (K, Np) from (3, 32) to (4, 8,192), with
  (1, 96) and (3, 64) for the small tile, at 2, 8 and Np / 2 edges a
  node (the last saturates the counts), its form, tile and load path
  logged, beside one ``torch.bmm`` squaring in each
  exact precision (fp32, TF32, bf16, fp16; the fastest is the kernels
  line's ``library_ms``); the reference bench's closure-bound graphs
  (n = 1,024 and 8,192) through the K8 ladder, the f32 cross-check and
  the host SCC; ``txn.check_history`` on the reference bench's
  100,000-txn rung (one G-single block) against the host SCC and the
  port's CPU run, on a 6,000-txn history with a write skew at every
  consistency level (``txn-lattice-mxu``, K = 4, Np = 8,192; 13 K8
  launches) against the host lattice and the f32 cross-check, and on
  every injected block.

Kernel times are CUDA events around ``n`` calls of a wrapper
(:func:`event_ms`, the wrapper's host work included), and for the short
kernels (K3, K5, ``pack_tables``) also the device's own kernel records
(``tools/keyed_times.device_ms``), printed beside them.

Exits non-zero, with no result line, when there is no CUDA device or any
phase fails. The last three lines are one JSON object of per-kernel
numbers (``launches``: summed over every drive of the main path), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from jepsen_tpu_torch.tools.keyed_times import (LONG_BAD, LONG_KEYS,
                                                LONG_OPS, device_ms)

HBM_RATE = 3.35e12       # H100 SXM device-memory bytes/s
# H100 SXM 32-bit integer operations/s: the data sheet's 67 TFLOP/s fp32
# is 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz; the integer pipe has 64
# lanes per SM, one operation each per clock: 132 x 64 x 1.98e9
INT32_PEAK = 132 * 64 * 1.98e9

# the independent suite's defaults (suites/register.py independent_test
# at 2,000 keys): 50 ops a key, 4 processes a key; every 100th key from
# key 7 on is corrupted
N_KEYS, OPS_PER_KEY, KEY_PROCS = 2_000, 50, 4
BAD_KEYS = tuple(range(7, N_KEYS, 100))
# one live key (the native keyed lane on K3)
ONE_KEY_OPS = 30_000
# check_batch: the bench's batch rung (32 cas-100k histories from
# fixtures.gen_packed), and 8 cas-30k histories, two corrupted
BATCH_N = 32
SMALL_BATCH_N, SMALL_BATCH_BAD = 8, (2, 5)


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def ptxas_kernels(text: str):
    """``(kernel, registers, spill store bytes)`` of each entry function
    in a ``ptxas -v`` log, the kernel as its name and template
    arguments."""
    def kernel_name(mangled: str) -> str:
        # the first length-prefixed name followed by its template
        # arguments (I) or the end of its scope (E)
        for m in re.finditer(r"(?=(\d+)([A-Za-z_][A-Za-z0-9_]*))", mangled):
            n, ident = int(m.group(1)), m.group(2)
            end = m.start() + len(m.group(1)) + n
            if len(ident) >= n and mangled[end:end + 1] in ("I", "E"):
                return ident[:n]
        return mangled

    out = []
    for block in text.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        args = ",".join(re.findall(r"L[a-z](\d+)E", mangled))
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out.append((f"{kernel_name(mangled)}<{args}>",
                    int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else -1))
    return out


def ptxas_summary(src: str, text: str) -> str:
    """One line of what ``ptxas -v`` said of a source's kernels: their
    number, the registers they use and their largest spill (the full
    log is beside the library in ``jepsen_tpu_torch/_build/``)."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
    spill = [int(m) for m in re.findall(r"(\d+) bytes spill stores", text)]
    return (f"ptxas {src}: {len(regs)} kernels, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill stores "
            f"up to {max(spill, default=0)} bytes")


def history_operands(h, model):
    """The reference-shaped numpy operands of one history's returns
    walk: ``(P, returns view, M)``."""
    from jepsen_tpu_torch import history
    from jepsen_tpu_torch.checkers import events as ev
    from jepsen_tpu_torch.checkers import reach

    memo, stream, _T, S_pad, M = reach._prep(
        model, history.pack(h), max_states=100_000, max_slots=20,
        max_dense=1 << 22)
    return reach._build_P(memo, S_pad), ev.returns_view(stream), M


def gen(kind, n_ops, processes, seed, corrupt=False, **kw):
    from jepsen_tpu_torch import fixtures

    h = fixtures.gen_history(kind, n_ops=n_ops, processes=processes,
                             seed=seed, **kw)
    return fixtures.corrupt(h, seed=seed) if corrupt else h


def event_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` calls, warmed, by CUDA
    events around the calls: the device's time, and the wrapper's host
    time where the device waits on it (short kernels)."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def plain_ms(fn):
    """One run of a plain version on the card: ``(result, ms)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def as_sets(sets) -> np.ndarray:
    """0/1 sets ``[H, M, S]`` (a tensor or an array) as booleans."""
    if isinstance(sets, torch.Tensor):
        sets = sets.cpu().numpy()
    return sets > 0.5


def walk_work(P: np.ndarray, ret_rh: np.ndarray, ops_rhw: np.ndarray,
              v0: np.ndarray, n_pass: int, lens=None):
    """The 32-bit operations these inputs need in the word form of the
    walk, by replaying H walks in lockstep on the host with numpy, each
    as the kernels run it: a mask's states are NW = ceil(S / 32) words;
    per return, ``min(c, n_pass)`` Jacobi passes, firing pending slot j
    into mask m (bit j set) ORs, into each of the NW words, P's word of
    each set state of the partner set, and ORs the image in; a
    projection moves M·NW words. ``ret_rh`` [R, H], ``ops_rhw``
    [R, H, W], ``v0`` bool sets [H, M, S]. With ``lens`` (K3 to K5) walk
    h stops after the first of its ``lens[h]`` returns that empties it.
    Returns ``(operations, final sets [H, M, S], dead [H])``; the final
    sets are an independent check of the kernel."""
    O1, S, _ = P.shape
    R, H, W = ops_rhw.shape
    M = 1 << W
    NW = -(-S // 32)
    Pi = (P > 0.5).astype(np.int32)
    v = v0.astype(bool).copy()
    masks = np.arange(M)
    his = [masks[(masks >> j) & 1 == 1] for j in range(W)]
    live = np.ones(H, bool)
    dead = np.full(H, -1, np.int64)
    ops = 0
    for r in range(R):
        o = ops_rhw[r]
        pend = o >= 0
        passes = np.minimum(pend.sum(1), n_pass) * live
        for p in range(int(passes.max(initial=0))):
            acc = v.copy()
            for j in range(W):
                on = np.nonzero((passes > p) & pend[:, j])[0]
                if not len(on):
                    continue
                hi = his[j]
                partner = v[on][:, hi ^ (1 << j)]            # [n, M/2, S]
                img = (partner.astype(np.int32) @ Pi[o[on, j]]) > 0
                acc[np.ix_(on, hi)] |= img
                ops += NW * (int(partner.sum()) + img.shape[0] * img.shape[1])
            v = acc
        js = ret_rh[r]
        proj = np.nonzero((js >= 0) & live)[0]
        if len(proj):
            j = js[proj][:, None]
            keep = ((masks[None, :] >> j) & 1) == 0
            src = v[proj[:, None], masks[None, :] | (1 << j)]  # [n, M, S]
            v[proj] = src & keep[..., None]
            ops += M * NW * len(proj)
        if lens is not None:
            died = live & (r < lens) & ~v.any((1, 2))
            dead[died] = r
            live &= ~died
    return ops, v, dead


def bound_ms(nbytes: int, operations: int):
    """Least time on this card for the work: the larger of its bytes
    (each input read once, each output written once) over the memory
    rate and its 32-bit operations (:func:`walk_work`) over the integer
    rate."""
    t_bytes, t_ops = nbytes / HBM_RATE, operations / INT32_PEAK
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            f"bytes={nbytes} int32_ops={operations}")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_smem_layout():
    """``reach_lane.smem_bytes`` and ``reach_pallas.smem_bytes`` (routing
    without a card) against the kernels' own ``jt_lane_walk_smem``,
    ``jt_keyed_walk_smem`` (K1, K2, K3) and ``jt_wide_walk_smem``, over
    the geometries they take."""
    from jepsen_tpu_torch.checkers import reach_lane

    lane, keyed = reach_lane._lib(), reach_lane._keyed_lib()
    for W in range(1, reach_lane._MAX_W + 1):
        for S in (1, 8, 32):
            for O1 in (2, 37, 442, 443, 1000):
                for warp in (False, True):
                    for lib, fn, host in (
                            (lane, "jt_lane_walk_smem",
                             reach_lane.smem_bytes),
                            (keyed, "jt_keyed_walk_smem",
                             reach_lane.smem_bytes)):
                        got = getattr(lib, fn)(W, S, O1, int(warp))
                        if got != host(W, S, O1, warp):
                            raise AssertionError(
                                f"{fn} differs at W={W} S={S} O1={O1} "
                                f"warp={warp}: kernel {got}, host "
                                f"{host(W, S, O1, warp)}")
    # the wide kernels' layout and form (K4, K5) against
    # reach_pallas.smem_bytes and reach_pallas.warp_form
    from jepsen_tpu_torch.checkers import reach_pallas

    lib = reach_pallas._lib()
    for W in range(1, reach_pallas._MAX_W + 1):
        for S in (1, 8, 32, 33, 64, 100, 128, 256, 257, 1024):
            if lib.jt_wide_walk_form(W, S) != reach_pallas.warp_form(W, S):
                raise AssertionError(f"wide form differs at W={W} S={S}")
            for O1 in (2, 19, 21, 248, 735):
                got = lib.jt_wide_walk_smem(W, S, O1)
                if got != reach_pallas.smem_bytes(W, S, O1):
                    raise AssertionError(
                        f"wide smem layout differs at W={W} S={S} O1={O1}: "
                        f"kernel {got}, host "
                        f"{reach_pallas.smem_bytes(W, S, O1)}")
    # the ablation kernels' layout (K6, K7) against ablate_lane.smem_bytes
    from jepsen_tpu_torch.tools import ablate_lane as ab

    walk, stream = ab._walk_lib(), ab._stream_lib()
    for W in range(1, 11):
        for S in (1, 3, 8, 16, 32, 64):
            for rep in (0, 1, 2):
                for O1, table in ((2, 0), (23, 1), (37, 1), (450, 0),
                                  (735, 0), (4000, 0)):
                    got = (walk.jt_ablate_walk_smem(W, S, O1, rep, table),
                           walk.jt_ablate_walk_design(W, S, O1, rep, table))
                    want = (ab.smem_bytes(W, S, O1, rep != 0, bool(table)),
                            ab.design(W, S, O1, rep != 0, bool(table)))
                    if got != want:
                        raise AssertionError(
                            f"ablate_walk layout differs at W={W} S={S} "
                            f"O1={O1} rep={rep} table={table}: kernel "
                            f"(bytes, design) {got}, host {want}")
                for i8 in (0, 1):
                    got = (stream.jt_ablate_stream_smem(W, S, rep, i8),
                           stream.jt_ablate_stream_design(W, S, rep, i8))
                    want = (ab.smem_bytes(W, S, 1, rep != 0, stream=True,
                                          g_int8=bool(i8)),
                            ab.design(W, S, 1, rep != 0, stream=True,
                                      g_int8=bool(i8)))
                    if got != want:
                        raise AssertionError(
                            f"ablate_stream layout differs at W={W} S={S} "
                            f"rep={rep} int8={i8}: kernel (bytes, design) "
                            f"{got}, host {want}")


def same(label: str, got, want):
    """Bit for bit, else the phase fails."""
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{label}: kernel differs from its plain "
                             f"version")
    return max(float((a.float() - b.float()).abs().max()) if a.numel()
               else 0.0 for a, b in zip(got, want))


# (label, kind, n_ops, processes, seed, B, corrupt, generator options,
# returns walked or None for all): the main path's K1 shape first (a
# history below chunk-lockstep's floor), then a multi-block walk, one
# past the ladder cap, a corrupted one that dies mid-stream and a
# many-op alphabet at 32 states whose tables stay in device memory (its
# first 4,096 returns: the plain version takes about 1 ms a return)
GEOMS = [
    ("sub-floor cas-30k", "cas", 30_000, 5, 0, 1024, False, {}, None),
    ("W=7 multi-block", "cas", 4_000, 7, 1, 64, False, {}, None),
    ("W=10 capped ladder", "cas", 1_000, 11, 0, 64, True, {}, None),
    ("corrupted cas-4k", "cas", 4_000, 5, 3, 256, True, {}, None),
    ("S=32 many ops, tables in device memory", "cas", 60_000, 5, 0, 1024,
     False, dict(values=31), 4096),
]


def tables_place(W: int, S: int, O1: int, warp: bool) -> str:
    from jepsen_tpu_torch.checkers import reach_lane

    return "shared" if reach_lane.tables_shared(W, S, O1, warp) \
        else "device"


def phase_k1():
    """K1 against its plain version on the same CUDA tensors, bit for
    bit (the dead return included), at each geometry, in the warp form
    and the block form; times of the first."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checkers import reach_lane

    out = {"max_abs_err": 0.0}
    for label, kind, n_ops, procs, seed, B, corrupt, kw, cut in GEOMS:
        P, rs, M = history_operands(
            gen(kind, n_ops, procs, seed, corrupt, **kw),
            models.cas_register())
        n_ret = rs.n_returns if cut is None else cut
        R0 = np.zeros((P.shape[1], M), bool)
        R0[0, 0] = True
        args = reach_lane.operands_from_numpy(
            P, rs.ret_slot[:n_ret], rs.slot_ops[:n_ret], R0, B=B,
            device="cuda")
        W, S, O1 = rs.W, P.shape[1], P.shape[0]
        for n_pass in sorted({min(W, reach_lane._FAST_PASSES), W}):
            got = reach_lane.lane_walk(*args, B, n_pass)
            ref, p_ms = plain_ms(
                lambda: reach_lane.lane_walk_plain(*args, B, n_pass))
            err = same(f"lane_walk [{label}] n_pass={n_pass}", got, ref)
            ms = event_ms(lambda: reach_lane.lane_walk(*args, B, n_pass), 10)
            work, v, dead = walk_work(P, args[1].cpu().numpy()[:, None],
                                      args[2].cpu().numpy()[:, None],
                                      as_sets(args[3][None]), n_pass,
                                      lens=np.array([n_ret]))
            if not (np.array_equal(v, as_sets(got[1][None]))
                    and int(dead[0]) == int(got[2][0])):
                raise AssertionError(f"lane_walk differs from the host "
                                     f"replay at {label} n_pass={n_pass}")
            bound, bound_by, detail = bound_ms(nbytes(*args, *got), work)
            block = ""
            if W <= 5:
                # the block form on the same walk: the reason the warp
                # form exists
                same(f"lane_walk block form [{label}]",
                     reach_lane._lane_walk_cuda(*args, B, n_pass,
                                                warp=False), got)
                t = event_ms(lambda: reach_lane._lane_walk_cuda(
                    *args, B, n_pass, warp=False), 10)
                block = f" (block form {t:.6f} ms, bit-identical)"
            log(f"kernel lane_walk [{label}] W={W} S={S} O1={O1} "
                f"form={'warp' if W <= 5 else 'block'} "
                f"tables={tables_place(W, S, O1, True)} returns={n_ret} "
                f"R_pad={args[1].shape[0]} B={B} n_pass={n_pass}: "
                f"bit-identical max_abs_err={err} kernel_ms={ms:.6f} "
                f"us_per_return={1e3 * ms / n_ret:.6f}{block} "
                f"plain_ms={p_ms:.3f} bound_ms={bound:.6f} "
                f"({bound_by}; {detail}) dead={int(got[2][0])}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            if label == GEOMS[0][0]:
                out.update(ms=ms, plain_ms=p_ms, bound_ms=bound,
                           bound_by=bound_by)
        if W > reach_lane._FAST_PASSES:
            # the capped walk, the exact rescue and the death location,
            # on the card against the plain version on the CPU
            dead_gpu, _ = reach_lane.walk_returns(
                P, rs.ret_slot, rs.slot_ops, R0, B=B, device="cuda")
            dead_cpu, _ = reach_lane.walk_returns(
                P, rs.ret_slot, rs.slot_ops, R0, B=B, device="cpu")
            log(f"walk_returns [{label}]: dead cuda={dead_gpu} "
                f"cpu={dead_cpu}")
            if dead_gpu != dead_cpu or (corrupt and dead_gpu < 0):
                raise AssertionError("capped-ladder walk disagrees")
    return out


def lane_sets(R: torch.Tensor, lanes: int, groups: int) -> np.ndarray:
    """K2's ``[E·M, H·S]`` sets as ``[H·E, M, S]``, walk ``h·E + e``."""
    Mp, HS = R.shape
    M, S = Mp // groups, HS // lanes
    return R.cpu().numpy().reshape(groups, M, lanes, S) \
        .transpose(2, 0, 1, 3).reshape(lanes * groups, M, S)


def phase_k2(P, rs, M):
    """K2 against its plain version at chunk-lockstep's phase-A and
    phase-B operands of this history, bit for bit; times, bound and the
    host replay of each phase, and the sum over the two launches."""
    from jepsen_tpu_torch.checkers import reach_batch
    from jepsen_tpu_torch.checkers import reach_chunklock as rcl

    C, e_pad, per, A, Bp = rcl.phase_operands(
        P, rs.ret_slot, rs.slot_ops, M, device="cuda")
    W, S = rs.W, P.shape[1]
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes": 0,
           "work": 0}
    P_t, ops_a, rs_a, r0_a, b_a = A
    _, ops_b, rs_b, b_b = Bp
    final_a = None
    for phase, groups in (("A", 1), ("B", e_pad)):
        if phase == "A":
            args, B = (P_t, ops_a, rs_a, r0_a), b_a
        else:
            _seeds, r0_b, _cnt = rcl._glue_call(final_a, C, M, S, e_pad)
            args, B = (P_t, ops_b, rs_b, r0_b), b_b
        ck, fin = reach_batch.batch_walk(*args, B, W)
        ref, p_ms = plain_ms(
            lambda: reach_batch.batch_walk_plain(*args, B, W))
        label = f"batch_walk [cas-100k phase {phase}]"
        err = same(label, (ck, fin), ref)
        blk = reach_batch._batch_walk_cuda(*args, B, W, warp=False)
        same(label + " block form", blk, (ck, fin))
        ms = event_ms(lambda: reach_batch.batch_walk(*args, B, W), 10)
        block_ms = event_ms(lambda: reach_batch._batch_walk_cuda(
            *args, B, W, warp=False), 10)
        R_pad = args[2].shape[0]
        ret_rh = np.repeat(args[2].cpu().numpy(), groups, axis=1)
        ops_rhw = np.repeat(args[1].cpu().numpy().reshape(R_pad, C, W),
                            groups, axis=1)
        work, v, _ = walk_work(P, ret_rh, ops_rhw,
                               as_sets(lane_sets(args[3], C, groups)), W)
        if not np.array_equal(v, as_sets(lane_sets(fin, C, groups))):
            raise AssertionError(f"{label} differs from the host replay")
        moved = nbytes(*args, ck, fin)
        bound, bound_by, detail = bound_ms(moved, work)
        log(f"kernel {label} lanes={C} groups={groups} blocks="
            f"{C * groups} M'={args[3].shape[0]} W={W} S={S} "
            f"steps={R_pad} B={B}: bit-identical max_abs_err={err} "
            f"kernel_ms={ms:.6f} (block form {block_ms:.6f}) "
            f"plain_ms={p_ms:.3f} bound_ms={bound:.6f} ({bound_by}; "
            f"{detail})")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["ms"] += ms
        out["plain_ms"] += p_ms
        out["bytes"] += moved
        out["work"] += work
        final_a = fin
    out["bound_ms"], out["bound_by"], detail = bound_ms(out["bytes"],
                                                        out["work"])
    log(f"kernel batch_walk [cas-100k, both phases, C={C} e_pad={e_pad} "
        f"per={per}]: kernel_ms={out['ms']:.6f} plain_ms="
        f"{out['plain_ms']:.3f} bound_ms={out['bound_ms']:.6f} "
        f"({out['bound_by']}; {detail})")
    return out


def keyed_histories(n_keys=N_KEYS, n_ops=OPS_PER_KEY, bad=BAD_KEYS,
                    processes=KEY_PROCS, **kw):
    """The independent shape: one cas history per key (generator options
    ``kw``), values wrapped as ``[key, v]``, processes ``key·4 + p``
    (4 processes a key), corrupted keys ``bad``. Returns ``(history,
    per-key histories)``."""
    per_key, flat = [], []
    for k in range(n_keys):
        hk = gen("cas", n_ops, processes, k, k in bad, **kw)
        per_key.append(hk)
        flat += [op.with_(process=k * processes + op.process,
                          value=[k, op.value]) for op in hk]
    return [op.with_(index=i, time=i) for i, op in enumerate(flat)], per_key


def keyed_operands(per_key):
    """The operands ``check_many`` builds for these keys' histories:
    ``(P, ret, ops, W, tensors on the card)``."""
    from jepsen_tpu_torch import history, models
    from jepsen_tpu_torch.checkers import events as ev
    from jepsen_tpu_torch.checkers import reach

    model = models.cas_register()
    packed = [history.pack(h) for h in per_key]
    preps = [reach._prep(model, p, max_states=100_000, max_slots=20,
                         max_dense=1 << 22) for p in packed]
    W = max(max(p[1].W, 1) for p in preps)
    rss = [ev.returns_view(p[1]) for p in preps]
    P, ret, ops, key, _off = reach._keyed_operands(
        model, packed, rss, list(range(len(packed))), W, 100_000)
    t = [torch.as_tensor(np.ascontiguousarray(a, dt), device="cuda")
         for a, dt in ((P, np.float32), (ret, np.int32), (ops, np.int32),
                       (key, np.int32))]
    return P, ret, ops, W, t


def keyed_replay(P, ret, ops, lo, hi, W):
    """:func:`walk_work` over the keys' runs ``[lo, hi)`` in lockstep:
    ``(operations, each key's flat dead index or -1)``."""
    lo_np, n = lo.cpu().numpy(), (hi - lo).cpu().numpy()
    L = int(n.max())
    steps = np.arange(L)[:, None]
    valid = steps < n[None, :]
    pos = np.where(valid, lo_np[None, :] + steps, 0)
    ret_rh = np.where(valid, ret[pos], -1)
    ops_rhw = np.where(valid[..., None], ops[pos], -1)
    v0 = np.zeros((len(n), 1 << W, P.shape[1]), bool)
    v0[:, 0, 0] = True
    work, _v, dead_host = walk_work(P, ret_rh, ops_rhw, v0, W, lens=n)
    return work, np.where(dead_host >= 0, lo_np + dead_host, -1)


def dev_text(dev) -> str:
    """A :func:`device_ms` result as text: the launch's device time and
    each kernel's, with ``pack_tables``' share."""
    if dev is None:
        return "device_ms not measured (the profiler recorded no kernel)"
    k = dev["kernels"]
    parts = ", ".join(f"{name} {ms:.6f}" for name, ms in k.items())
    share = 100 * k.get("pack_tables", 0.0) / dev["total"]
    return (f"device_ms={dev['total']:.6f} ({parts}; pack_tables share "
            f"{share:.1f}%; {100 * dev['recorded']:.0f}% of the launches "
            f"recorded)")


def phase_k3(label, per_key, n: int = 20, k5: bool = False):
    """K3 on the operands ``check_many`` builds for these keys, in the
    warp form (W <= 5) and the block form, each bit for bit against its
    plain version, which the host replay confirms; per form the
    wrapper's time (:func:`event_ms`) and the device's own
    (:func:`device_ms`: ``pack_tables`` and the walk). With ``k5``, K5
    on the same keys too (whose block form takes any number of words a
    mask). Returns the first form's numbers, ``ms`` the device's time
    when it was measured."""
    from jepsen_tpu_torch.checkers import reach_lane, reach_pallas

    P, ret, ops, W, t = keyed_operands(per_key)
    K = len(per_key)
    lo, hi = reach_lane._key_runs(t[3], K)
    ref, p_ms = plain_ms(lambda: reach_lane.keyed_walk_plain(*t, K, W))
    work, want = keyed_replay(P, ret, ops, lo, hi, W)
    if not np.array_equal(want, ref.cpu().numpy()):
        raise AssertionError(f"keyed_walk_plain [{label}] differs from the "
                             f"host replay")
    bound, bound_by, detail = bound_ms(nbytes(*t, ref), work)
    S, O1 = P.shape[1], P.shape[0]
    head = (f"[{label}] returns={ret.shape[0]} W={W} S={S} O1={O1} "
            f"tables_shared={reach_lane.tables_shared(W, S, O1)}")
    runs = [(f"keyed_walk {'warp' if warp else 'block'} form",
             lambda warp=warp: reach_lane._keyed_launch(*t[:3], lo, hi, W,
                                                        warp))
            for warp in ((True, False) if W <= 5 else (False,))]
    if k5:
        runs.append((f"wide_keyed form={form(W, S)}",
                     lambda: reach_pallas._keyed_launch(*t[:3], lo, hi)))
    out = None
    for name, run in runs:
        err = same(f"{name} {head}", (run(),), (ref,))
        ms = event_ms(run, n)
        dev = device_ms(run, n)
        log(f"kernel {name} {head}: bit-identical max_abs_err={err} "
            f"wrapper event_ms={ms:.6f} {dev_text(dev)} plain_ms={p_ms:.3f}"
            f" bound_ms={bound:.6f} ({bound_by}; {detail}) dead keys="
            f"{int((ref >= 0).sum())}")
        if out is None:
            out = {"max_abs_err": err, "ms": dev["total"] if dev else ms,
                   "plain_ms": p_ms, "bound_ms": bound,
                   "bound_by": bound_by}
    return out


def phase_native(histories):
    """The C++ host prep against its plain Python scans on each ``(label,
    ops)``: the slot assignment and the returns view of the history's
    event stream, array for array, with the time of each."""
    from jepsen_tpu_torch import history, models
    from jepsen_tpu_torch.checkers import events as ev
    from jepsen_tpu_torch.checkers import preproc_native, reach

    for label, h in histories:
        packed = history.pack(h)
        memo = reach._cached_memo(models.cas_register(), packed, 100_000)
        t0 = time.perf_counter()
        st = ev.build(packed, memo, max_slots=20)
        build_s = time.perf_counter() - t0
        n = st.n_entries + st.n_dropped_crashed
        t0 = time.perf_counter()
        got = preproc_native.assign_slots(st.kind, st.entry, n, 20)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = ev.assign_slots_plain(st.kind, st.entry, 20)
        plain_s = time.perf_counter() - t0
        if not (np.array_equal(got[0], want[0]) and got[1] == want[1]
                == st.W):
            raise AssertionError(f"assign_slots [{label}] differs from its "
                                 f"plain version")
        t0 = time.perf_counter()
        rv = ev.returns_view(st)
        rv_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rv_plain = ev.returns_view_plain(st)
        rv_plain_s = time.perf_counter() - t0
        for f in ("ret_slot", "slot_ops", "ret_event", "ret_entry"):
            if not np.array_equal(getattr(rv, f), getattr(rv_plain, f)):
                raise AssertionError(f"returns_view [{label}] {f} differs "
                                     f"from its plain version")
        log(f"native prep [{label}] events={st.n_events} W={st.W} returns="
            f"{rv.n_returns}: equal to the plain scans; events.build "
            f"{build_s:.6f} s (assign_slots native {native_s:.6f} s, plain "
            f"{plain_s:.6f} s), returns_view native {rv_s:.6f} s, plain "
            f"{rv_plain_s:.6f} s")


def union_operands(per_key):
    """The union prep of these keys' histories, as ``check_many`` builds
    it: ``(packed, live, stage A, (P, W, M, ret, ops, key_W, key_R,
    offsets))``."""
    from jepsen_tpu_torch import history, models
    from jepsen_tpu_torch.checkers import reach

    packed = [history.pack(h) for h in per_key]
    live = list(range(len(packed)))
    sa = reach._union_stage_a(models.cas_register(), packed, live, 100_000)
    return packed, live, sa, reach._union_prep(sa, 20)


def phase_k2_lockstep(label, per_key):
    """K2 at the lockstep lane's group geometry (the first group
    ``plan_buckets`` makes of these keys, E = 1, the lane's block)
    against its plain version on the same CUDA tensors, bit for bit, with
    the host replay; the wrapper's time and the device's own."""
    from jepsen_tpu_torch.checkers import reach, reach_batch

    _packed, _live, _sa, u = union_operands(per_key)
    P, W, M, ret, ops, _kW, key_R, off = u
    g = reach_batch.plan_buckets(key_R, group=reach._BATCH_GROUP)[0]
    prep = reach_batch.prepare_returns_batch(
        P, reach._flat_lanes(ret, off, g), reach._flat_lanes(ops, off, g), M)
    B, W, M, S, H, O1, R_pad = prep.geom
    args = tuple(torch.as_tensor(a, device="cuda") for a in prep.host)
    n_pass = min(W, reach_batch._FAST_PASSES)
    got = reach_batch.batch_walk(*args, B, n_pass)
    ref, p_ms = plain_ms(lambda: reach_batch.batch_walk_plain(*args, B,
                                                              n_pass))
    err = same(f"batch_walk [lockstep group, {label}]", got, ref)
    ms = event_ms(lambda: reach_batch.batch_walk(*args, B, n_pass), 20)
    dev = device_ms(lambda: reach_batch.batch_walk(*args, B, n_pass), 20)
    work, v, _ = walk_work(P, args[2].cpu().numpy(),
                           args[1].cpu().numpy().reshape(R_pad, H, W),
                           as_sets(lane_sets(args[3], H, 1)), n_pass)
    if not np.array_equal(v, as_sets(lane_sets(got[1], H, 1))):
        raise AssertionError(f"batch_walk [lockstep group, {label}] differs "
                             f"from the host replay")
    bound, bound_by, detail = bound_ms(nbytes(*args, *got), work)
    log(f"kernel batch_walk [lockstep group, {label}] H={H} E=1 W={W} "
        f"S={S} O1={O1} B={B} R_pad={R_pad} returns="
        f"{sum(prep.R_lens)} (longest {max(prep.R_lens)}): bit-identical "
        f"max_abs_err={err} wrapper event_ms={ms:.6f} {dev_text(dev)} "
        f"plain_ms={p_ms:.3f} bound_ms={bound:.6f} ({bound_by}; {detail})")
    return {"ms": dev["total"] if dev else ms, "event_ms": ms}


def timed(fn):
    """``(fn(), seconds)``, the card synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def planned_groups(per_key) -> int:
    """The lockstep groups ``plan_buckets`` makes of these keys' union
    prep: the K2 launches their ``independent`` check needs."""
    from jepsen_tpu_torch.checkers import reach, reach_batch

    key_R = union_operands(per_key)[3][6]
    return len(reach_batch.plan_buckets(key_R, group=reach._BATCH_GROUP))


def phase_lanes(label, per_key, reps: int = 3):
    """Both union lanes after one shared union prep: the lockstep lane's
    walk (every group) and the native keyed lane's (one K3 launch), each
    timed ``reps`` times by the host clock around a synchronised run;
    the two dead vectors must agree key for key."""
    from jepsen_tpu_torch.checkers import reach, reach_batch, reach_lane

    _packed, live, sa, u = union_operands(per_key)
    P, W, M, ret, ops, _kW, key_R, off = u
    groups = reach_batch.plan_buckets(key_R, group=reach._BATCH_GROUP)
    key_flat = np.repeat(np.arange(len(live), dtype=np.int32), key_R)
    times = {"lockstep": [], "keyed": []}
    deads = {}
    for _ in range(reps):
        diag = {}
        deads["lockstep"], t = timed(
            lambda: reach._dispatch_lockstep_groups(
                P, ret, ops, off, groups, M, len(live), diag,
                device="cuda"))
        times["lockstep"].append(t)
        d, t = timed(lambda: reach_lane.walk_returns_keyed(
            P, ret, ops, key_flat, len(live), M, device="cuda"))
        deads["keyed"] = np.where(d >= 0, d - off[:-1], -1)
        times["keyed"].append(t)
    if not np.array_equal(deads["lockstep"], deads["keyed"]):
        raise AssertionError(f"lanes [{label}]: dead vectors differ")
    log(f"lanes [{label}] after one union prep (W={W} S={sa.S_pad} "
        f"groups={len(groups)} pack_efficiency={diag['pack_efficiency']}): "
        f"lockstep " + ", ".join(f"{t:.6f}" for t in times["lockstep"]) +
        " s; native keyed (K3) " + ", ".join(f"{t:.6f}" for t in
                                            times["keyed"]) +
        f" s; dead vectors identical "
        f"({int((deads['lockstep'] >= 0).sum())} dead)")
    return {k: min(v) for k, v in times.items()}


RESULT_KEYS = ("valid", "op", "dead-event", "final-configs", "previous-ok")


def check_batch_phase(label, packed, n_ops, **launches):
    """One ``reach.check_batch`` over ``packed`` on the card (every count
    zeroed first): each history's result must equal its own
    ``check_packed`` on the card, and each kernel launch as ``launches``
    says (``batch_walk="groups"``: one K2 launch a group). Logs wall
    time, aggregate ops/s, groups and pad efficiency."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checkers import reach

    model = models.cas_register()
    diag = {}
    res, dt, la, spans, ledger = drive(
        lambda: reach.check_batch(model, packed, diag=diag))
    fallbacks = [r for r in ledger if r["event"] == "fallback"]
    if fallbacks:
        raise AssertionError(f"{label}: fallbacks {fallbacks}")
    if launches.get("batch_walk") == "groups":
        launches["batch_walk"] = len(diag["groups"])
    expect(label, la, **launches)
    t0 = time.perf_counter()
    for i, p in enumerate(packed):
        want = reach.check_packed(model, p)
        for key in RESULT_KEYS:
            if res[i].get(key) != want.get(key):
                raise AssertionError(f"{label} history {i}: {key} differs "
                                     f"batch={res[i].get(key)} "
                                     f"check_packed={want.get(key)}")
    one_s = time.perf_counter() - t0
    groups = [(g["H"], g["W"], g["B"], g["R_pad"]) for g in diag["groups"]]
    log(f"check_batch [{label}]: {dt:.4f} s = {n_ops / dt:.1f} ops/s "
        f"({len(packed)} histories, {n_ops} ops), valid "
        f"{sum(r['valid'] is True for r in res)}, groups (H, W, B, R_pad) "
        f"{groups}, pack_efficiency {diag['pack_efficiency']}, prep "
        f"{diag['prep_s']} s, dispatch {diag['dispatch_s']} s, fetch "
        f"{diag['fetch_s']} s; "
        f"{split(dt, spans)}; launches {la}; each history equals its "
        f"check_packed on the card ({one_s:.3f} s for all)")
    return la


# the wide shapes: a cas register over 40 values (41 states, S_pad 64)
# and a multi-register of 3 keys over 3 values (64 states)
WIDE_CAS = dict(values=40)
WIDE_MULTI = dict(values=3, keys=3)
WIDE_RETURNS = 20_000          # K4 against its plain version on this
                               # prefix
TORCH_RETURNS = 5_000          # and the torch returns walk on this one


def form(W: int, S: int) -> str:
    """The form a K4 or K5 launch of this geometry takes."""
    from jepsen_tpu_torch.checkers import reach_pallas

    return "warp" if reach_pallas.warp_form(W, S) else "block"


def phase_tables(alphabets):
    """``pack_tables`` (alone, through ``reach_pallas.image_tables``):
    the first kernel of every table walk (K1-K5), against its plain
    version on the same CUDA tensors, bit for bit, on each ``(label,
    P)``; its wrapper's and its device time, and where a W = 5 walk
    keeps the tables (K1, K2 and K3 up to 32 states, else K4 and K5)."""
    from jepsen_tpu_torch.checkers import reach_lane, reach_pallas

    for label, P in alphabets:
        Pt = torch.as_tensor(P, device="cuda")
        got = reach_pallas.image_tables(Pt)
        want, p_ms = plain_ms(lambda: reach_pallas.image_tables_plain(Pt))
        same(f"pack_tables [{label}]", (got,), (want,))
        ms = event_ms(lambda: reach_pallas.image_tables(Pt), 10)
        dev = device_ms(lambda: reach_pallas.image_tables(Pt), 10)
        O1, S = P.shape[0], P.shape[1]
        shared = reach_lane.tables_shared(5, S, O1) if S <= 32 else \
            reach_pallas.p_shared(5, S, O1)
        log(f"kernel pack_tables [{label}] O1={O1} S={S} "
            f"tables={tuple(got.shape)} {reach_pallas.table_bytes(S, O1)} "
            f"bytes, shared at W=5: {shared}: "
            f"bit-identical wrapper event_ms={ms:.6f} device_ms="
            f"{dev['total'] if dev else 'not measured'} "
            f"plain_ms={p_ms:.3f}")


def one_thread(fn):
    """``fn()`` with one CPU thread: the plain walk's products are a few
    kilobytes, where more threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


def one_hot(P, M):
    R0 = np.zeros((P.shape[1], M), bool)
    R0[0, 0] = True
    return R0


def phase_k4(P_wide, rs_wide, P_m, rs_m, multi100):
    """K4 against its plain version on the same CUDA tensors, bit for
    bit, with the host replay of each walk: the wide cas-100k's alphabet
    (735 ops, the tables in device memory) over its first
    :data:`WIDE_RETURNS` returns, multi-register-20k (the tables in
    shared memory; both in the warp form), a narrow walk (one word a
    mask) and a wide one at W = 7 (both in the block form); then K4
    against K1 on cas-30k, and the torch returns walk the wide route
    took before K4, on the first shape's first :data:`TORCH_RETURNS`
    returns; then the whole wide cas-100k and
    multi-register-100k streams, the main path's launches. Times, bound
    and plain time of the first shape."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checkers import reach, reach_lane, reach_pallas

    P_n, rs_n, _ = history_operands(gen("cas", 4_000, 7, 1),
                                    models.cas_register())
    P_7, rs_7, _ = history_operands(gen("multi", 5_000, 7, 0, **WIDE_MULTI),
                                    models.multi_register())
    n = WIDE_RETURNS
    runs = [("cas-40 alphabet, 20,000 returns", P_wide,
             rs_wide.ret_slot[:n], rs_wide.slot_ops[:n]),
            ("multi-register-20k", P_m, rs_m.ret_slot, rs_m.slot_ops),
            ("narrow W=7", P_n, rs_n.ret_slot, rs_n.slot_ops),
            ("wide multi-register W=7", P_7, rs_7.ret_slot, rs_7.slot_ops)]
    out = {"max_abs_err": 0.0}
    for label, P, ret, ops in runs:
        W, S, O1 = ops.shape[1], P.shape[1], P.shape[0]
        args = reach_pallas.operands_from_numpy(P, ret, ops,
                                                one_hot(P, 1 << W),
                                                device="cuda")
        rlim = len(ret)
        got = reach_pallas.walk(*args, rlim)
        ref, p_ms = plain_ms(lambda: reach_pallas.walk_plain(*args, rlim))
        err = same(f"wide_walk [{label}]", got, ref)
        ms = event_ms(lambda: reach_pallas.walk(*args, rlim), 5)
        work, v, dead = walk_work(P, ret[:, None], ops[:, None],
                                  as_sets(args[3][None]), W,
                                  lens=np.array([rlim]))
        if not (np.array_equal(v, as_sets(got[1][None]))
                and int(dead[0]) == int(got[0][0])):
            raise AssertionError(f"wide_walk differs from the host replay "
                                 f"at {label}")
        bound, bound_by, detail = bound_ms(nbytes(*args, *got), work)
        log(f"kernel wide_walk [{label}] W={W} S={S} O1={O1} "
            f"form={form(W, S)} "
            f"tables_shared={reach_pallas.p_shared(W, S, O1)} "
            f"returns={rlim}: bit-identical max_abs_err={err} "
            f"kernel_ms={ms:.6f} us_per_return={1e3 * ms / rlim:.6f} "
            f"plain_ms={p_ms:.3f} bound_ms={bound:.6f} ({bound_by}; "
            f"{detail}) dead={int(got[0][0])}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if "ms" not in out:
            out.update(ms=ms, plain_ms=p_ms, bound_ms=bound,
                       bound_by=bound_by)
    # the route before K4 on the first shape's first TORCH_RETURNS
    # returns: the torch returns walk
    _label, P, ret, ops = runs[0]
    ret, ops = ret[:TORCH_RETURNS], ops[:TORCH_RETURNS]
    W = ops.shape[1]
    args = reach_pallas.operands_from_numpy(P, ret, ops, one_hot(P, 1 << W),
                                            device="cuda")
    fin = reach_pallas.walk(*args, len(ret))[1]
    k4_ms = event_ms(lambda: reach_pallas.walk(*args, len(ret)), 5)
    xc, bm = reach._xor_bitmask(W, 1 << W)
    torch_args = [torch.as_tensor(a, device="cuda") for a in
                  (P, xc, bm, ops, one_hot(P, 1 << W))]
    (_ptr, R_t, alive, _), t_ms = plain_ms(lambda: reach._walk_returns(
        *torch_args[:3], ret, *torch_args[3:]))
    if not (alive and np.array_equal(R_t.cpu().numpy().T, as_sets(fin))):
        raise AssertionError("the torch returns walk disagrees with K4")
    log(f"torch returns walk [cas-40 alphabet, {len(ret)} returns] on the "
        f"card: {t_ms:.3f} ms ({1e3 * t_ms / len(ret):.3f} us a return), "
        f"K4 {k4_ms:.6f} ms: {t_ms / k4_ms:.1f}x; same final set")
    # the whole wide cas-100k and multi-register-100k streams, the main
    # path's launches
    P_h, rs_h, _ = history_operands(multi100, models.multi_register())
    for label, P, rs in (("wide cas-100k", P_wide, rs_wide),
                         ("multi-register-100k", P_h, rs_h)):
        args = reach_pallas.operands_from_numpy(
            P, rs.ret_slot, rs.slot_ops, one_hot(P, 1 << rs.W),
            device="cuda")
        full_ms = event_ms(lambda: reach_pallas.walk(*args, rs.n_returns), 3)
        log(f"kernel wide_walk [{label}, {rs.n_returns} returns] "
            f"form={form(rs.W, P.shape[1])}: kernel_ms={full_ms:.6f} "
            f"us_per_return={1e3 * full_ms / rs.n_returns:.6f}")
    # one word a mask: K4 against K1 on cas-30k
    P, rs, M = history_operands(gen("cas", 30_000, 5, 0),
                                models.cas_register())
    R0 = one_hot(P, M)
    lane_args = reach_lane.operands_from_numpy(P, rs.ret_slot, rs.slot_ops,
                                               R0, device="cuda")
    wide_args = reach_pallas.operands_from_numpy(P, rs.ret_slot,
                                                 rs.slot_ops, R0,
                                                 device="cuda")
    _ck, fin1, dead1 = reach_lane.lane_walk(*lane_args, 1024, rs.W)
    dead4, fin4 = reach_pallas.walk(*wide_args, rs.n_returns)
    if not (torch.equal(fin1, fin4) and int(dead4[0]) == int(dead1[0])
            == -1):
        raise AssertionError("K4 and K1 disagree on cas-30k")
    k1_ms = event_ms(lambda: reach_lane.lane_walk(*lane_args, 1024, rs.W), 5)
    k4_ms = event_ms(lambda: reach_pallas.walk(*wide_args, rs.n_returns), 5)
    log(f"kernel wide_walk [cas-30k, S={P.shape[1]} W={rs.W}] against K1: "
        f"same final set; K4 {k4_ms:.6f} ms (form="
        f"{form(rs.W, P.shape[1])}), K1 {k1_ms:.6f} ms")
    return out


# small histories that reach the warp form's other instances (entries
# of 1, 4 and 8 words; 1, 4 and 8 nibbles at one word): (label, kind,
# generator options); each K4 launch against its plain version
INSTANCES = [("cas S=4", "cas", dict(values=3)),
             ("cas S=16", "cas", dict(values=12)),
             ("cas S=32", "cas", dict(values=25)),
             ("multi S=128", "multi", dict(keys=3, values=4)),
             ("multi S=256", "multi", dict(keys=4, values=3))]


def phase_k4_instances():
    """K4 against its plain version, bit for bit, at :data:`INSTANCES`
    (1,000 ops, 4 processes each)."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checkers import reach_pallas

    for label, kind, kw in INSTANCES:
        model = models.cas_register() if kind == "cas" else \
            models.multi_register()
        P, rs, _ = history_operands(gen(kind, 1_000, 4, 0, **kw), model)
        W, S, O1 = rs.W, P.shape[1], P.shape[0]
        args = reach_pallas.operands_from_numpy(
            P, rs.ret_slot, rs.slot_ops, one_hot(P, 1 << W), device="cuda")
        got = reach_pallas.walk(*args, rs.n_returns)
        same(f"wide_walk [{label}]", got,
             reach_pallas.walk_plain(*args, rs.n_returns))
        log(f"kernel wide_walk [{label}] W={W} S={S} O1={O1} form="
            f"{form(W, S)} entry words={reach_pallas.table_words(S)} "
            f"nibbles={reach_pallas.n_nibbles(S)} tables_shared="
            f"{reach_pallas.p_shared(W, S, O1)} returns={rs.n_returns}: "
            f"bit-identical dead={int(got[0][0])}")


def phase_k5(per_key):
    """K5 against its plain version at the wide independent shape (the
    operands ``check_many`` builds), bit for bit; wrapper and device
    time, bound and host replay. (``phase_k3`` holds it at the narrow
    shapes, beside K3.)"""
    from jepsen_tpu_torch.checkers import reach_lane, reach_pallas

    P, ret, ops, W, t = keyed_operands(per_key)
    K = len(per_key)
    lo, hi = reach_lane._key_runs(t[3], K)
    dead = reach_pallas._keyed_launch(*t[:3], lo, hi)
    ref, p_ms = plain_ms(lambda: reach_pallas.keyed_walk_plain(*t, K))
    err = same("wide_keyed [wide independent]", (dead,), (ref,))
    ms = event_ms(lambda: reach_pallas._keyed_launch(*t[:3], lo, hi), 20)
    dev = device_ms(lambda: reach_pallas._keyed_launch(*t[:3], lo, hi), 20)
    work, want = keyed_replay(P, ret, ops, lo, hi, W)
    if not np.array_equal(want, dead.cpu().numpy()):
        raise AssertionError("wide_keyed differs from the host replay")
    bound, bound_by, detail = bound_ms(nbytes(*t, dead), work)
    S, O1 = P.shape[1], P.shape[0]
    log(f"kernel wide_keyed [wide independent {K} keys x {OPS_PER_KEY} "
        f"ops] returns={ret.shape[0]} W={W} S={S} O1={O1} form={form(W, S)} "
        f"tables_shared={reach_pallas.p_shared(W, S, O1)}: bit-identical "
        f"max_abs_err={err} wrapper event_ms={ms:.6f} {dev_text(dev)} "
        f"plain_ms={p_ms:.3f} bound_ms={bound:.6f} ({bound_by}; {detail}) "
        f"dead keys={int((dead >= 0).sum())}")
    return {"max_abs_err": err, "ms": dev["total"] if dev else ms,
            "plain_ms": p_ms, "bound_ms": bound, "bound_by": bound_by}


# the ablation harness's stream: its default history (cas, 100,000 ops,
# 5 processes, seed 42); each variant is held against its plain version
# on the first block of ABLATE_BLOCK returns. The block form's shape: a
# cas history of 6 processes (W = 6), its first ABLATE_W6_RETURNS
# returns
ABLATE_OPS = 100_000
ABLATE_BLOCK = 1024
ABLATE_W6_OPS, ABLATE_W6_RETURNS = 1_000, 256
# beyond the ladder's variants, the kernel instances that no variant
# takes alone: the reversed bool body and the f32 table projection
ABLATE_EXTRA = ("rev", "cnt-tree-matmulproj")
# at W = 6, one case per kernel instance of the block form, and K7's
ABLATE_W6_CASES = ("v2-bool-blend", "alt-p3", "rev", "bool-matmulproj",
                   "cgate-ladder-u2", "cnt-tree-blend", "maxnc-blend",
                   "cnt-tree-matmulproj", "bool-stream", "bool-stream-i8",
                   "maxnc-stream")


def ablate_case(name: str, W: int):
    """``(fire, proj, counts, unroll, n_pass, cgate)`` of a harness
    variant, or of one of :data:`ABLATE_EXTRA`."""
    from jepsen_tpu_torch.tools import ablate_lane as ab

    if name == "rev":
        return ab._fire_bool_rev, "blend", False, 1, min(W, 5), ()
    if name == "cnt-tree-matmulproj":
        return ab._fire_counts_tree, "matmul", True, 1, min(W, 5), ()
    return ab.spec(name, W)


def phase_ablate(label, geom, opnds, n: int, names, stream: bool,
                 reps: int = 5):
    """K6 (``stream=False``: the cases that gather the fire operand in
    the kernel) or K7 (the streamed ones) against their plain versions
    on the first ``n`` returns of the operands, bit for bit, with the
    host replay of each walk; each launch's form and table place (or
    ring) from the layout rule; time, plain time and bound of each case,
    and the device's own time of the first. Returns the numbers of the
    first case, and the largest error."""
    from jepsen_tpu_torch.tools import ablate_lane as ab

    B, W, M, S, O1, _R_pad = geom
    ret, ops, P, PJ, R0 = opnds
    ret, ops = ret[:n], ops[:n]
    P_np, ret_np, ops_np = P.cpu().numpy(), ret.cpu().numpy(), \
        ops.cpu().numpy()
    replays = {}
    out = {"max_abs_err": 0.0}
    kernel = "ablate_stream" if stream else "ablate_walk"
    for name in names:
        fire, proj, counts, unroll, n_pass, cgate = ablate_case(name, W)
        if (proj in ab._STREAM_DTYPE) != stream:
            continue
        if stream:
            dt = ab._STREAM_DTYPE[proj]
            G = ab.stream_operand(P, ops, dt)
            args = (ret, G, R0, B, n_pass, fire, counts)
            kern, plain = ab.ablate_stream, ab.ablate_stream_plain
            moved = nbytes(ret, G, R0)
            code = ab.design(W, S, O1, counts, stream=True,
                             g_int8=dt == torch.int8)
        else:
            args = (P, ret, ops, PJ, R0, B, n_pass, fire, proj, counts,
                    unroll, cgate)
            kern, plain = ab.ablate_walk, ab.ablate_walk_plain
            moved = nbytes(ret, ops, P, R0, *((PJ,) if proj == "matmul"
                                             else ()))
            code = ab.design(W, S, O1, counts, proj == "matmul")
        got = kern(*args)
        ref, p_ms = plain_ms(lambda: plain(*args))
        tag = f"{kernel} [{name}, first {n} returns of {label}]"
        err = same(tag, got, ref)
        ms = event_ms(lambda: kern(*args), reps)
        total = n_pass + sum(cgate)
        if total not in replays:
            replays[total] = walk_work(P_np, ret_np[:, None],
                                       ops_np[:, None], as_sets(R0[None]),
                                       total)
        work, v, _ = replays[total]
        if not np.array_equal(v, as_sets(got[1][None])):
            raise AssertionError(f"{tag} differs from the host replay")
        bound, bound_by, detail = bound_ms(moved + nbytes(*got), work)
        dev = ""
        if "ms" not in out:
            d = device_ms(lambda: kern(*args), reps)
            dev = f" {dev_text(d)}"
            out.update(variant=name, ms=ms, plain_ms=p_ms, bound_ms=bound,
                       bound_by=bound_by,
                       device_ms=d["total"] if d else None)
        log(f"kernel {tag}: W={W} S={S} O1={O1} passes<={total} "
            f"design={ab.describe(code, counts)} bit-identical max_abs_err={err} "
            f"kernel_ms={ms:.6f} us_per_return={1e3 * ms / n:.6f}{dev} "
            f"plain_ms={p_ms:.3f} bound_ms={bound:.6f} ({bound_by}; "
            f"{detail}) alive={bool(got[1].any())}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def ablate_ladder(geom, opnds, n_ret: int):
    """The harness's full ladder on its cas-100k stream through its own
    function (``ablate_lane.ladder``, two interleaved rounds), with every
    kernel count set to 0 just before and read just after: every exact
    variant must end on K1's final set, and each K6 launch of a bool
    variant starts with one ``pack_tables`` launch (counted apart).
    Returns the launches by kernel."""
    from jepsen_tpu_torch.checkers import reach_lane
    from jepsen_tpu_torch.tools import ablate_lane as ab

    B, W, M, S, O1, R_pad = geom
    ret, ops, P, PJ, R0 = opnds
    want = reach_lane.lane_walk(P, ret, ops, R0, B, W)[1] > 0
    for dt in (torch.float32, torch.int8):
        g = ab.stream_operand(P, ops, dt)
        log(f"ablate_stream operand G at cas-100k: {tuple(g.shape)} {dt}, "
            f"{nbytes(g)} bytes on the card")
        del g
    zero_launches()
    t0 = time.perf_counter()
    res = ab.ladder(list(ab.VARIANTS), geom, opnds, repeat=2, log=log)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    la = launches()
    n_stream = sum(ab.VARIANTS[v][1] in ab._STREAM_DTYPE
                   for v in ab.VARIANTS)
    n_bool = sum(not s[2] and s[1] not in ab._STREAM_DTYPE
                 for s in ab.VARIANTS.values())
    expect("ablate ladder", la, ablate_walk=2 * (len(ab.VARIANTS) - n_stream),
           ablate_stream=2 * n_stream, ablate_tables=2 * n_bool,
           lane_walk=0, batch_walk=0)
    for name, (ms, final) in res.items():
        fin = final > 0
        match = torch.equal(fin, want)
        if ab.exact(name, W) and not match:
            raise AssertionError(f"ablate ladder: exact variant {name} "
                                 f"differs from K1's final set")
        proj = ab.spec(name, W)[1]
        # the kernel's operands, each read once, and ckpt and final
        moved = nbytes(ret, R0, final) + 4 * (R_pad // B) * M * S + (
            R_pad * S * W * S * (1 if proj == "stream-i8" else 4)
            if proj in ab._STREAM_DTYPE else nbytes(ops, P)
            + (nbytes(PJ) if proj == "matmul" else 0))
        log(f"ablate ladder {name:22s} {ms:10.3f} ms "
            f"{1e6 * ms / n_ret:9.1f} ns/ret match={match} "
            f"alive={bool(fin.any())} "
            f"{'exact' if ab.exact(name, W) else 'capped'} "
            f"passes<={ab.passes(name, W)} bytes_bound_ms="
            f"{1e3 * moved / HBM_RATE:.6f}")
    log(f"ablate ladder at cas-100k (B={B} W={W} M={M} S={S} O1={O1} "
        f"R_pad={R_pad} returns={n_ret}): {len(res)} variants x 2 rounds "
        f"in {dt:.3f} s; launches {la}")
    return la


def launches():
    """The kernels' launch counts, by kernel."""
    from jepsen_tpu_torch.checkers import reach_batch, reach_lane
    from jepsen_tpu_torch.checkers import reach_pallas
    from jepsen_tpu_torch.tools import ablate_lane
    from jepsen_tpu_torch.txn import cycles

    return {"lane_walk": reach_lane.KERNEL_LAUNCHES,
            "batch_walk": reach_batch.KERNEL_LAUNCHES,
            "keyed_walk": reach_lane.KEYED_LAUNCHES,
            "wide_walk": reach_pallas.KERNEL_LAUNCHES,
            "wide_keyed": reach_pallas.KEYED_LAUNCHES,
            "ablate_walk": ablate_lane.ABLATE_LAUNCHES,
            "ablate_tables": ablate_lane.ABLATE_TABLE_LAUNCHES,
            "ablate_stream": ablate_lane.STREAM_LAUNCHES,
            "txn_closure": cycles.KERNEL_LAUNCHES}


def zero_launches():
    from jepsen_tpu_torch.checkers import reach_batch, reach_lane
    from jepsen_tpu_torch.checkers import reach_pallas
    from jepsen_tpu_torch.tools import ablate_lane
    from jepsen_tpu_torch.txn import cycles

    reach_lane.KERNEL_LAUNCHES = reach_lane.KEYED_LAUNCHES = 0
    reach_batch.KERNEL_LAUNCHES = 0
    reach_pallas.KERNEL_LAUNCHES = reach_pallas.KEYED_LAUNCHES = 0
    ablate_lane.ABLATE_LAUNCHES = ablate_lane.STREAM_LAUNCHES = 0
    ablate_lane.ABLATE_TABLE_LAUNCHES = 0
    cycles.KERNEL_LAUNCHES = 0


# each kernel's launches summed over every drive of the main path
MAIN_PATH_LAUNCHES = {}


def drive(fn):
    """Run one check of the main path with every kernel count set to 0
    just before and read just after (and added to
    :data:`MAIN_PATH_LAUNCHES`). Returns the result, its wall seconds,
    the launches by kernel, the span seconds by name (summed) and the
    decision ledger."""
    from jepsen_tpu_torch import obs

    zero_launches()
    with obs.capture() as cap:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = launches()
    for name, n in counts.items():
        MAIN_PATH_LAUNCHES[name] = MAIN_PATH_LAUNCHES.get(name, 0) + n
    spans = {}
    for s in cap.spans:
        spans[s["name"]] = spans.get(s["name"], 0.0) + s["dur"] / 1e6
    return res, dt, counts, spans, cap.ledger


def expect(label, counts, **want):
    """Each named kernel launched exactly as often as the route needs;
    ``None`` asks for at least one launch."""
    for name, n in want.items():
        got = counts[name]
        if (n is None and got < 1) or (n is not None and got != n):
            raise AssertionError(f"{label}: {name} launched {got} times, "
                                 f"want {'>= 1' if n is None else n}")


SPLIT = [("split", "independent.split"), ("pack", "facade.pack"),
         ("prep", "reach.prep"),
         ("returns-view", "reach.returns-view"),
         ("keyed-operands", "reach.keyed-operands"),
         ("walk", "reach.walk"), ("witness", "reach.witness")]


def split(dt: float, spans) -> str:
    """Where a check's seconds went, by the spans the port records:
    splitting by key, packing, memo and event-stream prep, the returns
    view, the keyed operands, the walk on the card, the witness
    re-walks, and the rest."""
    out, rest = [], dt
    for label, name in SPLIT:
        t = spans.get(name, 0.0)
        if t or label in ("pack", "prep", "walk"):
            rest -= t
            out.append(f"{label} {t:.4f} s ({100 * t / dt:.1f}%)")
    out.append(f"other {rest:.4f} s ({100 * rest / dt:.1f}%)")
    return ", ".join(out)


def check_keyed(label, h, n_keys, bad, cause, **launches):
    """One ``independent`` check of the main path on ``[key, v]``
    history ``h``, on the card with every count zeroed first, then on
    the CPU: the route's cause must be ``cause``, each kernel launched
    as ``launches`` says, the failed keys ``bad``, and every key's
    result equal on both. Returns the launches by kernel."""
    from jepsen_tpu_torch import Linearizable, independent, models

    def check(device=None):
        return independent.checker(Linearizable(
            models.cas_register(), device=device)).check(None, h)

    res, dt, la, spans, ledger = drive(check)
    routes = [r.get("cause") for r in ledger
              if r["stage"] == "reach-many" and r["event"] == "route"]
    if routes != [cause]:
        raise AssertionError(f"{label}: routes {routes}")
    expect(label, la, **launches)
    t0 = time.perf_counter()
    ref = check("cpu")
    cpu_s = time.perf_counter() - t0
    if sorted(res["failures"]) != sorted(bad) or res["valid"] is not \
            (not bad) or res["key-count"] != n_keys:
        raise AssertionError(f"{label}: failures {res['failures']}")
    for key in ("valid", "failures", "key-count"):
        if res[key] != ref[key]:
            raise AssertionError(f"{label}: {key} differs")
    for k, r in res["results"].items():
        for key in ("valid", "engine", "op", "dead-event", "final-configs",
                    "previous-ok"):
            if r.get(key) != ref["results"][k].get(key):
                raise AssertionError(f"{label} key {k}: {key} differs "
                                     f"cuda={r.get(key)} "
                                     f"cpu={ref['results'][k].get(key)}")
    log(f"main path {label} ({len(bad)} corrupted): route {cause}, "
        f"valid={res['valid']} failures={len(res['failures'])} {dt:.4f} s = "
        f"{len(h) // 2 / dt:.1f} ops/s; {split(dt, spans)}; launches {la}; "
        f"{cpu_s:.3f} s on cpu, every key agrees")
    return la


def linearizable(h, device=None):
    from jepsen_tpu_torch import Linearizable, models

    return Linearizable(models.cas_register(), device=device).check(None, h)


# -- the auto chain past the dense engine ------------------------------------

# where the chain phases run their checks (the CPU runs are their
# reference)
CARD = "cuda"
CHAIN_KEYS = ("valid", "engine", "op", "dead-event", "max-linearized",
              "previous-ok", "final-configs", "quotient", "product-space",
              "frontier-cap", "key-count", "failures", "key")


def chain_drive(fn):
    """:func:`drive` with the walks' counters: ``(res, dt, launches,
    spans, ledger, counters)``."""
    from jepsen_tpu_torch import obs

    with obs.capture() as cap:
        res, dt, la, spans, ledger = drive(fn)
    return res, dt, la, spans, ledger, cap.counters


def walk_line(dt, spans, counters) -> str:
    """Returns walked, host reads a return and milliseconds a return of
    the frontier's and the quotient's walks in one check."""
    out = [f"wall {dt:.4f} s"]
    for mod in ("reach_q", "frontier"):
        n = counters.get(f"{mod}.returns", 0)
        if not n:
            continue
        walk = spans.get(f"{mod}.walk", 0.0)
        out.append(f"{mod}: returns {n}, syncs/return "
                   f"{counters.get(f'{mod}.syncs', 0) / n:.3f}, walk "
                   f"{walk:.4f} s = {1e3 * walk / n:.4f} ms/return")
    return "; ".join(out)


def expect_any(label, counts, *names):
    """At least one launch of one of the named kernels."""
    if sum(counts[n] for n in names) < 1:
        raise AssertionError(f"{label}: none of {names} launched: {counts}")


def same_result(label, got, want, keys=CHAIN_KEYS):
    for key in keys:
        if got.get(key) != want.get(key):
            raise AssertionError(f"{label}: {key} differs cuda="
                                 f"{got.get(key)} cpu={want.get(key)}")


def chain_check(label, fn, expect_valid, expect_engine, **launches):
    """One check of the chain on the card (``fn(device)``), held against
    the same check on the CPU and against the expected verdict and
    engine; each named kernel launched as ``launches`` says. Returns
    the card's result and its launches by kernel."""
    res, dt, la, spans, ledger, counters = chain_drive(lambda: fn(CARD))
    expect(label, la, **launches)
    t0 = time.perf_counter()
    ref = fn("cpu")
    cpu_s = time.perf_counter() - t0
    same_result(label, res, ref)
    if res["valid"] is not expect_valid or res.get("engine") != \
            expect_engine:
        raise AssertionError(f"{label}: {res.get('valid')} by "
                             f"{res.get('engine')}")
    if expect_valid is False and not (res.get("op") and (
            res.get("final-configs") or res.get("key-result"))):
        raise AssertionError(f"{label}: no failing op or witness")
    sel = [r["stage"] for r in ledger if r["event"] == "selected"]
    log(f"chain {label}: {res.get('engine')} valid={res['valid']} "
        f"dead-event={res.get('dead-event')} frontier-cap="
        f"{res.get('frontier-cap')} product-space="
        f"{res.get('product-space')} selected {sel}; "
        f"{walk_line(dt, spans, counters)}; launches "
        f"{ {k: v for k, v in la.items() if v} }; {cpu_s:.3f} s on cpu, "
        f"agrees")
    return res, la


def burst(ops, peak=13, corrupt=False, seed=2):
    """A burst of ``peak`` concurrent distinct-value writes (the
    reference's sparse-live test shape)."""
    import random

    invoke, ok, _info = ops
    rng = random.Random(seed)
    h = [invoke(600 + g, "write", 40 + g) for g in range(3)]
    for i in range(40):
        v = rng.randrange(3)
        h += [invoke(i % 3, "write", v), ok(i % 3, "write", v)]
    h += [invoke(1000 + p, "write", 10 + p) for p in range(peak)]
    h += [ok(1000 + p, "write", 10 + p) for p in range(peak)]
    return h + [invoke(0, "read"),
                ok(0, "read", 7777 if corrupt else 10 + peak - 1)]


def same_op_burst(ops, peak=26, rounds=3, crash_k=6, seed=9):
    """``peak`` concurrent same-value live writes a round, ``crash_k``
    crashed writes on top (the live epochs' test shape)."""
    import random

    invoke, ok, info = ops
    rng = random.Random(seed)
    h = []
    for k in range(crash_k):
        h += [invoke(2000 + k, "write", 7), info(2000 + k, "write", 7)]
    for r in range(rounds):
        procs = [3000 + 100 * r + p for p in range(peak)]
        h += [invoke(p, "write", 5) for p in procs]
        rng.shuffle(procs)
        h += [ok(p, "write", 5) for p in procs]
        h += [invoke(0, "read"), ok(0, "read", 5)]
    return h + [invoke(1, "read"), ok(1, "read", 5)]


def tx_history(ops, n=120, values=30):
    """Two-key transactional reads and single-key writes (the restricted
    product's test shape); valid."""
    import random

    invoke, ok, _info = ops
    rng = random.Random(3)
    h, state = [], {"x": 0, "y": 0}
    for i in range(n):
        p = i % 3
        if rng.random() < 0.7:
            k = rng.choice(["x", "y"])
            v = rng.randrange(values)
            h += [invoke(p, "write", {k: v}), ok(p, "write", {k: v})]
            state[k] = v
        else:
            vals = dict(state)
            h += [invoke(p, "read", {k: None for k in vals}),
                  ok(p, "read", vals)]
    return h


def quotient_check(h, device, **kw):
    """``reach_q.check_quotient`` on a register(0) history."""
    from jepsen_tpu_torch import history, models
    from jepsen_tpu_torch.checkers import events as ev
    from jepsen_tpu_torch.checkers import reach_q
    from jepsen_tpu_torch.models.memo import memo_ops

    packed = history.pack(history.index(h))
    memo = memo_ops(models.register(0), tuple(packed.distinct_ops),
                    max_states=100_000)
    stream = ev.build(packed, memo, max_slots=128)
    return reach_q.check_quotient(memo, stream, packed, device=device, **kw)


def phase_chain():
    """The ``auto`` chain past the dense engine on the card: the C++ WGL
    search, the frontier (the dense-product quotient, the sparse-live
    quotient and the sparse rows), the per-key decomposition on the
    keyed lanes and the restricted product, each against the port's CPU
    run and the expected verdict; then a probe of the frontier alone on
    a history nothing has decided, bounded by its own time limit."""
    from jepsen_tpu_torch import Linearizable, fixtures, history, models, op
    from jepsen_tpu_torch.checkers import frontier

    t_phase = time.perf_counter()
    ops = (op.invoke, op.ok, op.info)

    def lin(model, h, **opts):
        return lambda dev: Linearizable(model, device=dev,
                                        opts=opts).check(None, h)

    # W = 75, 129 crashed ops: the dense engine declines, C++ WGL decides
    w75 = gen("register", 5000, 10, 3, crash_p=0.01, values=2)
    chain_check("W=75 register-5000 (crashed ops)",
                lin(models.register(), w75), True, "wgl-native-fallback",
                batch_walk=0, lane_walk=0)
    # W = 33 under a tight config budget: the frontier's dense-product
    # quotient decides, valid, then corrupted (dead event 562)
    w33 = gen("register", 2000, 5, 5, crash_p=0.02, values=3)
    chain_check("W=33 register-2000, max_configs 1000",
                lin(models.register(), w33, max_configs=1000), True,
                "frontier-fallback")
    w33_bad = fixtures.corrupt(w33, seed=1)
    res, _ = chain_check("corrupted W=33 register-2000, max_configs 1000",
                         lin(models.register(), w33_bad, max_configs=1000),
                         False, "frontier-fallback")
    if res["dead-event"] != 562:
        raise AssertionError(f"corrupted W=33: dead event "
                             f"{res['dead-event']}, want 562")
    # the reference's scaling row: the dense product, then the rows
    row = gen("register", 1200, 4, 11, crash_p=0.01, values=2)
    row_bad = fixtures.corrupt(row, seed=1)
    for label, h, valid in (("scaling row", row, True),
                            ("corrupted scaling row", row_bad, False)):
        for quotient in (True, False):
            def fr(dev, h=h, quotient=quotient):
                return frontier.check(models.register(), h, frontier0=512,
                                      quotient=quotient, device=dev)
            res, _ = chain_check(f"{label} register-1200, "
                                 f"quotient={quotient}", fr, valid,
                                 "frontier")
            if valid and quotient and res["product-space"] != [4, 16, 63]:
                raise AssertionError(f"{label}: {res['product-space']}")
            if valid and not quotient and res["frontier-cap"] != 2048:
                raise AssertionError(f"{label}: {res['frontier-cap']}")
    # the sparse-live quotient walk
    for label, h, kw, valid in (
            ("same-op bursts 26 x 3, 6 crashed", same_op_burst(ops),
             dict(max_dense=1 << 10), True),
            ("burst of 13", burst(ops), dict(max_dense=1 << 18), True),
            ("corrupted burst of 13", burst(ops, corrupt=True),
             dict(max_dense=1 << 18), False)):
        def q(dev, h=h, kw=kw):
            return quotient_check(h, dev, **kw)
        res, _ = chain_check(f"sparse-live {label}", q, valid, None)
        if res["walk"] != "sparse-live":
            raise AssertionError(f"{label}: walk {res['walk']}")
    # multi-register: the per-key decomposition on the keyed lanes
    multi8 = gen("multi", 20_000, 5, 3, keys=8, values=5)
    for label, h, valid in (("8 keys x 5 values", multi8, True),
                            ("corrupted 8 keys x 5 values",
                             fixtures.corrupt(multi8, seed=3), False)):
        res, _ = chain_check(f"multi-register-20000 {label}",
                             lin(models.multi_register(), h), valid,
                             "decompose", batch_walk=None)
    tx = history.index(tx_history(ops))
    res, la = chain_check("transactional x/y, 30 values, max_states 300",
                          lin(models.multi_register({"x": 0, "y": 0}), tx,
                              max_states=300), True, "decompose-product")
    expect_any("restricted product", la, "lane_walk", "wide_walk")
    # a probe: the frontier alone on the corrupted W = 75 twin
    w75_bad = fixtures.corrupt(w75, seed=1)
    res, dt, la, spans, _, counters = chain_drive(
        lambda: frontier.check(models.register(), w75_bad, time_limit=60,
                               device=CARD))
    if res["valid"] is True or (res["valid"] == "unknown"
                                and res.get("cause") != "timeout"):
        raise AssertionError(f"probe corrupted W=75: {res}")
    log(f"probe frontier corrupted W=75 register-5000, time_limit 60: "
        f"valid={res['valid']} cause={res.get('cause')} dead-event="
        f"{res.get('dead-event')} quotient={res.get('quotient')} "
        f"product-space={res.get('product-space')}; "
        f"{walk_line(dt, spans, counters)}")
    log(f"chain phases: {time.perf_counter() - t_phase:.1f} s")


# -- the transactional checker: K8 and the txn main path ---------------------

# K8 against its plain version: one squaring at each (K, Np), on seeded
# random graphs of 2, 8 and Np / 2 edges a node (the last saturates the
# counts); (1, 96) and (3, 64) take the small tile at widths whose rows
# TMA cannot take, 96 not a power of two
TXN_STEP_SHAPES = ((3, 32), (1, 96), (3, 64), (3, 1_024), (4, 1_024),
                   (3, 8_192), (4, 8_192))
TXN_STEP_DEGREES = (2, 8)


def txn_degrees(Np):
    return TXN_STEP_DEGREES + (Np // 2,)


# the reference bench's closure probe (bench.py _closure_kernel_probe:
# n = 1,024, 2n edges, seed 42) and the same recipe at the envelope
TXN_CLOSURE_NS = (1_024, 8_192)
# the reference bench's transactional rung (bench.py txn_probe at its
# default seed), and the lattice at the dense envelope
TXN_BENCH = dict(n_txns=100_000, keys=6, processes=8, key_rotate=32,
                 seed=42)
TXN_LATTICE = dict(n_txns=6_000, keys=6, processes=8, key_rotate=32,
                   seed=42)
TXN_LATTICE_NP = 8_192
# the kernels line's K8 row: the lattice's shape, the largest the main
# path gives K8
TXN_KERNEL_SHAPE = (4, 8_192)
# the host route never trims, so its results have no core-txns
TXN_RESULT_KEYS = ("valid", "anomalies", "anomaly", "witness", "booleans",
                   "edge-counts", "txns", "edges", "infer", "failed-txns",
                   "coverage")
TXN_LATTICE_KEYS = ("valid", "holds", "levels", "weakest-violated",
                    "witness", "anomalies", "session-violations")


def txn_words(K, Np, degree, seed):
    """K nested random lanes of ``degree`` edges a node (numpy, seeded):
    the masks ``bool[K, Np, Np]`` on the card and their row- and
    transpose-packed words ``int32[K, Np, Np/32]``."""
    from jepsen_tpu_torch.txn import cycles

    rng = np.random.default_rng(seed)
    masks = np.zeros((K, Np, Np), bool)
    for b in range(K):
        e = degree * Np // K
        masks[b:, rng.integers(0, Np, e), rng.integers(0, Np, e)] = True
    masks = torch.from_numpy(masks).cuda()
    return (masks,) + cycles.pack_lanes(masks)


# the int8 tensor cores' published peak (H100 SXM, dense), and the rate
# tools/mma_forms.py measured for wgmma m64n256k256 .b1 with AND and
# popcount on an NVIDIA H100 80GB HBM3 at 700 W: 15,791 TOP/s, 8.0x the
# int8 peak. K8 runs on that form, faster than the int8 bound allows,
# so its bound is stated from the measured single-bit rate.
INT8_PEAK = 1_979e12
B1_RATE = 15.79e15


def txn_step_bound(K, Np):
    """K8's bound for one squaring: the larger of the two packings read
    and written once over the memory rate and 2·K·Np³ operations over the
    single-bit rate :data:`B1_RATE`; the text also gives the int8 bound
    and the first design's bound (K·Np²·NW three-input logic
    instructions over the integer rate)."""
    NW = Np // 32
    nbytes, ops = 4 * K * Np * NW * 4, 2 * K * Np ** 3
    t_bytes, t_ops = nbytes / HBM_RATE, ops / B1_RATE
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            f"bytes={nbytes} b1_ops={ops}; int8 bound "
            f"{1e3 * max(t_bytes, ops / INT8_PEAK):.6f} ms, LOP3 bound "
            f"{1e3 * max(t_bytes, K * Np * Np * NW / INT32_PEAK):.6f} ms")


# the library's one-call squaring, ``where(bmm(C, C) > 0, 1, C)``, in each
# exact precision: 0/1 inputs and non-negative sums, so ``> 0`` is exact
# in any of them (a sum of ones never rounds to zero)
TXN_LIBRARY_DTYPES = (("fp32", torch.float32, False),
                      ("tf32", torch.float32, True),
                      ("bf16", torch.bfloat16, False),
                      ("fp16", torch.float16, False))


def txn_library_ms(masks, reps):
    """One squaring by ``torch.bmm`` in each of
    :data:`TXN_LIBRARY_DTYPES`: ms by name. Each one's ``> 0`` must equal
    the fp32 one's."""
    times, want = {}, None
    tf32 = torch.backends.cuda.matmul.allow_tf32
    try:
        for name, dtype, allow in TXN_LIBRARY_DTYPES:
            torch.backends.cuda.matmul.allow_tf32 = allow
            A = masks.to(dtype)
            got = torch.bmm(A, A) > 0
            if want is None:
                want = got
            elif not torch.equal(got, want):
                raise AssertionError(f"bmm in {name} differs from fp32")
            times[name] = event_ms(
                lambda: torch.where(torch.bmm(A, A) > 0, 1.0, A), reps)
            del A, got
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return times


def txn_closure_graph(n, seed=42):
    """The reference bench's closure-bound graph: ``2n`` random edges of
    random type, self-loops dropped (``bench.py:824-831``)."""
    from jepsen_tpu_torch.txn.infer import DepGraph

    r = np.random.default_rng(seed)
    e = n * 2
    src = r.integers(0, n, e).astype(np.int32)
    dst = r.integers(0, n, e).astype(np.int32)
    keep = src != dst
    return DepGraph(n=n, src=src[keep], dst=dst[keep],
                    et=r.integers(0, 3, int(keep.sum())).astype(np.int8),
                    txns=tuple(range(n)))


def txn_split(spans, stage):
    """A txn check's spans: collect, infer, its cycle stage and, inside
    that, the closure's mask build, packing and ladder."""
    return ", ".join(f"{name} {spans.get(name, 0.0):.4f} s" for name in (
        "txn.collect", "txn.infer", stage, "txn.closure.masks",
        "txn.closure.pack", "txn.closure.ladder"))


def same_txn(label, got, want, keys):
    for key in keys:
        if got.get(key) != want.get(key):
            raise AssertionError(f"{label}: {key} differs: "
                                 f"{got.get(key)!r} against "
                                 f"{want.get(key)!r}")


def phase_txn():
    """The transactional checker on the card: K8 bit for bit against its
    plain version at every shape, beside the library's squaring; the
    closure-bound graphs through the K8 ladder, the f32 cross-check and
    the host SCC; the reference bench's
    100,000-txn rung and a lattice check at the dense envelope through
    ``txn.check_history``, each against the host reference (and the
    rung against the port's CPU run); every injected block. Returns K8's
    numbers for the kernels line."""
    from jepsen_tpu_torch import device, fixtures, history, txn
    from jepsen_tpu_torch.txn import cycles, host_ref, infer, ops

    t_phase = time.perf_counter()
    cuda = device.default_device()
    # the f32 cross-check runs in full float32 (the default; TF32 would be
    # exact too: 0/1 inputs, counts below 2^24); the library is timed in
    # every exact precision (txn_library_ms)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for K, Np in TXN_STEP_SHAPES:
        form = cycles.square_form(Np)
        BM, BN = cycles.SQUARE_TILES[form]
        for degree in txn_degrees(Np):
            masks, Cw, CwT = txn_words(K, Np, degree, seed=K * Np + degree)
            got = cycles.square_step(Cw, CwT)
            want = cycles.square_step_plain(Cw, CwT)
            _, p_ms = plain_ms(lambda: cycles.square_step_plain(Cw, CwT))
            err = max(int((g.long() - w.long()).abs().max()) for g, w in
                      zip(got, want))
            if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"K8 at K={K} Np={Np} degree {degree}: "
                                     f"differs from its plain version")
            if degree != TXN_STEP_DEGREES[0]:
                continue
            reps = 20 if Np <= 1_024 else 5
            ms = event_ms(lambda: cycles.square_step(Cw, CwT), reps)
            dev = device_ms(lambda: cycles.square_step(Cw, CwT), reps)
            libs = txn_library_ms(masks, reps)
            lib_name = min(libs, key=libs.get)
            b_ms, b_by, b_txt = txn_step_bound(K, Np)
            dms = dev["total"] if dev else None
            log(f"K8 txn_closure step K={K} Np={Np}: form {form}, tile "
                f"{BM} x {BN}, wgmma m64n{BN}k256 .b1 and.popc, operands "
                f"by {'TMA' if (Np // 32) % 4 == 0 else 'cp.async'}; "
                f"bit-identical to its plain version at {txn_degrees(Np)} "
                f"edges a node; event_ms={ms:.6f} device_ms="
                f"{'not measured' if dms is None else f'{dms:.6f}'} "
                f"plain_ms={p_ms:.3f} bound_ms={b_ms:.6f} ({b_by}; {b_txt}) "
                f"= {ms / b_ms:.2f}x the bound; bmm step "
                + ", ".join(f"{k} {v:.6f} ms" for k, v in libs.items())
                + f" (fastest {lib_name}: K8 {libs[lib_name] / ms:.2f}x "
                f"its speed)")
            out[(K, Np)] = {"max_abs_err": err, "ms": ms, "device_ms": dms,
                            "plain_ms": p_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": libs[lib_name]}
            del Cw, CwT, got, want
        del masks
    step_s = time.perf_counter() - t_phase

    # -- closure-bound graphs: the K8 ladder, the f32 cross-check, the host
    for n in TXN_CLOSURE_NS:
        g = txn_closure_graph(n)
        Np = cycles._pad_n_words(n)
        masks, rw = cycles._masks(g, Np, cuda)
        Cw0, CwT0 = cycles.pack_lanes(masks)
        Arw = cycles.pack_rows_torch(rw)
        A, Af = masks.float(), rw.float()

        def ladder():
            Cw, CwT = Cw0, CwT0
            for _ in range(cycles.n_iter(Np)):
                Cw, CwT = cycles.square_step(Cw, CwT)
            return cycles.word_verdict(Cw, CwT, Arw, (1,))

        cycles.KERNEL_LAUNCHES = 0
        word = ladder().cpu().numpy()
        launched = cycles.KERNEL_LAUNCHES
        f32 = cycles.f32_verdict(A, Af, (1,)).cpu().numpy()
        t0 = time.perf_counter()
        host = host_ref.classify_booleans(g)
        host_s = time.perf_counter() - t0
        keys = ("cyc_ww", "cyc_wwwr", "cyc_full", "gsingle")
        if [bool(x) for x in word] != [host[k] for k in keys] or \
                [bool(x) for x in f32] != [host[k] for k in keys]:
            raise AssertionError(f"closure n={n}: word {word} f32 {f32} "
                                 f"host {host}")
        reps = 3 if n > 1_024 else 10
        # the ladder by CUDA events (its launches and the verdict's torch
        # ops, host work included); the device's own time of one
        # squaring (device_ms averages each kernel's records, so it
        # times a function that launches each kernel once)
        l_ms = event_ms(ladder, reps)
        s_ms = event_ms(lambda: cycles.square_step(Cw0, CwT0), reps)
        s_dev = device_ms(lambda: cycles.square_step(Cw0, CwT0), reps)
        f_ms = event_ms(lambda: cycles.f32_verdict(A, Af, (1,)), 2)
        b_ms, b_by, _ = txn_step_bound(3, Np)
        k = cycles.n_iter(Np)
        log(f"closure-bound n={n} ({g.e} edges, Np={Np}, {k} squarings): "
            f"booleans {host} from the K8 ladder, the f32 cross-check and "
            f"the host SCC ({host_s:.3f} s); K8 ladder event_ms={l_ms:.6f}; "
            f"one squaring event_ms={s_ms:.6f} {dev_text(s_dev)}"
            + (f", x{k} = {k * s_dev['total']:.6f} ms" if s_dev else "")
            + f"; f32 body {f_ms:.6f} ms; bound {b_ms:.6f} ms a squaring "
            f"({b_by}), {b_ms * k:.6f} ms the ladder; K8 launches "
            f"{launched}")
        del masks, rw, Cw0, CwT0, A, Af

    # -- the reference bench's 100,000-txn rung ------------------------------
    t0 = time.perf_counter()
    h = fixtures.gen_txn_history(**TXN_BENCH)
    h = history.index(h + [op.with_(index=-1) for op in
                           fixtures.txn_anomaly_block("G-single")])
    gen_s = time.perf_counter() - t0
    res, dt, la, spans, _ = drive(lambda: txn.check_history(h))
    expect("txn bench rung", la, txn_closure=None)
    t0 = time.perf_counter()
    host = txn.check_history(h, force_host=True)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = txn.check_history(h, device="cpu")
    cpu_s = time.perf_counter() - t0
    same_txn("txn bench rung, host", res, host, TXN_RESULT_KEYS)
    same_txn("txn bench rung, cpu", res, cpu,
             TXN_RESULT_KEYS + ("engine", "core-txns"))
    if res["engine"] != "txn-mxu" or "G-single" not in res["anomalies"]:
        raise AssertionError(f"txn bench rung: {res['engine']} "
                             f"{res['anomalies']}")
    log(f"main path txn bench rung ({res['txns']} txns, {res['edges']} "
        f"edges {res['edge-counts']}, core {res.get('core-txns')}): "
        f"{res['engine']} {res['anomalies']} {dt:.4f} s = "
        f"{res['txns'] / dt:.1f} txns/s ({txn_split(spans, 'txn.cycles')}); "
        f"host SCC {host_s:.3f} s, "
        f"cpu {cpu_s:.3f} s, both agree; generation {gen_s:.2f} s not "
        f"counted; launches {la['txn_closure']}")

    # -- the lattice at the dense envelope --------------------------------
    h = fixtures.gen_txn_history(**TXN_LATTICE)
    h = history.index(h + [op.with_(index=-1) for op in
                           fixtures.txn_anomaly_block("write-skew")])
    res, dt, la, spans, _ = drive(
        lambda: txn.check_history(h, consistency="all"))
    Np = cycles._pad_n(res["txns"])
    expect("txn lattice", la, txn_closure=cycles.n_iter(Np))
    if res["engine"] != "txn-lattice-mxu" or Np != TXN_LATTICE_NP:
        raise AssertionError(f"txn lattice: {res['engine']} at Np={Np}")
    t0 = time.perf_counter()
    host = txn.check_history(h, consistency="all", force_host=True)
    host_s = time.perf_counter() - t0
    same_txn("txn lattice, host", res, host, TXN_LATTICE_KEYS)
    # the f32 cross-check on the same lanes (witnesses never depend on
    # the body, so its six booleans are what it can change)
    txns, fails = ops.collect(h)
    graph = infer.infer(txns, fails)
    cm = cycles.commit_mask(np.asarray([t.index for t in txns], np.int64),
                            np.asarray([t.end for t in txns], np.int64), cuda)
    masks, rw = cycles._lattice_masks(graph, Np, cm, cuda)
    f32, f32_ms = plain_ms(lambda: cycles._f32_booleans(
        masks, rw, cycles.LATTICE_CONTRACTS))
    del masks, rw
    f32 = {k: bool(f32[i]) for i, k in enumerate(cycles.LATTICE_KEYS)}
    if f32 != res["booleans"]:
        raise AssertionError(f"txn lattice: f32 booleans {f32} against "
                             f"{res['booleans']}")
    log(f"main path txn lattice ({res['txns']} txns, K=4, Np={Np}): "
        f"{res['engine']} weakest-violated {res['weakest-violated']} "
        f"{dt:.4f} s ({txn_split(spans, 'txn.lattice')}); host lattice "
        f"{host_s:.4f} s (card {host_s / dt:.2f}x its speed), the f32 "
        f"ladder on the same lanes {f32_ms:.3f} ms; all agree; launches "
        f"{la['txn_closure']}")

    # -- every injected block, on the card and on the host ---------------
    base = fixtures.gen_txn_history(30, keys=2, seed=5)
    for kind in fixtures.TXN_ANOMALY_KINDS + fixtures.TXN_LATTICE_KINDS:
        h = base + [op.with_(index=-1) for op in
                    fixtures.txn_anomaly_block(kind)]
        for kw in ({}, {"consistency": "all"}):
            res, _dt, la, _s, _ = drive(lambda: txn.check_history(h, **kw))
            expect(f"txn block {kind}", la, txn_closure=None)
            host = txn.check_history(h, force_host=True, **kw)
            same_txn(f"txn block {kind} {kw}", res, host,
                     TXN_RESULT_KEYS + TXN_LATTICE_KEYS)
            if res["valid"] is not False:
                raise AssertionError(f"txn block {kind}: {res['valid']}")
    log(f"txn injected blocks "
        f"{fixtures.TXN_ANOMALY_KINDS + fixtures.TXN_LATTICE_KINDS}: the "
        f"card's results equal the host's, serializable and lattice")
    log(f"txn phase: {time.perf_counter() - t_phase:.1f} s (K8 steps "
        f"{step_s:.1f} s)")
    return out[TXN_KERNEL_SHAPE]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from jepsen_tpu_torch import (Linearizable, _build, _native, fixtures,
                                  history, models)
    from jepsen_tpu_torch.checkers import reach_lane

    name = torch.cuda.get_device_name(0)
    card = smi()
    log(f"device: {name} (count {torch.cuda.device_count()}); "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    build_s = _build.build_all()
    log(f"build: {build_s:.3f} s for {list(_build.sources())}")
    for lib in _native.LIBRARIES:
        native_s = _native.build(lib)
        log(f"build: {native_s:.3f} s for the host library "
            f"{os.path.relpath(_native.library_path(lib))} "
            f"(g++ {' '.join(_native.FLAGS)})")
    for src in _build.sources():
        log(ptxas_summary(src, _build.build_log(src)))
    for src in ("keyed_walk", "ablate_walk", "ablate_stream"):
        for kern, regs, spill in ptxas_kernels(_build.build_log(src)):
            log(f"ptxas {src}.cu {kern}: {regs} registers, spill stores "
                f"{spill} bytes")
    check_smem_layout()

    # -- kernels against their plain versions --------------------------
    k1 = phase_k1()
    h100k = gen("cas", 100_000, 5, 0)
    P, rs, M = history_operands(h100k, models.cas_register())
    k2 = phase_k2(P, rs, M)
    t0 = time.perf_counter()
    big = gen("cas", 1_000_000, 5, 1)
    gen_s = time.perf_counter() - t0
    phase_native([("cas-100k", h100k), ("cas-1M", big)])
    t0 = time.perf_counter()
    h_ind, per_key = keyed_histories()
    gen_ind_s = time.perf_counter() - t0
    k2_lock = phase_k2_lockstep(f"independent {N_KEYS} keys x "
                                f"{OPS_PER_KEY} ops", per_key)
    k3 = phase_k3(f"independent {N_KEYS} keys x {OPS_PER_KEY} ops", per_key,
                  k5=True)
    for procs in (6, 8):
        # the block form at its lookup count against K5's at any number
        # of words, on the same keys
        phase_k3(f"{N_KEYS} keys x {OPS_PER_KEY} ops, {procs} processes",
                 keyed_histories(processes=procs)[1], k5=True)
    h_long, per_key_long = keyed_histories(LONG_KEYS, LONG_OPS, LONG_BAD)
    phase_k3(f"long keys {LONG_KEYS} x {LONG_OPS} ops", per_key_long, n=10)
    lanes = {label: phase_lanes(label, pk) for label, pk in (
        (f"independent {N_KEYS} keys x {OPS_PER_KEY} ops", per_key),
        (f"long keys {LONG_KEYS} x {LONG_OPS} ops", per_key_long))}
    wide = gen("cas", 100_000, 5, 0, **WIDE_CAS)
    P_w, rs_w, _M_w = history_operands(wide, models.cas_register())
    P_m, rs_m, _ = history_operands(
        gen("multi", 20_000, 5, 0, **WIDE_MULTI), models.multi_register())
    P_32, _rs_32, _ = history_operands(
        gen("cas", 60_000, 5, 0, values=31), models.cas_register())
    phase_tables([("cas-40 alphabet", P_w), ("multi-register", P_m),
                  ("cas alphabet", P), ("cas alphabet at 32 states", P_32)])
    multi = gen("multi", 100_000, 5, 0, **WIDE_MULTI)
    k4 = phase_k4(P_w, rs_w, P_m, rs_m, multi)
    phase_k4_instances()
    h_wide_ind, per_key_wide = keyed_histories(**WIDE_CAS)
    k5 = phase_k5(per_key_wide)
    from jepsen_tpu_torch.tools import ablate_lane

    t0 = time.perf_counter()
    ab_geom, ab_opnds, ab_returns = ablate_lane.operands(ABLATE_OPS,
                                                         device="cuda")
    log(f"ablate operands (cas-100k, seed 42): {time.perf_counter() - t0:.3f}"
        f" s, geometry {ab_geom}, {ab_returns} returns")
    cases = list(ablate_lane.VARIANTS) + list(ABLATE_EXTRA)
    k6 = phase_ablate("cas-100k", ab_geom, ab_opnds, ABLATE_BLOCK, cases,
                      stream=False)
    k7 = phase_ablate("cas-100k", ab_geom, ab_opnds, ABLATE_BLOCK, cases,
                      stream=True)
    # the block form: W = 6, bool-matmulproj at its largest table
    w6_geom, w6_opnds, _n = ablate_lane.operands(
        ABLATE_W6_OPS, processes=6, B=ABLATE_W6_RETURNS, device="cuda")
    if w6_geom[1] != 6:
        raise AssertionError(f"ablate W=6 shape: geometry {w6_geom}")
    for stream in (False, True):
        phase_ablate("cas W=6", w6_geom, w6_opnds, ABLATE_W6_RETURNS,
                     ABLATE_W6_CASES, stream, reps=2)
    log(f"ablate kernel phases (K6, K7): {time.perf_counter() - t0:.1f} s")
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s")

    # -- the main path ------------------------------------------------
    res, dt, la, spans, _ = drive(lambda: linearizable(h100k))
    if res["valid"] is not True or res["engine"] != "reach-chunklock":
        raise AssertionError(f"valid cas-100k: {res}")
    expect("valid cas-100k", la, batch_walk=2, lane_walk=0, keyed_walk=0)
    log(f"main path valid cas-100k: {res['engine']} valid={res['valid']} "
        f"chunks={res['chunks']} basis-max={res['basis-max']} "
        f"rescues={res['rescues']} {dt:.4f} s = {100_000 / dt:.1f} ops/s; "
        f"{split(dt, spans)}; launches {la}")

    bad = gen("cas", 100_000, 5, 0, corrupt=True)
    res, dt, la, spans, _ = drive(lambda: linearizable(bad))
    # K1 twice: the dead chunk, which reports its dead return, and the
    # witness prefix
    expect("corrupted cas-100k", la, batch_walk=2, lane_walk=2,
           keyed_walk=0)
    t0 = time.perf_counter()
    ref = linearizable(bad, device="cpu")
    cpu_s = time.perf_counter() - t0
    for key in ("valid", "engine", "op", "dead-event", "max-linearized",
                "final-configs", "previous-ok", "chunks", "basis-max",
                "rescues"):
        if res.get(key) != ref.get(key):
            raise AssertionError(f"corrupted cas-100k: {key} differs "
                                 f"cuda={res.get(key)} cpu={ref.get(key)}")
    Pb, rsb, Mb = history_operands(bad, models.cas_register())
    R0 = np.zeros((Pb.shape[1], Mb), bool)
    R0[0, 0] = True
    dead_k1, _ = reach_lane.walk_returns(Pb, rsb.ret_slot, rsb.slot_ops, R0,
                                         device="cuda", fetch_R=False)
    if res["valid"] is not False or \
            int(rsb.ret_event[dead_k1]) != res["dead-event"]:
        raise AssertionError(f"corrupted cas-100k: K1 finds dead return "
                             f"{dead_k1}, chunk-lockstep {res}")
    log(f"main path corrupted cas-100k: {res['engine']} "
        f"valid={res['valid']} dead-event={res['dead-event']} (return "
        f"{dead_k1}, as K1 finds it) {dt:.4f} s on cuda ({split(dt, spans)}; "
        f"launches {la}), {cpu_s:.3f} s on cpu; verdict, op, dead event, "
        f"witness and chunk counts agree")
    # the walk stage by stage, each stage synchronised: no torch returns
    # walk, K1 once on the dead chunk and once for the witness
    from jepsen_tpu_torch.tools import walk_split

    st = walk_split.split(bad)
    if st["calls"].get("torch-walk", 0) or st["calls"].get("refine", 0) \
            or st["calls"].get("k1 in localize") != 1 \
            or st["calls"].get("k1 in witness-prefix") != 1 \
            or st["dead-event"] != res["dead-event"]:
        raise AssertionError(f"corrupted cas-100k split: {st}")
    log(f"walk split corrupted cas-100k: {json.dumps(st)}")

    res, dt, la, spans, _ = drive(lambda: linearizable(big))
    if res["valid"] is not True or res["engine"] != "reach-chunklock":
        raise AssertionError(f"cas-1M: {res}")
    expect("cas-1M", la, batch_walk=2, keyed_walk=0)
    log(f"scale cas-1M: {res['engine']} valid={res['valid']} "
        f"chunks={res['chunks']} basis-max={res['basis-max']} "
        f"rescues={res['rescues']} {dt:.4f} s = {1_000_000 / dt:.1f} ops/s; "
        f"{split(dt, spans)}; history generation {gen_s:.2f} s not "
        f"counted; launches {la}")

    small = gen("cas", 30_000, 5, 0)
    res, dt, la, spans, _ = drive(lambda: linearizable(small))
    if res["valid"] is not True or res["engine"] != "reach-lane":
        raise AssertionError(f"sub-floor cas-30k: {res}")
    expect("sub-floor cas-30k", la, lane_walk=1, batch_walk=0, keyed_walk=0)
    log(f"main path sub-floor cas-30k: {res['engine']} "
        f"valid={res['valid']} {dt:.4f} s = {30_000 / dt:.1f} ops/s; "
        f"{split(dt, spans)}; launches {la}")

    # the narrow independent shapes take the lockstep lane on K2: one
    # launch a planned group (W <= 8: no exact rescue), K1 twice a failed
    # key (its dead lane's refinement and its witness prefix)
    check_keyed(f"independent cas {N_KEYS} keys x {OPS_PER_KEY} ops", h_ind,
                N_KEYS, BAD_KEYS, "lockstep",
                batch_walk=planned_groups(per_key), keyed_walk=0,
                lane_walk=2 * len(BAD_KEYS))
    log(f"independent history generation {gen_ind_s:.2f} s not counted")
    check_keyed(f"long keys {LONG_KEYS} x {LONG_OPS} ops", h_long, LONG_KEYS,
                LONG_BAD, "lockstep",
                batch_walk=planned_groups(per_key_long), keyed_walk=0,
                lane_walk=2 * len(LONG_BAD))
    # one live key is no lockstep batch: the native keyed lane on K3
    h_one, _ = keyed_histories(1, ONE_KEY_OPS, (0,))
    check_keyed(f"one key x {ONE_KEY_OPS} ops", h_one, 1, (0,), "keyed",
                keyed_walk=1, batch_walk=0, lane_walk=1)

    # -- check_batch: several whole histories on the lockstep lane -------
    t0 = time.perf_counter()
    batch = [fixtures.gen_packed("cas", n_ops=100_000, processes=5,
                                 seed=1000 + i) for i in range(BATCH_N)]
    log(f"check_batch histories: {BATCH_N} x gen_packed cas-100k in "
        f"{time.perf_counter() - t0:.3f} s, not counted")
    check_batch_phase(f"{BATCH_N} x cas-100k", batch, BATCH_N * 100_000,
                      batch_walk="groups", lane_walk=0, keyed_walk=0)
    small_batch = [
        history.pack(gen("cas", 30_000, 5, 2000 + i, corrupt=True))
        if i in SMALL_BATCH_BAD else
        fixtures.gen_packed("cas", n_ops=30_000, processes=5, seed=2000 + i)
        for i in range(SMALL_BATCH_N)]
    check_batch_phase(f"{SMALL_BATCH_N} x cas-30k, {len(SMALL_BATCH_BAD)} "
                      f"corrupted", small_batch, SMALL_BATCH_N * 30_000,
                      batch_walk="groups", keyed_walk=0,
                      lane_walk=2 * len(SMALL_BATCH_BAD))

    # -- the wide main path: more than 32 states, K4 and K5 -------------
    # the dense engine alone: under "auto" a history of single-key
    # multi-register ops is split per key first (phase_chain drives that)
    def check_multi(h, device=None):
        return Linearizable(models.multi_register(), algorithm="reach",
                            device=device).check(None, h)

    for label, h, check in (("wide cas-100k", wide, linearizable),
                            ("multi-register-100k", multi, check_multi)):
        res, dt, la, spans, _ = drive(lambda: check(h))
        if res["valid"] is not True or res["engine"] != "reach-pallas":
            raise AssertionError(f"valid {label}: {res}")
        expect(label, la, wide_walk=1, lane_walk=0, batch_walk=0,
               keyed_walk=0, wide_keyed=0)
        S_pad = max(2, 1 << (res["states"] - 1).bit_length())
        log(f"main path valid {label}: {res['engine']} valid={res['valid']} "
            f"states={res['states']} slots={res['slots']} form="
            f"{form(res['slots'], S_pad)} {dt:.4f} s = "
            f"{len(h) // 2 / dt:.1f} ops/s; {split(dt, spans)}; "
            f"launches {la}")

    bad = gen("cas", 100_000, 5, 0, corrupt=True, **WIDE_CAS)
    res, dt, la, spans, _ = drive(lambda: linearizable(bad))
    expect("corrupted wide cas-100k", la, wide_walk=2, lane_walk=0,
           batch_walk=0, keyed_walk=0, wide_keyed=0)
    t0 = time.perf_counter()
    ref = one_thread(lambda: linearizable(bad, device="cpu"))
    cpu_s = time.perf_counter() - t0
    for key in ("valid", "engine", "op", "dead-event", "max-linearized",
                "final-configs", "previous-ok"):
        if res.get(key) != ref.get(key):
            raise AssertionError(f"corrupted wide cas-100k: {key} differs "
                                 f"cuda={res.get(key)} cpu={ref.get(key)}")
    if res["valid"] is not False or not res["final-configs"]:
        raise AssertionError(f"corrupted wide cas-100k: {res}")
    log(f"main path corrupted wide cas-100k: {res['engine']} "
        f"valid={res['valid']} dead-event={res['dead-event']} {dt:.4f} s on "
        f"cuda ({split(dt, spans)}; launches {la}: the walk and the "
        f"witness prefix), {cpu_s:.3f} s on cpu; verdict, op, dead event "
        f"and witness agree")

    # the union's 41 states are outside K2's envelope: the native keyed
    # lane on K5; every key has at most 32 states of its own, so K1
    # re-walks each failed key's witness prefix in the key's own geometry
    check_keyed(f"wide independent cas {N_KEYS} keys x {OPS_PER_KEY} "
                f"ops over 40 values", h_wide_ind, N_KEYS, BAD_KEYS,
                "keyed-wide", wide_keyed=1, keyed_walk=0, batch_walk=0,
                wide_walk=0, lane_walk=len(BAD_KEYS))

    # -- the auto chain past the dense engine ---------------------------
    phase_chain()

    # -- the transactional checker: K8 and its main path ----------------
    k8 = phase_txn()

    # -- the ablation harness: the full ladder, K6 and K7 --------------
    la = ablate_ladder(ab_geom, ab_opnds, ab_returns)
    k6_launches, k7_launches = la["ablate_walk"], la["ablate_stream"]

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(f"main-path launches, summed over every drive: {MAIN_PATH_LAUNCHES}")
    log(f"K2 at the lockstep group geometry: {k2_lock}; both lanes' walks "
        f"(fastest of each): {json.dumps(lanes)}")
    total = MAIN_PATH_LAUNCHES
    entries = [
        ("lane_walk", "lane_walk.cu", "jepsen_tpu/checkers/reach_lane.py:201",
         total["lane_walk"], k1),
        ("batch_walk", "batch_walk.cu",
         "jepsen_tpu/checkers/reach_batch.py:336", total["batch_walk"], k2),
        ("keyed_walk", "keyed_walk.cu",
         "jepsen_tpu/checkers/reach_lane.py:339", total["keyed_walk"], k3),
        ("wide_walk", "wide_walk.cu",
         "jepsen_tpu/checkers/reach_pallas.py:167", total["wide_walk"], k4),
        ("wide_keyed", "wide_keyed.cu",
         "jepsen_tpu/checkers/reach_pallas.py:374", total["wide_keyed"], k5),
        ("ablate_walk", "ablate_walk.cu", "tools/ablate_lane.py:147",
         k6_launches, k6),
        ("ablate_stream", "ablate_stream.cu", "tools/ablate_lane.py:262",
         k7_launches, k7),
        ("txn_closure", "txn_closure.cu", "jepsen_tpu/txn/cycles.py:198",
         total["txn_closure"], k8),
    ]
    log(json.dumps({"kernels": [{
        "name": kname, "route": "cuda",
        "source": f"jepsen_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": n, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k.get("library_ms")}
        for kname, src, replaces, n, k in entries]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --serve 256     # the daemon's phase alone
    python3 chip_smoke.py --sessions      # K10 and the sessions alone
    python3 chip_smoke.py --words         # K11 and the word route alone
    python3 chip_smoke.py --harnesses     # loadgen, chaos, soak, disk tier
    python3 chip_smoke.py --kernel-phases # the kernels against their plain
                                          # versions alone

With ``--serve N`` it builds the kernels and runs only ``phase_serve``,
with N cas requests (and ``min(N, 64)`` again at ``pipeline_k`` 1 and
4): the daemon's measurement at a traffic the full run has no time for.
With ``--sessions`` it builds them and runs only :func:`phase_k10` and
:func:`phase_sessions`; with ``--words`` only :func:`phase_words`. With ``--kernel-phases`` it stops after the
kernels' checks against their plain versions (their time, with the disk
memo tier on, or off under the persistence switch in the environment).
Every mode points the disk memo tier at one fresh directory
(:func:`use_fresh_memo_cache`).

Builds the port's CUDA kernels from ``jepsen_tpu_torch/csrc`` (K1
``lane_walk``, K2 ``batch_walk``, K3 ``keyed_walk``, K4 ``wide_walk``,
K5 ``wide_keyed``, K6 ``ablate_walk``, K7 ``ablate_stream``, K8
``txn_closure``, K9 ``txn_inc_join``, K10 ``mega_walk``, K11
``word_walk``), holds each
kernel bit for bit against its plain PyTorch version on the card at the
shapes the main path gives it, then drives the main path through the
user's entry points and checks the results:

- ``Linearizable(cas_register()).check`` on a 100,000-op history
  (chunk-lockstep: two K2 launches), valid and corrupted (the corrupted
  one against K1, with no torch returns walk: K1 reports the dead
  return itself; its walk split stage by stage,
  ``tools/walk_split.py``), and on a :data:`SCALE_OPS`-op one (generated
  in a worker process while the kernels are checked);
- the same on a 30,000-op history, below chunk-lockstep's floor (K1);
  K1 and K2 walk P's nibble image tables, built by one
  ``pack_tables`` launch and copied into each block's shared memory
  or, for a many-op alphabet at 32 states, read from device memory;
  each K1 launch is held against its plain version in its dead return
  too;
- the C++ host prep (``native/preproc.cpp``, built by ``g++``): its slot
  assignment and returns view against the plain Python scans, array for
  array, at cas-100k and at :data:`SCALE`;
- ``independent.checker(Linearizable(cas_register()))`` on 2,000 keys of
  50 ops and on 200 keys of 1,000 ops (the lockstep lane: one union
  prep, a K2 launch a group of up to 32 keys, K1 for each failed key),
  and on one key of 30,000 ops (the native keyed lane, one K3 launch),
  each against the CPU run; K2 at the lockstep group's geometry against
  its plain version, and both lanes' walks after one shared union prep
  (the lockstep scheduler, and K3), which must agree key for key; K3 walks P's nibble image tables as K1 and K2 do,
  in the warp form and in the block form (held bit for bit against its
  plain version and the host replay at W = 4 (2,000 keys), 6 and 8
  (500 keys) and at the long keys, and timed beside K5 on the same
  keys);
- ``reach.check_batch`` on 32 cas-100k histories from
  ``fixtures.gen_packed`` (one K2 launch) and on 8 cas-30k histories, two
  corrupted, each history's result against its own ``check_packed`` on
  the card;
- more than 32 states: a 100,000-op cas history over 40 values and a
  100,000-op multi-register history (``algorithm="reach"``, the dense
  engine alone; one K4 launch each), the corrupted
  cas one (and a corrupted 30,000-op one against the CPU run), and
  2,000 keys over 40 values (one K5
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
  bit for bit against its plain version and the host replay (the first
  case of each kernel on the first block of 1,024 returns, the others on
  the first 256), with the form, table place and ring its launch
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
  every injected block;
- the command line (:func:`phase_cli`), each command in a subprocess
  through ``python -m jepsen_tpu_torch`` on the card: ``check`` on the
  ``data/`` fixtures, on a 100,000-op cas ``history.jsonl`` and on the
  6,000-txn history (K8); ``recheck`` of 8 cas-30k histories, two
  corrupted (one K2 launch); ``--algorithm reach-chunked`` on the
  100,000-op history, valid and corrupted (K1's forward pass, K2's
  basis walk); ``--algorithm competition`` (the winner, the losers'
  stop time) and ``linear`` on a corrupted cas-30k; each verdict, op and
  dead event against the dense engine in process; K2's largest basis
  launch of a 30,000-op history and a full-basis launch (E = D = 256)
  bit for bit against their plain version;
- the test runner (:func:`phase_run`): ``core.run`` of the register
  suite at the README command's width (5 nodes, concurrency 5, the
  partition nemesis, :data:`RUN_TIME_LIMIT` s), linearizable (valid, as ``wgl-native`` finds
  it on the same history) and sloppy (invalid at the CPU dense engine's
  failing op and dead event, ``wgl-native`` agreeing, ``linear.svg``
  written), each with its route (K1 below chunk-lockstep's floor) and
  launches; ``independent_test()`` key by key against its CPU run; then
  ``python -m jepsen_tpu_torch run --mode sloppy`` (exit 1, the run
  dir's files), ``recheck`` of that dir (exit 1, the same failing op)
  and ``run`` (exit 0), each in its own process;
- the other suites of ``run`` (:func:`phase_suites`), each at its
  builder's defaults (5 nodes, concurrency 5, its own nemesis,
  :data:`SUITE_TIME_LIMIT` s):
  mutex (linearizable; sloppy under a permanent partition, invalid),
  set, counter, queue (safe, and ``universe=6``), etcd over HTTP, redis
  over RESP and the list-append ``txn_test`` (fake tier), in both
  modes, each ``linear`` verdict as ``wgl-native``'s (an invalid one at
  the CPU dense engine's failing op and dead event), each ``txn``
  result as the host SCC's, K1 launched by mutex, etcd and redis, K8 by
  every txn graph with edges, the set's and the queue's route logged;
  then ``run --suite queue --mode sloppy`` (the broker's ``lossy``) and
  ``run --suite mutex``, each in its own process;
- online checking (:func:`phase_online`): the same runs with
  ``online-check`` in process, linearizable (the monitor valid) and
  sloppy (the monitor stops the workers early; its violation equal to
  ``NativeStreamEngine`` fed the stored history on the CPU), then
  ``run --mode sloppy --online`` in its own process (exit 1);
- the streaming session engines: ``DeviceFrontierEngine``'s carried
  frontier (:func:`phase_carry`) on K1 at cas-100k and on K4 at wide
  cas-60k, each with its corrupted twin, in 256-op blocks, against
  ``NativeStreamEngine`` (violation, settled returns, the final set);
  K9's join, one launch for both packings, bit for bit against its
  plain version at (4, 8,192, 256) and (4, 8,192, 8,192) beside its
  bound, both tile forms and the library's ``bmm`` join, and the
  update's column gather by K9 and by torch ops (:func:`phase_join`);
  and ``TxnSessionEngine`` (:func:`phase_txn_session`) over the
  6,003-txn write-skew history in 128-op blocks at K = 3 and K = 4 in
  the default precision (the word update on K8 and K9 runs no float32
  product), every block's booleans against the f32 cross-check (TF32
  allowed around it alone), the close against the post-hoc check on K8,
  the last block's K9 launches against the plain version, the launches
  of both kernels and the session's peak device memory;
- the check daemon's streaming sessions: K10, the mega-group advance
  (:func:`phase_k10`), bit for bit against its plain version and the
  host replay at 1, 2, 64 and 1,024 lanes on K1's route (cas) and K4's
  (multi-register over 64 states), the block forms at 64, each beside
  the same blocks' solo K1 or K4 advances; then the daemon
  (:func:`phase_sessions`): 256 cas sessions across 4 tenants, 16 wide
  and 2 txn ones, 8 appends each, the daemon dropped and started again
  halfway (the journal's replay), every close and first violation
  against the standalone check, K10's device time a wave, appends a
  second, and the results browser's ``/`` and ``/engine``;
- the daemon's harnesses (:func:`phase_harnesses`): ``tools.loadgen`` at
  its defaults (20 requests/s for 20 s, cas of 32-400 ops, 4 tenants,
  a quarter invalid) with 4 streaming sessions, self-hosted in process
  (the tool's exit rule; K2 and K1 launched from inside the daemon;
  K10's launches and the mega waves), ``--mixed-consistency --quick``
  (K8 from the daemon); ``tools.chaos --quick`` and ``--fleet --quick``
  as processes (exit 0: every invariant across a SIGKILL and a lease
  failover); ``tools.soak``'s register, mutex-leases and lossy-queue
  configs (the correct one valid, each buggy one caught within 3
  rounds); the disk memo tier (a corrupted cas-30k from a memo read
  back from disk, its verdict, dead event and witness unchanged). The
  disk memo tier is on in every phase, in a directory fresh to the run
  (``JEPSEN_TPU_CACHE_DIR``).

Depths cut to make room (``PERF.md`` section 4): K1's plain version on
the first :data:`K1_PLAIN_RETURNS` returns of cas-30k (K1 also timed on
all of them), no CPU run at the long keys, the wide CPU run at
:data:`WIDE_CPU_OPS` ops, no CPU run of the chain's four valid checks
whose corrupted twins take the same walk on the CPU; the command lines
started in batches; no CPU run of a corrupted cas-48k; the runner's runs
at :data:`RUN_TIME_LIMIT` and the suites' at :data:`SUITE_TIME_LIMIT`
seconds; the scale check at :data:`SCALE_OPS` ops (from 1,000,000), K4's
plain version at :data:`WIDE_RETURNS` returns (from 20,000), the wide
carry at 60,000 ops (from 100,000), the ablation's cases after the
first at :data:`ABLATE_REST` returns (from 256); the
scale history and the check daemon's traffic generated
by worker processes (:func:`pool`) while the kernels are checked.

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
# the scale check's history (cut from 1,000,000 ops: PERF.md section 4)
SCALE_OPS = 300_000
SCALE = "cas-300k"
# H100 SXM 32-bit integer operations/s: the data sheet's 67 TFLOP/s fp32
# is 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz; the integer pipe has 64
# lanes per SM, one operation each per clock: 132 x 64 x 1.98e9
INT32_PEAK = 132 * 64 * 1.98e9

# the independent suite's defaults (suites/register.py independent_test
# at 2,000 keys): 50 ops a key, 4 processes a key; every 100th key from
# key 7 on is corrupted
N_KEYS, OPS_PER_KEY, KEY_PROCS = 2_000, 50, 4
BAD_KEYS = tuple(range(7, N_KEYS, 100))
# K3's block form at W = 6 and 8 is held on this many of those keys
BLOCK_FORM_KEYS = 500
# one live key (the native keyed lane on K3)
ONE_KEY_OPS = 30_000
# check_batch: the bench's batch rung (32 cas-100k histories from
# fixtures.gen_packed), and 8 cas-30k histories, two corrupted
BATCH_N = 32
# the corrupted wide (40-value) history the CPU run holds K4's answer
# against; the card also checks the corrupted wide cas-100k alone
WIDE_CPU_OPS = 15_000
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


# worker processes that generate histories while the main process checks
# kernels (history generation is Python, one core a history); created by
# pool(), shut down at exit
POOL = None


def pool():
    global POOL
    if POOL is None:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        POOL = ProcessPoolExecutor(
            max_workers=max(1, min(2, (os.cpu_count() or 2) - 2)),
            mp_context=multiprocessing.get_context("spawn"))
    return POOL


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
# the first geometry's plain version runs on its first K1_PLAIN_RETURNS
# returns, W = 7's on its first 1,024 (PERF.md section 4's cuts); K1 is
# timed on the whole stream too
K1_PLAIN_RETURNS = 2_048
GEOMS = [
    ("sub-floor cas-30k", "cas", 30_000, 5, 0, 1024, False, {},
     K1_PLAIN_RETURNS),
    ("W=7 multi-block", "cas", 4_000, 7, 1, 64, False, {}, 1_024),
    ("W=10 capped ladder", "cas", 1_000, 11, 0, 64, True, {}, None),
    ("corrupted cas-4k", "cas", 4_000, 5, 3, 256, True, {}, None),
    ("S=32 many ops, tables in device memory", "cas", 60_000, 5, 0, 1024,
     False, dict(values=31), 2048),
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
                full = reach_lane.operands_from_numpy(
                    P, rs.ret_slot, rs.slot_ops, R0, B=B, device="cuda")
                t = event_ms(lambda: reach_lane.lane_walk(*full, B, n_pass),
                             10)
                log(f"kernel lane_walk [{label}, all {rs.n_returns} "
                    f"returns] n_pass={n_pass}: kernel_ms={t:.6f} "
                    f"us_per_return={1e3 * t / rs.n_returns:.6f}")
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
# K4 against its plain version on the first returns of the multi-register
# histories (a plain walk's time grows with its returns)
WIDE_MULTI_RETURNS, WIDE_W7_RETURNS = 5_000, 2_000
WIDE_RETURNS = 2_500           # K4 against its plain version on this
                               # prefix
TORCH_RETURNS = 2_000          # and the torch returns walk on this one


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
    :data:`WIDE_RETURNS` returns, multi-register-20k's first
    :data:`WIDE_MULTI_RETURNS` (the tables in shared memory; both in the
    warp form), a narrow walk (one word a mask) and a wide one at W = 7
    (its first :data:`WIDE_W7_RETURNS`; both in the block form); then K4
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
    n, nm, n7 = WIDE_RETURNS, WIDE_MULTI_RETURNS, WIDE_W7_RETURNS
    runs = [(f"cas-40 alphabet, first {n} returns", P_wide,
             rs_wide.ret_slot[:n], rs_wide.slot_ops[:n]),
            (f"multi-register-20k, first {nm} returns", P_m,
             rs_m.ret_slot[:nm], rs_m.slot_ops[:nm]),
            ("narrow W=7", P_n, rs_n.ret_slot, rs_n.slot_ops),
            (f"wide multi-register W=7, first {n7} returns", P_7,
             rs_7.ret_slot[:n7], rs_7.slot_ops[:n7])]
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
             ("multi S=256", "multi", dict(keys=4, values=3)),
             # the set suite's shape: the block form at 2^W * NW = 1,024
             # (mask, word) pairs, more threads than its registers allow
             # one block
             ("bounded set S=1024", "set", dict(adds=10, processes=5))]


def set_history(adds, processes):
    """A bounded-set history of rounds of ``processes`` concurrent adds
    of fresh elements (W = ``processes``; 2^adds states), then a read of
    the whole set."""
    from jepsen_tpu_torch import history
    from jepsen_tpu_torch.op import invoke, ok

    h = []
    for first in range(0, adds, processes):
        vals = range(first, min(adds, first + processes))
        h += [invoke(p, "add", v) for p, v in enumerate(vals)]
        h += [ok(p, "add", v) for p, v in enumerate(vals)]
    h += [invoke(0, "read", None), ok(0, "read", list(range(adds)))]
    return history.index(h)


def phase_k4_instances():
    """K4 against its plain version, bit for bit, at :data:`INSTANCES`
    (1,000 ops, 4 processes each; the set's history by
    :func:`set_history`)."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checkers import reach_pallas

    for label, kind, kw in INSTANCES:
        if kind == "set":
            h, model = set_history(**kw), models.bounded_set(12)
        else:
            h = gen(kind, 1_000, 4, 0, **kw)
            model = models.cas_register() if kind == "cas" else \
                models.multi_register()
        P, rs, _ = history_operands(h, model)
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
# every case after the first (whose numbers the kernels line reports) on
# its first ABLATE_REST returns: the plain versions are most of the
# phase's time
ABLATE_REST = 128
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
                 reps: int = 5, n_rest: int = None):
    """K6 (``stream=False``: the cases that gather the fire operand in
    the kernel) or K7 (the streamed ones) against their plain versions
    on the first ``n`` returns of the operands (``n_rest`` for every
    case after the first), bit for bit, with the host replay of each
    walk; each launch's form and table place (or ring) from the layout
    rule; time, plain time and bound of each case, and the device's own
    time of the first. Returns the numbers of the first case, and the
    largest error."""
    from jepsen_tpu_torch.tools import ablate_lane as ab

    B, W, M, S, O1, _R_pad = geom
    ret_all, ops_all, P, PJ, R0 = opnds
    P_np = P.cpu().numpy()
    replays = {}
    out = {"max_abs_err": 0.0}
    kernel = "ablate_stream" if stream else "ablate_walk"
    for name in names:
        fire, proj, counts, unroll, n_pass, cgate = ablate_case(name, W)
        if (proj in ab._STREAM_DTYPE) != stream:
            continue
        m = n if "ms" not in out else (n_rest or n)
        ret, ops, Bm = ret_all[:m], ops_all[:m], min(B, m)
        if stream:
            dt = ab._STREAM_DTYPE[proj]
            G = ab.stream_operand(P, ops, dt)
            args = (ret, G, R0, Bm, n_pass, fire, counts)
            kern, plain = ab.ablate_stream, ab.ablate_stream_plain
            moved = nbytes(ret, G, R0)
            code = ab.design(W, S, O1, counts, stream=True,
                             g_int8=dt == torch.int8)
        else:
            args = (P, ret, ops, PJ, R0, Bm, n_pass, fire, proj, counts,
                    unroll, cgate)
            kern, plain = ab.ablate_walk, ab.ablate_walk_plain
            moved = nbytes(ret, ops, P, R0, *((PJ,) if proj == "matmul"
                                             else ()))
            code = ab.design(W, S, O1, counts, proj == "matmul")
        got = kern(*args)
        ref, p_ms = plain_ms(lambda: plain(*args))
        tag = f"{kernel} [{name}, first {m} returns of {label}]"
        err = same(tag, got, ref)
        ms = event_ms(lambda: kern(*args), reps)
        total = n_pass + sum(cgate)
        if (total, m) not in replays:
            replays[total, m] = walk_work(
                P_np, ret.cpu().numpy()[:, None], ops.cpu().numpy()[:, None],
                as_sets(R0[None]), total)
        work, v, _ = replays[total, m]
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
            f"kernel_ms={ms:.6f} us_per_return={1e3 * ms / m:.6f}{dev} "
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
    from jepsen_tpu_torch.checkers import reach_pallas, reach_word
    from jepsen_tpu_torch.tools import ablate_lane
    from jepsen_tpu_torch.txn import cycles

    return {"lane_walk": reach_lane.KERNEL_LAUNCHES,
            "mega_walk": reach_word.KERNEL_LAUNCHES,
            "word_walk": reach_word.WORD_LAUNCHES,
            "batch_walk": reach_batch.KERNEL_LAUNCHES,
            "keyed_walk": reach_lane.KEYED_LAUNCHES,
            "wide_walk": reach_pallas.KERNEL_LAUNCHES,
            "wide_keyed": reach_pallas.KEYED_LAUNCHES,
            "ablate_walk": ablate_lane.ABLATE_LAUNCHES,
            "ablate_tables": ablate_lane.ABLATE_TABLE_LAUNCHES,
            "ablate_stream": ablate_lane.STREAM_LAUNCHES,
            "txn_closure": cycles.KERNEL_LAUNCHES,
            "txn_inc_join": cycles.INC_JOIN_LAUNCHES}


def zero_launches():
    from jepsen_tpu_torch.checkers import reach_batch, reach_lane
    from jepsen_tpu_torch.checkers import reach_pallas, reach_word
    from jepsen_tpu_torch.tools import ablate_lane
    from jepsen_tpu_torch.txn import cycles

    reach_lane.KERNEL_LAUNCHES = reach_lane.KEYED_LAUNCHES = 0
    reach_word.KERNEL_LAUNCHES = reach_word.WORD_LAUNCHES = 0
    reach_batch.KERNEL_LAUNCHES = 0
    reach_pallas.KERNEL_LAUNCHES = reach_pallas.KEYED_LAUNCHES = 0
    ablate_lane.ABLATE_LAUNCHES = ablate_lane.STREAM_LAUNCHES = 0
    ablate_lane.ABLATE_TABLE_LAUNCHES = 0
    cycles.KERNEL_LAUNCHES = cycles.INC_JOIN_LAUNCHES = 0


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


def check_keyed(label, h, n_keys, bad, cause, cpu=True, **launches):
    """One ``independent`` check of the main path on ``[key, v]``
    history ``h``, on the card with every count zeroed first, then (with
    ``cpu``) on the CPU: the route's cause must be ``cause``, each kernel
    launched as ``launches`` says, the failed keys ``bad``, and every
    key's result equal on both. Returns the launches by kernel."""
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
    if sorted(res["failures"]) != sorted(bad) or res["valid"] is not \
            (not bad) or res["key-count"] != n_keys:
        raise AssertionError(f"{label}: failures {res['failures']}")
    if not cpu:
        log(f"main path {label} ({len(bad)} corrupted): route {cause}, "
            f"valid={res['valid']} failures={len(res['failures'])} "
            f"{dt:.4f} s = {len(h) // 2 / dt:.1f} ops/s; {split(dt, spans)}"
            f"; launches {la}; no CPU run (PERF.md section 4's cuts)")
        return la
    t0 = time.perf_counter()
    ref = check("cpu")
    cpu_s = time.perf_counter() - t0
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


def chain_check(label, fn, expect_valid, expect_engine, cpu=True,
                **launches):
    """One check of the chain on the card (``fn(device)``), held against
    the same check on the CPU (unless ``cpu`` is false: a valid check
    whose corrupted twin takes the same walk on both) and against the
    expected verdict and engine; each named kernel launched as
    ``launches`` says. Returns the card's result and its launches by
    kernel."""
    res, dt, la, spans, ledger, counters = chain_drive(lambda: fn(CARD))
    expect(label, la, **launches)
    cpu_text = "no cpu run (its twin's agrees)"
    if cpu:
        t0 = time.perf_counter()
        ref = fn("cpu")
        cpu_text = f"{time.perf_counter() - t0:.3f} s on cpu, agrees"
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
        f"{ {k: v for k, v in la.items() if v} }; {cpu_text}")
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
    # quotient decides, valid, then corrupted (dead event 562); the CPU
    # runs only the corrupted one (the valid one's took 25 s)
    w33 = gen("register", 2000, 5, 5, crash_p=0.02, values=3)
    chain_check("W=33 register-2000, max_configs 1000",
                lin(models.register(), w33, max_configs=1000), True,
                "frontier-fallback", cpu=False)
    w33_bad = fixtures.corrupt(w33, seed=1)
    res, _ = chain_check("corrupted W=33 register-2000, max_configs 1000",
                         lin(models.register(), w33_bad, max_configs=1000),
                         False, "frontier-fallback")
    if res["dead-event"] != 562:
        raise AssertionError(f"corrupted W=33: dead event "
                             f"{res['dead-event']}, want 562")
    # the reference's scaling row: the dense product, then the rows (the
    # valid rows' walk held against the CPU by its corrupted twin's)
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
                                 "frontier", cpu=quotient or not valid)
            if valid and quotient and res["product-space"] != [4, 16, 63]:
                raise AssertionError(f"{label}: {res['product-space']}")
            if valid and not quotient and res["frontier-cap"] != 2048:
                raise AssertionError(f"{label}: {res['frontier-cap']}")
    # the sparse-live quotient walk (the valid burst of 13 held against
    # the CPU by its corrupted twin's)
    for label, h, kw, valid, cpu in (
            ("same-op bursts 26 x 3, 6 crashed", same_op_burst(ops),
             dict(max_dense=1 << 10), True, True),
            ("burst of 13", burst(ops), dict(max_dense=1 << 18), True,
             False),
            ("corrupted burst of 13", burst(ops, corrupt=True),
             dict(max_dense=1 << 18), False, True)):
        def q(dev, h=h, kw=kw):
            return quotient_check(h, dev, **kw)
        res, _ = chain_check(f"sparse-live {label}", q, valid, None,
                             cpu=cpu)
        if res["walk"] != "sparse-live":
            raise AssertionError(f"{label}: walk {res['walk']}")
    # multi-register: the per-key decomposition on the keyed lanes (the
    # valid one held against the CPU by its corrupted twin's)
    multi8 = gen("multi", 20_000, 5, 3, keys=8, values=5)
    for label, h, valid in (("8 keys x 5 values", multi8, True),
                            ("corrupted 8 keys x 5 values",
                             fixtures.corrupt(multi8, seed=3), False)):
        res, _ = chain_check(f"multi-register-20000 {label}",
                             lin(models.multi_register(), h), valid,
                             "decompose", cpu=not valid, batch_walk=None)
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


# -- the command line: python -m jepsen_tpu_torch check / recheck -------------

ROOT = os.path.dirname(os.path.abspath(__file__))
# sizes of the command-line phase (the CPU rehearsal lowers them)
CLI_BIG_OPS, CLI_SMALL_OPS, CLI_FULL_BASIS_OPS = 100_000, 30_000, 5_000
CLI_RECHECK_N, CLI_RECHECK_BAD = 8, (2, 5)
CLI_VERDICT = ("valid", "op", "dead-event")
CLI_FIXTURES = (("cas-register-ok-small.edn", "cas-register"),
                ("cas-register-ok-large.edn", "cas-register"),
                ("cas-register-bad.edn", "cas-register"),
                ("cas-register-recorded-bad.edn", "cas-register"),
                ("register-ok.edn", "register"),
                ("register-bad.edn", "register"),
                ("mutex-ok.edn", "mutex"),
                ("multi-register-ok.edn", "multi-register"),
                ("multi-register-bad.edn", "multi-register"))
# the child: ``python -m jepsen_tpu_torch`` (runpy, as ``-m`` runs it) with
# every kernel count set to 0 just before and read just after, its wall
# time and its route records, as the last line of its standard error
CLI_CHILD = (
    "import json, runpy, sys, time, torch\n"
    "import chip_smoke\n"
    "from jepsen_tpu_torch import obs\n"
    "sys.argv = ['jepsen_tpu_torch'] + sys.argv[1:]\n"
    "chip_smoke.zero_launches()\n"
    "rc = 0\n"
    "with obs.capture() as cap:\n"
    "    t0 = time.perf_counter()\n"
    "    try:\n"
    "        runpy.run_module('jepsen_tpu_torch', run_name='__main__')\n"
    "    except SystemExit as e:\n"
    "        rc = e.code\n"
    "    if torch.cuda.is_available():\n"
    "        torch.cuda.synchronize()\n"
    "    dt = time.perf_counter() - t0\n"
    "print(json.dumps({'launches': chip_smoke.launches(), 'main_s': dt,\n"
    "                  'ledger': [d for d in cap.ledger if d['stage'] in\n"
    "                             ('reach-chunked', 'competition',\n"
    "                              'recheck')]}), file=sys.stderr)\n"
    "sys.exit(rc)\n")


def cli_args(*args):
    """A command line for the child, on this phase's device."""
    return list(args) + ([] if CARD == "cuda" else ["--device", CARD])


def cli_start(args):
    return subprocess.Popen([sys.executable, "-c", CLI_CHILD, *args],
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def cli_finish(label, proc, t0):
    """Wait for a child: ``(rc, stdout, info)``, ``info`` its launches,
    in-child wall seconds, route records and the process's own wall
    seconds; its launches are added to :data:`MAIN_PATH_LAUNCHES`."""
    out, err = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    try:
        info = json.loads(err.strip().splitlines()[-1])
    except (ValueError, IndexError):
        raise AssertionError(f"cli {label}: exit {proc.returncode}, no "
                             f"result; stderr: {err[-4000:]}") from None
    for name, n in info["launches"].items():
        MAIN_PATH_LAUNCHES[name] = MAIN_PATH_LAUNCHES.get(name, 0) + n
    info["wall_s"] = wall
    return proc.returncode, out, info


def cli_run(label, args):
    t0 = time.perf_counter()
    return cli_finish(label, cli_start(cli_args(*args)), t0)


def cli_same(label, got, want, keys=CLI_VERDICT):
    diff = {k: (want.get(k), got.get(k)) for k in keys
            if k in got and want.get(k) != got.get(k)}
    if diff or got.get("valid") != want.get("valid"):
        raise AssertionError(f"cli {label}: differs from the in-process "
                             f"run {diff or (got, want)}")


def cli_line(label, rc, res, info, extra=""):
    la = {k: v for k, v in info["launches"].items()
          if k in ("lane_walk", "batch_walk", "wide_walk", "txn_closure")}
    log(f"cli {label}: exit {rc} valid={res.get('valid')} engine="
        f"{res.get('engine')} dead-event={res.get('dead-event')}{extra}; "
        f"process {info['wall_s']:.3f} s, command {info['main_s']:.4f} s; "
        f"launches K1 {la['lane_walk']} K2 {la['batch_walk']} K4 "
        f"{la['wide_walk']} K8 {la['txn_closure']}")


def basis_launches(fn):
    """Run ``fn`` with every K2 launch's operands recorded: ``(result,
    [(P, slot_ops, ret_slot_rh, R0, B, n_pass), ...])``."""
    from jepsen_tpu_torch.checkers import reach_batch

    calls, real = [], reach_batch.batch_walk

    def rec(*a):
        calls.append(a)
        return real(*a)

    reach_batch.batch_walk = rec
    try:
        return fn(), calls
    finally:
        reach_batch.batch_walk = real


def basis_vs_plain(label, args):
    """One recorded basis launch of K2 against ``batch_walk_plain`` on
    the same operands, bit for bit, and both timed."""
    from jepsen_tpu_torch.checkers import reach_batch

    *ops, B, n_pass = args
    got = reach_batch.batch_walk(*ops, B, n_pass)
    want, p_ms = plain_ms(lambda: reach_batch.batch_walk_plain(*ops, B,
                                                               n_pass))
    err = same(label, got, want)
    ms = event_ms(lambda: reach_batch.batch_walk(*ops, B, n_pass), 5)
    P, slot_ops, ret_rh, R0 = ops
    W = slot_ops.numel() // ret_rh.numel()
    log(f"kernel batch_walk [{label}] lanes={ret_rh.shape[1]} seed "
        f"groups={R0.shape[0] >> W} rows E*M={R0.shape[0]} steps="
        f"{ret_rh.shape[0]} B={B} n_pass={n_pass}: bit-identical "
        f"max_abs_err={err} kernel_ms={ms:.6f} plain_ms={p_ms:.3f}")


def phase_cli():
    """The command line on the card, each command in a subprocess through
    ``python -m jepsen_tpu_torch`` with no ``--device`` (the card):
    ``check`` on the ``data/`` fixtures (started together), on a cas
    history of :data:`CLI_BIG_OPS` ops written to ``history.jsonl``, and
    on the 6,000-txn lattice history (K8); ``recheck`` of
    :data:`CLI_RECHECK_N` cas histories of :data:`CLI_SMALL_OPS` ops,
    two corrupted (one lockstep batch on K2); ``--algorithm
    reach-chunked`` on the big history, valid and corrupted (K1's forward
    pass, K2's basis walk); ``--algorithm competition`` and ``linear`` on
    the corrupted small one; these seven started together. Each verdict,
    failing op and dead event equals the in-process dense engine's on
    the card. In process, after they end:
    ``reach-chunked`` against ``reach`` on the big history, and K2's
    largest basis launch of a :data:`CLI_SMALL_OPS`-op history and a
    full-basis launch (E = D) held bit for bit against
    ``batch_walk_plain``."""
    import tempfile

    from jepsen_tpu_torch import Linearizable, fixtures, history, models
    from jepsen_tpu_torch.checkers import facade

    t_phase = time.perf_counter()
    cas = models.cas_register()

    def reach(h, model=cas):
        return Linearizable(model, algorithm="reach",
                            device=CARD).check(None, h)

    with tempfile.TemporaryDirectory(prefix="chip-smoke-cli-") as tmp:
        def write(name, h):
            path = os.path.join(tmp, name)
            history.save_jsonl(h, path)
            return path

        # -- the fixtures, started together ------------------------------
        t0 = time.perf_counter()
        procs = [(f, m, cli_start(cli_args(
            "check", os.path.join(ROOT, "data", f), "--model", m)))
            for f, m in CLI_FIXTURES]

        # -- the other commands' inputs and the in-process answers, made
        # while the fixtures' processes start --------------------------
        big = gen("cas", CLI_BIG_OPS, 5, 0)
        big_bad = gen("cas", CLI_BIG_OPS, 5, 0, corrupt=True)
        p_big, p_bad = write("history.jsonl", big), write("bad.jsonl",
                                                          big_bad)
        want_big, want_bad = reach(big), reach(big_bad)
        paths, wants = [], []
        for i in range(CLI_RECHECK_N):
            h = gen("cas", CLI_SMALL_OPS, 5, 2000 + i,
                    corrupt=i in CLI_RECHECK_BAD)
            paths.append(write(f"h{i}.jsonl", h))
            wants.append(reach(h))
        small_bad = gen("cas", CLI_SMALL_OPS, 5, 0, corrupt=True)
        p_small = write("small_bad.jsonl", small_bad)
        want_small = reach(small_bad)
        h = fixtures.gen_txn_history(**TXN_LATTICE)
        h_txn = history.index(h + [op.with_(index=-1) for op in
                                   fixtures.txn_anomaly_block("write-skew")])
        p_txn = write("txn.jsonl", h_txn)
        want_txn = facade.auto_check_txn(h_txn, {"device": CARD})
        for f, m, proc in procs:
            rc, out, info = cli_finish(f, proc, t0)
            res = json.loads(out)
            want = reach(history.load_edn(os.path.join(ROOT, "data", f)),
                         getattr(models, m.replace("-", "_"))())
            # the decomposition reports its failing op per key
            keys = ("valid",) if m == "multi-register" else CLI_VERDICT
            cli_same(f, res, want, keys)
            if rc != (0 if res["valid"] is True else 1):
                raise AssertionError(f"cli {f}: exit {rc} for {res}")
            cli_line(f"check {f}", rc, res, info)
        log(f"cli fixtures: {len(CLI_FIXTURES)} processes at once, "
            f"{time.perf_counter() - t0:.3f} s")

        # -- the commands, started together (each its own process) --------
        commands = (("check big", ["check", p_big]),
                    ("reach-chunked valid", ["check", p_big, "--algorithm",
                                             "reach-chunked"]),
                    ("reach-chunked corrupted", ["check", p_bad,
                                                 "--algorithm",
                                                 "reach-chunked"]),
                    ("recheck", ["recheck", *paths]),
                    ("competition", ["check", p_small, "--algorithm",
                                     "competition"]),
                    ("linear", ["check", p_small, "--algorithm", "linear"]),
                    ("txn", ["check", p_txn]))
        t0 = time.perf_counter()
        started = [(label, cli_start(cli_args(*args)))
                   for label, args in commands]
        ran = {label: cli_finish(label, proc, t0) for label, proc in started}
        ran_s = time.perf_counter() - t0

        rc, out, info = ran["check big"]
        res = json.loads(out)
        cli_same("check big", res, want_big)
        cli_line(f"check cas-{CLI_BIG_OPS} history.jsonl", rc, res, info)
        if CARD == "cuda" and CLI_BIG_OPS >= 100_000:
            expect("cli check cas-100k", info["launches"], batch_walk=2)
        for label, want in (("valid", want_big), ("corrupted", want_bad)):
            rc, out, info = ran[f"reach-chunked {label}"]
            res = json.loads(out)
            cli_same(f"reach-chunked {label}", res, want)
            routes = {d["phase"]: d for d in info["ledger"]
                      if d["stage"] == "reach-chunked"}
            basis = routes.get("basis", {}).get("groups")
            if CARD == "cuda":
                expect(f"cli reach-chunked {label}", info["launches"],
                       lane_walk=1,
                       batch_walk=len(basis) if basis else 0)
            cli_line(f"check cas-{CLI_BIG_OPS} {label} --algorithm "
                     f"reach-chunked", rc, res, info,
                     f" chunks={res.get('chunks')} forward="
                     f"{routes['forward']['engine']} basis groups "
                     f"(chunks, configs)={basis}")

        # -- recheck of several paths: one lockstep batch -----------------
        rc, out, info = ran["recheck"]
        lines = [json.loads(ln) for ln in out.strip().splitlines()]
        for i, (ln, want) in enumerate(zip(lines, wants)):
            cli_same(f"recheck path {i}", ln, want)
        if rc != 1 or len(lines) != CLI_RECHECK_N:
            raise AssertionError(f"cli recheck: exit {rc}, {lines}")
        if CARD == "cuda":
            expect("cli recheck", info["launches"], batch_walk=1,
                   lane_walk=2 * len(CLI_RECHECK_BAD))
        cli_line(f"recheck {CLI_RECHECK_N} x cas-{CLI_SMALL_OPS}, "
                 f"{len(CLI_RECHECK_BAD)} corrupted", rc,
                 {"valid": [ln["valid"] for ln in lines]}, info)

        # -- competition and linear on a corrupted small history ----------
        for algorithm in ("competition", "linear"):
            rc, out, info = ran[algorithm]
            res = json.loads(out)
            cli_same(algorithm, res, want_small)
            extra = ""
            if algorithm == "competition":
                rec = [d for d in info["ledger"]
                       if d["stage"] == "competition"]
                extra = (f" winner={res.get('winner')} losers stopped in "
                         f"{rec[0]['stop_s']:.4f} s")
            cli_line(f"check cas-{CLI_SMALL_OPS} corrupted --algorithm "
                     f"{algorithm}", rc, res, info, extra)

        # -- a txn history: the closure on K8 -----------------------------
        rc, out, info = ran["txn"]
        res = json.loads(out)
        cli_same("txn", res, want_txn, ("valid", "anomalies", "engine"))
        if CARD == "cuda":
            expect_any("cli txn", info["launches"], "txn_closure")
        cli_line(f"check txn {len(h_txn)} ops", rc, res, info,
                 f" anomalies={res.get('anomalies')}")
        log(f"cli commands: {len(commands)} processes at once, "
            f"{ran_s:.3f} s")

        # in process, with no command running: reach-chunked against
        # reach on the big history, and K2's basis launches against their
        # plain version
        def chunked(h):
            return Linearizable(cas, algorithm="reach-chunked",
                                device=CARD).check(None, h)

        res, dt, la, spans, ledger = drive(lambda: chunked(big))
        cli_same("in-process reach-chunked", res, want_big)
        res_r, dt_r, la_r, _, _ = drive(lambda: reach(big))
        groups = [d.get("groups") for d in ledger
                  if d["stage"] == "reach-chunked"
                  and d.get("phase") == "basis"]
        log(f"in-process cas-{CLI_BIG_OPS}: reach-chunked {dt:.4f} s "
            f"(chunks {res['chunks']}, basis groups {groups}, launches "
            f"K1 {la['lane_walk']} K2 {la['batch_walk']}; "
            f"{split(dt, spans)}) against reach {dt_r:.4f} s "
            f"({res_r['engine']}, launches K1 {la_r['lane_walk']} K2 "
            f"{la_r['batch_walk']})")
        # K2's basis launches against their plain version: the largest
        # of a cas history of CLI_SMALL_OPS ops (a third of the big one's
        # steps), and the full basis below
        mid = gen("cas", CLI_SMALL_OPS, 5, 0)
        (res, calls) = basis_launches(lambda: chunked(mid))
        cli_same("mid basis", res, reach(mid))
        if calls and CARD == "cuda":
            basis_vs_plain(f"cas-{CLI_SMALL_OPS} largest basis launch",
                           max(calls, key=lambda a: a[3].numel()))
        full = gen("cas", CLI_FULL_BASIS_OPS, 5, 7)
        (res, calls) = basis_launches(lambda: chunked(full))
        cli_same("full basis", res, reach(full))
        E_M = max(a[3].shape[0] for a in calls)
        log(f"in-process cas-{CLI_FULL_BASIS_OPS}: reach-chunked "
            f"valid={res['valid']} chunks={res['chunks']}, full basis: "
            f"E*M = {E_M} rows")
        if CARD == "cuda":
            basis_vs_plain(f"cas-{CLI_FULL_BASIS_OPS} full basis",
                           max(calls, key=lambda a: a[3].numel()))
    log(f"cli phase: {time.perf_counter() - t_phase:.1f} s")


# -- the test runner (python -m jepsen_tpu_torch run) -----------------------

# the README's command: 5 nodes, concurrency 5, the partition nemesis
RUN_TIME_LIMIT, RUN_SEED = 2.0, 7
RUN_SPANS = ("run.setup", "run.workers", "run.teardown", "run.check",
             "run.store")
RUN_FILES = ("test.json", "results.json", "results.edn", "history.jsonl",
             "history.edn", "history.txt", "jepsen.log", "timeline.html",
             "obs.jsonl", "trace.json")


def run_dir_files(label, d, invalid):
    """The reference's run-dir files, the charts or their skip, and
    ``linear.svg`` on an invalid verdict; returns how the charts went."""
    res = json.load(open(os.path.join(d, "results.json")))
    want = list(RUN_FILES) + (["linear.svg"] if invalid else [])
    charts = []
    for name, png in (("latency", "latency-raw.png"), ("rate", "rate.png")):
        r = res["results"][name]
        if r.get("skipped") == "matplotlib not installed":
            charts.append(f"{name} skipped (no matplotlib)")
        else:
            want.append(png)
            charts.append(f"{name} {png}")
    missing = [f for f in want if not os.path.exists(os.path.join(d, f))]
    if missing:
        raise AssertionError(f"run {label}: {d} lacks {missing}")
    return ", ".join(charts)


def run_route(label, ledger, la, invalid):
    """The route record of the run's check, and its launches by route:
    chunk-lockstep (two K2 launches; K1 on the dead chunk and the
    witness when invalid) from ``MIN_RETURNS`` returns, else K1."""
    routes = [r for r in ledger if r["stage"] == "reach"
              and r["event"] == "route"]
    if len(routes) != 1:
        raise AssertionError(f"run {label}: routes {routes}")
    route = routes[0]
    if route["engine"] == "reach-chunklock":
        expect(f"run {label}", la, batch_walk=2)
    elif route["engine"] == "reach-lane":
        expect(f"run {label}", la, batch_walk=0)
    else:
        raise AssertionError(f"run {label}: route {route}")
    expect(f"run {label}", la, lane_walk=2 if invalid else
           (1 if route["engine"] == "reach-lane" else 0), keyed_walk=0,
           wide_walk=0, wide_keyed=0)
    return route


def run_line(label, done, dt, la, spans, route, returns):
    n = len(done["history"])
    walls = ", ".join(f"{k} {spans.get(k, 0.0):.4f} s" for k in RUN_SPANS)
    check = spans.get("run.check", 0.0)
    split_ = ", ".join(f"{k} {spans.get(v, 0.0):.4f} s" for k, v in (
        ("pack", "facade.pack"), ("prep", "reach.prep"),
        ("returns-view", "reach.returns-view"), ("walk", "reach.walk"),
        ("witness", "reach.witness")))
    infos = sum(1 for op in done["history"]
                if op.type == "info" and op.process != "nemesis")
    log(f"run {label}: valid={done['results']['valid']} ops={n} "
        f"returns={returns} info={infos} W={route['slots']} route "
        f"{route['engine']} (states {route['states']}); workers "
        f"{n / spans['run.workers']:.1f} ops/s; spans {walls}; check "
        f"{check:.4f} s: {split_}; wall {dt:.4f} s; launches "
        f"{ {k: v for k, v in la.items() if v} }")


def phase_run():
    """The test runner on the card, at the README command's width (5
    nodes, concurrency 5, the partition nemesis, :data:`RUN_TIME_LIMIT`
    seconds). In process: ``core.run(register_test(...))`` in
    linearizable mode (valid; the same verdict from ``wgl-native``, the
    host C++ search, on the same history) and in sloppy mode (invalid;
    failing op and dead event equal the port's CPU dense engine on the
    same history, ``wgl-native`` agrees, ``linear.svg`` written), each
    with its route and launches; ``independent_test()`` at its defaults,
    key by key against its CPU run. Then three command lines, each in
    its own process: ``run --mode sloppy`` (exit 1, the run dir's
    files) and ``run`` (exit 0), started together, then ``recheck`` of
    the sloppy run's dir (exit 1, the same failing op)."""
    import tempfile

    from jepsen_tpu_torch import Linearizable, core, history, models, obs
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checkers import reach_chunklock
    from jepsen_tpu_torch.suites import register

    t_phase = time.perf_counter()
    cas = models.cas_register()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-run-") as tmp:
        for mode in ("linearizable", "sloppy"):
            t = register.register_test(mode=mode, time_limit=RUN_TIME_LIMIT,
                                       seed=RUN_SEED, store=True)
            t["store-root"] = os.path.join(tmp, "in-process")
            with obs.capture() as cap:
                done, dt, la, spans, ledger = drive(lambda: core.run(t))
            invalid = mode == "sloppy"
            res = done["results"]
            lin = res["results"]["linear"]
            if res["valid"] is not (not invalid) or \
                    lin["valid"] is not (not invalid):
                raise AssertionError(f"run {mode}: {res['valid']} {lin}")
            route = run_route(mode, ledger, la, invalid)
            returns = [s["args"]["returns"] for s in cap.spans
                       if s["name"] == "reach.walk"][0]
            if (route["engine"] == "reach-chunklock") != (
                    returns >= reach_chunklock.MIN_RETURNS):
                raise AssertionError(f"run {mode}: {returns} returns took "
                                     f"{route['engine']}")
            run_line(f"in process {mode}", done, dt, la, spans, route,
                     returns)
            h = done["history"]
            t0 = time.perf_counter()
            wgl = Linearizable(cas, algorithm="wgl-native").check(None, h)
            wgl_s = time.perf_counter() - t0
            if wgl["valid"] is not lin["valid"]:
                raise AssertionError(f"run {mode}: wgl-native {wgl}")
            extra = ""
            if invalid:
                # the port's dense engine on the CPU: the lane walk's
                # plain version (the abort hook keeps it off
                # chunk-lockstep), which stops after the dead segment
                t0 = time.perf_counter()
                ref = Linearizable(cas, algorithm="reach", device="cpu",
                                   opts={"should_abort": lambda: False}
                                   ).check(None, h)
                cpu_s = time.perf_counter() - t0
                same_result(f"run {mode}", lin, ref, ("valid", "op",
                                                      "dead-event"))
                if not os.path.exists(lin.get("report-file", "")):
                    raise AssertionError(f"run {mode}: no linear.svg")
                extra = (f"; failing op index {lin['op']['index']} dead "
                         f"event {lin['dead-event']}, as the CPU dense "
                         f"engine finds them ({cpu_s:.3f} s)")
            charts = run_dir_files(mode, done["dir"], invalid)
            log(f"run in process {mode}: wgl-native valid={wgl['valid']} "
                f"({wgl_s:.3f} s){extra}; {charts}")

        # -- independent_test() at its defaults ---------------------------
        t = register.independent_test()
        with obs.capture() as cap:
            done, dt, la, spans, ledger = drive(lambda: core.run(t))
        res = done["results"]
        causes = [r.get("cause") for r in ledger
                  if r["stage"] == "reach-many" and r["event"] == "route"]
        if causes not in (["lockstep"], ["keyed"]):
            raise AssertionError(f"run independent: routes {causes}")
        expect_any("run independent", la, "batch_walk", "keyed_walk")
        ref = independent.checker(Linearizable(cas, device="cpu")).check(
            None, done["history"])
        if res["key-count"] != 8 or res["valid"] is not True:
            raise AssertionError(f"run independent: {res['valid']} "
                                 f"{res['key-count']} {res['failures']}")
        for key in ("valid", "failures", "key-count"):
            if res[key] != ref[key]:
                raise AssertionError(f"run independent: {key} differs")
        for k, r in res["results"].items():
            same_result(f"run independent key {k}", r, ref["results"][k],
                        ("valid", "engine", "op", "dead-event",
                         "final-configs", "previous-ok"))
        log(f"run in process independent: valid={res['valid']} key-count="
            f"{res['key-count']} ops={len(done['history'])} route "
            f"{causes[0]}; spans "
            f"{', '.join(f'{k} {spans.get(k, 0.0):.4f} s' for k in RUN_SPANS)}"
            f"; wall {dt:.4f} s; launches "
            f"{ {k: v for k, v in la.items() if v} }; every key agrees "
            f"with the CPU run")

        # -- the command line, each in its own process (both runs started
        # together, then the recheck) ------------------------------------
        root = os.path.join(tmp, "cli")
        runs = {}
        t0 = time.perf_counter()
        started = {mode: cli_start(cli_args(
            "run", "--suite", "register", "--time-limit",
            str(RUN_TIME_LIMIT), "--store-root", os.path.join(root, mode),
            "--mode", mode)) for mode in ("sloppy", "linearizable")}
        for mode, rc_want in (("sloppy", 1), ("linearizable", 0)):
            rc, out, info = cli_finish(f"run {mode}", started[mode], t0)
            line = json.loads(out.strip().splitlines()[-1])
            if rc != rc_want or line["valid"] is not (rc_want == 0):
                raise AssertionError(f"cli run {mode}: exit {rc} {line}")
            charts = run_dir_files(f"cli {mode}", line["dir"], rc_want == 1)
            runs[mode] = line
            la = info["launches"]
            log(f"cli run --mode {mode}: exit {rc} valid={line['valid']} "
                f"ops={line['ops']}; process {info['wall_s']:.3f} s, "
                f"command {info['main_s']:.4f} s; launches K1 "
                f"{la['lane_walk']} K2 {la['batch_walk']}; {charts}")
            if mode == "sloppy":
                stored = json.load(open(os.path.join(
                    line["dir"], "results.json")))["results"]["linear"]
                rc, out, info = cli_run("recheck", cli_args(
                    "recheck", line["dir"]))
                res = json.loads(out)
                cli_same("recheck of the sloppy run", res, stored)
                if rc != 1 or res["op"] != stored["op"]:
                    raise AssertionError(f"cli recheck: exit {rc} {res}")
                cli_line("recheck of the sloppy run dir", rc, res, info)
    log(f"run phase: {time.perf_counter() - t_phase:.1f} s")



# -- the other suites of run ---------------------------------------------------

# each suite at its builder's defaults (5 nodes, concurrency 5, its own
# nemesis, SUITE_TIME_LIMIT seconds), seed RUN_SEED
SUITE_TIME_LIMIT = 2.0
# the sub-checkers that judge the system (the others draw and count)
SUITE_VERDICTS = ("linear", "set", "counter", "queue", "total-queue", "txn")
SUITE_TXN_KEYS = ("valid", "anomalies", "edge-counts", "txns")


def split_halves(cluster):
    """The reference tests' permanent partition {n1, n2} | {n3, n4, n5},
    installed before a sloppy run so that both sides serve it."""
    for a in ("n1", "n2"):
        for b in ("n3", "n4", "n5"):
            cluster.drop_link(a, b)
            cluster.drop_link(b, a)


def suite_cases():
    """``(label, build, model, verdict, kernel)`` for :func:`phase_suites`:
    ``build()`` makes the test map (the check on the card), ``model`` is
    the ``linear`` check's model (``"txn"`` for the txn check, None where
    the test map has no device check), ``verdict`` the verdict the run
    must reach (None: held only against the other engines) and
    ``kernel`` the kernel its check must launch (a txn check launches K8
    when its graph has edges)."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.suites import (counter, etcd, mutex, queue, redis,
                                         set_suite, txn)

    kw = dict(time_limit=SUITE_TIME_LIMIT, seed=RUN_SEED)

    def partitioned_mutex():
        t = mutex.mutex_test(mode="sloppy", with_nemesis=False, **kw)
        split_halves(t["cluster"])
        return t

    cas = models.cas_register()
    return [
        ("mutex linearizable", lambda: mutex.mutex_test(**kw),
         models.mutex(), True, "lane_walk"),
        ("mutex sloppy, partitioned", partitioned_mutex, models.mutex(),
         False, "lane_walk"),
        ("set linearizable", lambda: set_suite.set_test(**kw),
         models.bounded_set(12), True, None),
        ("set sloppy", lambda: set_suite.set_test(mode="sloppy", **kw),
         models.bounded_set(12), None, None),
        ("counter linearizable", lambda: counter.counter_test(**kw), None,
         True, None),
        ("counter sloppy", lambda: counter.counter_test(mode="sloppy", **kw),
         None, None, None),
        ("queue safe", lambda: queue.queue_test(**kw), None, True, None),
        ("queue safe universe=6", lambda: queue.queue_test(universe=6, **kw),
         models.bounded_queue(6), True, None),
        ("etcd linearizable", lambda: etcd.etcd_test(**kw), cas, True,
         "lane_walk"),
        ("etcd sloppy", lambda: etcd.etcd_test(mode="sloppy", **kw), cas,
         None, "lane_walk"),
        ("redis linearizable", lambda: redis.redis_test(**kw), cas, True,
         "lane_walk"),
        ("redis sloppy", lambda: redis.redis_test(mode="sloppy", **kw), cas,
         None, "lane_walk"),
        ("txn fake linearizable", lambda: txn.txn_test(**kw), "txn", True,
         None),
        ("txn fake sloppy", lambda: txn.txn_test(mode="sloppy", **kw), "txn",
         None, None),
    ]


def suite_linear(label, lin, h, model, ledger):
    """A suite's ``linear`` result against ``wgl-native`` on the same
    history, and an invalid one against the port's CPU dense engine
    (failing op and dead event); returns the route's text."""
    from jepsen_tpu_torch import Linearizable

    routes = [r for r in ledger if r["stage"] == "reach"
              and r["event"] == "route"]
    if len(routes) != 1:
        raise AssertionError(f"suite {label}: routes {routes}")
    route = routes[0]
    t0 = time.perf_counter()
    wgl = Linearizable(model, algorithm="wgl-native").check(None, h)
    wgl_s = time.perf_counter() - t0
    if wgl["valid"] is not lin["valid"]:
        raise AssertionError(f"suite {label}: wgl-native {wgl['valid']}, "
                             f"the card {lin['valid']}")
    text = (f"route {route['engine']} (states {route['states']}, slots "
            f"{route['slots']}), engine {lin.get('engine')}; wgl-native "
            f"agrees ({wgl_s:.3f} s)")
    if lin["valid"] is False:
        t0 = time.perf_counter()
        ref = Linearizable(model, algorithm="reach", device="cpu",
                           opts={"should_abort": lambda: False}
                           ).check(None, h)
        same_result(f"suite {label}", lin, ref, ("valid", "op",
                                                 "dead-event"))
        text += (f"; failing op index {lin['op']['index']} dead event "
                 f"{lin['dead-event']}, as the CPU dense engine finds them "
                 f"({time.perf_counter() - t0:.3f} s)")
    return text


def phase_suites():
    """The other suites of ``run`` on the card, in process, each at its
    builder's defaults (:func:`suite_cases`): mutex (linearizable, and
    sloppy under a permanent partition: invalid), set, counter, queue
    (safe, and at ``universe=6``), etcd over HTTP, redis over RESP and
    the list-append ``txn_test`` on the fake tier, in both modes. Each
    ``linear`` result is held against ``wgl-native`` (and an invalid one
    against the port's CPU dense engine), each ``txn`` result against
    the host SCC on the same history; the kernels the checks must take
    launched (K1 for mutex, etcd and redis, K8 for every txn graph with
    edges), the set's and the queue's route recorded. Then ``run --suite
    queue --mode sloppy`` (the broker's ``lossy``) and ``run --suite
    mutex``, each in its own process, started together."""
    import tempfile

    from jepsen_tpu_torch import core, txn

    t_phase = time.perf_counter()
    for label, build, model, verdict, kernel in suite_cases():
        t = build()
        done, dt, la, spans, ledger = drive(lambda: core.run(t))
        res, h = done["results"], done["history"]
        subs = res["results"]
        judged = {k: subs[k]["valid"] for k in SUITE_VERDICTS if k in subs}
        if verdict is True and not all(v is True for v in judged.values()):
            raise AssertionError(f"suite {label}: {judged}")
        if model == "txn":
            r = subs["txn"]
            t0 = time.perf_counter()
            host = txn.check_history(h, force_host=True)
            same_txn(f"suite {label}", r, host, SUITE_TXN_KEYS)
            if r["edges"]:
                expect(f"suite {label}", la, txn_closure=None)
            text = (f"txn {r['engine']}: {r['txns']} txns, {r['edges']} "
                    f"edges {r['edge-counts']}, anomalies "
                    f"{r.get('anomalies')}; the host SCC agrees "
                    f"({time.perf_counter() - t0:.3f} s)")
        elif model is not None:
            lin = subs["linear"]
            if verdict is False and lin["valid"] is not False:
                raise AssertionError(f"suite {label}: {lin}")
            text = suite_linear(label, lin, h, model, ledger)
        else:
            text = "no device check (host checkers only)"
        if kernel is not None:
            expect(f"suite {label}", la, **{kernel: None})
        workers = spans["run.workers"]
        walls = ", ".join(f"{k} {spans.get(k, 0.0):.4f} s" for k in RUN_SPANS
                          if k in spans)
        infos = sum(1 for op in h
                    if op.type == "info" and op.process != "nemesis")
        log(f"suite {label}: valid={res['valid']} "
            f"{ {k: v.get('valid') for k, v in subs.items()} } ops={len(h)} "
            f"info={infos}; workers {len(h) / workers:.1f} ops/s; spans "
            f"{walls}; wall {dt:.4f} s; {text}; launches "
            f"{ {k: v for k, v in la.items() if v} }")

    with tempfile.TemporaryDirectory(prefix="chip-smoke-suites-") as tmp:
        commands = ((["--suite", "queue", "--mode", "sloppy"],
                     "queue-lossy"),
                    (["--suite", "mutex"], "mutex-linearizable"))
        t0 = time.perf_counter()
        started = [cli_start(cli_args(
            "run", *args, "--time-limit", str(SUITE_TIME_LIMIT), "--seed",
            str(RUN_SEED), "--store-root", os.path.join(tmp, name)))
            for args, name in commands]
        for (args, name), proc in zip(commands, started):
            rc, out, info = cli_finish(f"run {' '.join(args)}", proc, t0)
            line = json.loads(out.strip().splitlines()[-1])
            stored = json.load(open(os.path.join(line["dir"],
                                                 "results.json")))
            judged = {k: stored["results"][k]["valid"]
                      for k in SUITE_VERDICTS if k in stored["results"]}
            la = info["launches"]
            if line["name"] != name or rc != (0 if line["valid"] is True
                                              else 1) or \
                    stored["valid"] is not line["valid"] or \
                    line["valid"] is not all(
                        v is True for v in judged.values()):
                raise AssertionError(f"cli run {args}: exit {rc} {line} "
                                     f"{judged}")
            if name.startswith("mutex"):
                if line["valid"] is not True:
                    raise AssertionError(f"cli run {args}: {line}")
                expect(f"cli run {args}", la, lane_walk=None)
            log(f"cli run {' '.join(args)}: exit {rc} name={line['name']} "
                f"valid={line['valid']} {judged} ops={line['ops']}; process "
                f"{info['wall_s']:.3f} s, command {info['main_s']:.4f} s; "
                f"launches K1 {la['lane_walk']} K2 {la['batch_walk']} K4 "
                f"{la['wide_walk']}")
    log(f"suites phase: {time.perf_counter() - t_phase:.1f} s")


# -- online checking: run --online, the streaming monitor ---------------------

# online-opts of the phase's runs: the reference's test cadence
ONLINE_OPTS = {"interval_s": 0.3, "min_new_ops": 64}
# the violation dict's keys that a replay of the stored prefix must give
ONLINE_KEYS = ("valid", "engine", "op", "settled-returns")


def online_replay(hist, found):
    """The monitor's violation ``found``, from a fresh
    ``NativeStreamEngine`` fed the stored history's detected prefix on
    the host at once: the settled walk does not depend on the flush
    boundaries, so its advance and its tail alarm at the prefix's end
    give the monitor's detection (or, when the monitor found it at its
    final flush, the run-over advance)."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checkers import online

    eng = online.NativeStreamEngine(models.cas_register())
    eng.feed_many(hist[:found["prefix-ops"]])
    return eng.advance() or eng.tail_alarm() or eng.advance(run_over=True)


# -- the check daemon ----------------------------------------------------------

# phase_serve's traffic: SERVE_N cas histories of SERVE_OPS ops (seeds 0
# to SERVE_N - 1, every eighth corrupted) POSTed by SERVE_TENANTS tenant
# threads, SERVE_CHUNK a worker task; SERVE_RERUN of them again at each
# pipeline window; a group of SERVE_WIDE_N wide multi-register histories
# of SERVE_WIDE_OPS ops queued before the lanes start (one K5 group).
# The HTTP threads' admission (parse, pack, the journal's EDN copy of
# the history) and the lane's host work share the interpreter lock, which
# bounds the daemon at about 2 requests/s of this traffic: 256 requests
# take some 115 s, so the full run's depth is cut to SERVE_N and
# SERVE_RERUN; ``--serve 256`` runs the phase alone at that traffic
# (PERF.md sections 5 and 6)
SERVE_N, SERVE_OPS, SERVE_TENANTS, SERVE_CHUNK = 24, (2_000, 10_000), 8, 8
SERVE_RERUN = 4
SERVE_WIDE_N, SERVE_WIDE_OPS = 8, 5_000
# the `check` command's time on cas-100k (PERF.md section 5)
CHECK_COMMAND_S = 5.4661
SERVE_KEYS = ("valid", "op", "dead-event", "max-linearized",
              "final-configs", "previous-ok")
# the route each singleton takes from inside the daemon: cas-100k on
# chunk-lockstep (two K2 launches), cas-30k on K1, the wide cas-100k on K4
SERVE_ROUTES = {"cas-100k": "reach-chunklock", "cas-30k": "reach-lane",
                "wide cas-100k": "reach-pallas"}
# the host time of the daemon's parts (seconds, summed over the run):
# admission on the HTTP threads, the lane's stage, collect, blocking
# checks, publish and stats file
SERVE_HOST = ("serve.admit.parse_s", "serve.admit.pack_s",
              "serve.admit.journal_s", "serve.lane.stage_s",
              "lockstep.union_prep_s", "lockstep.marshal_s",
              "serve.lane.collect_s", "lockstep.fetch_s",
              "lockstep.results_s", "serve.lane.check_s",
              "serve.lane.publish_s", "serve.lane.stats_s")


def gen_to_file(path, *args):
    """A worker task: :func:`gen` ``(*args)`` pickled into ``path`` (the
    main process loads it where it is used: a result handed back through
    the pool would be unpickled on the pool's thread, holding the
    interpreter lock while the kernel phases run)."""
    import pickle

    with open(path, "wb") as f:
        pickle.dump(gen(*args), f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


def load_pickle(path):
    import pickle

    with open(path, "rb") as f:
        out = pickle.load(f)
    os.unlink(path)
    return out


def serve_ops(seed: int, lo: int, hi: int) -> int:
    """The length of the serve phase's history ``seed``: spread over
    ``[lo, hi]``."""
    return lo + (seed * 7_919) % (hi - lo + 1)


def serve_bodies(seeds, lo: int, hi: int, tenants: int):
    """A worker task: the serve phase's cas histories ``seeds``, each as
    ``(seed, its POST body, its packed history)``."""
    from jepsen_tpu_torch import history

    out = []
    for s in seeds:
        h = gen("cas", serve_ops(s, lo, hi), 5, s, corrupt=s % 8 == 7)
        body = json.dumps({"model": "cas-register",
                           "tenant": f"tenant-{s % tenants}",
                           "history": [o.to_dict() for o in h]}).encode()
        out.append((s, body, history.pack(h)))
    return out


def serve_submit():
    """Start generating the serve phase's traffic in the pool."""
    return [pool().submit(serve_bodies, range(i, min(i + SERVE_CHUNK,
                                                     SERVE_N)),
                          *SERVE_OPS, SERVE_TENANTS)
            for i in range(0, SERVE_N, SERVE_CHUNK)]


def http_json(url, method="GET", body=None, ctype="application/json"):
    """``(status, parsed body)`` of one request to the daemon."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve_wait(url, ids, timeout=600.0):
    """Poll ``GET /check/<id>`` until each request is terminal: ``{id:
    (status code, body)}`` and when the last one was seen done."""
    out, pending = {}, list(ids)
    end = time.monotonic() + timeout
    while pending:
        if time.monotonic() > end:
            raise AssertionError(f"serve: {len(pending)} requests never "
                                 f"finished")
        rest = []
        for rid in pending:
            code, st = http_json(f"{url}/check/{rid}")
            if st.get("status") in ("queued", "dispatched"):
                rest.append(rid)
            else:
                out[rid] = (code, st)
        pending = rest
        if pending:
            time.sleep(0.02)
    return out, time.perf_counter()


def serve_post_all(url, bodies):
    """POST ``bodies`` (``(key, bytes, content type)``) from
    :data:`SERVE_TENANTS` threads, body i on thread i mod the tenants,
    each retried after its ``Retry-After`` on a 429: ``{key: id}``, the
    first POST's time and the 429s."""
    import threading

    ids, errs, t_first, n429 = {}, [], [], [0]
    lock = threading.Lock()

    def tenant(t):
        try:
            for key, body, ctype in bodies[t::SERVE_TENANTS]:
                with lock:
                    if not t_first:
                        t_first.append(time.perf_counter())
                code, resp = http_json(f"{url}/check", "POST", body, ctype)
                while code == 429:
                    with lock:
                        n429[0] += 1
                    time.sleep(float(resp.get("retry-after-s", 1.0)))
                    code, resp = http_json(f"{url}/check", "POST", body,
                                           ctype)
                if code != 202:
                    raise AssertionError(f"serve POST {key}: {code} {resp}")
                ids[key] = resp["id"]
        except Exception as e:                          # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=tenant, args=(t,))
               for t in range(SERVE_TENANTS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errs:
        raise errs[0]
    return ids, t_first[0], n429[0]


def serve_norm(res, keys=SERVE_KEYS):
    """A result's verdict fields as JSON would carry them (the witness
    configs sorted)."""
    out = {}
    for k in keys:
        v = res.get(k)
        if k == "final-configs" and v is not None:
            v = sorted(json.dumps(c, sort_keys=True, default=str) for c in v)
        out[k] = json.loads(json.dumps(v, sort_keys=True, default=str))
    return out


def serve_process(root):
    """``python -m jepsen_tpu_torch check-serve --port 0`` on ``root``:
    ``(process, base url)`` once its first line names its port."""
    os.makedirs(root, exist_ok=True)
    err = open(os.path.join(root, "check-serve.stderr"), "a")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch",
         *cli_args("check-serve", "--port", "0", "--store-root", root)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    return proc


def serve_process_url(proc):
    line = proc.stdout.readline()
    m = re.search(r"http://([^/]+)/", line)
    if m is None:
        proc.kill()
        raise AssertionError(f"check-serve: first line {line!r}")
    return f"http://{m.group(1)}"


def serve_process_stop(label, proc):
    """SIGTERM, then exit 0 with the clean-shutdown line last."""
    import signal

    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    last = json.loads(out.strip().splitlines()[-1])
    if proc.returncode != 0 or last.get("shutdown") != "clean":
        raise AssertionError(f"check-serve {label}: exit {proc.returncode}"
                             f" {last.get('shutdown')}")
    return last


def phase_serve(singles, futures):
    """The check daemon on the card (:class:`serve.Daemon` in process,
    the defaults: group 32, one lane, ``pipeline_k`` 4): the serve
    phase's cas histories (``futures``, from the pool) and ``singles``
    (cas-100k on chunk-lockstep, cas-30k on K1, wide cas-100k on K4, the
    6,003-txn history on K8) POSTed by :data:`SERVE_TENANTS` tenant
    threads over loopback, after a group of wide multi-register
    histories queued before the lanes start (K5); cas-100k last, alone
    on the idle daemon. Every verdict against
    the standalone chain on the card, the invalid ones' verdict against
    ``wgl-native``; no result degraded or an error, no retry, no breaker
    route to the host, no device fault, groups staged, and K1, K2, K4,
    K5 and K8 launched from inside the daemon. Then SERVE_RERUN of the
    cas requests at ``pipeline_k`` 1 and 4 (the same verdicts), and a
    ``check-serve`` process: four requests (a profiler capture of its
    first dispatch), SIGTERM (exit 0), a restart
    on its store root that replays nothing and answers from its
    journal."""
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-serve-")
    procs = []
    try:
        serve_body(singles, futures, tmp, procs, t_phase)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    log(f"serve phase: {time.perf_counter() - t_phase:.1f} s")


def serve_body(singles, futures, tmp, procs, t_phase):
    """:func:`phase_serve`'s checks; the processes it starts go into
    ``procs``."""
    from jepsen_tpu_torch import history, models, obs, serve
    from jepsen_tpu_torch.checkers import facade, wgl_native
    from jepsen_tpu_torch.serve.http import parse_check_body

    dev = None if CARD == "cuda" else CARD
    # the daemon passes an abort hook to every check; the standalone
    # chain gets one too, so that both take the same route
    kw = {"device": CARD, "should_abort": lambda: False}

    def at():
        return f" [{time.perf_counter() - t_phase:.1f} s into the phase]"
    proc = serve_process(os.path.join(tmp, "process"))
    procs.append(proc)
    traffic = [x for f in futures for x in f.result()]
    log(f"serve traffic: {len(traffic)} cas histories of {SERVE_OPS[0]}-"
        f"{SERVE_OPS[1]} ops, generated by worker processes, waited "
        f"{time.perf_counter() - t_phase:.2f} s for them")
    # JSON turns the multi-register values' integer keys into strings
    # (EDN would keep them, at 1.2 s a parse): the standalone chain checks
    # the histories as the daemon reads them
    wide_bodies = [json.dumps({
        "model": "multi-register", "tenant": f"tenant-{i}",
        "history": [o.to_dict() for o in gen(
            "multi", SERVE_WIDE_OPS, 5, 100 + i, corrupt=i == 3,
            **WIDE_MULTI)]}).encode() for i in range(SERVE_WIDE_N)]
    # the wide cas-100k names the engines' default max_states: the same
    # walk, and an option set of its own, so that it does not coalesce
    # with the cas-100k of the same length (requests coalesce by model,
    # options and length)
    opts = {"wide cas-100k": {"max_states": 100_000}}
    singles_body = {name: json.dumps({
        "model": model, "tenant": "tenant-big", "options": opts.get(name, {}),
        "history": [o.to_dict() for o in h]}).encode()
        for name, (model, h) in singles.items()}

    d = serve.Daemon(port=0, store_root=os.path.join(tmp, "in-process"),
                     device=dev)
    d.start(dispatch=False)
    url = f"http://127.0.0.1:{d.port}"
    # queued before the lanes start, so that they coalesce into one
    # group; POST /profile: torch.profiler around the first dispatch
    wide_ids = {f"wide-{i}": http_json(f"{url}/check", "POST", b)[1]["id"]
                for i, b in enumerate(wide_bodies)}
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    c0, h0 = obs.counters(), obs.histograms()
    t0 = time.perf_counter()
    d.dispatcher.start()
    warm_s = time.perf_counter() - t0
    bodies = [(name, b, "application/json")
              for name, b in singles_body.items() if name != "cas-100k"]
    bodies += [(s, b, "application/json") for s, b, _p in traffic]
    ids, t_first, n429 = serve_post_all(url, bodies)
    ids.update(wide_ids)
    done, t_last = serve_wait(url, ids.values())
    # cas-100k alone on the idle daemon: parse, pack and check
    t_big = time.perf_counter()
    code, resp = http_json(f"{url}/check", "POST", singles_body["cas-100k"])
    ids["cas-100k"] = resp["id"]
    big_done, t_big1 = serve_wait(url, [resp["id"]])
    done.update(big_done)
    torch.cuda.synchronize()
    la = launches()
    c1, h1 = obs.counters(), obs.histograms()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    for name, n in la.items():
        MAIN_PATH_LAUNCHES[name] = MAIN_PATH_LAUNCHES.get(name, 0) + n
    expect("serve", la, lane_walk=None, batch_walk=None, wide_walk=None,
           wide_keyed=None, txn_closure=None)
    delta = {k: c1.get(k, 0) - c0.get(k, 0) for k in set(c1) | set(c0)}
    for key in ("serve.retry.attempts", "serve.breaker.degraded_dispatches",
                "serve.device_faults", "serve.errors"):
        if delta.get(key, 0):
            raise AssertionError(f"serve: {key} = {delta[key]}")
    if delta.get("pipeline.staged", 0) < 1:
        raise AssertionError(f"serve: no group staged {delta}")
    res = {}
    for key, rid in ids.items():
        code, st = done[rid]
        if code != 200 or st["status"] != "done"                 or st["result"].get("degraded"):
            raise AssertionError(f"serve {key}: {code} {st.get('status')} "
                                 f"{st.get('result')}")
        res[key] = st
    d.shutdown()
    log(f"serve traffic done{at()}")

    # the standalone chain on the card, and wgl-native for the invalid
    std = dict(zip([s for s, _b, _p in traffic],
                   facade.auto_check_many_packed(
                       models.cas_register(), [p for _s, _b, p in traffic],
                       kw)))
    for name, r in zip(wide_ids, facade.auto_check_many_packed(
            models.multi_register(), [history.pack(parse_check_body(
                b, "application/json")[2]) for b in wide_bodies], kw)):
        std[name] = r
    txn_keys = ("valid", "anomalies", "anomaly", "witness", "edges",
                "edge-counts", "txns")
    for name, (model, h) in singles.items():
        if model == "txn-list-append":
            std[name] = facade.auto_check_txn(h, kw)
        else:
            std[name] = facade.auto_check_packed(
                getattr(models, model.replace("-", "_"))(), history.pack(h),
                dict(kw, **opts.get(name, {})))
    n_bad = n_same_op = 0
    for key, st in res.items():
        keys = txn_keys if key == "txn" else SERVE_KEYS
        if not isinstance(key, int):
            # a singleton's or the wide group's route is the standalone
            # chain's; the cas traffic's groups depend on its timing
            keys += ("engine",)
        got, want = serve_norm(st["result"], keys), serve_norm(std[key],
                                                                keys)
        if got != want:
            raise AssertionError(f"serve {key}: the daemon's {got} differs "
                                 f"from the standalone chain's {want}")
        if st["result"]["valid"] is False and key in std \
                and isinstance(key, int):
            n_bad += 1
            p = traffic[key][2]
            # wgl-native's verdict; its op is the one its search could
            # not place, the dense engine's the return that empties the
            # set, so they may differ (counted, as phase_run does)
            w = wgl_native.check_packed(models.cas_register(), p)
            if w["valid"] is not False:
                raise AssertionError(f"serve {key}: wgl-native {w}")
            n_same_op += serve_norm(w, ("op",)) == serve_norm(
                st["result"], ("op",))
    if n_bad != sum(1 for s, _b, _p in traffic if s % 8 == 7):
        raise AssertionError(f"serve: {n_bad} invalid cas histories")
    routes = {k: res[k]["result"].get("engine") for k in SERVE_ROUTES}
    if routes != SERVE_ROUTES:
        raise AssertionError(f"serve: the singletons' routes {routes}")

    wall = t_last - t_first
    n_req = len(ids) - 1
    e2e = obs.hist_delta(h1.get("serve.e2e_s"), h0.get("serve.e2e_s"))
    qw = obs.hist_delta(h1.get("serve.queue_wait_s"),
                        h0.get("serve.queue_wait_s"))
    dw = obs.hist_delta(h1.get("serve.dispatch_wall_s"),
                        h0.get("serve.dispatch_wall_s"))
    lat = sorted((res[k]["submitted-at"], res[k]["latency-s"])
                 for k in ids if isinstance(k, int))
    steady = float(np.median([x for _t, x in lat[1:]]))
    engines = {}
    for k, st in res.items():
        e = st["result"].get("engine", "?")
        engines[e] = engines.get(e, 0) + 1
    log(f"serve in process (group 32, 1 lane, pipeline_k 4; warm start "
        f"{warm_s:.3f} s before the lanes took work): {n_req} requests "
        f"({len(traffic)} cas {SERVE_OPS[0]}-{SERVE_OPS[1]} ops, "
        f"{n_bad} invalid as wgl-native finds them, {n_same_op} at its "
        f"failing op; {', '.join(singles)}; "
        f"{SERVE_WIDE_N} wide multi-register of {SERVE_WIDE_OPS} ops; "
        f"then cas-100k alone) in {wall:.3f} s = {n_req / wall:.2f} "
        f"requests/s before cas-100k ({n429} POSTs "
        f"answered 429 and retried); every verdict as the standalone "
        f"chain's on the card; engines {engines}{at()}")
    log(f"serve latency: e2e p50 {obs.hist_quantile(e2e, 0.5):.4f} s, p99 "
        f"{obs.hist_quantile(e2e, 0.99):.4f} s ({e2e['count']} done); "
        f"queue wait p50 {obs.hist_quantile(qw, 0.5):.4f} s; the first "
        f"cas request {lat[0][1]:.4f} s against the rest's median "
        f"{steady:.4f} s; cas-100k alone {res['cas-100k']['latency-s']:.4f}"
        f" s in the daemon, {t_big1 - t_big:.4f} s from its POST to its "
        f"verdict (the check command: {CHECK_COMMAND_S} s, PERF.md), cas-30k "
        f"{res['cas-30k']['latency-s']:.4f} s, wide cas-100k "
        f"{res['wide cas-100k']['latency-s']:.4f} s, txn "
        f"{res['txn']['latency-s']:.4f} s")
    host = {k: delta.get(k, 0.0) for k in SERVE_HOST}
    admit = sum(host[k] for k in SERVE_HOST[:3])
    lane = sum(host[k] for k in ("serve.lane.stage_s", "serve.lane.collect_s",
                                 "serve.lane.check_s", "serve.lane.publish_s",
                                 "serve.lane.stats_s"))
    parts = {k: v for k, v in host.items()
             if k not in ("serve.lane.stage_s", "serve.lane.collect_s")}
    top = sorted(parts.items(), key=lambda kv: -kv[1])[:3]
    log(f"serve host time: admission {admit:.4f} s on the HTTP threads "
        f"(parse {host['serve.admit.parse_s']:.4f}, pack "
        f"{host['serve.admit.pack_s']:.4f}, journal "
        f"{host['serve.admit.journal_s']:.4f}); the lane {lane:.4f} s (stage "
        f"{host['serve.lane.stage_s']:.4f}: union prep "
        f"{host['lockstep.union_prep_s']:.4f}, marshal and launch "
        f"{host['lockstep.marshal_s']:.4f}; collect "
        f"{host['serve.lane.collect_s']:.4f}: fetch "
        f"{host['lockstep.fetch_s']:.4f}, results "
        f"{host['lockstep.results_s']:.4f}; blocking checks "
        f"{host['serve.lane.check_s']:.4f}; publish "
        f"{host['serve.lane.publish_s']:.4f}; stats file "
        f"{host['serve.lane.stats_s']:.4f}); the largest parts "
        f"{', '.join(f'{k} {v:.4f}' for k, v in top)}; wall {wall:.4f} s")
    log(f"serve window: pipeline.staged {delta.get('pipeline.staged', 0):g} "
        f"groups, overlap_s {delta.get('pipeline.overlap_s', 0):.4f}, "
        f"stall_s {delta.get('pipeline.stall_s', 0):.4f}; device_s "
        f"{delta.get('serve.device_s', 0):.4f} against the dispatch wall "
        f"{dw['sum']:.4f} s ({int(dw['count'])} dispatches), pad_waste_s "
        f"{delta.get('serve.pad_waste_s', 0):g}; peak device memory "
        f"{peak_mib:.1f} MiB; launches {la}")

    # the same SERVE_RERUN cas requests at pipeline_k 1 and 4, fresh
    # daemons; the check-serve process restarts meanwhile
    url_p = serve_process_url(proc)
    # POST /profile: torch.profiler around the process's first dispatch
    code, armed = http_json(f"{url_p}/profile", "POST", b'{"dispatches": 1}')
    if code != 202:
        raise AssertionError(f"check-serve /profile: {code} {armed}")
    four = [traffic[i] for i in range(4)]
    pids, _, _ = serve_post_all(url_p, [(s, b, "application/json")
                                        for s, b, _p in four])
    pdone, _ = serve_wait(url_p, pids.values())
    end = time.monotonic() + 60
    while True:
        prof = http_json(f"{url_p}/stats")[1]["profile"]
        if not prof["active"] and prof["device-records"] is not None:
            break
        if time.monotonic() > end:
            raise AssertionError(f"check-serve /profile: {prof}")
        time.sleep(0.05)
    for s, rid in pids.items():
        code, st = pdone[rid]
        if code != 200 or serve_norm(st["result"]) != serve_norm(
                res[s]["result"]):
            raise AssertionError(f"check-serve {s}: {code} {st}")
    first = serve_process_stop("first", proc)
    proc = serve_process(os.path.join(tmp, "process"))
    procs.append(proc)
    for k in (1, 4):
        dk = serve.Daemon(port=0, store_root=os.path.join(tmp, f"k{k}"),
                          device=dev, pipeline_k=k)
        dk.start()
        uk = f"http://127.0.0.1:{dk.port}"
        c_k = obs.counters()
        kids, t_k, _ = serve_post_all(uk, [(s, b, "application/json") for s, b,
                                        _p in traffic[:SERVE_RERUN]])
        kdone, t_k1 = serve_wait(uk, kids.values())
        staged = obs.counters().get("pipeline.staged", 0) \
            - c_k.get("pipeline.staged", 0)
        for s, rid in kids.items():
            if serve_norm(kdone[rid][1]["result"]) != serve_norm(
                    res[s]["result"]):
                raise AssertionError(f"serve pipeline_k={k} {s} differs")
        if (staged > 0) != (k > 1):
            raise AssertionError(f"serve pipeline_k={k}: {staged} staged")
        dk.shutdown()
        rate = SERVE_RERUN / (t_k1 - t_k)
        log(f"serve pipeline_k={k}: {SERVE_RERUN} cas requests in "
            f"{t_k1 - t_k:.3f} s = {rate:.2f} requests/s, "
            f"{staged:g} groups staged, the verdicts of the first run"
            f"{at()}")
    url_p = serve_process_url(proc)
    rid0 = pids[four[0][0]]
    code, st = http_json(f"{url_p}/check/{rid0}")
    _c, pst = http_json(f"{url_p}/stats")
    if code != 200 or not st.get("recovered-from-journal") \
            or serve_norm(st["result"]) != serve_norm(res[four[0][0]]["result"]) \
            or pst["counters"].get("serve.journal.replayed", 0) \
            or pst.get("journal", {}).get("pending"):
        raise AssertionError(f"check-serve restart: {code} {st} "
                             f"{pst.get('journal')}")
    serve_process_stop("restart", proc)
    log(f"check-serve process: 4 requests as in process, a torch.profiler "
        f"capture (POST /profile) of its first dispatch with "
        f"{prof['device-records']} device records, SIGTERM exit 0 "
        f"{{'shutdown': 'clean'}} "
        f"({first['counters'].get('serve.completed', 0):g} completed); the "
        f"restart replayed nothing and answered "
        f"{rid0} from its journal{at()}")


def phase_online():
    """``run --online`` on the card: ``register_test(time_limit=10,
    seed=7)`` with ``online-check``, linearizable (the monitor valid, the
    post-hoc check valid) and sloppy (the monitor stops the workers
    early, its violation equal to ``NativeStreamEngine`` fed the stored
    history on the CPU), in process; then ``run --mode sloppy --online``
    in its own process (exit 1). Returns the phase's readings."""
    import tempfile

    from jepsen_tpu_torch import core
    from jepsen_tpu_torch.suites import register

    t_phase = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-online-") as tmp:
        for mode in ("linearizable", "sloppy"):
            t = register.register_test(mode=mode, time_limit=RUN_TIME_LIMIT,
                                       seed=RUN_SEED, store=True)
            t["store-root"] = os.path.join(tmp, "in-process")
            t["online-check"] = True
            t["online-opts"] = dict(ONLINE_OPTS)
            done, dt, la, spans, ledger = drive(lambda: core.run(t))
            invalid = mode == "sloppy"
            res = done["results"]
            on, lin = res["online-check"], res["results"]["linear"]
            hist = done["history"]
            if on["valid"] is not (not invalid) or \
                    lin["valid"] is not (not invalid) or \
                    res["valid"] is not (not invalid):
                raise AssertionError(f"online {mode}: {on} {lin['valid']}")
            route = run_route(f"online {mode}", ledger, la, invalid)
            workers = spans["run.workers"]
            if invalid:
                # fail fast: the monitor stopped the workers before the
                # time limit, and only the in-flight ops landed after it
                if workers >= RUN_TIME_LIMIT or \
                        len(hist) > on["prefix-ops"] + 2000:
                    raise AssertionError(f"online sloppy: did not stop "
                                         f"early ({workers:.3f} s, "
                                         f"{len(hist)} ops, {on})")
                t0 = time.perf_counter()
                rep = online_replay(hist, on)
                rep_s = time.perf_counter() - t0
                same_txn("online sloppy, replay", on, rep, ONLINE_KEYS)
                detect_s = hist[on["prefix-ops"] - 1].time / 1e9
                text = (f"violation at op {on['op']['index']} after "
                        f"{on['prefix-ops']} ops (flush "
                        f"{on['detected-at-flush']}, settled returns "
                        f"{on['settled-returns']}), its last op {detect_s:.4f}"
                        f" s into the run; the host engine on the stored "
                        f"prefix gives the same violation ({rep_s:.3f} s); "
                        f"post-hoc op index {lin['op']['index']}")
                out.update(detect_ops=on["prefix-ops"], detect_s=detect_s,
                           workers_s=workers, wall_s=dt)
            else:
                if on["ops-checked"] != len(hist):
                    raise AssertionError(f"online linearizable: {on}")
                text = (f"{on['flushes']} flushes, {on['settled-returns']} "
                        f"settled returns of {on['ops-checked']} ops")
                out.update(valid_wall_s=dt, valid_workers_s=workers,
                           valid_ops=len(hist))
            log(f"online in process {mode}: valid={on['valid']} ops="
                f"{len(hist)} route {route['engine']}; run.workers "
                f"{workers:.4f} s of {RUN_TIME_LIMIT} s, run.check "
                f"{spans.get('run.check', 0.0):.4f} s, wall {dt:.4f} s; "
                f"{text}; launches {({k: v for k, v in la.items() if v})}")
        args = ["run", "--suite", "register", "--mode", "sloppy", "--online",
                "--time-limit", str(RUN_TIME_LIMIT), "--store-root",
                os.path.join(tmp, "cli")]
        rc, stdout, info = cli_run("run --online", args)
        line = json.loads(stdout.strip().splitlines()[-1])
        stored = json.load(open(os.path.join(line["dir"], "results.json")))
        on = stored["online-check"]
        if rc != 1 or line["valid"] is not False or on["valid"] is not False \
                or line["ops"] > on["prefix-ops"] + 2000:
            raise AssertionError(f"cli run --online: exit {rc} {line} {on}")
        la = info["launches"]
        log(f"cli run --mode sloppy --online: exit {rc} ops={line['ops']} "
            f"detected after {on['prefix-ops']} ops; process "
            f"{info['wall_s']:.3f} s, command {info['main_s']:.4f} s; "
            f"launches K1 {la['lane_walk']} K2 {la['batch_walk']}")
        out.update(cli_wall_s=info["wall_s"], cli_ops=line["ops"])
    log(f"online phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# -- the streaming session engines --------------------------------------------

# the carry's histories (fixtures.gen_history "cas", processes=5, seed=0,
# and the corrupted twins; the wide feeds' time is their some 150 memo
# rebuilds, which a shorter history does not cut) and the append block,
# in ops
CARRY_BLOCK = 256
CARRY_CASES = (("cas-100k", {}, "lane_walk", 100_000),
               ("wide cas-60k", WIDE_CAS, "wide_walk", 60_000))


def carry_feed(eng, hist, times):
    """Feed ``hist`` in :data:`CARRY_BLOCK`-op blocks, advancing and
    running the tail alarm after each (a session's append), then the
    run-over advance; each advance's wall seconds into ``times``."""
    v = None
    for i in range(0, len(hist), CARRY_BLOCK):
        eng.feed_many(hist[i:i + CARRY_BLOCK])
        t0 = time.perf_counter()
        v = eng.advance()
        times.append(time.perf_counter() - t0)
        if v is None:
            v = eng.tail_alarm()
        if v is not None:
            return v
    t0 = time.perf_counter()
    v = eng.advance(run_over=True)
    times.append(time.perf_counter() - t0)
    return v


def host_carry(kw, n_ops, corrupt):
    """A worker task for the wide carry cases, whose host feed is as long
    as the card's: :func:`host_feed` of the case's history."""
    return host_feed(gen("cas", n_ops, 5, 0, corrupt=corrupt, **kw))


def host_feed(h):
    """``NativeStreamEngine`` fed ``h`` in :func:`carry_feed`'s blocks:
    ``(violation, settled returns, final set, advance seconds, feed
    seconds)``."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checkers import online

    host = online.NativeStreamEngine(models.cas_register())
    t_host = []
    t0 = time.perf_counter()
    vh = carry_feed(host, h, t_host)
    return vh, host.settled_returns, host.R, t_host, time.perf_counter() - t0


def phase_carry():
    """The register family's streaming session on the card:
    ``DeviceFrontierEngine`` (the carried frontier on K1 at cas-100k, on
    K4 at wide cas-60k, each with its corrupted twin) against
    ``NativeStreamEngine``'s host walk on the same blocks (the wide
    cases' in worker processes while the card's feeds run): violation,
    ``settled-returns``, and the final carried set against the host's.
    Returns the readings by case."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.serve import session

    t_phase = time.perf_counter()
    out = {}
    wide = {(label, corrupt): pool().submit(host_carry, kw, n_ops, corrupt)
            for label, kw, kernel, n_ops in CARRY_CASES
            if kernel == "wide_walk" for corrupt in (False, True)}
    for label, kw, kernel, n_ops in CARRY_CASES:
        for corrupt in (False, True):
            name = f"{'corrupted ' if corrupt else ''}{label}"
            h = gen("cas", n_ops, 5, 0, corrupt=corrupt, **kw)
            dev = session.DeviceFrontierEngine(models.cas_register())
            t_dev = []
            vd, dt, la, _spans, ledger = drive(
                lambda: carry_feed(dev, h, t_dev))
            routes = {r["engine"] for r in ledger
                      if r["stage"] == "frontier-carry"}
            want = "reach-lane" if kernel == "lane_walk" else "reach-pallas"
            if routes != {want}:
                raise AssertionError(f"carry {name}: routes {routes}")
            fut = wide.get((label, corrupt))
            vh, settled, host_R, t_host, host_s = (
                fut.result() if fut is not None else host_feed(h))
            expect(f"carry {name}", la, **{kernel: None},
                   **{k: 0 for k in ("lane_walk", "wide_walk", "batch_walk")
                      if k != kernel})
            if (vh is None) == corrupt or vh != vd or \
                    settled != dev.settled_returns:
                raise AssertionError(f"carry {name}: host {vh} "
                                     f"{settled}, card {vd} "
                                     f"{dev.settled_returns}")
            if not corrupt and not np.array_equal(dev.host_set(), host_R):
                raise AssertionError(f"carry {name}: the final sets differ")
            n = dev.settled_returns
            reseeds = sum(1 for r in ledger if r["stage"] == "frontier-carry")
            adv_d, adv_h = 1e3 * sum(t_dev), 1e3 * sum(t_host)
            log(f"carry {name} ({len(h)} ops, {CARRY_BLOCK}-op blocks): "
                f"{'violation at op ' + str(vd['op']['index']) if vd else 'valid'}"
                f", {n} settled returns, equal to the host engine's"
                f"{'' if corrupt else ' with the final set'}; carry seeded "
                f"{reseeds} times ({want}); {kernel} launches "
                f"{la[kernel]}; card: {len(t_dev)} advances "
                f"{adv_d:.3f} ms ({adv_d / len(t_dev):.4f} ms an advance, "
                f"{1e3 * adv_d / max(n, 1):.4f} us a return), whole feed "
                f"{dt:.3f} s; host engine: {adv_h:.3f} ms "
                f"({adv_h / len(t_host):.4f} ms an advance, "
                f"{1e3 * adv_h / max(n, 1):.4f} us a return), whole feed "
                f"{host_s:.3f} s")
            out[name] = {"advance_ms": adv_d / len(t_dev),
                         "us_per_return": 1e3 * adv_d / max(n, 1),
                         "host_advance_ms": adv_h / len(t_host),
                         "host_us_per_return": 1e3 * adv_h / max(n, 1),
                         "launches": la[kernel], "returns": n}
    log(f"carry phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# the txn session: phase_txn's 6,003-txn write-skew history
# (TXN_LATTICE) in blocks of TXN_SESSION_BLOCK ops (64 txns), at K = 3
# and at every lattice level (K = 4)
TXN_SESSION_BLOCK = 128
# K9 against its plain version: the session's join, (K, Np, d) at the
# dense envelope with a 256-node dirty block and with the lattice
# session's last blocks' d = Np, and the density of A's (thru's) bits
TXN_JOIN_SHAPES = ((4, 8_192, 256), (4, 8_192, 8_192))
TXN_JOIN_DENSITY = 0.5


def join_bound(K, M, N, KW, both=True):
    """K9's bound: the larger of its bytes (A, B, C and, with ``both``,
    CT read once, each output written once) over the memory rate and
    ``2·K·M·N·32·KW`` single-bit operations over :data:`B1_RATE`."""
    OW, TW = -(-N // 32), -(-M // 32)
    words = K * (M * KW + N * KW + 2 * M * OW + (2 * N * TW if both else 0))
    nbytes, ops = 4 * words, 2 * K * M * N * 32 * KW
    t_bytes, t_ops = nbytes / HBM_RATE, ops / B1_RATE
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            f"bytes={nbytes} b1_ops={ops}")


def join_library_ms(thru, right, C, CT, reps):
    """The library's join: one exact ``torch.bmm`` of the dense ``thru``
    by the dense ``right`` in bf16 and in fp16 (0/1 inputs, sums of ones:
    ``> 0`` is exact), then ``> 0``, both packings and the OR with ``C``
    and ``CT``; each must equal the other. ms by dtype, and the output."""
    from jepsen_tpu_torch.txn import cycles

    out, want = {}, None
    for name, dt in (("bf16", torch.bfloat16), ("fp16", torch.float16)):
        a, b = thru.to(dt), right.to(dt)

        def lib():
            prod = torch.bmm(a, b) > 0
            return (C | cycles.pack_rows_torch(prod),
                    CT | cycles.pack_rows_torch(prod.transpose(1, 2)))

        got = lib()
        if want is not None and not all(map(torch.equal, got, want)):
            raise AssertionError(f"join library {name} differs")
        want = got
        out[name] = event_ms(lib, reps)
        del a, b, got
    return out, want


def k9_form_ms(A, B, C, CT, reps):
    """K9 in each of its two tile forms on the same operands (the C entry
    point, past the wrapper and its count): ms by form."""
    from jepsen_tpu_torch.txn import cycles

    lib = cycles._inc_lib()
    K, M, KW = A.shape
    N = B.shape[1]
    out = torch.empty((K, M, -(-N // 32)), dtype=torch.int32, device=CARD)
    outT = None if CT is None else torch.empty(
        (K, N, -(-M // 32)), dtype=torch.int32, device=CARD)
    stream = torch.cuda.current_stream().cuda_stream

    def run(form):
        err = lib.jt_txn_inc_join(
            A.data_ptr(), B.data_ptr(), C.data_ptr(), cycles._ptr(CT),
            out.data_ptr(), cycles._ptr(outT), K, M, N, KW, form, stream)
        if err:
            raise RuntimeError(f"K9 form {form}: CUDA error {err}")

    return {form: event_ms(lambda: run(form), reps) for form in (0, 1)}


def gather_torch(Cw, dd, Dp, rows=1_024):
    """The update's column gather ``C[:, :, dd]``, packed over ``dd``
    into ``Dp / 32`` words, by torch ops on bools ``rows`` rows at a time
    (no ``[K, Np, d]`` tensor): the other way to the K9 launch the
    update makes."""
    from jepsen_tpu_torch.txn import cycles

    K, Np, _NW = Cw.shape
    out = torch.empty((K, Np, Dp // 32), dtype=torch.int32, device=Cw.device)
    dw, db = dd >> 5, (dd & 31).to(torch.int32)
    for r0 in range(0, Np, rows):
        bits = ((Cw[:, r0:r0 + rows][:, :, dw] >> db) & 1).bool()
        out[:, r0:r0 + rows] = cycles.pack_bits(
            torch.nn.functional.pad(bits, (0, Dp - len(dd))))
    return out


def gather_line(K, Np, d, g):
    """The column gather at (K, Np, d) both ways, K9 against torch ops on
    bools, equal bit for bit: ms of each."""
    from jepsen_tpu_torch.txn import cycles

    Cw = torch.randint(-2**31, 2**31 - 1, (K, Np, Np // 32), generator=g,
                       device=CARD, dtype=torch.int32)
    dd = torch.randperm(Np, generator=g, device=CARD)[:d]
    Dp = 32 * -(-d // 32)
    St_w = torch.zeros((Dp, Np // 32), dtype=torch.int32, device=CARD)
    St_w[torch.arange(d, device=CARD), dd >> 5] = cycles._to_int32(
        torch.ones_like(dd) << (dd & 31))

    def k9():
        return cycles.inc_join(Cw, St_w.expand(K, Dp, Np // 32).contiguous(),
                               rows_only=True)[0]

    if not torch.equal(k9(), gather_torch(Cw, dd, Dp)):
        raise AssertionError(f"gather ({K}, {Np}, {d}): K9 and torch differ")
    return event_ms(k9, 10), event_ms(lambda: gather_torch(Cw, dd, Dp), 3)


def phase_join():
    """K9 against its plain version, bit for bit in both packings, at
    each of :data:`TXN_JOIN_SHAPES` (``A`` = thru packed over the dirty
    columns, bits of density :data:`TXN_JOIN_DENSITY`; ``B`` = right's
    transpose; random old words): event_ms, device_ms, the plain
    version's time, the bound, both tile forms and the library's join;
    then the update's column gather by K9 and by torch ops. Returns the
    kernels line's numbers, those of the last shape."""
    from jepsen_tpu_torch.txn import cycles

    out, errs = {}, []
    g = torch.Generator(device=CARD).manual_seed(15)
    for K, Np, d in TXN_JOIN_SHAPES:
        NW, DW = Np // 32, -(-d // 32)
        thru = torch.rand((K, Np, d), generator=g, device=CARD) \
            < TXN_JOIN_DENSITY
        right = torch.rand((K, d, Np), generator=g, device=CARD) < 0.05
        C, CT = (torch.randint(-2**31, 2**31 - 1, (K, Np, NW), generator=g,
                               device=CARD, dtype=torch.int32)
                 for _ in range(2))
        A = cycles.pack_bits(thru)
        B = cycles.pack_bits(right.transpose(1, 2))

        def k9():
            return cycles.inc_join(A, B, C, CT)

        got = k9()
        want, p_ms = plain_ms(lambda: cycles.inc_join_plain(A, B, C, CT))
        err = max(int((x.long() - y.long()).abs().max())
                  for x, y in zip(got, want))
        errs.append(err)
        if err or not all(map(torch.equal, got, want)):
            raise AssertionError(f"K9 at ({K}, {Np}, {d}) differs from "
                                 f"its plain version")
        ms = event_ms(k9, 20)
        dev = device_ms(k9, 50)
        forms = k9_form_ms(A, B, C, CT, 10)
        libs, lib_out = join_library_ms(thru, right, C, CT, 5)
        if not all(map(torch.equal, lib_out, got)):
            raise AssertionError("K9 differs from the library's join")
        del lib_out, thru, right
        b_ms, b_by, b_txt = join_bound(K, Np, Np, DW)
        lib_name = min(libs, key=libs.get)
        log(f"K9 txn_inc_join join K={K} M=N={Np} d={d} (KW={DW}, A density "
            f"{TXN_JOIN_DENSITY}, both packings in one launch, form "
            f"{cycles.join_form(Np, Np)}): bit-identical to its plain "
            f"version and the library's join; event_ms={ms:.6f} "
            f"{dev_text(dev)} plain_ms={p_ms:.3f} bound_ms={b_ms:.6f} "
            f"({b_by}; {b_txt}) = {ms / b_ms:.2f}x the bound; forms: small "
            f"{forms[0]:.6f} ms, big {forms[1]:.6f} ms; library "
            + ", ".join(f"{k} {v:.6f} ms" for k, v in libs.items())
            + f" (fastest {lib_name}: K9 {libs[lib_name] / ms:.2f}x its "
            f"speed)")
        k9_ms, t_ms = gather_line(K, Np, d, g)
        log(f"K9 the update's column gather K={K} Np={Np} d={d}: K9 "
            f"{k9_ms:.6f} ms, torch ops on bools {t_ms:.6f} ms (equal bit "
            f"for bit; the update takes K9)")
        out = {"max_abs_err": max(errs), "ms": ms,
               "device_ms": dev["total"] if dev else None, "plain_ms": p_ms,
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": libs[lib_name]}
        del A, B, C, CT, got, want
    return out


def phase_txn_session():
    """The transactional streaming session on the card:
    ``TxnSessionEngine`` over :data:`TXN_LATTICE`'s history with a write
    skew, in :data:`TXN_SESSION_BLOCK`-op blocks, serializable (K = 3)
    and at every lattice level (K = 4, Np growing to 8,192), in the
    default precision (no float32 product runs in the engine). Every
    block's booleans against the f32 cross-check (``inc_update_f32`` on
    the same operands, on the card, with TF32 allowed around it alone),
    the close verdict against the post-hoc ``txn.check_history`` on K8,
    and the session's last block's K9 launches against K9's plain
    version bit for bit. Returns the readings."""
    from jepsen_tpu_torch import fixtures, history

    t_phase = time.perf_counter()
    h = fixtures.gen_txn_history(**TXN_LATTICE)
    h = history.index(h + [op.with_(index=-1) for op in
                           fixtures.txn_anomaly_block("write-skew")])
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("txn session phase: TF32 is allowed on entry")
    out = {consistency: txn_session_run(h, consistency)
           for consistency in (None, "all")}
    log(f"txn session phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def txn_session_run(h, consistency):
    """One :func:`phase_txn_session` session (``consistency`` None: K =
    3; ``"all"``: the lattice, K = 4)."""
    from jepsen_tpu_torch import txn
    from jepsen_tpu_torch.serve import session
    from jepsen_tpu_torch.txn import cycles

    label = "serializable" if consistency is None else "lattice"
    eng = session.TxnSessionEngine(consistency=consistency)
    clo = eng.closure
    f32 = {"C": None, "A": None, "s": 0.0, "blocks": 0, "d": []}
    mem = {"session": 0, "update": 0}
    # host seconds of the closure's add_block and, inside it, of the word
    # update (synchronised on both sides); the rest of a block is the
    # engine's inference and host work
    secs = {"closure": 0.0, "update": 0.0}
    real_add, real_join = clo.add_block, cycles.inc_join
    real_update = cycles.inc_update_word
    joins = []

    def update(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_update(*args)
        torch.cuda.synchronize()
        secs["update"] += time.perf_counter() - t0
        return res

    def add_block(n, src, dst, et):
        torch.cuda.synchronize()
        mem["session"] = max(mem["session"], torch.cuda.max_memory_allocated())
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = real_add(n, src, dst, et)
        secs["closure"] += time.perf_counter() - t0
        mem["update"] = max(mem["update"],
                            torch.cuda.max_memory_allocated() - base)
        ops = [torch.as_tensor(a, device=CARD) for a in
               cycles.block_operands(np.asarray(src), np.asarray(dst),
                                     np.asarray(et), clo.Np,
                                     clo.lattice)]
        # the cross-check's float32 products on 0/1 operands, thresholded
        # at 0, are exact in TF32 as in full float32: TF32 here only
        t0 = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            f32["C"], f32["A"], want = cycles.inc_update_f32(
                f32["C"], f32["A"], clo.Np, *ops, clo.contracts)
            want = want.cpu().numpy()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        f32["s"] += time.perf_counter() - t0
        f32["blocks"] += 1
        f32["d"].append(len(ops[4]))
        if [bool(x) for x in want] != list(got.values()):
            raise AssertionError(f"txn session {label} block "
                                 f"{f32['blocks']}: {got} against the "
                                 f"f32 cross-check {want}")
        return got

    def join(A, B, C=None, CT=None, rows_only=False):
        res = real_join(A, B, C, CT, rows_only)
        joins[:] = joins[-3:] + [((A, B, C, CT, rows_only), res)]
        return res

    def feed():
        for i in range(0, len(h), TXN_SESSION_BLOCK):
            if eng.advance_block(h[i:i + TXN_SESSION_BLOCK]):
                break
        return eng.close_incremental()

    clo.add_block = add_block
    cycles.inc_join, cycles.inc_update_word = join, update
    torch.cuda.reset_peak_memory_stats()
    try:
        res, dt, la, _spans, _ = drive(feed)
    finally:
        cycles.inc_join, cycles.inc_update_word = real_join, real_update
    mem["session"] = max(mem["session"], torch.cuda.max_memory_allocated())
    blocks = f32["blocks"]
    ladder = sum(cycles.n_iter(max(d, 2)) for d in f32["d"])
    expect(f"txn session {label}", la, txn_inc_join=4 * blocks,
           txn_closure=ladder)
    kw = {} if consistency is None else {"consistency": consistency}
    post, post_dt, post_la, _s, _l = drive(
        lambda: txn.check_history(h, **kw))
    expect(f"txn session {label} post-hoc", post_la, txn_closure=None)
    if res["valid"] is not False or post["valid"] is not False or \
            res["booleans"] != post["booleans"] or \
            res["anomalies"] != post["anomalies"]:
        raise AssertionError(f"txn session {label}: {res} against the "
                             f"post-hoc {post}")
    for args, got in joins:
        want = cycles.inc_join_plain(*args)
        if not torch.equal(got[0], want[0]) or (
                got[1] is not None and not torch.equal(got[1], want[1])):
            raise AssertionError(f"txn session {label}: K9 differs "
                                 f"from its plain version")
    shapes = [(tuple(a[0].shape), tuple(a[1].shape), "rows" if a[4]
               else "both") for a, _g in joins]
    j_ms = [event_ms(lambda: cycles.inc_join(*a), 5) for a, _g in joins]
    wall = dt - f32["s"]
    per = 1e3 * wall / blocks
    log(f"txn session {label} ({eng.infer.n} txns, {blocks} blocks of "
        f"{TXN_SESSION_BLOCK} ops, K = {clo.K}, Np {clo.Np}, dirty width "
        f"up to {max(f32['d'])}; torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} in the engine): invalid, "
        f"anomalies {res['anomalies']}, booleans equal the f32 "
        f"cross-check at every block and the post-hoc check "
        f"({post['engine']}, {post_dt:.4f} s) at close; session "
        f"{wall:.3f} s ({per:.3f} ms a block; the cross-check's "
        f"{f32['s']:.3f} s not counted): the closure's add_block "
        f"{1e3 * secs['closure'] / blocks:.3f} ms a block, of which the "
        f"word update on K8 and K9 {1e3 * secs['update'] / blocks:.3f} ms "
        f"and the block's operands and verdict fetch the rest; inference "
        f"and the engine's host work "
        f"{1e3 * (wall - secs['closure']) / blocks:.3f} ms; launches K9 "
        f"{la['txn_inc_join']}, K8 {la['txn_closure']} (the ladders); "
        f"max_memory_allocated over the session "
        f"{mem['session'] / 2**20:.1f} MiB (the cross-check's float32 "
        f"masks included), the word update's own peak above what was "
        f"allocated before it {mem['update'] / 2**20:.1f} MiB; the last "
        f"block's K9 launches ({shapes}) bit-identical to the plain "
        f"version, event_ms " + ", ".join(f"{x:.6f}" for x in j_ms))
    return {"block_ms": per, "blocks": blocks,
            "closure_ms": 1e3 * secs["closure"] / blocks,
            "update_ms": 1e3 * secs["update"] / blocks,
            "launches": la["txn_inc_join"], "ladder": la["txn_closure"],
            "last_join_ms": j_ms, "peak_mib": mem["session"] / 2**20}


# -- K10 and the daemon's streaming sessions ---------------------------------

# K10 against its plain version: lanes a launch, and the returns of a
# lane's block (ragged); the narrow lanes hold cas carries of 5 and 6
# processes (K1's route; the warp and the block form), the wide lanes
# multi-register ones over 64 states (K4's route; both forms) and cas
# ones over 40 values whose op bucket O1 = 128 makes whole tables of 256
# KB, past one block's shared memory
K10_LANES = (1, 2, 64, 1_024)
K10_BLOCK = (16, 160)
K10_HISTS = 4                  # histories (each its own P) a group
                               # (their making and the carries' seeding
                               # are most of the phase)
K10_REPLAY_LANES = 2           # the wide groups' host replay's lanes
                               # (its int32 numpy products grow with S;
                               # the narrow groups replay every lane up
                               # to K10_REPLAY_NARROW)
K10_REPLAY_NARROW = 64
K10_REPS = 5                   # timed waves a reading (the median)
# K10's numbers in the kernels line beside every kernel's: its
# wrapper's host time, its launch with the wrapper, its chain bound and
# the blocks an SM holds (its ms is the kernel alone)
K10_LINE_KEYS = ("wrapper_ms", "launch_ms", "chain_bound_ms",
                 "blocks_per_sm")
# K11's: its row's ms, plain_ms and bound_ms are on the cas-100k prefix
# (chip_smoke.WORD_PREFIX returns); these are the whole stream's kernel
# time, time a return, chain bound and the profiler's record
K11_LINE_KEYS = ("full_ms", "full_us_per_return", "full_chain_bound_ms",
                 "full_device_ms")
# the daemon's sessions: cas sessions across tenants, each of
# SESS_APPENDS blocks of SESS_OPS history entries, SESS_BAD of them with
# a violation; a group of wide (multi-register, K4's route) and txn ones
SESS_N = 256
SESS_TENANTS = 4
SESS_APPENDS = 8
SESS_OPS = (64, 256)
SESS_BAD = 8
SESS_WIDE_N = 16
SESS_TXN_N = 2
SESS_TXN = dict(n_txns=600, keys=4, processes=4, key_rotate=16, seed=5)
SESS_CLIENTS = 16              # HTTP client threads
SESS_CRASH_AT = 2              # the daemon is dropped before this wave
SESS_VERDICT = ("valid", "op", "dead-event")


def k10_carries(kind, model, procs, L, seed, n_ops=3_000, **kw):
    """L carries of one mega geometry on ``CARD`` and a block each: the
    most common geometry of :data:`K10_HISTS` histories of ``n_ops`` ops
    (one in four corrupted), lane i on history i mod their count with its
    own seed (every other lane a random set over the one-hot one) and a
    ragged block at a random offset of that history's returns. Returns
    ``(carries, blocks, history of each lane, geometry, draw)``:
    ``draw(which, rng)`` draws another block for each lane."""
    from jepsen_tpu_torch import history
    from jepsen_tpu_torch.checkers import events, reach

    rng = np.random.RandomState(seed)
    by_sig = {}
    for s in range(K10_HISTS):
        h = gen(kind, n_ops, procs, seed + s, corrupt=s % 4 == 1, **kw)
        memo, stream, _T, _S, M = reach._prep(
            model, history.pack(h), max_states=100_000, max_slots=20,
            max_dense=1 << 22)
        R0 = np.zeros((memo.n_states, M), bool)
        R0[0, 0] = True
        c = reach.FrontierCarry(memo, M.bit_length() - 1, R0, device=CARD)
        by_sig.setdefault(c.mega_sig, []).append(
            (memo, events.returns_view(stream), M))
    sig, members = max(by_sig.items(), key=lambda kv: len(kv[1]))

    def draw(which, rng):
        out = []
        for j in which:
            rs = members[j][1]
            n = rng.randint(K10_BLOCK[0], K10_BLOCK[1] + 1)
            off = rng.randint(0, max(1, rs.n_returns - n))
            out.append((rs.ret_slot[off:off + n], rs.slot_ops[off:off + n]))
        return out

    carries, which = [], []
    for i in range(L):
        j = i % len(members)
        memo, rs, M = members[j]
        R0 = rng.random_sample((memo.n_states, M)) < (0.05 if i % 2 else 0)
        R0[0, 0] = True
        carries.append(reach.FrontierCarry(memo, M.bit_length() - 1, R0,
                                           device=CARD))
        which.append(j)
    blocks = draw(which, rng)
    if any(c.mega_sig != sig for c in carries):
        raise AssertionError(f"K10 lanes: geometry {sig} not shared")
    return carries, blocks, which, sig, draw


def k10_stage(carries, blocks):
    """A group's lanes and its wave staged as the group advance stages
    it (pinned on the card)."""
    from jepsen_tpu_torch.checkers import reach_word

    lanes = [c.lane for c in carries]
    return lanes, reach_word.stage_blocks(
        [ln.packed for ln in lanes], blocks, carries[0].W, pin=CARD == "cuda")


def lane_passes(P: np.ndarray, ret: np.ndarray, ops: np.ndarray,
                v0: np.ndarray, W: int) -> int:
    """The fire passes one lane's walk runs, as the kernels run them: per
    return up to min(c, W) passes, ending after the first that adds no
    config (walk.cuh's fixpoint exit), the walk ending at its first empty
    set. A host replay in numpy, for the chain bound."""
    M = 1 << W
    Pi = (P > 0.5).astype(np.int32)
    v = v0.astype(bool).copy()
    masks = np.arange(M)
    total = 0
    for r in range(len(ret)):
        pend = [j for j in range(W) if ops[r, j] >= 0]
        for _p in range(min(len(pend), W)):
            total += 1
            acc = v.copy()
            for j in pend:
                hi = masks[(masks >> j) & 1 == 1]
                acc[hi] |= (v[hi ^ (1 << j)].astype(np.int32)
                            @ Pi[ops[r, j]]) > 0
            grew = (acc != v).any()
            v = acc
            if not grew:
                break
        j = int(ret[r])
        if j >= 0:
            keep = ((masks >> j) & 1) == 0
            v = v[masks | (1 << j)] & keep[:, None]
            if not v.any():
                break
    return total


def k10_kernel_ms(lanes, stage, narrow, place="auto") -> float:
    """The kernel alone, the median of :data:`K10_REPS` waves: CUDA
    events recorded in the C entry point right around its launch (on
    the CPU the plain version's host time)."""
    from jepsen_tpu_torch.checkers import reach_word

    if CARD != "cuda":
        t0 = time.perf_counter()
        reach_word.mega_walk(lanes, stage, narrow, place=place)
        return 1e3 * (time.perf_counter() - t0)
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(K10_REPS)]
    for pair in evs:
        reach_word.mega_walk(lanes, stage, narrow, place=place, events=pair)
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in evs]))


def k10_wave_times(carries, blocks, lanes, stage, narrow):
    """One wave's times, each the median of :data:`K10_REPS`: the kernel
    alone (:func:`k10_kernel_ms`), the group advance's host time to its
    launch (``launch_frontiers_mega``: the rows, the staging, the copy
    and the launch queued; ``perf_counter``), and that launch with its
    wrapper by CUDA events around it (:func:`event_ms`)."""
    from jepsen_tpu_torch.checkers import reach_word

    ms = k10_kernel_ms(lanes, stage, narrow)
    host = []
    for _ in range(K10_REPS):
        if CARD == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        reach_word.launch_frontiers_mega(carries, blocks)
        host.append(1e3 * (time.perf_counter() - t0))
    launch = event_ms(lambda: reach_word.launch_frontiers_mega(
        carries, blocks), K10_REPS)
    return ms, float(np.median(host)), launch


def k10_check(label, carries, blocks, which, sig, replay: bool,
              places=("auto",), time_it=True):
    """K10 on one group: bit for bit against its plain version on the
    same sets and blocks, in each table place of ``places`` (and against
    the host replay, :func:`walk_work`, when ``replay``); with
    ``time_it`` its times (:func:`k10_wave_times`, in each place of
    ``places`` that differs from ``auto``'s pick), its launch design
    (blocks resident a SM), L solo advances of the same blocks on K1 or
    K4 (each lane's dead return and final set held against K10's too),
    its bytes bound and its chain bound. Returns the kernels line's
    numbers."""
    from jepsen_tpu_torch.checkers import reach_lane, reach_pallas
    from jepsen_tpu_torch.checkers import reach_word

    engine, S, W, O1 = sig
    narrow = engine == "reach-lane"
    L = len(carries)
    lanes, stage = k10_stage(carries, blocks)
    P = [ln.P for ln in lanes]
    R = [ln.R for ln in lanes]
    ret_np, ops_np = stage.padded()
    rs = torch.as_tensor(ret_np, device=CARD)
    so = torch.as_tensor(ops_np, device=CARD)
    lens = stage.n
    ref, p_ms = plain_ms(lambda: reach_word.mega_walk_plain(
        P, R, rs, so, lens))
    designs = {}
    got = None
    for place in places:
        design = (reach_word.mega_design(stage, S, O1, narrow, place)
                  if CARD == "cuda" else {"place": place})
        designs[place] = design
        for ln in lanes:
            ln.out.fill_(0.5)          # no earlier launch's sets
        dead = reach_word.mega_walk(lanes, stage, narrow, place=place)
        final = torch.stack([ln.out for ln in lanes])
        if not (torch.equal(final, ref[0]) and torch.equal(dead, ref[1])):
            raise AssertionError(f"mega_walk [{label}] L={L} place={place} "
                                 f"({design['place']}): differs from its "
                                 f"plain version")
        if got is None:
            got = (final, dead)
    if any(not torch.equal(ln.R, r) for ln, r in zip(lanes, R)):
        raise AssertionError(f"mega_walk [{label}]: a lane's set changed")
    err = float((got[0] - ref[0]).abs().max())
    deads = got[1].cpu().tolist()
    n_dead = sum(d >= 0 for d in deads)
    out = {"max_abs_err": err, "plain_ms": p_ms, "library_ms": None,
           "dead": n_dead, "L": L, "design": designs}
    work = 0
    if replay:
        for j in sorted(set(which)):
            ids = [i for i in range(L) if which[i] == j]
            ops_j, v, dead = walk_work(
                P[ids[0]].cpu().numpy(), rs[ids].cpu().numpy().T,
                so[ids].cpu().numpy().transpose(1, 0, 2),
                as_sets(torch.stack([R[i] for i in ids])), W,
                lens=np.array([lens[i] for i in ids]))
            if not (np.array_equal(v, as_sets(got[0][ids]))
                    and dead.tolist() == [deads[i] for i in ids]):
                raise AssertionError(f"mega_walk [{label}] L={L}: differs "
                                     f"from the host replay")
            work += ops_j
    if not time_it:
        log(f"kernel mega_walk [{label}] L={L} engine={engine} S={S} W={W} "
            f"O1={O1} R_pad={stage.R_pad} returns={int(lens.sum())} dead "
            f"lanes={n_dead} places {designs}: bit-identical"
            f"{'; host replay agrees' if replay else ''}")
        return out
    ms, host_ms, launch_ms = k10_wave_times(carries, blocks, lanes, stage,
                                            narrow)
    # the kernel alone in the other table place, where it differs
    times = {designs["auto"]["place"]: ms}
    for place in places:
        if designs[place]["place"] not in times:
            times[designs[place]["place"]] = k10_kernel_ms(
                lanes, stage, narrow, place)
    # L solo advances of the same blocks, as a session's solo path walks
    # them (K1: a checkpoint block the size of the block, n_pass = W)
    solo_ops = []
    for i, (b_rs, b_so) in enumerate(blocks):
        t_rs = torch.as_tensor(np.ascontiguousarray(b_rs, np.int32),
                               device=CARD)
        t_so = torch.as_tensor(np.ascontiguousarray(b_so, np.int32),
                               device=CARD)
        solo_ops.append((P[i], t_rs, t_so, R[i], int(lens[i])))

    def solo_all():
        res = []
        for Pi, t_rs, t_so, Ri, n in solo_ops:
            if n == 0:
                res.append(([-1], Ri))
            elif narrow:
                _c, fin, dead = reach_lane.lane_walk(Pi, t_rs, t_so, Ri, n,
                                                     W)
                res.append((dead, fin))
            else:
                dead, fin = reach_pallas.walk(Pi, t_rs, t_so, Ri, n)
                res.append((dead, fin))
        return res

    # timed once, warm (the walks' libraries are loaded), by CUDA events
    e0 = torch.cuda.Event(enable_timing=True) if CARD == "cuda" else None
    e1 = torch.cuda.Event(enable_timing=True) if CARD == "cuda" else None
    t0 = time.perf_counter()
    if e0 is not None:
        e0.record()
    solo = solo_all()
    if e1 is not None:
        e1.record()
        torch.cuda.synchronize()
        solo_ms = e0.elapsed_time(e1)
    else:
        solo_ms = 1e3 * (time.perf_counter() - t0)
    for i, (dead, fin) in enumerate(solo):
        if int(dead[0]) != deads[i] or (deads[i] < 0
                                        and not torch.equal(fin, got[0][i])):
            raise AssertionError(f"mega_walk [{label}] L={L} lane {i}: "
                                 f"solo {int(dead[0])}, K10 {deads[i]}")
    # the bytes the function needs: each lane's real returns (ret_slot
    # and its W slot ops; the identity steps that pad a block to the
    # longest are the layout's, not the function's), the table rows of
    # the ops those returns name and the all-zero sentinel row, the
    # seeds, the finals, the dead returns and the lane descriptors
    rows = sum(len(set(np.asarray(b_so[:lens[i]]).ravel().tolist())
                   - {-1}) + 1 for i, (_r, b_so) in enumerate(blocks))
    moved = (int(lens.sum()) * (1 + W) * 4 + rows * lanes[0].T[0].nbytes
             + nbytes(*R, got[0], got[1]) + stage.desc.nbytes
             + stage.off.nbytes)
    bound, bound_by, detail = bound_ms(moved, work)
    if not replay:
        bound_by, detail = "bytes", f"bytes={moved} (operations not " \
                                    f"counted: no host replay)"
        bound = 1e3 * moved / HBM_RATE
    # the chain bound: the longest surviving lane's real returns, the
    # passes they run, one shared-memory round trip each
    alive = np.asarray(deads) < 0
    i_long = int(np.argmax(np.where(alive, lens, -1) if alive.any()
                           else lens))
    passes = lane_passes(P[i_long].cpu().numpy(),
                         np.asarray(blocks[i_long][0]),
                         np.asarray(blocks[i_long][1]),
                         as_sets(R[i_long]), W)
    chain = passes * K10_SMEM_NS[0] * 1e-6
    design = designs["auto"]
    alt = ", ".join(f"{pl} {t:.6f}" for pl, t in times.items())
    log(f"kernel mega_walk [{label}] L={L} engine={engine} S={S} W={W} "
        f"O1={O1} form={design.get('form')} R_pad={stage.R_pad} returns="
        f"{int(lens.sum())} cap={stage.cap} dead lanes={n_dead}: "
        f"bit-identical in places {sorted(set(places))} max_abs_err={err} "
        f"design {design}; kernel_ms={ms:.6f} (events in the C entry) "
        f"us_per_lane={1e3 * ms / L:.6f} wrapper_host_ms={host_ms:.6f} "
        f"launch_ms={launch_ms:.6f} [the kernel by table place: {alt}]; solo_"
        f"{'k1' if narrow else 'k4'}_ms={solo_ms:.6f} ({L} launches, "
        f"{solo_ms / ms:.2f}x K10's kernel, {solo_ms / launch_ms:.2f}x its "
        f"launch) plain_ms={p_ms:.3f} bound_ms={bound:.6f} ({bound_by}; "
        f"{detail}) chain_bound_ms={chain:.6f} (lane {i_long}: "
        f"{int(lens[i_long])} returns, {passes} passes x "
        f"{K10_SMEM_NS[0]:.3f} ns; kernel {ms / max(chain, 1e-12):.2f}x)"
        f"{'; host replay agrees' if replay else ''}")
    out.update({"ms": ms, "wrapper_ms": host_ms, "launch_ms": launch_ms,
                "bound_ms": bound, "bound_by": bound_by,
                "chain_bound_ms": chain, "solo_ms": solo_ms,
                "blocks_per_sm": design.get("blocks_per_sm"),
                "times": times})
    return out


# one shared-memory load's round trip on the card, ns and cycles
# (reach_word.smem_round_trip), measured at the start of phase_k10
K10_SMEM_NS = [0.0, 0.0]


def k10_after_solo(carries, which, sig, draw, rng):
    """A wave after solo advances: the group advanced once by K10 (its
    sets swapped in), every third carry then advanced alone on K1 or K4
    (its set replaced, its lane rebound), and the next wave, in which lane
    0's block holds no return, held bit for bit against the plain
    version from the lanes' current sets."""
    from jepsen_tpu_torch.checkers import reach_word

    reach_word.advance_frontiers_mega(carries, draw(which, rng))
    for i, b in enumerate(draw(which, rng)):
        if i % 3 == 1:
            carries[i].advance(*b)
    blocks = draw(which, rng)
    blocks[0] = (blocks[0][0][:0], blocks[0][1][:0])
    return k10_check("cas after solo advances", carries, blocks, which, sig,
                     replay=True, places=("auto", "shared", "global"),
                     time_it=False)


def k10_refuses(carries, blocks, sig):
    """A lane whose block names an op past its tables walks nothing: K10
    reports it as dead return -2 in both table places (the collect then
    raises), and the other lanes as their plain version does."""
    from jepsen_tpu_torch.checkers import reach_word

    engine, _S, _W, O1 = sig
    narrow = engine == "reach-lane"
    bad = (blocks[1][0], np.array(blocks[1][1], np.int32))
    bad[1][0, 0] = O1
    blocks = [blocks[0], bad] + list(blocks[2:])
    lanes, stage = k10_stage(carries, blocks)
    if CARD != "cuda":
        return
    for place in ("shared", "global"):
        dead = reach_word.mega_walk(lanes, stage, narrow, place=place)
        got = dead.cpu().tolist()
        if got[1] != -2 or min(got[:1] + got[2:]) < -1:
            raise AssertionError(f"mega_walk: an op past O1 in lane 1 "
                                 f"({place}): dead {got}")
    inf = reach_word.MegaInflight(carries, lanes, stage.n, dead)
    try:
        reach_word.collect_frontiers_mega(inf)
    except RuntimeError as e:
        log(f"K10 refuses a lane naming op {O1} of O1 = {O1}: dead -2 in "
            f"both places, the collect raises ({e})")
    else:
        raise AssertionError("mega_walk: collect took a refused lane")


def phase_k10():
    """K10 (``csrc/mega_walk.cu``) against its plain version at
    :data:`K10_LANES` lanes on K1's route (cas, 5 processes: the warp
    form; 6: the block form), K4's (multi-register over 64 states, both
    forms) and K4's at O1 = 128 (wide cas: whole tables past shared
    memory), in each table place, with its times, its launch design and
    the same blocks' solo K1 or K4 advances; then a wave after solo
    advances with a lane of no returns. Returns the kernels line's
    numbers: the narrow warp-form group at the most lanes."""
    from jepsen_tpu_torch import models
    from jepsen_tpu_torch.checkers import reach_word

    t0 = time.perf_counter()
    if CARD == "cuda":
        cyc, ns = reach_word.smem_round_trip()
        K10_SMEM_NS[:] = [ns, cyc]
    else:
        K10_SMEM_NS[:] = [1.0, 1.0]
    log(f"K10: one shared-memory load's round trip {K10_SMEM_NS[1]:.2f} "
        f"cycles = {K10_SMEM_NS[0]:.3f} ns (a warp's pointer chase)")
    out = {}
    both = ("auto", "shared", "global")
    cases = (("cas", "cas", models.cas_register(), 5, {}, 3_000,
              K10_LANES),
             ("multi-register S=64", "multi", models.multi_register(), 5,
              WIDE_MULTI, 3_000, K10_LANES),
             ("cas W=6", "cas", models.cas_register(), 6, {}, 3_000,
              K10_LANES),
             ("multi-register S=64 W=6", "multi", models.multi_register(),
              6, WIDE_MULTI, 3_000, K10_LANES),
             ("wide cas O1=128", "cas", models.cas_register(), 5, WIDE_CAS,
              400, K10_LANES[-2:]))
    for label, kind, model, procs, kw, n_ops, lanes in cases:
        t_case = time.perf_counter()
        carries, blocks, which, sig, draw = k10_carries(
            kind, model, procs, max(lanes), 900 + procs, n_ops, **kw)
        log(f"K10 lanes [{label}]: {max(lanes)} carries seeded in "
            f"{time.perf_counter() - t_case:.2f} s, geometry {sig}")
        for L in lanes:
            narrow_replay = sig[1] <= 32 and L <= K10_REPLAY_NARROW
            r = k10_check(label, carries[:L], blocks[:L], which[:L], sig,
                          replay=L <= K10_REPLAY_LANES or narrow_replay,
                          places=both)
            if L >= 64 and not 0 < r["dead"] < L:
                raise AssertionError(f"mega_walk [{label}] L={L}: "
                                     f"{r['dead']} dead lanes")
            if label == "cas" and L == max(lanes):
                out = r
        if label == "cas":
            k10_after_solo(carries[:64], which[:64], sig, draw,
                           np.random.RandomState(7))
            k10_refuses(carries[:4], blocks[:4], sig)
        log(f"K10 case [{label}]: {time.perf_counter() - t_case:.1f} s")
    out["max_abs_err"] = 0.0
    log(f"K10 phase: {time.perf_counter() - t0:.1f} s")
    return out


def sess_params():
    """The session traffic's sizes, handed to the pool's workers (a
    worker imports this module afresh)."""
    return dict(n=SESS_N, tenants=SESS_TENANTS, appends=SESS_APPENDS,
                ops=SESS_OPS, bad=SESS_BAD, wide=SESS_WIDE_N,
                txn_n=SESS_TXN_N, txn=SESS_TXN)


def sess_streams(pm):
    """The sessions' streams for the sizes ``pm`` (:func:`sess_params`):
    ``(key, model name, tenant, blocks)``, blocks of op maps as the
    client sends them, the same on every call."""
    from jepsen_tpu_torch import fixtures, history

    rng = np.random.RandomState(19)
    out = []

    def sizes():
        return rng.randint(pm["ops"][0], pm["ops"][1] + 1, pm["appends"])

    def cut(ops, sz):
        """``ops`` in blocks in the proportions of ``sz``, none empty."""
        ends = np.round(np.cumsum(sz) / sz.sum() * len(ops)).astype(int)
        bounds = [0]
        for k, e in enumerate(ends):
            bounds.append(max(bounds[-1] + 1,
                              min(int(e), len(ops) - (len(sz) - 1 - k))))
        return [[o.to_dict() for o in ops[bounds[k]:bounds[k + 1]]]
                for k in range(len(sz))]

    stride = pm["n"] // pm["bad"]
    for i in range(pm["n"]):
        sz = sizes()
        h = gen("cas", int(sz.sum()) // 2, 5, 7_000 + i,
                corrupt=i % stride == stride // 2)
        out.append((f"cas-{i}", "cas-register",
                    f"tenant-{i % pm['tenants']}", cut(h, sz)))
    for i in range(pm["wide"]):
        sz = sizes()
        h = gen("multi", int(sz.sum()) // 2, 5, 8_000 + i, corrupt=i == 3,
                **WIDE_MULTI)
        out.append((f"wide-{i}", "multi-register", "tenant-wide",
                    cut(h, sz)))
    for i in range(pm["txn_n"]):
        h = fixtures.gen_txn_history(**dict(pm["txn"],
                                            seed=pm["txn"]["seed"] + i))
        if i == 0:
            h = history.index(h + [op.with_(index=-1) for op in
                                   fixtures.txn_anomaly_block(
                                       "write-skew")])
        out.append((f"txn-{i}", "txn-list-append", "tenant-txn",
                     cut(h, sizes())))
    return out


def sess_to_file(path, pm):
    """A worker task: :func:`sess_streams` pickled into ``path``."""
    import pickle

    with open(path, "wb") as f:
        pickle.dump(sess_streams(pm), f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


def sess_submit():
    """Start generating the sessions' streams in the pool."""
    import tempfile

    return pool().submit(sess_to_file, os.path.join(
        tempfile.gettempdir(), f"chip-smoke-sessions-{os.getpid()}.pickle"),
        sess_params())


def sess_standalone(pm, device):
    """A worker task: the standalone check of every session's whole
    history as the daemon reads it (:func:`sess_streams` again, the same
    streams), on ``device``: ``check_packed`` for the register family,
    ``auto_check_txn`` for txn; ``{key: verdict}`` as JSON carries it."""
    from jepsen_tpu_torch import history, serve
    from jepsen_tpu_torch.checkers import facade, reach
    from jepsen_tpu_torch.op import Op

    out = {}
    for key, model_name, _t, blocks in sess_streams(pm):
        ops = history.index([Op.from_dict(o) for b in blocks for o in b])
        if model_name == "txn-list-append":
            want = facade.auto_check_txn(ops, {"device": device})
        else:
            want = reach.check_packed(serve.resolve_model(model_name),
                                      history.pack(ops), device=device)
        out[key] = json.loads(json.dumps(want, default=str))
    return out


def sess_threads(work, fn):
    """``fn(item)`` for every item of ``work`` on :data:`SESS_CLIENTS`
    threads; the results in order, the first error raised."""
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(SESS_CLIENTS) as ex:
        return list(ex.map(fn, work))


def sess_wave(d, sessions, w):
    """Block w of every session, posted over HTTP without waiting
    (``wait-s`` 0, the client's 202), then each request's verdict awaited
    on the daemon's registry in process (no polling: clients polling
    ``GET /check/<id>`` held the interpreter lock from the lane), and
    the first one's read over HTTP too: ``{key: (status, result)}``."""
    url = f"http://127.0.0.1:{d.port}"

    def post(s):
        key, _m, _t, blocks = s
        code, r = http_json(f"{url}/session/{SESS_IDS[key]}/append", "POST",
                            json.dumps({"history": blocks[w], "seq": w + 1,
                                        "wait-s": 0}).encode())
        if code not in (200, 202):
            raise AssertionError(f"session {key} block {w + 1}: {code} {r}")
        return r["id"]

    ids = sess_threads(sessions, post)
    out = {}
    for s, rid in zip(sessions, ids):
        req = d.registry.get(rid)
        if not req.done_event.wait(600):
            raise AssertionError(f"session {s[0]} block {w + 1}: no verdict")
        out[s[0]] = (req.status, req.result)
    code, st = http_json(f"{url}/check/{ids[0]}")
    if code != 200 or st["result"] != out[sessions[0][0]][1]:
        raise AssertionError(f"GET /check/{ids[0]}: {code} {st}")
    return out


SESS_IDS = {}


def op_id(op):
    """An op map's identity: process, function, value and index."""
    return None if op is None else tuple(
        json.dumps(op.get(k), sort_keys=True)
        for k in ("process", "f", "value", "index"))


def phase_sessions(streams):
    """The check daemon's streaming sessions on the card
    (:class:`serve.Daemon` in process, a tenant cap of 128, every tenant
    allowed 1,024 requests in flight so that a group can hold every
    session): :data:`SESS_N` cas sessions across :data:`SESS_TENANTS`
    tenants (:data:`SESS_BAD` with an injected violation),
    :data:`SESS_WIDE_N` multi-register sessions over 64 states (K4's
    route, K10's wide form) and :data:`SESS_TXN_N` txn sessions (K8, K9;
    one with a write skew), :data:`SESS_APPENDS` blocks each, posted a
    wave at a time (block w of every session, then their verdicts). After
    :data:`SESS_CRASH_AT` waves the daemon is dropped without a shutdown
    and a second one on the same store replays every session from the
    journal. Every
    close's verdict, op and dead event, and every session's first
    violation, against the standalone ``check_packed`` (``auto_check_txn``)
    of its whole history as the daemon read it; the main path's launches
    (K10 among them, in both forms); K10's device time a wave (CUDA
    events around each launch) and its share of the advances' wall;
    appends a second; the results browser's ``/`` and ``/engine``."""
    import tempfile

    from jepsen_tpu_torch import obs, serve, web
    from jepsen_tpu_torch.checkers import reach_word

    t_phase = time.perf_counter()
    sessions = load_pickle(streams.result())
    # the standalone checks run in a worker process on the card while the
    # daemon serves (they are the phase's reference, not its work)
    standalone = pool().submit(sess_standalone, sess_params(), CARD)
    log(f"sessions: {len(sessions)} streams generated by a worker process,"
        f" waited {time.perf_counter() - t_phase:.2f} s for and loaded "
        f"them, not counted")
    dev = None if CARD == "cuda" else CARD
    tmp = tempfile.mkdtemp(prefix="chip-smoke-sessions-")
    kw = dict(port=0, store_root=tmp, device=dev, session_tenant_cap=128,
              max_inflight_per_tenant=1_024, queue_depth=4_096)
    # K10's device time: CUDA events recorded in the C entry point right
    # around every launch, read at the end; the group advance's host time
    # to its launch by perf_counter
    timed, hosts = [], []
    launch, group = reach_word.mega_walk, reach_word.launch_frontiers_mega

    def mega_walk_timed(lanes, stage, narrow, **k):
        evs = None
        if CARD == "cuda":
            evs = (torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
        t0 = time.perf_counter()
        out = launch(lanes, stage, narrow, events=evs, **k)
        timed.append((len(lanes), narrow, evs, time.perf_counter() - t0))
        return out

    def group_timed(*a, **k):
        t0 = time.perf_counter()
        out = group(*a, **k)
        hosts.append(time.perf_counter() - t0)
        return out

    reach_word.mega_walk = mega_walk_timed
    reach_word.launch_frontiers_mega = group_timed
    walls, appends = [], 0
    zero_launches()
    # the lanes' counters are the process's (a capture sees one thread)
    ctr0 = obs.counters()
    try:
        d = serve.Daemon(**kw).start()
        url = f"http://127.0.0.1:{d.port}"
        for key, model_name, tenant, _b in sessions:
            code, r = http_json(f"{url}/session", "POST", json.dumps(
                {"model": model_name, "tenant": tenant}).encode())
            if code != 201:
                raise AssertionError(f"open {key}: {code} {r}")
            SESS_IDS[key] = r["session"]
        verdicts = {s[0]: [] for s in sessions}
        for w in range(SESS_APPENDS):
            if w == SESS_CRASH_AT:
                # a crash: no drain, no shutdown; the next daemon
                # replays every open session from the journal
                t0 = time.perf_counter()
                d.httpd.server_close()
                d.dispatcher.stop()
                d = serve.Daemon(**kw).start()
                url = f"http://127.0.0.1:{d.port}"
                replayed = sum(d.sessions.get(SESS_IDS[s[0]]).replayed
                               for s in sessions)
                log(f"sessions: daemon dropped after {w} waves and "
                    f"started again, {replayed} blocks of "
                    f"{len(sessions)} sessions replayed in "
                    f"{time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
            out = sess_wave(d, sessions, w)
            walls.append(time.perf_counter() - t0)
            appends += len(out)
            for key, (status, res) in out.items():
                if status != "done":
                    raise AssertionError(f"session {key} block {w + 1}:"
                                         f" {status} {res}")
                verdicts[key].append(res)
        # the browser, while the sessions are open
        httpd = web.serve(root=tmp, port=0, block=False)
        d.dispatcher._write_stats_file()
        wurl = f"http://127.0.0.1:{httpd.server_address[1]}"
        import urllib.request
        index = urllib.request.urlopen(wurl + "/", timeout=60).read()
        engine = urllib.request.urlopen(wurl + "/engine",
                                        timeout=60).read().decode()
        httpd.shutdown()
        httpd.server_close()
        if f"{len(sessions)} open sessions" not in engine \
                or b"jepsen-tpu results" not in index:
            raise AssertionError("sessions: the browser's pages")
        t0 = time.perf_counter()
        closes = sess_threads(sessions, lambda s: http_json(
            f"{url}/session/{SESS_IDS[s[0]]}/close", "POST",
            b'{"wait-s": 600}'))
        close_s = time.perf_counter() - t0
        stats = d.stats()
        health = d.health()
        d.shutdown()
        if CARD == "cuda":
            torch.cuda.synchronize()
    finally:
        reach_word.mega_walk = launch
        reach_word.launch_frontiers_mega = group
    la = launches()
    for name, n in la.items():
        MAIN_PATH_LAUNCHES[name] = MAIN_PATH_LAUNCHES.get(name, 0) + n
    expect("sessions", la, mega_walk=None, lane_walk=None, wide_walk=None,
           txn_inc_join=None, txn_closure=None)
    if health[0] != 200:
        raise AssertionError(f"sessions: /healthz {health}")
    # every close and first violation against the standalone check of
    # the whole history as the daemon read it
    t0 = time.perf_counter()
    wants = standalone.result()
    n_bad = 0
    for (key, model_name, _t, blocks), (code, res) in zip(sessions, closes):
        if code != 200 or res["status"] != "closed":
            raise AssertionError(f"close {key}: {code} {res}")
        got, want = res["result"], wants[key]
        keys = (("valid", "anomalies") if model_name == "txn-list-append"
                else SESS_VERDICT)
        for k in keys:
            if got.get(k) != want.get(k):
                raise AssertionError(f"session {key}: {k} {got.get(k)} "
                                     f"!= standalone {want.get(k)}")
        first = next((v for v in verdicts[key] if not v["valid-so-far"]),
                     None)
        if (first is None) != (want["valid"] is True):
            raise AssertionError(f"session {key}: incremental verdicts "
                                 f"against {want['valid']}")
        # the incremental violation names the failing op's completion,
        # the exact check its invocation: the same op
        if first is not None and model_name != "txn-list-append" and \
                op_id(first["violation"].get("op")) != op_id(want.get("op")):
            raise AssertionError(f"session {key}: first violation "
                                 f"{first['violation'].get('op')} != "
                                 f"{want.get('op')}")
        n_bad += want["valid"] is False
    check_s = time.perf_counter() - t0
    if CARD == "cuda":
        dev_ms = [(lanes, narrow, evs[0].elapsed_time(evs[1]))
                  for lanes, narrow, evs, _h in timed]
    else:
        dev_ms = [(lanes, narrow, 1e3 * h) for lanes, narrow, _e, h
                  in timed]
    host_ms = 1e3 * sum(hosts)
    forms = {bool(n) for _l, n, _ms in dev_ms}
    if forms != {True, False}:
        raise AssertionError(f"sessions: K10 launched in forms {forms}")
    k10_ms = sum(ms for _l, _n, ms in dev_ms)
    lanes_all = sum(lanes for lanes, _n, _ms in dev_ms)
    ctr1 = obs.counters()
    ctr = {k: ctr1.get(k, 0) - ctr0.get(k, 0) for k in ctr1}
    adv_s = ctr.get("serve.session.advance_wall_s", 0.0)
    scatter_s = ctr.get("serve.session.mega.scatter_s", 0.0)
    log(f"sessions: {len(sessions)} sessions ({SESS_N} cas, {SESS_WIDE_N} "
        f"wide, {SESS_TXN_N} txn; {n_bad} invalid), {appends} appends in "
        f"{sum(walls):.3f} s of waves = {appends / sum(walls):.1f} appends/s"
        f" (waves {', '.join(f'{x:.3f}' for x in walls)} s); closes "
        f"{close_s:.3f} s; K10 {len(dev_ms)} launches of {lanes_all} lanes "
        f"({lanes_all / max(1, len(dev_ms)):.1f} a wave), device "
        f"{k10_ms:.3f} ms = {k10_ms / max(1, len(dev_ms)):.6f} ms a wave, "
        f"{k10_ms / max(1, lanes_all):.6f} ms a lane (the kernel alone: "
        f"events in the C entry point); the group advance's host time to "
        f"its launch {host_ms:.3f} ms = {host_ms / max(1, len(hosts)):.6f} "
        f"ms a wave; the staged part of "
        f"the waves {scatter_s:.3f} s, the advances' wall {adv_s:.3f} s, "
        f"K10 {100 * k10_ms / 1e3 / max(adv_s, 1e-9):.2f}% of it; "
        f"groups {ctr.get('serve.session.mega.groups', 0)}, fallbacks "
        f"{ctr.get('serve.session.fallback', 0)}, journal "
        f"{ctr.get('serve.journal.session_appended', 0)} blocks; "
        f"launches {la}; dispatch {stats['dispatch']}; every close as the "
        f"standalone check (a worker process; {check_s:.2f} s waited for "
        f"it), browser / and /engine ({len(sessions)} open sessions)")
    log(f"sessions phase: {time.perf_counter() - t_phase:.1f} s")


# -- the daemon's harnesses: loadgen, chaos, soak; the disk memo tier ---------

# the run's disk memo directory (JEPSEN_TPU_CACHE_DIR), made at its start
# and removed at its end: no memo of an earlier run warms this one
# -- K11: the word-packed post-hoc walk ------------------------------------

# K11 is held bit for bit against its plain version on this many returns
# of each stream and of each lane of the lockstep group (the plain
# version walks a return in tens of torch ops, all lanes at once)
WORD_PREFIX = 1_024
WORD_REPS = 3                 # timed walks a reading (the median or mean)
# the histories: cas-100k (and its corrupted twin, and wide cas-100k
# over 40 values, when main does not pass its own), the W = 8 history of
# PERF.md section 4 (S = 6, M = 256, NW = 8) and the small batch's lanes
WORD_OPS = 100_000
WORD_W8 = ("cas", 30_000, 8, 3)
WORD_GROUP_OPS = 30_000
# the --bodies child's arguments past the flag (its defaults: cas-100k)
WORD_BODIES_ARGS = ()
# the lockstep group: 8 cas-30k lanes (the small batch's seeds), one
# corrupted at its first read
WORD_GROUP_BAD = 5
WORD_KEYS = ("valid", "op", "dead-event", "max-linearized", "final-configs",
             "previous-ok")
# one shared-memory load's round trip (reach_word.smem_round_trip): ns,
# cycles; the unit of K11's chain bound
WORD_SMEM_NS = [0.0, 0.0]


def corrupt_first_read(h):
    """A history made non-linearizable at its first successful read (its
    value rewritten to one no write produced), so that the violation
    falls inside a prefix of the stream."""
    i = next(k for k, op in enumerate(h) if op.type == "ok" and op.f == "read")
    return h[:i] + [h[i].with_(value=999_999)] + h[i + 1:]


def word_stream(h):
    """A cas history's word-walk operands: ``(memo, returns view, M)``."""
    from jepsen_tpu_torch import history, models
    from jepsen_tpu_torch.checkers import events as ev
    from jepsen_tpu_torch.checkers import reach

    memo, stream, _T, _S, M = reach._prep(
        models.cas_register(), history.pack(h), max_states=100_000,
        max_slots=20, max_dense=1 << 22)
    return memo, ev.returns_view(stream), M


def word_lane(memo, rs, M, n=None):
    """One lane's operands on the card: ``(Tpad, R0 words, ret, ops)`` of
    the first ``n`` returns (default all), seeded at state 0, mask 0."""
    from jepsen_tpu_torch.checkers import reach_word

    n = rs.n_returns if n is None else min(n, rs.n_returns)
    R0 = np.zeros((1, memo.n_states, reach_word.n_words(M)), np.int32)
    R0[0, 0, 0] = 1
    return [torch.as_tensor(np.ascontiguousarray(x), device=CARD) for x in (
        reach_word.pad_table(memo.table), R0, rs.ret_slot[None, :n],
        rs.slot_ops[None, :n])]


def word_bound(args, n, passes, steps):
    """K11's bounds on one walk: the bytes (the table, the stream, the
    seeds and finals read or written once, the dead returns), the 32-bit
    operations (a shifted word and its OR for each (state, slot, word) a
    pass, a word for each (state, word) a projecting step) and the chain
    (each pass one shared-memory round trip, summed over the stream).
    Returns ``(bound_ms, bound_by, detail, chain_ms)``."""
    Tpad, R0 = args[0], args[1]
    H, S, NW = R0.shape
    W = args[3].shape[2]
    moved = (nbytes(Tpad) + 2 * nbytes(R0) + int(n.sum()) * (1 + W) * 4
             + 4 * H)
    work = 2 * S * W * NW * passes + S * NW * steps
    bound, by, detail = bound_ms(moved, work)
    return bound, by, detail, passes * WORD_SMEM_NS[0] * 1e-6


def word_check(label, args, n=None, want_dead=None):
    """K11 against its plain version on the same tensors on the card, bit
    for bit (final words and dead returns); with ``want_dead`` a lane
    that must die (``True``) or survive. Returns its numbers: the plain
    version's time, the kernel alone (CUDA events in the C entry), the
    passes it ran and the bound."""
    from jepsen_tpu_torch.checkers import reach_word

    H = args[1].shape[0]
    n_t = None if n is None else torch.as_tensor(n, dtype=torch.int32,
                                                 device=CARD)
    ref, p_ms = plain_ms(lambda: reach_word.walk_words_plain(*args, n_t))
    stats = torch.zeros((H, 2), dtype=torch.int32, device=CARD)
    got = reach_word.walk_words(*args, n_t, stats=stats)
    if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
        raise AssertionError(f"word_walk [{label}]: differs from its plain "
                             f"version: dead {got[1].tolist()} plain "
                             f"{ref[1].tolist()}")
    dead = got[1].cpu().tolist()
    if want_dead is not None and [d >= 0 for d in dead] != want_dead:
        raise AssertionError(f"word_walk [{label}]: dead {dead}")
    ms = word_kernel_ms(args, n_t)
    lens = np.full(H, args[2].shape[1]) if n is None else np.asarray(n)
    passes, steps = (int(x) for x in stats.sum(0).tolist())
    bound, by, detail, chain = word_bound(args, lens, passes, steps)
    S, NW = args[1].shape[1:]
    W = args[3].shape[2]
    log(f"kernel word_walk [{label}] H={H} S={S} W={W} NW={NW} returns="
        f"{int(lens.sum())} dead={dead}: bit-identical max_abs_err=0.0 "
        f"kernel_ms={ms:.6f} plain_ms={p_ms:.3f} passes={passes} "
        f"steps={steps} bound_ms={bound:.6f} ({by}; {detail}) "
        f"chain_bound_ms={chain:.6f}")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": p_ms,
            "bound_ms": bound, "bound_by": by, "chain_bound_ms": chain,
            "library_ms": None}


def word_kernel_ms(args, n_t=None) -> float:
    """K11 alone: the median of :data:`WORD_REPS` launches, CUDA events
    recorded in the C entry right around each (on the CPU the plain
    version's host time)."""
    from jepsen_tpu_torch.checkers import reach_word

    if CARD != "cuda":
        t0 = time.perf_counter()
        reach_word.walk_words(*args, n_t)
        return 1e3 * (time.perf_counter() - t0)
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(WORD_REPS)]
    for pair in evs:
        reach_word.walk_words(*args, n_t, events=pair)
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in evs]))


def word_times(label, memo, rs, M, walker):
    """One full stream: K11 alone (events in its C entry, and the
    profiler's record), its entry ``walk_returns_words`` with its copies
    and fetch (:func:`event_ms`), its passes and chain bound, and the
    default route's kernel on the same stream, ``walker`` (K1's
    ``reach_lane`` or K4's ``reach_pallas``): its ``walk_returns`` entry
    by events and its kernels by the profiler."""
    from jepsen_tpu_torch.checkers import reach, reach_word

    n = rs.n_returns
    args = word_lane(memo, rs, M)
    stats = torch.zeros((1, 2), dtype=torch.int32, device=CARD)
    fin, dead = reach_word.walk_words(*args, stats=stats)
    passes, steps = (int(x) for x in stats[0].tolist())
    ms = word_kernel_ms(args)
    dev = device_ms(lambda: reach_word.walk_words(*args), WORD_REPS) \
        if CARD == "cuda" else None
    entry = event_ms(lambda: reach_word.walk_returns_words(
        memo.table, rs.ret_slot[:n], rs.slot_ops[:n], M, device=CARD),
        WORD_REPS)
    bound, by, detail, chain = word_bound(args, np.array([n]), passes,
                                          steps)
    S_pad = max(2, 1 << (memo.n_states - 1).bit_length())
    P = reach._build_P(memo, S_pad)
    R0 = np.zeros((S_pad, M), bool)
    R0[0, 0] = True

    def dense():
        return walker.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                   device=CARD, fetch_R=False)

    d_dead, _ = dense()
    if d_dead != int(dead[0]) and not (d_dead < 0 and int(dead[0]) < 0):
        raise AssertionError(f"word_walk [{label}]: dead {int(dead[0])}, "
                             f"{walker.__name__} {d_dead}")
    d_entry = event_ms(dense, WORD_REPS)
    d_dev = device_ms(dense, WORD_REPS) if CARD == "cuda" else None
    name = "K1" if walker.__name__.endswith("reach_lane") else "K4"
    W = args[3].shape[2]
    design = reach_word.word_design(memo.n_states, W, n) \
        if CARD == "cuda" else None
    log(f"word_walk times [{label}] S={memo.n_states} W={W} M={M} "
        f"returns={n} dead={int(dead[0])} design {design}: kernel_ms={ms:.6f} "
        f"(events in the C entry) device_ms="
        f"{None if dev is None else round(dev['total'], 6)} "
        f"us_per_return={1e3 * ms / n:.6f} entry event_ms={entry:.6f} "
        f"(walk_returns_words: copies, launch, fetch) passes={passes} "
        f"steps={steps} chain_bound_ms={chain:.6f} (kernel "
        f"{ms / max(chain, 1e-12):.2f}x) bound_ms={bound:.6f} ({by}; "
        f"{detail}); {name} on the same stream: walk_returns event_ms="
        f"{d_entry:.6f} device_ms="
        f"{None if d_dev is None else round(d_dev['total'], 6)} "
        f"({None if d_dev is None else d_dev['kernels']}); K11 kernel "
        f"{ms / max(d_dev['total'] if d_dev else d_entry, 1e-12):.2f}x "
        f"{name}'s")
    return {"full_ms": ms, "full_us_per_return": 1e3 * ms / n,
            "full_chain_bound_ms": chain, "full_device_ms":
            None if dev is None else dev["total"]}


def word_route(label, h, want_engine, **launches):
    """The main path through the word route: ``Linearizable(body="word")``
    on the card, its verdict, op, dead event and witness equal to the
    default route's (``want_engine``), one K11 launch and ``launches``."""
    from jepsen_tpu_torch import Linearizable, models

    want, dt_d, _la, _sp, _ = drive(
        lambda: Linearizable(models.cas_register()).check(None, h))
    if want["engine"] != want_engine:
        raise AssertionError(f"word route [{label}]: the default route "
                             f"took {want['engine']}")
    res, dt, la, spans, ledger = drive(lambda: Linearizable(
        models.cas_register(), body="word").check(None, h))
    if res["engine"] != "reach-word":
        raise AssertionError(f"word route [{label}]: {res['engine']}")
    expect(f"word route [{label}]", la, word_walk=1, batch_walk=0,
           **launches)
    same_result(f"word route [{label}] against {want_engine}", res, want,
                WORD_KEYS)
    routes = [r["engine"] for r in ledger if r["event"] == "route"]
    log(f"word route [{label}]: {res['engine']} valid={res['valid']} "
        f"dead-event={res.get('dead-event')} {dt:.4f} s = "
        f"{len(h) // 2 / dt:.1f} ops/s ({split(dt, spans)}; launches "
        f"{la}; routes {routes}); {want_engine} {dt_d:.4f} s; verdict, op, "
        f"dead event and witness agree")


def word_group(model, packed):
    """The lockstep lane's first group of ``packed`` (its union prep and
    plan, as ``check_many`` makes them), marshalled with the word body."""
    from jepsen_tpu_torch.checkers import reach, reach_batch

    live = list(range(len(packed)))
    sa, u, groups = reach._lockstep_plan(
        model, packed, live, max_states=100_000, max_slots=20,
        max_dense=1 << 22, u_box=None)
    P, _W, M, ret_flat, ops_flat, _kW, _kR, offsets = u
    g = groups[0]
    if len(groups) != 1 or len(g) != len(packed):
        raise AssertionError(f"word group: planned {groups}")
    return reach_batch.prepare_returns_batch(
        P, reach._flat_lanes(ret_flat, offsets, g),
        reach._flat_lanes(ops_flat, offsets, g), M, body="word"), g


def word_bodies():
    """``python -m jepsen_tpu_torch.tools.ablate_lane --bodies`` as a user
    runs it, in a child process under a cache directory of its own (no
    later route here reads the winner it records): its row, the table it
    wrote and its wall time."""
    import tempfile

    from jepsen_tpu_torch.checkers import autotune

    with tempfile.TemporaryDirectory(prefix="chip-smoke-autotune-") as d:
        env = dict(os.environ, JEPSEN_TPU_CACHE_DIR=d)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "jepsen_tpu_torch.tools.ablate_lane",
             "--bodies", *WORD_BODIES_ARGS], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"--bodies: exit {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
        row = json.loads(out.stdout.strip().splitlines()[-1])
        path = os.path.join(d, "autotune.json")
        with open(path) as f:
            table = json.load(f)
    g = row["geometry"]
    key = (f"walk|{'cuda' if CARD == 'cuda' else 'cpu'}|"
           f"{autotune.walk_key(g['S'], g['W'], g['M'], g['returns'])}")
    entry = table["entries"].get(key, {})
    if row.get("recorded") != path or entry.get("body") != row["winner"] \
            or row["word_engine"] != "reach-word":
        raise AssertionError(f"--bodies: row {row}, table {table}")
    log(f"--bodies at cas-100k: {json.dumps(row)} ({dt:.2f} s in a child "
        f"process; the table's entry {key}: {json.dumps(entry)})")


def word_winner_routes(h):
    """A recorded ``walk`` winner of ``word`` (in a table of its own)
    routes the default ``Linearizable`` check of ``h`` to K11: one
    launch, no K2."""
    import tempfile

    from jepsen_tpu_torch import Linearizable, models
    from jepsen_tpu_torch.checkers import autotune

    memo, rs, M = word_stream(h)
    key = autotune.walk_key(memo.n_states, rs.slot_ops.shape[1], M,
                            rs.n_returns)
    old = os.environ.get("JEPSEN_TPU_CACHE_DIR")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-autotune-") as d:
        os.environ["JEPSEN_TPU_CACHE_DIR"] = d
        try:
            autotune.record("walk", key, "word",
                            backend_name=torch.device(CARD).type)
            res, dt, la, _spans, ledger = drive(lambda: Linearizable(
                models.cas_register()).check(None, h))
        finally:
            if old is None:
                os.environ.pop("JEPSEN_TPU_CACHE_DIR", None)
            else:
                os.environ["JEPSEN_TPU_CACHE_DIR"] = old
    causes = [r.get("cause") for r in ledger if r["event"] == "route"
              and r.get("engine") == "reach-word"]
    if res["engine"] != "reach-word" or causes != ["winner"]:
        raise AssertionError(f"walk winner {key}: {res['engine']} {ledger}")
    expect("walk winner", la, word_walk=1, batch_walk=0, lane_walk=0)
    log(f"a recorded walk winner ({key}: word) routes cas-100k's default "
        f"check to K11: {res['engine']} valid={res['valid']} {dt:.4f} s; "
        f"launches {la}")


def phase_words(h100k=None, wide=None, batch=None):
    """K11 (``csrc/word_walk.cu``) against its plain version bit for bit on
    :data:`WORD_PREFIX`-return prefixes of cas-100k, the W = 8 cas-30k
    and wide cas-100k, on an injected violation and on a lockstep group
    of 8 cas-30k lanes with one corrupted; its times on the full streams
    beside K1's and K4's, with its chain bound; the word route of the
    main path (``Linearizable(body="word")`` on the four histories,
    ``check_many(body="word")`` on the 8 x cas-30k batch) against the
    default route; a recorded winner routing a default check; and the
    ``--bodies`` sweep in a child process. ``h100k``, ``wide`` and
    ``batch`` (the 8 x cas-30k, :data:`SMALL_BATCH_BAD` corrupted) are
    main's, made here when not given. Returns the kernels line's
    numbers (the cas-100k prefix, with the full stream's times)."""
    from jepsen_tpu_torch import fixtures, history, models
    from jepsen_tpu_torch.checkers import (reach, reach_batch, reach_lane,
                                           reach_pallas, reach_word)

    t0 = time.perf_counter()
    if CARD == "cuda":
        cyc, ns = reach_word.smem_round_trip()
        WORD_SMEM_NS[:] = [ns, cyc]
    else:
        WORD_SMEM_NS[:] = [1.0, 1.0]
    log(f"K11: one shared-memory load's round trip {WORD_SMEM_NS[1]:.2f} "
        f"cycles = {WORD_SMEM_NS[0]:.3f} ns")
    h100k = gen("cas", WORD_OPS, 5, 0) if h100k is None else h100k
    wide = gen("cas", WORD_OPS, 5, 0, **WIDE_CAS) if wide is None else wide
    w8 = gen(*WORD_W8)
    bad = gen("cas", WORD_OPS, 5, 0, corrupt=True)
    streams = {"cas-100k": word_stream(h100k), "W=8 cas-30k": word_stream(w8),
               "wide cas-100k": word_stream(wide)}
    out = {}
    for label, (memo, rs, M) in streams.items():
        r = word_check(f"{label}, first {WORD_PREFIX} returns",
                       word_lane(memo, rs, M, WORD_PREFIX), want_dead=[False])
        if label == "cas-100k":
            out = r
    memo, rs, M = word_stream(corrupt_first_read(h100k))
    word_check(f"cas-100k corrupted at its first read, first {WORD_PREFIX} "
               f"returns", word_lane(memo, rs, M, WORD_PREFIX),
               want_dead=[True])
    model = models.cas_register()
    if batch is None:
        batch = [history.pack(gen("cas", WORD_GROUP_OPS, 5, 2000 + i,
                                  corrupt=True))
                 if i in SMALL_BATCH_BAD else
                 fixtures.gen_packed("cas", n_ops=WORD_GROUP_OPS,
                                     processes=5, seed=2000 + i)
                 for i in range(SMALL_BATCH_N)]
    # the batch with one lane corrupted at its first read, the others not
    group = [history.pack(corrupt_first_read(
        gen("cas", WORD_GROUP_OPS, 5, 2000 + i))) if i == WORD_GROUP_BAD else
        fixtures.gen_packed("cas", n_ops=WORD_GROUP_OPS, processes=5,
                            seed=2000 + i) if i in SMALL_BATCH_BAD else
        batch[i] for i in range(SMALL_BATCH_N)]
    prep, g = word_group(model, group)
    ops = reach_batch.word_operands(prep)
    lens = np.minimum(ops[4], WORD_PREFIX)
    word_check(f"lockstep group {SMALL_BATCH_N} x cas-30k, lane "
               f"{WORD_GROUP_BAD} corrupted, first {WORD_PREFIX} returns",
               [torch.as_tensor(x, device=CARD) for x in ops[:4]], lens,
               want_dead=[i == WORD_GROUP_BAD for i in g])
    for label, walker in (("cas-100k", reach_lane),
                          ("W=8 cas-30k", reach_lane),
                          ("wide cas-100k", reach_pallas)):
        t = word_times(label, *streams[label], walker)
        if label == "cas-100k":
            out.update(t)
    word_route("cas-100k", h100k, "reach-chunklock", lane_walk=0)
    word_route("corrupted cas-100k", bad, "reach-chunklock", lane_walk=1)
    word_route("W=8 cas-30k", w8, "reach-lane", lane_walk=0)
    word_route("wide cas-100k", wide, "reach-pallas", lane_walk=0,
               wide_walk=0)
    # the lockstep lane's word body on the small batch (two corrupted)
    want, dt_d, la_d, _s, _l = drive(lambda: reach.check_many(model, batch))
    expect("lockstep dense", la_d, batch_walk=1, word_walk=0)
    got, dt, la, spans, ledger = drive(
        lambda: reach.check_many(model, batch, body="word"))
    expect("lockstep word", la, word_walk=1, batch_walk=0,
           lane_walk=len(SMALL_BATCH_BAD))
    for i, (g, w) in enumerate(zip(got, want)):
        same_result(f"lockstep word lane {i} against K2", g, w, WORD_KEYS)
    log(f"lockstep word body [{SMALL_BATCH_N} x cas-30k, "
        f"{len(SMALL_BATCH_BAD)} corrupted]: {dt:.4f} s "
        f"({split(dt, spans)}; launches {la}); K2's group {dt_d:.4f} s "
        f"(launches {la_d}); dead vector "
        f"{[r.get('dead-event') for r in got]} equals K2's, with the ops "
        f"and witnesses")
    word_winner_routes(h100k)
    word_bodies()
    log(f"K11 phase: {time.perf_counter() - t0:.1f} s")
    return out


MEMO_CACHE_ROOT = None
# --kernel-phases: main stops after the kernels' checks
KERNEL_PHASES_ONLY = False


def use_fresh_memo_cache():
    """Point the disk memo tier of this process and of every process it
    starts at a new empty directory. The tier stays as the environment
    has it: on, as a user's, unless the persistence switch turns it
    off."""
    global MEMO_CACHE_ROOT
    import tempfile

    MEMO_CACHE_ROOT = tempfile.mkdtemp(prefix="chip-smoke-memo-")
    os.environ["JEPSEN_TPU_CACHE_DIR"] = MEMO_CACHE_ROOT

# the soak configs phase_suites does not run, each at SUITE_TIME_LIMIT; a
# correct mode runs one round, a buggy one up to soak's rounds, until one
# catches it (soak's rule: soak.unexpected, soak.never_caught)
SOAK_CASES = (("register", "linearizable"), ("register", "sloppy"),
              ("mutex", "leases"), ("queue", "lossy"))
# the disk tier's check: a corrupted cas history below chunk-lockstep's
# floor (K1), its verdict, dead event and witness from a memo read back
DISK_OPS = 30_000
DISK_KEYS = ("valid", "engine", "op", "dead-event", "max-linearized",
             "final-configs", "previous-ok")
MEMO_COUNTERS = ("memo_cache.hit", "memo_cache.miss", "memo_cache.evict",
                 "memo_cache.disk.hit", "memo_cache.disk.miss",
                 "memo_cache.disk.store", "memo_cache.disk.invalid",
                 "memo_cache.disk.evict")


def memo_counters():
    """This process's memo tiers' counters so far."""
    from jepsen_tpu_torch import obs

    c = obs.counters()
    return {k: c[k] for k in MEMO_COUNTERS if c.get(k)}


def counter_delta(c0, c1, prefixes):
    return {k: round(c1.get(k, 0) - c0.get(k, 0), 6)
            for k in sorted(set(c1) | set(c0))
            if k.startswith(prefixes) and c1.get(k, 0) != c0.get(k, 0)}


def cold_memos():
    from jepsen_tpu_torch.checkers import reach

    with reach._MEMO_CACHE_LOCK:
        reach._MEMO_CACHE.clear()
        reach._SUPERSET_SEEDS.clear()
        reach._SUPERSET_SEEDS_FAILED.clear()


def loadgen_line(label, rep, dt, la, delta):
    """One loadgen run's reading: both windows, the 429s, the queue-wait
    and service split, the sessions, the memo tiers, routes and
    launches."""
    w = rep["windows"]
    split_ = rep["stage_split"]
    sess = rep.get("sessions") or {}
    mux = sess.get("mux") or {}
    xc = rep.get("latency_crosscheck") or {}
    text = (f"loadgen {label}: {rep['completed']} of {rep['submitted']} "
            f"completed at {rep['target_rate']} req/s offered, sustained "
            f"{rep['sustained_req_s']} req/s; window 1 {w[0]['req_s']} req/s "
            f"p50 {w[0]['p50_s']} p99 {w[0]['p99_s']} s; window 2 "
            f"{w[1]['req_s']} req/s p50 {w[1]['p50_s']} p99 {w[1]['p99_s']} "
            f"s; 429s {rep['rejected_429']}; queue wait p50 "
            f"{split_['queue_wait']['p50_s']} p99 "
            f"{split_['queue_wait']['p99_s']} s, service p50 "
            f"{split_['service']['p50_s']} p99 {split_['service']['p99_s']} "
            f"s; cross-check {xc.get('anchor')} ok={xc.get('ok')} "
            f"{xc.get('p99_gate', '')}; warmup {rep.get('warmup')}; "
            f"mismatches {rep['verdict_mismatches']}")
    if sess:
        text += (f"; sessions {sess['sessions']}: {sess['appends']} appends, "
                 f"{sess['sustained_appends_s']} appends/s, append p50 "
                 f"{sess['append_p50_s']} p99 {sess['append_p99_s']} s, "
                 f"mega waves {mux.get('mega_groups')} over "
                 f"{mux.get('mega_lanes')} lanes, mux efficiency "
                 f"{mux.get('mux_efficiency')}, flagged before close "
                 f"{sess['flagged_before_close']} of "
                 f"{sess['violating_sessions']}, tenant cap "
                 f"{sess['tenant_cap_probe']}")
    memo = {k: v for k, v in delta.items() if k.startswith("memo_cache")}
    routes = {k[16:]: v for k, v in delta.items()
              if k.startswith("engine.selected.")}
    text += (f"; memo tiers {memo}; routes {routes}"
             f"; staged {delta.get('pipeline.staged', 0)}; launches from the "
             f"daemon K1 {la['lane_walk']} K2 {la['batch_walk']} K4 "
             f"{la['wide_walk']} K8 {la['txn_closure']} K10 "
             f"{la['mega_walk']}; run {dt:.1f} s")
    log(text)


def phase_harnesses():
    """The daemon's harnesses on the card, each store root fresh:
    ``tools.loadgen`` at its defaults (no store root)
    with ``--sessions``, self-hosted in process (the tool's exit rule; K2 and
    K1 launched from inside the daemon; K10 and the mega waves printed),
    then ``tools.chaos --quick`` and ``--fleet --quick`` as processes on
    the card, started together (exit 0, every invariant; the recovery and
    failover times) while, in process, loadgen ``--mixed-consistency
    --quick`` runs (K8 from the daemon), then ``tools.soak``'s configs that
    :func:`phase_suites` does not run (:data:`SOAK_CASES`) run at
    :data:`SUITE_TIME_LIMIT`, and the disk tier: a corrupted cas-30k
    checked with a cache directory of its own, the in-memory tiers
    emptied, checked again from a disk hit with the same verdict, dead
    event and witness. Everything else shares the run's memo
    directory."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-harnesses-")
    procs = []
    try:
        harness_body(tmp, procs)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"harnesses phase: {time.perf_counter() - t_phase:.1f} s")


def disk_tier():
    """A corrupted cas-30k checked twice, the in-memory tiers emptied
    before each: the first stores its memo, the second reads it back from
    disk with the same verdict, dead event and witness."""
    from jepsen_tpu_torch import obs

    h = gen("cas", DISK_OPS, 5, 0, corrupt=True)
    runs = []
    for label in ("cold", "from disk"):
        cold_memos()
        c0 = obs.counters()
        res, dt, la, _spans, _ledger = drive(lambda: linearizable(h))
        runs.append((res, dt, counter_delta(c0, obs.counters(),
                                            ("memo_cache",))))
        log(f"disk tier, corrupted cas-{DISK_OPS // 1000}k {label}: "
            f"{res['engine']} valid={res['valid']} dead-event="
            f"{res.get('dead-event')} {dt:.4f} s; {runs[-1][2]}; launches "
            f"K1 {la['lane_walk']}")
    if runs[0][2].get("memo_cache.disk.store", 0) < 1 or \
            runs[1][2].get("memo_cache.disk.hit", 0) < 1:
        raise AssertionError(f"disk tier: {runs[0][2]} then {runs[1][2]}")
    same_result("disk tier", runs[1][0], runs[0][0], DISK_KEYS)
    if runs[0][0]["valid"] is not False:
        raise AssertionError(f"disk tier: {runs[0][0]}")


def harness_body(tmp, procs):
    import random

    from jepsen_tpu_torch import obs
    from jepsen_tpu_torch.tools import loadgen, soak

    dev = None if CARD == "cuda" else CARD
    prefixes = ("memo_cache", "engine.selected.", "pipeline.staged",
                "serve.session.mega", "serve.device_faults", "serve.errors")

    def run_loadgen(label, opts, **kernels):
        # the tool's defaults: no store root (no journal, no stored
        # verdicts)
        opts = dict(opts, device=dev)
        cold_memos()
        c0 = obs.counters()
        rep, dt, la, _spans, _ledger = drive(
            lambda: loadgen.run_loadgen(opts))
        delta = counter_delta(c0, obs.counters(), prefixes)
        loadgen_line(label, rep, dt, la, delta)
        if not loadgen.passes(rep) or rep.get("error"):
            brief = {k: v for k, v in rep.items() if k != "stats"}
            raise AssertionError(f"loadgen {label}: exit rule failed: "
                                 f"{json.dumps(brief, default=str)}")
        if delta.get("serve.device_faults") or delta.get("serve.errors"):
            raise AssertionError(f"loadgen {label}: {delta}")
        expect(f"loadgen {label}", la, **kernels)

    # -- loadgen at its defaults, with sessions: alone on the machine ------
    run_loadgen("defaults with sessions", {"sessions": True},
                batch_walk=None, lane_walk=None)

    # -- chaos --quick and --fleet --quick, as processes, started together;
    # the mixed-consistency loadgen, the soak and the disk tier run in
    # process meanwhile ---------------------------------------------------
    t0 = time.perf_counter()
    started = []
    for name, args in (("chaos", ["--quick"]),
                       ("fleet", ["--fleet", "--quick"])):
        proc = subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch.tools.chaos", *args,
             "--store-root", os.path.join(tmp, f"store-{name}")]
            + ([] if dev is None else ["--device", dev]),
            cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(proc)
        started.append((name, proc))
    run_loadgen("mixed consistency, quick",
                {"mixed_consistency": True, "quick": True},
                txn_closure=None)

    # -- soak: the configs phase_suites does not run -----------------------
    expected = {(s, m): e for s, m, e in soak.CONFIGS}
    rng = random.Random(RUN_SEED)
    for suite, mode in SOAK_CASES:
        want = expected[(suite, mode)]
        seen = []
        for rnd in range(1 if want else soak.ROUNDS):
            seed = rng.randrange(1 << 30)
            test = soak.build(suite, mode, seed, SUITE_TIME_LIMIT,
                              device=dev)
            valid, dt, la, _spans, _ledger = drive(
                lambda: soak.run_once(test))
            seen.append(valid)
            log(f"soak {suite} {mode} round {rnd + 1} (seed {seed}): "
                f"valid={valid} wall {dt:.2f} s; "
                f"launches { {k: v for k, v in la.items() if v} }")
            if soak.unexpected(want, valid):
                raise AssertionError(f"soak {suite} {mode}: expected "
                                     f"{want}, saw {valid}")
            if suite in ("register", "mutex"):
                expect(f"soak {suite} {mode}", la, lane_walk=None)
            if valid is False:
                break
        if soak.never_caught(want, seen):
            raise AssertionError(f"soak {suite} {mode}: never caught in "
                                 f"{seen}")

    # -- the disk tier, in a cache directory of its own --------------------
    run_cache = os.environ["JEPSEN_TPU_CACHE_DIR"]
    os.environ["JEPSEN_TPU_CACHE_DIR"] = os.path.join(tmp, "cache-disk")
    try:
        disk_tier()
    finally:
        os.environ["JEPSEN_TPU_CACHE_DIR"] = run_cache

    for name, proc in started:
        out, err = proc.communicate(timeout=600)
        wall = time.perf_counter() - t0
        try:
            rep = json.loads(out)
        except ValueError:
            raise AssertionError(f"chaos {name}: exit {proc.returncode}, "
                                 f"no report; {err[-4000:]}") from None
        if proc.returncode != 0 or rep.get("ok") is not True:
            raise AssertionError(f"chaos {name}: exit {proc.returncode} "
                                 f"violations {rep.get('violations')}")
        if name == "chaos":
            log(f"chaos --quick: exit 0, every invariant held; schedule "
                f"{rep['fault_schedule']} fired {rep['fault_counters']}; "
                f"recovery to first verdict across the SIGKILL "
                f"{rep['recovery_to_first_verdict_s']} s; {rep['checked_done']}"
                f" verdicts against the facade in process, mismatches "
                f"{rep['verdict_mismatches']}; the session replayed "
                f"{rep['session_replayed_appends']} appends and closed "
                f"{rep['session_close']}; process {wall:.1f} s")
        else:
            log(f"chaos --fleet --quick: exit 0, every gate held; 2 "
                f"replicas, the victim held {rep['victim_pending_at_kill']} "
                f"leases at the kill, {rep.get('leases_stolen', 0)} stolen; "
                f"failover to first verdict {rep['failover_to_first_verdict_s']}"
                f" s; {rep['checked_done']} verdicts, mismatches "
                f"{rep['verdict_mismatches']}; session {rep['session_close']};"
                f" process {wall:.1f} s (the two harnesses side by side, "
                f"the mixed loadgen, the soak and the disk tier in process "
                f"meanwhile)")



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    use_fresh_memo_cache()
    from jepsen_tpu_torch import (Linearizable, _build, _native, fixtures,
                                  history, models)
    from jepsen_tpu_torch.checkers import reach_lane


    name = torch.cuda.get_device_name(0)
    card = smi()
    log(f"device: {name} (count {torch.cuda.device_count()}); "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    build_s = _build.build_all()
    log(f"build: {build_s:.3f} s for {list(_build.sources())}")
    # generated by worker processes while the kernels are checked (after
    # the build: the nvcc processes want the cores)
    import tempfile

    big_future = pool().submit(
        gen_to_file, os.path.join(tempfile.gettempdir(),
                                  f"chip-smoke-{SCALE}-{os.getpid()}.pickle"),
        "cas", SCALE_OPS, 5, 1)
    serve_futures = serve_submit()
    sess_future = sess_submit()
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
    big = load_pickle(big_future.result())
    gen_s = time.perf_counter() - t0
    phase_native([("cas-100k", h100k), (SCALE, big)])
    t0 = time.perf_counter()
    h_ind, per_key = keyed_histories()
    gen_ind_s = time.perf_counter() - t0
    k2_lock = phase_k2_lockstep(f"independent {N_KEYS} keys x "
                                f"{OPS_PER_KEY} ops", per_key)
    k3 = phase_k3(f"independent {N_KEYS} keys x {OPS_PER_KEY} ops", per_key,
                  k5=True)
    for procs in (6, 8):
        # the block form at its lookup count against K5's at any number
        # of words, on the same keys (fewer: the host replay and the plain
        # version grow with them)
        phase_k3(f"{BLOCK_FORM_KEYS} keys x {OPS_PER_KEY} ops, {procs} "
                 f"processes", keyed_histories(
                     BLOCK_FORM_KEYS, processes=procs)[1], k5=True)
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
                      stream=False, n_rest=ABLATE_REST)
    k7 = phase_ablate("cas-100k", ab_geom, ab_opnds, ABLATE_BLOCK, cases,
                      stream=True, n_rest=ABLATE_REST)
    # the block form: W = 6, bool-matmulproj at its largest table
    w6_geom, w6_opnds, _n = ablate_lane.operands(
        ABLATE_W6_OPS, processes=6, B=ABLATE_W6_RETURNS, device="cuda")
    if w6_geom[1] != 6:
        raise AssertionError(f"ablate W=6 shape: geometry {w6_geom}")
    for stream in (False, True):
        phase_ablate("cas W=6", w6_geom, w6_opnds, ABLATE_W6_RETURNS,
                     ABLATE_W6_CASES, stream, reps=2)
    log(f"ablate kernel phases (K6, K7): {time.perf_counter() - t0:.1f} s")
    log(f"kernel phases done at {time.perf_counter() - t_start:.1f} s; "
        f"memo tiers {memo_counters()} (the disk tier "
        f"{'off' if os.environ.get('JEPSEN_TPU_NO_PERSIST') else 'on'})")
    if KERNEL_PHASES_ONLY:
        return 0

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
    # held against K1's dead return and the walk split below (the CPU
    # run of a corrupted cas-48k is cut: PERF.md section 4; the CPU tests
    # hold chunk-lockstep's invalid route against the reference)
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
        f"launches {la})")
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
        raise AssertionError(f"{SCALE}: {res}")
    expect(SCALE, la, batch_walk=2, keyed_walk=0)
    log(f"scale {SCALE}: {res['engine']} valid={res['valid']} "
        f"chunks={res['chunks']} basis-max={res['basis-max']} "
        f"rescues={res['rescues']} {dt:.4f} s = {SCALE_OPS / dt:.1f} ops/s; "
        f"{split(dt, spans)}; history generated in a worker process, "
        f"{gen_s:.2f} s to wait for and load it, not counted; launches "
        f"{la}")

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
    # no CPU run at the long keys: the 2,000-key check above holds the
    # lockstep lane against it (PERF.md section 4's cuts)
    check_keyed(f"long keys {LONG_KEYS} x {LONG_OPS} ops", h_long, LONG_KEYS,
                LONG_BAD, "lockstep", cpu=False,
                batch_walk=planned_groups(per_key_long), keyed_walk=0,
                lane_walk=2 * len(LONG_BAD))
    # one live key is no lockstep batch: the native keyed lane on K3
    h_one, _ = keyed_histories(1, ONE_KEY_OPS, (0,))
    # no CPU run: phase_lanes holds K3's lane against the lockstep lane
    # key for key (PERF.md section 4's cuts)
    check_keyed(f"one key x {ONE_KEY_OPS} ops", h_one, 1, (0,), "keyed",
                cpu=False, keyed_walk=1, batch_walk=0, lane_walk=1)

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
    if res["valid"] is not False or res["engine"] != "reach-pallas" or \
            not res["final-configs"]:
        raise AssertionError(f"corrupted wide cas-100k: {res}")
    # against the CPU run on a shorter corrupted wide history (the CPU
    # run's time grows with the history), which the card checks too
    mid = gen("cas", WIDE_CPU_OPS, 5, 0, corrupt=True, **WIDE_CAS)
    res_mid, dt_mid, la_mid, _, _ = drive(lambda: linearizable(mid))
    expect(f"corrupted wide cas-{WIDE_CPU_OPS}", la_mid, wide_walk=2,
           lane_walk=0, batch_walk=0, keyed_walk=0, wide_keyed=0)
    t0 = time.perf_counter()
    ref = one_thread(lambda: linearizable(mid, device="cpu"))
    cpu_s = time.perf_counter() - t0
    for key in ("valid", "engine", "op", "dead-event", "max-linearized",
                "final-configs", "previous-ok"):
        if res_mid.get(key) != ref.get(key):
            raise AssertionError(f"corrupted wide cas-{WIDE_CPU_OPS}: {key} "
                                 f"differs cuda={res_mid.get(key)} "
                                 f"cpu={ref.get(key)}")
    if res_mid["valid"] is not False or not res_mid["final-configs"]:
        raise AssertionError(f"corrupted wide cas-{WIDE_CPU_OPS}: {res_mid}")
    log(f"main path corrupted wide cas-100k: {res['engine']} "
        f"valid={res['valid']} dead-event={res['dead-event']} {dt:.4f} s on "
        f"cuda ({split(dt, spans)}; launches {la}: the walk and the "
        f"witness prefix); corrupted wide cas-{WIDE_CPU_OPS}: dead-event="
        f"{res_mid['dead-event']} {dt_mid:.4f} s on cuda, {cpu_s:.3f} s on "
        f"cpu; verdict, op, dead event and witness agree")

    # the union's 41 states are outside K2's envelope: the native keyed
    # lane on K5; every key has at most 32 states of its own, so K1
    # re-walks each failed key's witness prefix in the key's own geometry
    # no CPU run: K5 is held against its plain version and the host
    # replay on these keys in phase_k5 (PERF.md section 4's cuts)
    check_keyed(f"wide independent cas {N_KEYS} keys x {OPS_PER_KEY} "
                f"ops over 40 values", h_wide_ind, N_KEYS, BAD_KEYS,
                "keyed-wide", cpu=False, wide_keyed=1, keyed_walk=0,
                batch_walk=0, wide_walk=0, lane_walk=len(BAD_KEYS))

    # -- the auto chain past the dense engine ---------------------------
    phase_chain()

    # -- the transactional checker: K8 and its main path ----------------
    k8 = phase_txn()

    # -- the command line ----------------------------------------------
    phase_cli()

    # -- the test runner ------------------------------------------------
    phase_run()

    # -- the other suites of run: mutex, set, counter, queue, etcd, redis,
    # txn ---------------------------------------------------------------
    phase_suites()

    # -- the check daemon: K1, K2, K4, K5 and K8 behind HTTP ------------
    h_txn = fixtures.gen_txn_history(**TXN_LATTICE)
    h_txn = history.index(h_txn + [op.with_(index=-1) for op in
                                   fixtures.txn_anomaly_block("write-skew")])
    phase_serve({"cas-100k": ("cas-register", h100k),
                 "cas-30k": ("cas-register", small),
                 "wide cas-100k": ("cas-register", wide),
                 "txn": ("txn-list-append", h_txn)}, serve_futures)

    # -- online checking and the streaming session engines: K9 ---------
    phase_online()
    phase_carry()
    k9 = phase_join()
    phase_txn_session()

    # -- the daemon's streaming sessions: K10 and its main path ---------
    k10 = phase_k10()
    phase_sessions(sess_future)

    # -- the word-packed post-hoc walk: K11 and its routes --------------
    k11 = phase_words(h100k, wide, small_batch)

    # -- the daemon's harnesses and the disk memo tier ------------------
    phase_harnesses()

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
        ("txn_inc_join", "txn_inc_join.cu", "jepsen_tpu/txn/cycles.py:482",
         total["txn_inc_join"], k9),
        ("mega_walk", "mega_walk.cu",
         "jepsen_tpu/checkers/reach_word.py:249", total["mega_walk"], k10),
        ("word_walk", "word_walk.cu",
         "jepsen_tpu/checkers/reach_word.py:162", total["word_walk"], k11),
    ]
    log(json.dumps({"kernels": [{
        "name": kname, "route": "cuda",
        "source": f"jepsen_tpu_torch/csrc/{src}", "replaces": replaces,
        "launches": n, "max_abs_err": k["max_abs_err"], "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": k.get("library_ms"),
        **{x: k[x] for x in K10_LINE_KEYS + K11_LINE_KEYS if x in k}}
        for kname, src, replaces, n, k in entries]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def harnesses_main() -> int:
    """``--harnesses``: the kernels built, then :func:`phase_harnesses`
    alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import _build, _native

    use_fresh_memo_cache()
    log(f"device: {torch.cuda.get_device_name(0)}; {smi()}")
    log(f"build: {_build.build_all():.3f} s")
    for lib in _native.LIBRARIES:
        _native.build(lib)
    phase_harnesses()
    log(f"main-path launches: {MAIN_PATH_LAUNCHES}")
    return 0


def words_main() -> int:
    """``--words``: the kernels built, then :func:`phase_words` alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import _build, _native

    use_fresh_memo_cache()
    log(f"device: {torch.cuda.get_device_name(0)}; {smi()}")
    log(f"build: {_build.build_all():.3f} s")
    log(ptxas_summary("word_walk", _build.build_log("word_walk")))
    for lib in _native.LIBRARIES:
        _native.build(lib)
    phase_words()
    log(f"main-path launches: {MAIN_PATH_LAUNCHES}")
    return 0


def sessions_main() -> int:
    """``--sessions``: the kernels built, then :func:`phase_k10` and
    :func:`phase_sessions` alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import _build, _native

    use_fresh_memo_cache()
    log(f"device: {torch.cuda.get_device_name(0)}; {smi()}")
    log(f"build: {_build.build_all():.3f} s")
    log(ptxas_summary("mega_walk", _build.build_log("mega_walk")))
    for lib in _native.LIBRARIES:
        _native.build(lib)
    streams = sess_submit()
    phase_k10()
    phase_sessions(streams)
    return 0


def serve_main(n: int) -> int:
    """``--serve N``: the kernels built, then :func:`phase_serve` alone
    with N cas requests."""
    global SERVE_N, SERVE_RERUN
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import _build, _native, fixtures, history

    use_fresh_memo_cache()
    log(f"device: {torch.cuda.get_device_name(0)}; {smi()}")
    SERVE_N, SERVE_RERUN = n, min(n, 64)
    log(f"build: {_build.build_all():.3f} s")
    for lib in _native.LIBRARIES:
        _native.build(lib)
    futures = serve_submit()
    h_txn = fixtures.gen_txn_history(**TXN_LATTICE)
    h_txn = history.index(h_txn + [op.with_(index=-1) for op in
                                   fixtures.txn_anomaly_block("write-skew")])
    phase_serve({"cas-100k": ("cas-register", gen("cas", 100_000, 5, 0)),
                 "cas-30k": ("cas-register", gen("cas", 30_000, 5, 0)),
                 "wide cas-100k": ("cas-register",
                                   gen("cas", 100_000, 5, 0, **WIDE_CAS)),
                 "txn": ("txn-list-append", h_txn)}, futures)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--serve"]:
            rc = serve_main(int(sys.argv[2]))
        elif sys.argv[1:2] == ["--sessions"]:
            rc = sessions_main()
        elif sys.argv[1:2] == ["--words"]:
            rc = words_main()
        elif sys.argv[1:2] == ["--harnesses"]:
            rc = harnesses_main()
        elif sys.argv[1:2] == ["--kernel-phases"]:
            KERNEL_PHASES_ONLY = True
            rc = main()
        else:
            rc = main()
    finally:
        if POOL is not None:
            POOL.shutdown(cancel_futures=True)
        if MEMO_CACHE_ROOT is not None:
            import shutil

            shutil.rmtree(MEMO_CACHE_ROOT, ignore_errors=True)
    sys.exit(rc)

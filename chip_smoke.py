"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``jepsen_tpu_torch/csrc``, holds each
kernel bit for bit against its plain PyTorch version on the card, then
drives the main path — ``Linearizable(cas_register()).check`` on a
100,000-op history, valid and corrupted, and on a 1,000,000-op history —
and checks the verdicts. Exits non-zero, with no result line, when there
is no CUDA device or any phase fails. The last two lines are one JSON
object of per-kernel numbers and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_RATE = 3.35e12       # H100 SXM device-memory bytes/s
# H100 SXM 32-bit integer operations/s: the data sheet's 67 TFLOP/s fp32
# is 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz; the integer pipe has 64
# lanes per SM, one operation each per clock: 132 x 64 x 1.98e9
INT32_PEAK = 132 * 64 * 1.98e9


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def lane_operands(kind, n_ops, processes, seed, corrupt=False):
    """The reference-shaped numpy operands of one history's returns walk."""
    from jepsen_tpu_torch import fixtures, history
    from jepsen_tpu_torch.checkers import events as ev
    from jepsen_tpu_torch.checkers import reach

    h = fixtures.gen_history(kind, n_ops=n_ops, processes=processes,
                             seed=seed)
    if corrupt:
        h = fixtures.corrupt(h, seed=seed)
    memo, stream, _T, S_pad, M = reach._prep(
        fixtures.model_for(kind), history.pack(h), max_states=100_000,
        max_slots=20, max_dense=1 << 22)
    rs = ev.returns_view(stream)
    R0 = np.zeros((S_pad, M), bool)
    R0[0, 0] = True
    return reach._build_P(memo, S_pad), rs, R0


def event_ms(fn, n: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``n`` launches, warmed."""
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


def lane_work(P: np.ndarray, ret_slot: np.ndarray, slot_ops: np.ndarray,
              R0_sm: np.ndarray, n_pass: int):
    """The 32-bit operations these inputs need in the bit form of the
    walk, by replaying it on the host with numpy: a mask's states are one
    word; firing pending slot j into mask m (bit j set) ORs the partner
    set's P rows, one per set bit, and ORs the image in; a projection
    moves M words. Returns ``(operations, final bool[S, M])``; the final
    set is a third, independent check of the kernel."""
    O1, S, _ = P.shape
    W = slot_ops.shape[1]
    M = 1 << W
    Pw = ((P > 0.5).astype(np.int64) << np.arange(S)).sum(2)   # [O1, S]
    v = ((R0_sm.T.astype(np.int64)) << np.arange(S)).sum(1)    # [M]
    masks = np.arange(M)
    hi = np.stack([masks[(masks >> j) & 1 == 1] for j in range(W)])
    bits_of = np.arange(S)
    ops = 0
    for r in range(ret_slot.shape[0]):
        pj = np.nonzero(slot_ops[r] >= 0)[0]
        if len(pj):
            sel = hi[pj]                                    # [c, M/2]
            rows = Pw[slot_ops[r, pj]][:, None, :]          # [c, 1, S]
            for _ in range(min(len(pj), n_pass)):
                partner = v[sel ^ (1 << pj)[:, None]]
                bits = (partner[..., None] >> bits_of) & 1  # [c, M/2, S]
                img = np.bitwise_or.reduce(np.where(bits == 1, rows, 0), 2)
                contrib = np.zeros((len(pj), M), np.int64)
                np.put_along_axis(contrib, sel, img, 1)
                v = v | np.bitwise_or.reduce(contrib, 0)
                ops += int(bits.sum()) + sel.size
        j = int(ret_slot[r])
        if j >= 0:
            v = np.where((masks >> j) & 1 == 1, 0, v[masks | (1 << j)])
            ops += M
    return ops, ((v[None, :] >> bits_of[:, None]) & 1).astype(bool)


def lane_bound_ms(args, B: int, operations: int):
    """Least time for one walk on this card: the larger of its bytes
    (each input read once, each output written once) over the memory
    rate and the 32-bit operations these inputs need (:func:`lane_work`)
    over the integer rate."""
    P, ret_slot, slot_ops, R0 = args
    R_pad = slot_ops.shape[0]
    M, S = R0.shape
    nbytes = 4 * (P.numel() + ret_slot.numel() + slot_ops.numel()
                  + R0.numel() + (R_pad // B + 1) * M * S)
    t_bytes, t_ops = nbytes / HBM_RATE, operations / INT32_PEAK
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            f"bytes={nbytes} int32_ops={operations}")


def check_smem_layout():
    """``reach_lane.smem_bytes`` (routing without a card) against the
    kernel's own ``jt_lane_walk_smem``, over the geometries it takes."""
    from jepsen_tpu_torch.checkers import reach_lane

    lib = reach_lane._lib()
    for W in range(1, reach_lane._MAX_W + 1):
        for S in (1, 8, 32):
            for O1 in (2, 37, 1000):
                for warp in (False, True):
                    got = lib.jt_lane_walk_smem(W, S, O1, int(warp))
                    if got != reach_lane.smem_bytes(W, S, O1, warp):
                        raise AssertionError(
                            f"smem layout differs at W={W} S={S} O1={O1} "
                            f"warp={warp}: kernel {got}, host "
                            f"{reach_lane.smem_bytes(W, S, O1, warp)}")


# (label, kind, n_ops, processes, seed, B, corrupt): the main path's
# shape first, then a multi-block walk and one past the ladder cap
GEOMS = [
    ("headline cas-100k", "cas", 100_000, 5, 0, 1024, False),
    ("W=7 multi-block", "cas", 4_000, 7, 1, 64, False),
    ("W=10 capped ladder", "cas", 1_000, 11, 0, 64, True),
]


def phase_kernels():
    """Each geometry: kernel vs plain version on the same CUDA tensors,
    bit for bit; times of the headline geometry."""
    from jepsen_tpu_torch.checkers import reach_lane

    out = {"max_abs_err": 0.0}
    for label, kind, n_ops, procs, seed, B, corrupt in GEOMS:
        P, rs, R0 = lane_operands(kind, n_ops, procs, seed, corrupt)
        args = reach_lane.operands_from_numpy(
            P, rs.ret_slot, rs.slot_ops, R0, B=B, device="cuda")
        W = rs.W
        for n_pass in sorted({min(W, reach_lane._FAST_PASSES), W}):
            ck, fin = reach_lane.lane_walk(*args, B, n_pass)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck_p, fin_p = reach_lane.lane_walk_plain(*args, B, n_pass)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t0)
            err = max(float((ck - ck_p).abs().max()),
                      float((fin - fin_p).abs().max()))
            same = torch.equal(ck, ck_p) and torch.equal(fin, fin_p)
            ms = event_ms(lambda: reach_lane.lane_walk(*args, B, n_pass),
                          10)
            operations, fin_host = lane_work(P, rs.ret_slot, rs.slot_ops,
                                             R0, n_pass)
            if not np.array_equal(fin_host, fin.cpu().numpy().T > 0.5):
                raise AssertionError(f"lane_walk differs from the host "
                                     f"replay at {label} n_pass={n_pass}")
            bound, bound_by, work = lane_bound_ms(args, B, operations)
            if W <= 5:
                # the shared-memory kernel on the same walk: the reason
                # the warp kernel exists
                ck_b, fin_b = reach_lane._lane_walk_cuda(*args, B, n_pass,
                                                         warp=False)
                if not (torch.equal(ck_b, ck) and torch.equal(fin_b, fin)):
                    raise AssertionError(f"lane_walk_block differs at "
                                         f"{label}")
                block_ms = event_ms(lambda: reach_lane._lane_walk_cuda(
                    *args, B, n_pass, warp=False), 10)
                log(f"kernel lane_walk [{label}] warp kernel {ms:.6f} ms, "
                    f"shared-memory kernel {block_ms:.6f} ms "
                    f"(bit-identical)")
            log(f"kernel lane_walk [{label}] W={W} S={P.shape[1]} "
                f"O1={P.shape[0]} returns={rs.n_returns} "
                f"R_pad={args[1].shape[0]} B={B} n_pass={n_pass}: "
                f"bit-identical={same} max_abs_err={err} "
                f"kernel_ms={ms:.6f} "
                f"us_per_return={1e3 * ms / rs.n_returns:.6f} "
                f"plain_ms={plain_ms:.3f} bound_ms={bound:.6f} "
                f"({bound_by}; {work}) alive={bool(fin.any())}")
            if not same:
                raise AssertionError(f"lane_walk differs from its plain "
                                     f"version at {label} n_pass={n_pass}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            if label.startswith("headline"):
                out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
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


def phase_main(history, expect_valid: bool):
    """One check through the user's entry point on the card. Returns the
    result, its wall seconds, the kernel launches it made and its span
    seconds by name."""
    from jepsen_tpu_torch import Linearizable, models, obs
    from jepsen_tpu_torch.checkers import reach_lane

    reach_lane.KERNEL_LAUNCHES = 0
    with obs.capture() as cap:
        t0 = time.perf_counter()
        res = Linearizable(models.cas_register()).check(None, history)
        dt = time.perf_counter() - t0
    launches = reach_lane.KERNEL_LAUNCHES
    spans = {s["name"]: s["dur"] / 1e6 for s in cap.spans}
    if res["valid"] is not expect_valid:
        raise AssertionError(f"expected valid={expect_valid}: {res}")
    if launches < 1:
        raise AssertionError("the main path did not launch the kernel")
    return res, dt, launches, spans


def split(dt: float, spans) -> str:
    """Where a check's seconds went, by the spans the port records:
    packing the history, memo and event-stream prep, the returns view,
    the walk on the card, the witness re-walk, and the rest."""
    parts = [("pack", "facade.pack"), ("prep", "reach.prep"),
             ("returns-view", "reach.returns-view"),
             ("walk", "reach.walk"), ("witness", "reach.witness")]
    out, rest = [], dt
    for label, name in parts:
        t = spans.get(name, 0.0)
        rest -= t
        out.append(f"{label} {t:.4f} s ({100 * t / dt:.1f}%)")
    out.append(f"other {rest:.4f} s ({100 * rest / dt:.1f}%)")
    return ", ".join(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from jepsen_tpu_torch import Linearizable, _build, fixtures, models

    name = torch.cuda.get_device_name(0)
    card = smi()
    log(f"device: {name} (count {torch.cuda.device_count()}); "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    build_s = _build.build_all()
    log(f"build: {build_s:.3f} s for {list(_build.sources())}")
    for src in _build.sources():
        log(_build.build_log(src).strip())
    check_smem_layout()

    kern = phase_kernels()

    h = fixtures.gen_history("cas", n_ops=100_000, processes=5, seed=0)
    res, dt, launches, spans = phase_main(h, True)
    log(f"main path valid cas-100k: {res['engine']} valid={res['valid']} "
        f"{dt:.4f} s = {100_000 / dt:.1f} ops/s; {split(dt, spans)}; "
        f"kernel launches {launches}")
    main_launches = launches

    bad = fixtures.corrupt(h, seed=0)
    res, dt, launches, spans = phase_main(bad, False)
    t0 = time.perf_counter()
    ref = Linearizable(models.cas_register(), device="cpu").check(None, bad)
    cpu_s = time.perf_counter() - t0
    for key in ("valid", "op", "dead-event", "max-linearized",
                "final-configs", "previous-ok"):
        if res.get(key) != ref.get(key):
            raise AssertionError(f"corrupted cas-100k: {key} differs "
                                 f"cuda={res.get(key)} cpu={ref.get(key)}")
    log(f"main path corrupted cas-100k: valid={res['valid']} "
        f"dead-event={res['dead-event']} {dt:.4f} s on cuda "
        f"({launches} launches; {split(dt, spans)}), {cpu_s:.3f} s on "
        f"cpu; verdict, op, dead event and witness agree")

    t0 = time.perf_counter()
    big = fixtures.gen_history("cas", n_ops=1_000_000, processes=5, seed=1)
    gen_s = time.perf_counter() - t0
    res, dt, launches, spans = phase_main(big, True)
    log(f"scale cas-1M: valid={res['valid']} {dt:.4f} s = "
        f"{1_000_000 / dt:.1f} ops/s; {split(dt, spans)}; history "
        f"generation {gen_s:.2f} s not counted; kernel launches "
        f"{launches}")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "lane_walk", "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/lane_walk.cu",
        "replaces": "jepsen_tpu/checkers/reach_lane.py:201",
        "launches": main_launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": None}]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

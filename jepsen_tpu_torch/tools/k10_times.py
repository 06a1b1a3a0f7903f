"""Times of K10 (``csrc/mega_walk.cu``), the streaming sessions'
mega-group advance, at 64 and 1,024 lanes of cas carries (K1's route)
and of multi-register carries over 64 states (K4's route), the same
walks on any checkout ``TREE`` (:func:`_group`), so that two trees
compare in one call: the first design (its wrapper takes
lists of P, tables and sets and the padded stream on the card) and the
later one (lane handles checked when a carry is seeded, the wave staged
in one pinned buffer, the named ops' table slices in shared memory).

For each group:

- ``kernel_ms``: the kernel alone, the median of :data:`REPS` waves. On
  a tree with lane handles, CUDA events that the C entry point records
  right around the launch. On the first design, CUDA events around the
  wrapper's call while ``torch.cuda._sleep`` holds the stream for longer
  than the wrapper's host work, so that the first event fires after that
  work: the window then holds the descriptors' copy, the last host steps
  before the launch and the kernel, an upper bound of the kernel alone;
- ``device_ms``: the device's own record of the kernel, read through
  ``torch.profiler`` (``tools/keyed_times.device_ms``), where it has one;
- ``wrapper_ms``: the host's time until the launch is queued, by
  ``perf_counter`` (the first design: ``mega_walk`` on the padded
  tensors; the later one: ``launch_frontiers_mega``, the rows, the
  staging, the copy and the launch);
- ``launch_ms``: the launch with its wrapper, CUDA events around
  :data:`REPS` calls (``chip_smoke.event_ms``);
- ``blocks_per_sm`` and the table place (the later design).

Usage, from the root of a checkout (``TREE`` default ``.``)::

    python -m jepsen_tpu_torch.tools.k10_times [TREE]

Prints one line, ``K10_TIMES`` and a JSON object, and the card's name
and power limit. It needs the card.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

from jepsen_tpu_torch.tools.keyed_times import device_ms
from jepsen_tpu_torch.tools.table_times import use_tree

REPS = 5
LANES = 1_024
# cycles the stream is held before the first event: 50 ms at 1.98 GHz,
# longer than the first design's per-lane host work at 1,024 lanes
SLEEP_CYCLES = 100_000_000


def _group(cs, kind, model, L, seed, **kw):
    """L carries of one geometry on the card and a block each, made the
    same way on any tree (so that two trees time the same walks): the
    most common geometry of 8 histories of 3,000 ops (one in four
    corrupted), lane i on history i mod their count, every other lane
    seeded with a random set over the one-hot one, and a ragged block of
    16-160 returns at a random offset."""
    import numpy as np

    from jepsen_tpu_torch import history
    from jepsen_tpu_torch.checkers import events, reach

    rng = np.random.RandomState(seed)
    by_sig = {}
    for s in range(8):
        h = cs.gen(kind, 3_000, 5, seed + s, corrupt=s % 4 == 1, **kw)
        memo, stream, _T, _S, M = reach._prep(
            model, history.pack(h), max_states=100_000, max_slots=20,
            max_dense=1 << 22)
        R0 = np.zeros((memo.n_states, M), bool)
        R0[0, 0] = True
        c = reach.FrontierCarry(memo, M.bit_length() - 1, R0, device="cuda")
        by_sig.setdefault(c.mega_sig, []).append(
            (memo, events.returns_view(stream), M))
    sig, members = max(by_sig.items(), key=lambda kv: len(kv[1]))
    carries, blocks = [], []
    for i in range(L):
        memo, rs, M = members[i % len(members)]
        R0 = rng.random_sample((memo.n_states, M)) < (0.05 if i % 2 else 0)
        R0[0, 0] = True
        carries.append(reach.FrontierCarry(memo, M.bit_length() - 1, R0,
                                           device="cuda"))
        n = rng.randint(16, 161)
        off = rng.randint(0, max(1, rs.n_returns - n))
        blocks.append((rs.ret_slot[off:off + n], rs.slot_ops[off:off + n]))
    return carries, blocks, sig


def _median(xs) -> float:
    return float(statistics.median(xs))


def _first_design(cs, reach_word, carries, blocks, narrow) -> dict:
    P, T, R, rs, so, lens = cs.k10_operands(carries, blocks)

    def call():
        return reach_word.mega_walk(P, T, R, rs, so, lens, narrow)

    call()
    torch.cuda.synchronize()
    kern, host = [], []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        call()
        e1.record()
        torch.cuda.synchronize()
        kern.append(e0.elapsed_time(e1))
    for _ in range(REPS):          # the stream idle: no copy waits on it
        t0 = time.perf_counter()
        call()
        host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return {"kernel_ms": _median(kern), "kernel_ms_is": "upper bound",
            "wrapper_ms": _median(host), "launch_ms": cs.event_ms(call, REPS),
            "device_ms": (device_ms(call, REPS) or {}).get("total")}


def _lane_design(cs, reach_word, carries, blocks, narrow, sig) -> dict:
    lanes, stage = cs.k10_stage(carries, blocks)
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    reach_word.mega_walk(lanes, stage, narrow)
    for pair in evs:
        reach_word.mega_walk(lanes, stage, narrow, events=pair)
    torch.cuda.synchronize()
    kern = [e0.elapsed_time(e1) for e0, e1 in evs]
    host = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reach_word.launch_frontiers_mega(carries, blocks)
        host.append(1e3 * (time.perf_counter() - t0))
    out = {"kernel_ms": _median(kern), "kernel_ms_is": "events in the C "
           "entry point", "wrapper_ms": _median(host),
           "launch_ms": cs.event_ms(lambda: reach_word.launch_frontiers_mega(
               carries, blocks), REPS),
           "device_ms": (device_ms(lambda: reach_word.mega_walk(
               lanes, stage, narrow), REPS) or {}).get("total")}
    _engine, S, _W, O1 = sig
    for place in ("auto", "shared", "global"):
        try:
            d = reach_word.mega_design(stage, S, O1, narrow, place)
        except RuntimeError as e:          # the shared slices do not fit
            out[f"design_{place}"] = str(e)
            continue
        out[f"design_{place}"] = d
        if place != "auto":
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(REPS)]
            for pair in ev:
                reach_word.mega_walk(lanes, stage, narrow, place=place,
                                     events=pair)
            torch.cuda.synchronize()
            out[f"kernel_ms_{place}"] = _median(
                [e0.elapsed_time(e1) for e0, e1 in ev])
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tree = os.path.abspath(argv[0] if argv else ".")
    cs = use_tree(tree)
    from jepsen_tpu_torch import _build, models
    from jepsen_tpu_torch.checkers import reach_word

    t0 = time.perf_counter()
    _build.build_all()
    out = {"tree": tree, "build_s": time.perf_counter() - t0}
    lanes_api = hasattr(reach_word, "MegaLane")
    for label, kind, model, kw in (
            ("cas", "cas", models.cas_register(), {}),
            ("multi-register S=64", "multi", models.multi_register(),
             cs.WIDE_MULTI)):
        carries, blocks, sig = _group(cs, kind, model, LANES, 905, **kw)
        narrow = sig[0] == "reach-lane"
        for L in (64, LANES):
            key = f"{label} L={L}"
            out[key] = (_lane_design(cs, reach_word, carries[:L],
                                     blocks[:L], narrow, sig) if lanes_api
                        else _first_design(cs, reach_word, carries[:L],
                                           blocks[:L], narrow))
            out[key]["geometry"] = list(sig)
    print("K10_TIMES " + json.dumps(out), flush=True)
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

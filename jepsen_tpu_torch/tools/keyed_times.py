"""Device-only times of the keyed walks, K3 (``csrc/keyed_walk.cu``) and
K5 (``csrc/wide_keyed.cu``), each with the ``pack_tables`` launch a
table walk starts with, at the shapes ``chip_smoke.py`` holds them at:

- K3 at the independent shape (2,000 keys of 50 cas ops, 4 processes a
  key: W = 4), in the warp form and in the block form;
- K3's block form and K5 (whose block form takes any number of words a
  mask) on the same 2,000 keys at W = 6 and W = 8 (6 and 8 processes a
  key);
- K5 at the independent shape;
- K3 at the long-keys shape (:data:`LONG_KEYS` keys of :data:`LONG_OPS`
  cas ops);
- ``reach_lane.walk_returns_keyed`` (K3's host side: the operands to the
  card, the keys' runs, the launch and the dead indices back) at the
  independent shape, by the host's clock: the median of 20 calls;
- the independent check of the 2,000 keys, twice: its wall time and its
  ``reach.walk`` span.

A launch's device time is the sum of the durations the card records for
the kernels one call launches (:func:`device_ms`: CUPTI's kernel records,
read through ``torch.profiler``). The wrapper's host work (operand
checks, allocation, the ctypes call), which CUDA events around the call
count, is not in it.

Usage, from the root of a checkout (``TREE``, default ``.``, is the root
of the checkout whose kernels are timed, so that two trees compare in
one call)::

    python -m jepsen_tpu_torch.tools.keyed_times [TREE]

Prints one line, ``KEYED`` and a JSON object of ms by shape, and the
card's name and power limit. It needs the card.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import sys
import time
from typing import Callable, Dict, Optional

import torch

from jepsen_tpu_torch.tools.table_times import use_tree

# the long-keys shape: 1,000 cas ops a key, 4 processes, keys 7 and 107
# corrupted
LONG_KEYS, LONG_OPS, LONG_BAD = 200, 1_000, (7, 107)


def _short(name: str) -> str:
    """A kernel's name without its namespace, return type or parameters:
    ``walk_warp<1, 2, true, true, false>``."""
    name = name.replace("(anonymous namespace)::", "")
    return re.sub(r"^void ", "", name).split("(")[0]


def device_ms(fn: Callable[[], object], n: int = 20) -> Optional[dict]:
    """The device's own time of one call of ``fn``, which launches each
    of its kernels once: over ``n`` calls after one to warm up, the mean
    duration of each kernel's records (``"kernels"``, by :func:`_short`
    name), their sum (``"total"``, ms) and the share of the ``n`` calls'
    launches the profiler recorded (``"recorded"``: it may drop some,
    which the means do not depend on). None when it records no
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    durs: Dict[str, list] = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or \
                e.name.startswith(("Memcpy", "Memset")):
            continue
        dur = e.time_range.end - e.time_range.start        # microseconds
        durs.setdefault(_short(e.name), []).append(dur / 1e3)
    if not durs:
        return None
    kernels = {k: sum(v) / len(v) for k, v in durs.items()}
    return {"total": sum(kernels.values()), "kernels": kernels,
            "recorded": sum(map(len, durs.values())) / (n * len(durs))}


def per_key_histories(n_keys: int, n_ops: int, processes: int, bad):
    """One cas history a key (seed = the key), the keys in ``bad``
    corrupted: the histories ``chip_smoke.keyed_operands`` takes."""
    from jepsen_tpu_torch import fixtures

    out = []
    for k in range(n_keys):
        h = fixtures.gen_history("cas", n_ops=n_ops, processes=processes,
                                 seed=k)
        out.append(fixtures.corrupt(h, seed=k) if k in bad else h)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    cs = use_tree(os.path.abspath(argv[0] if argv else "."))
    from jepsen_tpu_torch import Linearizable, _build, independent, models
    from jepsen_tpu_torch.checkers import reach_lane, reach_pallas

    t0 = time.perf_counter()
    _build.build_all()
    out = {"tree": os.getcwd(), "build_s": time.perf_counter() - t0}
    bad = set(range(7, 2_000, 100))
    for procs in (4, 6, 8):
        _P, _ret, _ops, W, t = cs.keyed_operands(
            per_key_histories(2_000, 50, procs, bad))
        lo, hi = reach_lane._key_runs(t[3], 2_000)
        forms = ((True, False) if procs == 4 else (False,))
        for warp in forms:
            out[f"k3 W={W} {'warp' if warp else 'block'}"] = device_ms(
                lambda: reach_lane._keyed_launch(*t[:3], lo, hi, W, warp))
        out[f"k5 W={W}"] = device_ms(
            lambda: reach_pallas._keyed_launch(*t[:3], lo, hi))
        if procs == 4:
            P, ret, ops, key = _P, _ret, _ops, t[3].cpu().numpy()
            wall = []
            for _ in range(21):
                t0 = time.perf_counter()
                reach_lane.walk_returns_keyed(P, ret, ops, key, 2_000,
                                              1 << W)
                wall.append(1e3 * (time.perf_counter() - t0))
            out["walk_returns_keyed host ms"] = statistics.median(wall[1:])
    _P, _ret, _ops, W, t = cs.keyed_operands(
        per_key_histories(LONG_KEYS, LONG_OPS, 4, LONG_BAD))
    lo, hi = reach_lane._key_runs(t[3], LONG_KEYS)
    out[f"k3 long keys W={W} warp"] = device_ms(
        lambda: reach_lane._keyed_launch(*t[:3], lo, hi, W), 10)
    h_ind, _per_key = cs.keyed_histories()
    for i in range(2):
        _res, dt, _la, spans, _ = cs.drive(lambda: independent.checker(
            Linearizable(models.cas_register())).check(None, h_ind))
        out[f"independent #{i}"] = {"wall_s": dt,
                                    "walk_s": spans.get("reach.walk")}
    out["card"] = cs.smi()
    print("KEYED " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

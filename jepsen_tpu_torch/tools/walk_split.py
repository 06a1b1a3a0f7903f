"""Where an invalid single-history check spends its walk, stage by stage.

Runs ``Linearizable(cas_register()).check`` on a corrupted cas history
(:data:`OPS` ops, 5 processes, seed :data:`SEED`: the chunk-lockstep
route) twice after a warm-up: once as a user would, for the wall time and the
spans the port records, and once with each stage of the walk wrapped,
the device synchronised before and after it, for the split:

- ``phase-a``, ``phase-b``: chunk-lockstep's two K2 launches;
- ``glue``, ``fold``: the seed glue and the fold on the device;
- ``localize``: the dead chunk's re-walk, of which ``k1 in localize`` is
  K1 and ``refine`` the refinement of a dying block, if any;
- ``torch-walk``: the eager torch returns walk (``reach._walk_returns``),
  with the returns it walked;
- ``witness-prefix``: the witness prefix walk, of which ``k1 in
  witness-prefix`` is K1.

With ``--kernels`` it also times, by CUDA events, K1's walk of a valid
cas history of 30,000 ops (the main path's K1 shape, below
chunk-lockstep's floor) and K2's two chunk-lockstep phases on a valid
cas-100k history, through the modules' public wrappers, so that two
trees can be compared in one call.

Usage::

    python -m jepsen_tpu_torch.tools.walk_split [--kernels]

Prints one JSON line. It runs on the card, and raises when there is
none; :func:`split` also takes ``device="cpu"`` (the plain versions).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Any, Dict, List

import torch

from jepsen_tpu_torch import device as _device

OPS = 100_000  # the corrupted history's ops
SEED = 0       # its generator's and its corruption's seed

# (module, attribute, stage): the wrapped stages, outermost first
_STAGES = [
    ("reach_chunklock", "_localize", "localize"),
    ("reach_lane", "prefix_set", "witness-prefix"),
    ("reach_batch", "batch_walk", "phase"),
    ("reach_chunklock", "_glue_call", "glue"),
    ("reach_chunklock", "_fold_call", "fold"),
    ("reach_lane", "_refine_dead", "refine"),
    ("reach_lane", "lane_walk", "k1"),
    ("reach", "_walk_returns", "torch-walk"),
]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def staged(dev: torch.device):
    """Wrap every stage of :data:`_STAGES` while the block runs (a stage
    that is not there raises, so a stage never called is one the check
    did not run). Yields ``(ms, calls, returns)``, dicts by stage: K1
    launches are filed under the outer stage that made them (``k1 in
    localize``), K2's under ``phase-a`` and ``phase-b`` in call order,
    and the torch walk counts the returns it was given."""
    from jepsen_tpu_torch.checkers import (reach, reach_batch,
                                           reach_chunklock, reach_lane)

    mods = {"reach": reach, "reach_batch": reach_batch,
            "reach_chunklock": reach_chunklock, "reach_lane": reach_lane}
    ms: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    returns: Dict[str, int] = {}
    outer: List[str] = []
    saved = []

    def wrap(fn, stage):
        def timed(*a, **k):
            label = stage
            if stage == "phase":
                label = "phase-b" if calls.get("phase-a") else "phase-a"
            elif stage == "k1" and outer:
                label = f"k1 in {outer[-1]}"
            if stage == "torch-walk":
                returns[label] = returns.get(label, 0) + len(a[3])
            outer.append(label)
            _sync(dev)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                _sync(dev)
                outer.pop()
                ms[label] = ms.get(label, 0.0) + \
                    1e3 * (time.perf_counter() - t0)
                calls[label] = calls.get(label, 0) + 1
        return timed

    try:
        for mod, attr, stage in _STAGES:
            m = mods[mod]
            fn = getattr(m, attr)
            saved.append((m, attr, fn))
            setattr(m, attr, wrap(fn, stage))
        yield ms, calls, returns
    finally:
        for m, attr, fn in reversed(saved):
            setattr(m, attr, fn)


def split(history, device=None) -> Dict[str, Any]:
    """The check of ``history`` on ``device`` (default: the card): one
    warm-up, one run as a user makes it (``wall_s``, ``spans`` summed by
    name, the result's verdict and dead event) and one with
    :func:`staged` (``split_ms``, ``calls``, ``torch_walk_returns``)."""
    from jepsen_tpu_torch import Linearizable, models, obs

    dev = _device.resolve(device)

    def check():
        return Linearizable(models.cas_register(),
                            device=dev).check(None, history)

    check()
    with obs.capture() as cap:
        t0 = time.perf_counter()
        res = check()
        _sync(dev)
        wall = time.perf_counter() - t0
    spans: Dict[str, float] = {}
    for s in cap.spans:
        spans[s["name"]] = spans.get(s["name"], 0.0) + s["dur"] / 1e6
    with staged(dev) as (ms, calls, returns):
        t0 = time.perf_counter()
        again = check()
        staged_wall = time.perf_counter() - t0
    if again.get("dead-event") != res.get("dead-event"):
        raise AssertionError("the staged run found another dead event")
    return {"valid": res["valid"], "engine": res.get("engine"),
            "dead-event": res.get("dead-event"), "wall_s": wall,
            "spans_s": spans, "staged_wall_s": staged_wall,
            "split_ms": ms, "calls": calls,
            "torch_walk_returns": returns.get("torch-walk", 0)}


def _event_ms(fn, n: int) -> float:
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


def kernel_times() -> Dict[str, float]:
    """Mean ms of K1 on cas-30k (B = 1,024, the exact ladder) and of K2's
    phases A and B on cas-100k, over 5 launches each, on the card."""
    import numpy as np

    from jepsen_tpu_torch import fixtures, history, models
    from jepsen_tpu_torch.checkers import events as ev
    from jepsen_tpu_torch.checkers import reach, reach_batch
    from jepsen_tpu_torch.checkers import reach_chunklock as rcl
    from jepsen_tpu_torch.checkers import reach_lane

    n = 5

    def operands(n_ops):
        h = fixtures.gen_history("cas", n_ops=n_ops, processes=5, seed=0)
        memo, stream, _T, S_pad, M = reach._prep(
            models.cas_register(), history.pack(h), max_states=100_000,
            max_slots=20, max_dense=1 << 22)
        return reach._build_P(memo, S_pad), ev.returns_view(stream), M

    out = {}
    P, rs, M = operands(30_000)
    R0 = np.zeros((P.shape[1], M), bool)
    R0[0, 0] = True
    args = reach_lane.operands_from_numpy(P, rs.ret_slot, rs.slot_ops, R0,
                                          device="cuda")
    out["k1 cas-30k"] = _event_ms(
        lambda: reach_lane.lane_walk(*args, 1024, rs.W), n)
    P, rs, M = operands(100_000)
    C, e_pad, _per, (P_t, ops_a, rs_a, r0_a, b_a), (_, ops_b, rs_b, b_b) = \
        rcl.phase_operands(P, rs.ret_slot, rs.slot_ops, M, device="cuda")
    _ck, final_a = reach_batch.batch_walk(P_t, ops_a, rs_a, r0_a, b_a, rs.W)
    _s, r0_b, _c = rcl._glue_call(final_a, C, M, P.shape[1], e_pad)
    out["k2 cas-100k phase A"] = _event_ms(
        lambda: reach_batch.batch_walk(P_t, ops_a, rs_a, r0_a, b_a, rs.W), n)
    out["k2 cas-100k phase B"] = _event_ms(
        lambda: reach_batch.batch_walk(P_t, ops_b, rs_b, r0_b, b_b, rs.W), n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args(argv)
    from jepsen_tpu_torch import fixtures

    dev = _device.resolve(None)
    h = fixtures.corrupt(fixtures.gen_history(
        "cas", n_ops=OPS, processes=5, seed=SEED), seed=SEED)
    out = split(h, dev)
    out.update(ops=OPS, seed=SEED, card=torch.cuda.get_device_name(dev))
    if args.kernels:
        out["kernels_ms"] = kernel_times()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

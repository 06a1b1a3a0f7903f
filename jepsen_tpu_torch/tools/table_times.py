"""Times of the walks on P's nibble image tables (K1, K2, K4, K5), by
CUDA events, on the shapes ``chip_smoke.py`` holds them against their
plain versions:

- K1 and K4 on cas-30k, alternating, twice each;
- K1 on cas-30k and K2's two chunk-lockstep phases on cas-100k
  (:func:`walk_split.kernel_times`);
- the block forms at W = 7: K4 and K1 on cas-4k, K4 on a multi-register
  history of 5,000 ops;
- K4 on multi-register-20k (tables in shared memory) and on the cas-40
  alphabet at 30,000 ops (tables in device memory);
- K5 on 2,000 keys over 40 values.

Usage, from the root of a checkout (``TREE``, default ``.``, is the root
of the checkout whose kernels and ``chip_smoke.py`` are timed, so that
two trees compare in one call)::

    python -m jepsen_tpu_torch.tools.table_times [TREE]

Prints one line, ``K1K4`` and a JSON object of ms by shape, the card's
name and power limit. It needs the card.
"""
from __future__ import annotations

import json
import os
import sys
import time


def use_tree(tree: str):
    """Make the checkout at ``tree`` the one whose ``chip_smoke`` and
    ``jepsen_tpu_torch`` are imported from here on (its kernels built
    there), and return its ``chip_smoke``."""
    sys.path.insert(0, tree)
    for name in [m for m in sys.modules if m == "chip_smoke"
                 or m.split(".")[0] == "jepsen_tpu_torch"]:
        del sys.modules[name]  # import the tree's own modules below
    os.chdir(tree)
    import chip_smoke as cs

    if not cs.__file__.startswith(tree):
        raise RuntimeError(f"chip_smoke from {cs.__file__}, not {tree}")
    return cs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tree = os.path.abspath(argv[0] if argv else ".")
    cs = use_tree(tree)
    from jepsen_tpu_torch import _build, models
    from jepsen_tpu_torch.checkers import reach_lane, reach_pallas
    from jepsen_tpu_torch.tools import walk_split

    t0 = time.perf_counter()
    _build.build_all()
    out = {"tree": tree, "build_s": time.perf_counter() - t0}
    P, rs, M = cs.history_operands(cs.gen("cas", 30_000, 5, 0),
                                   models.cas_register())
    R0 = cs.one_hot(P, M)
    la = reach_lane.operands_from_numpy(P, rs.ret_slot, rs.slot_ops, R0,
                                        device="cuda")
    wa = reach_pallas.operands_from_numpy(P, rs.ret_slot, rs.slot_ops, R0,
                                          device="cuda")
    for i in range(2):
        out[f"k1 cas-30k #{i}"] = cs.event_ms(
            lambda: reach_lane.lane_walk(*la, 1024, rs.W), 5)
        out[f"k4 cas-30k #{i}"] = cs.event_ms(
            lambda: reach_pallas.walk(*wa, rs.n_returns), 5)
    out.update(walk_split.kernel_times())
    shapes = [
        ("k4 narrow W=7 block", cs.gen("cas", 4_000, 7, 1),
         models.cas_register()),
        ("k4 wide W=7 block",
         cs.gen("multi", 5_000, 7, 0, **cs.WIDE_MULTI),
         models.multi_register()),
        ("k4 multi-register-20k",
         cs.gen("multi", 20_000, 5, 0, **cs.WIDE_MULTI),
         models.multi_register()),
        ("k4 cas-40 alphabet 30k ops",
         cs.gen("cas", 30_000, 5, 0, **cs.WIDE_CAS), models.cas_register()),
    ]
    for label, h, model in shapes:
        P, r, _ = cs.history_operands(h, model)
        R0 = cs.one_hot(P, 1 << r.W)
        a = reach_pallas.operands_from_numpy(P, r.ret_slot, r.slot_ops, R0,
                                             device="cuda")
        out[label] = cs.event_ms(lambda: reach_pallas.walk(*a, r.n_returns),
                                 5)
        if label.startswith("k4 narrow"):
            a1 = reach_lane.operands_from_numpy(P, r.ret_slot, r.slot_ops,
                                                R0, B=64, device="cuda")
            out["k1 narrow W=7 block"] = cs.event_ms(
                lambda: reach_lane.lane_walk(*a1, 64, r.W), 5)
    _h, per_key = cs.keyed_histories(**cs.WIDE_CAS)
    _P, _ret, _ops, _W, t = cs.keyed_operands(per_key)
    lo, hi = reach_lane._key_runs(t[3], len(per_key))
    out["k5 wide independent"] = cs.event_ms(
        lambda: reach_pallas._keyed_launch(*t[:3], lo, hi), 20)
    out["card"] = cs.smi()
    print("K1K4 " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

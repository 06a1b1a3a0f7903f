"""Times of the ablation kernels, K6 (``csrc/ablate_walk.cu``) and K7
(``csrc/ablate_stream.cu``), on the harness's cas-100k operand set:

- every variant's best time over the full ladder
  (``ablate_lane.ladder``, two interleaved rounds, all returns), as ms
  and as µs a return;
- one K6 launch (``v2-bool-blend``) and one K7 launch (``bool-stream``)
  on the first 1,024 returns, by CUDA events around the wrapper
  (``event_ms``) and by the device's own kernel records
  (``keyed_times.device_ms``: for K6 the ``pack_tables`` launch and the
  walk).

Usage, from the root of a checkout (``TREE``, default ``.``, is the root
of the checkout whose kernels are timed, so that two trees compare in
one call)::

    python -m jepsen_tpu_torch.tools.ablate_times [TREE]

Prints one line, ``ABLATE`` and a JSON object, with the card's name and
power limit. It needs the card.
"""
from __future__ import annotations

import json
import os
import sys
import time

from jepsen_tpu_torch.tools.keyed_times import device_ms
from jepsen_tpu_torch.tools.table_times import use_tree

FIRST = 1024


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    tree = os.path.abspath(argv[0] if argv else ".")
    cs = use_tree(tree)
    from jepsen_tpu_torch import _build
    from jepsen_tpu_torch.tools import ablate_lane as ab

    t0 = time.perf_counter()
    _build.build_all(["ablate_walk", "ablate_stream"])
    out = {"tree": tree, "build_s": time.perf_counter() - t0}
    geom, opnds, n_ret = ab.operands(device="cuda")
    res = ab.ladder(list(ab.VARIANTS), geom, opnds, repeat=2)
    out["returns"] = n_ret
    out["ladder_ms"] = {name: ms for name, (ms, _f) in res.items()}
    out["ladder_us_per_return"] = {name: 1e3 * ms / n_ret
                                   for name, (ms, _f) in res.items()}
    B, W = geom[:2]
    ret, ops, P, PJ, R0 = opnds
    ret, ops = ret[:FIRST], ops[:FIRST]
    fire, proj, counts, unroll, n_pass, cgate = ab.spec("v2-bool-blend", W)

    def k6():
        return ab.ablate_walk(P, ret, ops, PJ, R0, B, n_pass, fire, proj,
                              counts, unroll, cgate)

    fire, _proj, counts, _u, n_pass, _g = ab.spec("bool-stream", W)
    G = ab.stream_operand(P, ops)

    def k7():
        return ab.ablate_stream(ret, G, R0, B, n_pass, fire, counts)

    for label, fn in (("k6 v2-bool-blend", k6), ("k7 bool-stream", k7)):
        out[f"{label} first {FIRST}"] = {"event_ms": cs.event_ms(fn, 5),
                                         "device_ms": device_ms(fn, 5)}
    out["card"] = cs.smi()
    print("ABLATE " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

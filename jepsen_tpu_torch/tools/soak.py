"""Full-harness soak: run every suite end-to-end across modes and seeds
and assert the EXPECTED verdict for each (correct modes must pass,
deliberately-buggy modes must be caught). This exercises the whole
stack — generators, worker threads, nemeses, fault injection, clients
(including the etcd HTTP and redis RESP wire paths), checkers on the
card, store — far longer than the tests do.

Usage::

    python -m jepsen_tpu_torch.tools.soak [--rounds 3] [--time-limit 2.0]
        [--seed 0] [--device cpu]

Every check runs on ``--device``: the card unless ``--device cpu`` is
given. Exit 1 on any unexpected verdict. One JSON summary line at the
end. The same configs and rule as the reference's ``tools/soak.py``.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time


def build(suite: str, mode: str, seed: int, time_limit: float,
          device=None):
    from jepsen_tpu_torch.suites import (counter, etcd, mutex, queue, redis,
                                         register, set_suite)
    kw = dict(time_limit=time_limit, seed=seed, store=False,
              with_nemesis=True, nemesis_interval=0.3, device=device)
    if suite == "register":
        return register.register_test(mode, concurrency=5, **kw)
    if suite == "etcd":
        return etcd.etcd_test(mode, concurrency=5, **kw)
    if suite == "redis":
        return redis.redis_test(mode, concurrency=5, **kw)
    if suite == "mutex":
        return mutex.mutex_test(mode, concurrency=4, **kw)
    if suite == "queue":
        return queue.queue_test(mode, concurrency=4, **kw)
    if suite == "set":
        return set_suite.set_test(mode, concurrency=4, **kw)
    if suite == "counter":
        return counter.counter_test(mode, concurrency=4, **kw)
    raise ValueError(suite)


# (suite, mode, expected top-level valid). Buggy modes rely on nemesis
# timing, so their expectation is "False OR True" only when the fault
# window may not align — the strict ones are the deliberately-seeded
# deterministic configs asserted in tests/; here sloppy modes get
# several rounds so a never-caught bug still fails the soak overall.
CONFIGS = [
    ("register", "linearizable", True),
    ("register", "sloppy", False),
    ("etcd", "linearizable", True),
    ("etcd", "sloppy", False),
    ("redis", "linearizable", True),
    ("redis", "sloppy", False),
    ("mutex", "linearizable", True),
    # lease-based lock + clock-bump nemesis (bump-time analogue): safe
    # clocks keep it linearizable; the skewed node double-grants
    ("mutex", "leases", False),
    ("queue", "safe", True),
    ("queue", "lossy", False),
    ("set", "linearizable", True),
    ("set", "sloppy", False),
    ("counter", "linearizable", True),
    ("counter", "sloppy", False),
]


# rounds a config runs: a buggy mode must be caught in at least one
ROUNDS = 3


def run_once(test):
    """``core.run(test)``'s top-level ``valid``, or ``"crash: ..."`` when
    it raised: a crash must not discard the completed rounds or the
    final summary, and is recorded as an unexpected outcome."""
    from jepsen_tpu_torch import core
    try:
        return core.run(test)["results"].get("valid")
    except Exception as e:                              # noqa: BLE001
        return f"crash: {type(e).__name__}: {e}"


def unexpected(expect, valid) -> bool:
    """A correct mode that was not valid, or a crash in any mode: a crash
    is never a verdict, so a device fault cannot hide behind a buggy
    mode's other rounds."""
    return (expect is True and valid is not True) or isinstance(valid, str)


def never_caught(expect, verdicts) -> bool:
    """A buggy mode that none of its rounds found invalid."""
    return expect is False and False not in verdicts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--time-limit", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the checks' device: the card by default; 'cpu' "
                         "runs the plain versions")
    args = ap.parse_args(argv)

    from jepsen_tpu_torch import obs

    rng = random.Random(args.seed)
    t0 = time.monotonic()
    runs = 0
    failures = []                       # unexpected verdicts
    seen = {}                           # (suite,mode) -> verdicts
    for rnd in range(args.rounds):
        for suite, mode, expect in CONFIGS:
            seed = rng.randrange(1 << 30)
            valid = run_once(build(suite, mode, seed, args.time_limit,
                                   args.device))
            runs += 1
            key = f"{suite}-{mode}"
            seen.setdefault(key, []).append(valid)
            if unexpected(expect, valid):
                failures.append({"round": rnd, "suite": suite,
                                 "mode": mode, "seed": seed,
                                 "valid": valid})
                print(f"UNEXPECTED {key} seed={seed}: valid={valid}",
                      file=sys.stderr)
    # a buggy mode that was NEVER caught across all rounds is a miss
    for suite, mode, expect in CONFIGS:
        if never_caught(expect, seen.get(f"{suite}-{mode}", [])):
            failures.append({"suite": suite, "mode": mode,
                             "error": "bug never caught"})
            print(f"NEVER CAUGHT: {suite}-{mode}", file=sys.stderr)
    caught = {k: v.count(False) for k, v in seen.items() if False in v}
    # cross-run observability: every run's engine selections and every
    # silent-degradation counter, aggregated over the whole soak (each
    # run's own ledger also lands in its results["obs"])
    snap = obs.counters()
    print(json.dumps({
        "runs": runs, "unexpected": len(failures),
        "caught": caught,
        "obs": {k: v for k, v in sorted(snap.items())
                if k.startswith(("engine.", "checker.swallowed.",
                                 "reach.", "lockstep."))},
        "elapsed_s": round(time.monotonic() - t0, 1)}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line interface — upstream ``jepsen/src/jepsen/cli.clj``:
``run`` (execute a test suite against the in-process fake cluster and
check its history), and the offline checks of a stored or upstream
history, ``check`` (one history file; transactional histories go to the
list-append checker) and ``recheck`` (one or more stored runs; several
paths are checked together on the lockstep lane).

    python -m jepsen_tpu_torch run --suite register --mode sloppy --time-limit 10
    python -m jepsen_tpu_torch check history.edn --model cas-register
    python -m jepsen_tpu_torch recheck store/<name>/latest [more paths]

Each prints its verdict as JSON and exits 0 when every result is valid,
else 1; a fault in a check prints its traceback and exits 1.
``--device`` names where the checks run: the card by default, ``cpu``
for the plain PyTorch versions; without a card the default fails with
the port's :func:`~jepsen_tpu_torch.device.default_device` error (exit
2) before anything runs (``run`` generates no op), and nothing runs on
the CPU by itself. ``run`` takes every suite of the reference's:
``register``, ``register-independent``, ``mutex``, ``set``,
``counter``, ``queue`` (``--mode sloppy`` is the broker's ``lossy``),
``etcd`` (over HTTP) and ``redis`` (over RESP), with ``--online``
watching the history while it streams and ending the run at the first
violation (a suite whose test map has no model only logs a warning);
``serve`` and ``check-serve`` are not ported yet and exit 2 naming
their ``ROADMAP.md`` item.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, Callable, Dict, Optional, Sequence

_NOT_PORTED = {
    "serve": "'serve' (the results browser) is not ported yet (ROADMAP.md, "
             "Queue 1 item 3)",
    "check-serve": "'check-serve' (the checking daemon) is not ported yet "
                   "(ROADMAP.md, Queue 1 item 3)",
}


def _add_common(ap: argparse.ArgumentParser) -> None:
    """The upstream shared option set (``--nodes``, ``--concurrency``,
    ``--time-limit``, ``--test-count``, ssh opts)."""
    ap.add_argument("--nodes", default=None,
                    help="comma-separated node names")
    ap.add_argument("--nodes-file", default=None)
    ap.add_argument("--username", default="root")
    ap.add_argument("--password", default=None)
    ap.add_argument("--ssh-private-key", default=None)
    ap.add_argument("--concurrency", type=int, default=5)
    ap.add_argument("--time-limit", type=float, default=10.0)
    ap.add_argument("--test-count", type=int, default=1)
    ap.add_argument("--store-root", default="store")
    ap.add_argument("--seed", type=int, default=None)


def _nodes_from(args) -> Optional[list]:
    if args.nodes:
        return args.nodes.split(",")
    if args.nodes_file:
        with open(args.nodes_file) as f:
            return [ln.strip() for ln in f if ln.strip()]
    return None


def _suite_mode(mode: str, cluster_cls) -> str:
    """Translate the CLI's linearizable/sloppy vocabulary positionally
    through a fake-system class's ``MODES`` (first = safe, second =
    deliberately buggy) — e.g. sloppy → FakeBroker's "lossy"."""
    from jepsen_tpu_torch.fake import FakeCluster
    base = FakeCluster.MODES
    return cluster_cls.MODES[base.index(mode)] if mode in base else mode


def _cmd_run(args, dev) -> int:
    """Run a suite ``--test-count`` times: the workload against the
    in-process fake cluster, then the check on ``dev``. One JSON line a
    run; exit 0 when every run is valid, else 1."""
    from jepsen_tpu_torch import core
    from jepsen_tpu_torch.fake import FakeBroker
    from jepsen_tpu_torch.suites import (counter as counter_suite, etcd,
                                         mutex, queue, redis, register,
                                         set_suite)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s")
    nodes = _nodes_from(args)                 # the fake cluster must be
    builders: Dict[str, Callable[..., Dict[str, Any]]] = {  # built over them
        "register": lambda: register.register_test(
            mode=args.mode, time_limit=args.time_limit,
            concurrency=args.concurrency, seed=args.seed,
            with_nemesis=not args.no_nemesis, store=True,
            algorithm=args.algorithm, nodes=nodes or 5, device=dev),
        "register-independent": lambda: register.independent_test(
            mode=args.mode, concurrency=args.concurrency,
            seed=args.seed, store=True, device=dev),
        "mutex": lambda: mutex.mutex_test(
            mode=args.mode, time_limit=args.time_limit,
            concurrency=args.concurrency, seed=args.seed,
            with_nemesis=not args.no_nemesis, store=True,
            algorithm=args.algorithm, nodes=nodes or 5, device=dev),
        "queue": lambda: queue.queue_test(
            mode=_suite_mode(args.mode, FakeBroker),
            time_limit=args.time_limit, concurrency=args.concurrency,
            seed=args.seed, with_nemesis=not args.no_nemesis, store=True,
            nodes=nodes or 5, device=dev),
        "set": lambda: set_suite.set_test(
            mode=args.mode, time_limit=args.time_limit,
            concurrency=args.concurrency, seed=args.seed,
            with_nemesis=not args.no_nemesis, store=True, nodes=nodes or 5,
            device=dev),
        "counter": lambda: counter_suite.counter_test(
            mode=args.mode, time_limit=args.time_limit,
            concurrency=args.concurrency, seed=args.seed,
            with_nemesis=not args.no_nemesis, store=True, nodes=nodes or 5,
            device=dev),
        "etcd": lambda: etcd.etcd_test(
            mode=args.mode, time_limit=args.time_limit,
            concurrency=args.concurrency, seed=args.seed,
            with_nemesis=not args.no_nemesis, store=True,
            algorithm=args.algorithm, nodes=nodes or 5, device=dev),
        "redis": lambda: redis.redis_test(
            mode=args.mode, time_limit=args.time_limit,
            concurrency=args.concurrency, seed=args.seed,
            with_nemesis=not args.no_nemesis, store=True,
            algorithm=args.algorithm, nodes=nodes or 5, device=dev),
    }
    if args.suite not in builders:
        print(f"unknown suite {args.suite!r}; have {sorted(builders)}",
              file=sys.stderr)
        return 2
    ok = True
    for i in range(args.test_count):
        test = builders[args.suite]()
        test["store-root"] = args.store_root
        test["ssh"] = {"username": args.username,
                       "password": args.password,
                       "private-key-path": args.ssh_private_key}
        if args.online:
            test["online-check"] = True
        done = core.run(test)
        valid = done["results"].get("valid")
        print(json.dumps({"run": i, "name": done["name"], "valid": valid,
                          "dir": done.get("dir"),
                          "ops": len(done["history"])}), flush=True)
        ok = ok and valid is True
    return 0 if ok else 1


def _load_history(path: str):
    from jepsen_tpu_torch import history as h

    if os.path.isdir(path):
        from jepsen_tpu_torch import store
        return store.load_history(path)
    if path.endswith(".edn"):
        return h.load_edn(path)
    return h.load_jsonl(path)


def _model(name: str):
    from jepsen_tpu_torch import models

    return getattr(models, name.replace("-", "_"))()


def _cmd_recheck(args, dev) -> int:
    """Re-analyze stored histories offline (our store dirs, bare
    history.jsonl paths, or upstream EDN histories). Several paths go
    through ``reach.check_batch``, the lockstep lane on K2: the histories
    advance together. An unreadable path gets its own ``unknown`` line;
    when the batch declines for capacity each history is checked alone
    (recorded as a ``recheck`` fallback); any other error propagates."""
    from jepsen_tpu_torch import history as h
    from jepsen_tpu_torch import obs
    from jepsen_tpu_torch.checkers import facade, reach

    model = _model(args.model)
    if len(args.path) > 1:
        if args.algorithm != "auto":
            logging.getLogger("jepsen.cli").warning(
                "--algorithm %s is ignored with multiple paths: the "
                "lockstep batch engine checks them together",
                args.algorithm)
        loaded: list = []               # (path, history|None, error|None)
        for p in args.path:
            try:
                loaded.append((p, _load_history(p), None))
            except Exception as e:                      # noqa: BLE001
                loaded.append((p, None, f"{type(e).__name__}: {e}"))
        live = [(i, hist) for i, (_p, hist, err) in enumerate(loaded)
                if err is None]
        try:
            batch = reach.check_batch(model,
                                      [h.pack(hist) for _, hist in live],
                                      device=dev)
            res_by_idx = {i: r for (i, _), r in zip(live, batch)}
        except facade._capacity_declines() as e:
            obs.decision("recheck", "fallback", cause=type(e).__name__,
                         histories=len(live))
            checker = facade.Linearizable(model, device=dev)
            res_by_idx = {i: facade.check_declining(
                checker, {"model": model}, hist) for i, hist in live}
        ok = True
        for i, (p, _hist, err) in enumerate(loaded):
            res = (res_by_idx[i] if err is None
                   else {"valid": "unknown", "error": err})
            ok = ok and res.get("valid") is True
            print(json.dumps({"path": p, **res}, default=str))
        return 0 if ok else 1
    history = _load_history(args.path[0])
    checker = facade.Linearizable(model, algorithm=args.algorithm,
                                  device=dev)
    res = facade.check_declining(checker, {"model": model}, history)
    print(json.dumps(res, indent=2, default=str))
    return 0 if res.get("valid") is True else 1


def _cmd_check(args, dev) -> int:
    """One offline check of a history file. A transactional history
    (every client op ``f == "txn"``, the Elle list-append shape; or
    ``--txn``) goes to ``facade.auto_check_txn``, the closure on K8;
    any other to ``Linearizable`` against ``--model``. With
    ``--store-root`` the check persists as a store run dir."""
    from jepsen_tpu_torch.checkers import facade

    history = _load_history(args.path)
    client_ops = [op for op in history if op.process != "nemesis"]
    is_txn = args.txn or (bool(client_ops)
                          and all(op.f == "txn" for op in client_ops))
    if is_txn:
        res = facade.auto_check_txn(history, {"device": dev})
    else:
        model = _model(args.model)
        checker = facade.Linearizable(model, algorithm=args.algorithm,
                                      device=dev)
        res = facade.check_declining(checker, {"model": model}, history)
    if args.store_root:
        import uuid

        from jepsen_tpu_torch import store
        name = "txn-check" if is_txn else f"check-{args.model}"
        res = dict(res)
        res["run-dir"] = store.save_check(args.store_root, name,
                                          uuid.uuid4().hex[:8],
                                          list(history), res)
    print(json.dumps(res, indent=2, default=str))
    return 0 if res.get("valid") is True else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch",
        description="Jepsen tests against an in-process fake cluster, and "
                    "offline linearizability and transactional checks, "
                    "on one NVIDIA GPU")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for cmd, text in _NOT_PORTED.items():
        sub.add_parser(cmd, help=f"not ported: {text}")

    def device_arg(p):
        p.add_argument("--device", default=None,
                       help="where the checks run (default: the card; "
                            "'cpu' runs the plain PyTorch versions)")

    runp = sub.add_parser("run", help="run a test suite")
    _add_common(runp)
    runp.add_argument("--suite", default="register",
                      help="register, register-independent, mutex, set, "
                           "counter, queue, etcd or redis")
    runp.add_argument("--mode", default="linearizable",
                      choices=["linearizable", "sloppy"])
    runp.add_argument("--algorithm", default="auto")
    runp.add_argument("--no-nemesis", action="store_true")
    runp.add_argument("--online", action="store_true",
                      help="live linearizability monitoring: check the "
                           "history during the run and abort on the first "
                           "violation")
    device_arg(runp)
    runp.set_defaults(fn=_cmd_run)

    ckp = sub.add_parser(
        "check",
        help="check one history file; txn (list-append) histories "
             "auto-route through the transactional checker")
    ckp.add_argument("path",
                     help="run dir, history.jsonl, or history.edn "
                          "(EDN list-append format supported)")
    ckp.add_argument("--txn", action="store_true",
                     help="force the transactional route (default: "
                          "auto-detected when every client op is a txn)")
    ckp.add_argument("--model", default="cas-register",
                     help="model for non-txn histories")
    ckp.add_argument("--algorithm", default="auto")
    ckp.add_argument("--store-root", default=None,
                     help="persist the check as a store run dir")
    device_arg(ckp)
    ckp.set_defaults(fn=_cmd_check)

    rp = sub.add_parser("recheck",
                        help="re-analyze stored histories offline "
                             "(several paths = one lockstep batch)")
    rp.add_argument("path", nargs="+",
                    help="run dir(s), history.jsonl, or history.edn; "
                         "more than one path checks them all on the "
                         "lockstep lane")
    rp.add_argument("--model", default="cas-register")
    rp.add_argument("--algorithm", default="auto",
                    help="engine for single-path rechecks (several paths "
                         "always use the batch engine)")
    device_arg(rp)
    rp.set_defaults(fn=_cmd_recheck)

    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _NOT_PORTED:
        print(f"jepsen_tpu_torch: {_NOT_PORTED[argv[0]]}", file=sys.stderr)
        return 2
    args = ap.parse_args(argv)
    from jepsen_tpu_torch import device as _device
    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        print(f"jepsen_tpu_torch: {e}", file=sys.stderr)
        return 2
    return args.fn(args, dev)


if __name__ == "__main__":
    sys.exit(main())

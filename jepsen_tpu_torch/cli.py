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
violation (a suite whose test map has no model only logs a warning).

``check-serve`` runs the check daemon (``docs/SERVING.md``'s protocol)
on ``--device`` until SIGTERM or SIGINT; its first line names its URL
and its last the shutdown and the daemon's stats. It exits 1 when a
device fault ended a dispatch, and 2 before binding a port when there
is no card. ``serve`` is the results browser (:mod:`jepsen_tpu_torch.web`)
over ``--store-root``: it reads the store and checks nothing, so it
takes no ``--device``.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, Callable, Dict, Optional, Sequence

_POD_NOT_PORTED = ("check-serve's pod mode (--coordinator, --num-processes, "
                   "--process-id) is not ported yet (ROADMAP.md, Queue 1 "
                   "item 9)")


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


def _cmd_check_serve(args, dev) -> int:
    """``check-serve``: the check daemon on ``dev`` until SIGTERM or
    SIGINT, then a graceful shutdown (stop admitting, drain, stop)."""
    import signal
    import threading

    from jepsen_tpu_torch import serve

    if args.coordinator or args.num_processes or args.process_id is not None:
        print(f"jepsen_tpu_torch: {_POD_NOT_PORTED}", file=sys.stderr)
        return 2
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s")
    engine_kw = {"max_states": args.max_states} if args.max_states else {}
    daemon = serve.Daemon(
        port=args.port, host=args.host, queue_depth=args.queue_depth,
        max_inflight_per_tenant=args.tenant_inflight, group=args.group,
        engine_kw=engine_kw, store_root=args.store_root,
        persist=not args.no_persist_runs, journal=not args.no_journal,
        breaker=serve.CircuitBreaker(threshold=args.breaker_threshold,
                                     cooldown_s=args.breaker_cooldown),
        dispatch_deadline_s=args.dispatch_deadline or None,
        lanes=args.lanes, replica_id=args.replica_id or None,
        lease_ttl_s=args.lease_ttl, device=dev,
        pipeline_k=args.pipeline_k, faults=args.faults or None,
        session_tenant_cap=args.session_tenant_cap,
        session_idle_ttl_s=args.session_idle_ttl or None)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: stop.set())
    daemon.start()
    print(f"jepsen-tpu check daemon: http://{args.host}:{daemon.port}/ "
          f"(POST /check, GET /check/<id>, POST /session, GET /stats, GET "
          f"/metrics, GET /healthz, POST /profile; device "
          f"{daemon.device}, store root {args.store_root})", flush=True)
    while not stop.wait(0.5):
        pass
    daemon.shutdown()
    faulted = daemon.dispatcher.device_faults > 0
    print(json.dumps({"shutdown": "device-fault" if faulted else "clean",
                      **daemon.stats()}, default=str), flush=True)
    return 1 if faulted else 0


def _add_check_serve(sub) -> argparse.ArgumentParser:
    csp = sub.add_parser(
        "check-serve",
        help="run the check daemon: concurrent checks over HTTP, "
             "coalesced into lockstep groups on the card")
    csp.add_argument("--port", type=int, default=8642,
                     help="0 picks a free port (the first line names it)")
    csp.add_argument("--host", default="127.0.0.1",
                     help="bind address; loopback by default: the endpoint "
                          "accepts work")
    csp.add_argument("--store-root", default="store",
                     help="verdicts land as run dirs, the journal and "
                          "stats under <root>/serve/")
    csp.add_argument("--queue-depth", type=int, default=256,
                     help="admission bound; past it POST /check answers "
                          "429")
    csp.add_argument("--tenant-inflight", type=int, default=8,
                     help="in-flight requests a tenant")
    csp.add_argument("--group", type=int, default=32,
                     help="requests a coalesced dispatch group")
    csp.add_argument("--max-states", type=int, default=0,
                     help="engine max_states (0: the default)")
    csp.add_argument("--no-persist-runs", action="store_true",
                     help="do not write verdicts into the store")
    csp.add_argument("--no-journal", action="store_true",
                     help="no admission journal: admitted requests do not "
                          "survive a crash")
    csp.add_argument("--breaker-threshold", type=int, default=5,
                     help="consecutive recoverable failures of the card's "
                          "route that open the circuit breaker")
    csp.add_argument("--breaker-cooldown", type=float, default=15.0,
                     help="seconds before an open breaker's probe")
    csp.add_argument("--dispatch-deadline", type=float, default=0.0,
                     help="wall-clock cap a dispatch; survivors of a hung "
                          "one are requeued (0: none)")
    csp.add_argument("--lanes", type=int, default=1,
                     help="dispatch lanes (a thread and a breaker each)")
    csp.add_argument("--pipeline-k", type=int, default=None,
                     help="staged groups a lane keeps in flight (default "
                          "4; 1 never stages)")
    csp.add_argument("--faults", default="",
                     help="arm the self-nemesis, e.g. "
                          "'dispatch@3;device@2x6;poison=tenant-x'")
    csp.add_argument("--session-tenant-cap", type=int, default=64,
                     help="open streaming sessions a tenant (429 cause "
                          "tenant-cap past it; 0: no cap)")
    csp.add_argument("--session-idle-ttl", type=float, default=3600.0,
                     help="close open sessions idle this many seconds "
                          "(exact verdict, journal marker; 0: never)")
    csp.add_argument("--replica-id", default="",
                     help="fleet mode: this replica's name; replicas over "
                          "one --store-root share the journal by lease")
    csp.add_argument("--lease-ttl", type=float, default=10.0,
                     help="fleet lease time-to-live, seconds")
    for flag in ("--coordinator", "--num-processes", "--process-id"):
        csp.add_argument(flag, default=None, help="not ported (item 9)")
    csp.set_defaults(fn=_cmd_check_serve)
    return csp


def _cmd_serve(args, _dev=None) -> int:
    """``serve``: the results browser over the store, until interrupted."""
    from jepsen_tpu_torch import web
    web.serve(root=args.store_root, port=args.port, host=args.host)
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch",
        description="Jepsen tests against an in-process fake cluster, and "
                    "offline linearizability and transactional checks, "
                    "on one NVIDIA GPU")
    sub = ap.add_subparsers(dest="cmd", required=True)
    servep = sub.add_parser(
        "serve", help="browse stored results over HTTP (read-only; the "
                      "checking daemon is 'check-serve')")
    servep.add_argument("--store-root", default="store")
    servep.add_argument("--port", type=int, default=8080)
    servep.add_argument("--host", default="127.0.0.1",
                        help="bind address (loopback by default)")
    servep.set_defaults(fn=_cmd_serve)

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

    device_arg(_add_check_serve(sub))

    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if args.fn is _cmd_serve:
        return _cmd_serve(args)
    from jepsen_tpu_torch import device as _device
    try:
        dev = _device.resolve(args.device)
    except RuntimeError as e:
        print(f"jepsen_tpu_torch: {e}", file=sys.stderr)
        return 2
    return args.fn(args, dev)


if __name__ == "__main__":
    sys.exit(main())

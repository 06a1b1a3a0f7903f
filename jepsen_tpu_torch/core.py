"""Test orchestrator — upstream ``jepsen/src/jepsen/core.clj``: interpret
a *test map* into a run.

A test is a plain dict (the upstream test map — the test map is the
config system): ``{"name", "nodes", "os", "db", "client", "nemesis",
"generator", "checker", "model", "concurrency", "remote"/"cluster", ...}``.

``run(test)`` drives the full lifecycle::

    os/db setup on all nodes → open clients → spawn one worker thread per
    logical process + a nemesis thread → each worker loop pulls an op
    sketch from the generator, appends the :invoke to the shared history,
    calls client.invoke, appends the completion → join → db teardown +
    log snarfing → checker analysis → store persistence.

Worker crash semantics match upstream exactly: an ``info`` completion
(client exception / timeout) kills the logical process — the op stays
forever-pending for the checkers — and the worker continues as process
``p + concurrency`` with a freshly opened client.

The history is appended under a lock and (crash-safely) streamed to
``history.jsonl`` as it grows — the upstream holds it in memory until
``store/save!``.

The workload is host Python: workers and the nemesis are threads that
never touch the card. The check runs on the calling thread after the
workers are joined, through
:func:`~jepsen_tpu_torch.checkers.facade.check_declining`: a capacity
decline is an ``unknown``, any other error (a failed kernel build, a
CUDA launch error) propagates out of :func:`run` with ``history.jsonl``
already on disk, so the run can be rechecked. A test map's ``"device"``
(set by the suites; ``None`` is the card) is resolved before setup, so a
run that needs a card and has none fails before any op is generated.

With ``"online-check"`` the run is also watched while it streams by
:class:`~jepsen_tpu_torch.checkers.online.OnlineLinearizable` (options
from ``"online-opts"``), fed by the history's observer: the first
violation stops the workers, the monitor's verdict joins the results as
``results["online-check"]``, and an invalid one makes the run invalid.
A fault of the monitor propagates, as the check's does.
"""
from __future__ import annotations

import contextvars
import json
import logging
import threading
import time as _time
from typing import Any, Dict, List, Mapping, Optional

from jepsen_tpu_torch import db as db_mod
from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import obs
from jepsen_tpu_torch import os_setup
from jepsen_tpu_torch.checkers.facade import check_declining
from jepsen_tpu_torch.client import Client
from jepsen_tpu_torch.generators import NEMESIS, Generator, gen
from jepsen_tpu_torch.op import FAIL, INFO, INVOKE, OK, Op

log = logging.getLogger("jepsen.core")


class History:
    """Thread-safe append-only history with optional JSONL streaming and
    an optional observer notified of every op in append order (the hook
    an online checker plugs into)."""

    def __init__(self, stream_path: Optional[str] = None,
                 observer: Optional[Any] = None):
        self._ops: List[Op] = []
        self._lock = threading.Lock()
        self._file = open(stream_path, "w") if stream_path else None
        self._observer = observer

    def append(self, op: Op) -> Op:
        with self._lock:
            op = op.with_(index=len(self._ops))
            self._ops.append(op)
            # after close() (timed-out workers completing late) the op is
            # still recorded in memory, just not streamed
            if self._file:
                self._file.write(json.dumps(op.to_dict(), default=str) + "\n")
                self._file.flush()
            if self._observer is not None:
                try:
                    self._observer(op)
                except Exception:                       # noqa: BLE001
                    pass                # observers must not break the run
        return op

    def snapshot(self) -> List[Op]:
        with self._lock:
            return list(self._ops)

    def close(self) -> None:
        with self._lock:
            if self._file:
                self._file.close()
                self._file = None


class _Worker:
    """One logical-process worker (upstream ``core/worker``)."""

    def __init__(self, test: Mapping, run: "_Run", wid: int,
                 generator: Generator):
        self.test = test
        self.run = run
        self.wid = wid                      # worker slot, fixed
        self.process: Any = wid             # logical process, bumps on crash
        self.generator = generator
        self.client: Optional[Client] = None
        # run under a copy of the spawning thread's context so obs
        # spans recorded by the worker reach the run's capture scope
        ctx = contextvars.copy_context()
        self.thread = threading.Thread(target=lambda: ctx.run(self._loop),
                                       daemon=True,
                                       name=f"jepsen-worker-{wid}")

    # -- client lifecycle ----------------------------------------------------
    def _node(self) -> Any:
        nodes = self.test.get("nodes") or [None]
        return nodes[self.wid % len(nodes)]

    def _open_client(self) -> Optional[Client]:
        proto = self.test.get("client")
        if proto is None:
            return None
        c = proto.open(self.test, self._node())
        c.setup(self.test)
        return c

    def _close_client(self) -> None:
        if self.client is not None:
            try:
                self.client.teardown(self.test)
                self.client.close(self.test)
            except Exception:                           # noqa: BLE001
                pass
            self.client = None

    # -- op loop -------------------------------------------------------------
    def _loop(self) -> None:
        name = "run.nemesis" if self.process == NEMESIS else "run.worker"
        with obs.span(name, wid=self.wid):
            self._loop_inner()

    def _loop_inner(self) -> None:
        test, run = self.test, self.run
        try:
            self.client = self._open_client()
        except Exception as e:                          # noqa: BLE001
            log.error("worker %s: client open failed: %s", self.wid, e)
            run.active.discard(self.process)
            return
        op_timeout = test.get("op-timeout")
        while not run.stop.is_set():
            try:
                sketch = self.generator.op(test, self.process)
            except Exception as e:                      # noqa: BLE001
                log.error("generator crashed for %s: %s", self.process, e)
                break
            if sketch is None:
                break
            if "sleep" in sketch and "f" not in sketch:
                _time.sleep(float(sketch["sleep"]))
                continue
            if sketch.get("pending"):
                _time.sleep(0.001)
                continue
            inv = Op(process=self.process, type=INVOKE,
                     f=sketch.get("f"), value=sketch.get("value"),
                     time=run.now_ns())
            inv = run.history.append(inv)
            completion = self._invoke(inv, op_timeout)
            completion = completion.with_(
                process=self.process, f=inv.f, time=run.now_ns(), index=-1)
            run.history.append(completion)
            if completion.type == INFO and self.process != NEMESIS:
                # logical process died; hand its slot to a successor
                run.active.discard(self.process)
                self._close_client()
                self.process = self.process + test["concurrency"]
                run.active.add(self.process)
                try:
                    self.client = self._open_client()
                except Exception as e:                  # noqa: BLE001
                    log.error("worker %s: reopen failed: %s", self.wid, e)
                    break
        run.active.discard(self.process)
        self._close_client()

    def _invoke(self, inv: Op, op_timeout: Optional[float]) -> Op:
        client = self.client
        if client is None:
            return inv.with_(type=OK)
        try:
            if op_timeout is None:
                res = client.invoke(self.test, inv)
            else:
                res = _with_timeout(
                    lambda: client.invoke(self.test, inv), op_timeout)
            if res is None or res.type not in (OK, FAIL, INFO):
                raise ValueError(f"client returned bad completion {res!r}")
            return res
        except _TimeoutExpired:
            return inv.with_(type=INFO,
                             extra={**(inv.extra or {}), "error": "timeout"})
        except Exception as e:                          # noqa: BLE001
            return inv.with_(type=INFO, extra={
                **(inv.extra or {}),
                "error": f"{type(e).__name__}: {e}"})


class _TimeoutExpired(Exception):
    pass


def _with_timeout(fn, seconds: float):
    """Run ``fn`` on a helper thread with a deadline (upstream
    ``util/timeout`` interrupts the worker; Python threads can't be
    interrupted, so the orphaned call parks on the helper — the worker
    moves on as a new process either way)."""
    box: List[Any] = []
    err: List[BaseException] = []

    def target():
        try:
            box.append(fn())
        except BaseException as e:                      # noqa: BLE001
            err.append(e)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise _TimeoutExpired()
    if err:
        raise err[0]
    return box[0]


class _Run:
    def __init__(self, history: History, start: float):
        self.history = history
        self.start = start
        self.stop = threading.Event()
        self.active: set = set()
        self._lock = threading.Lock()

    def now_ns(self) -> int:
        return int((_time.monotonic() - self.start) * 1e9)


def _normalize(test: Mapping) -> Dict[str, Any]:
    from jepsen_tpu_torch.tests_base import noop_test
    t = dict(noop_test())
    t.update(test)
    if t.get("concurrency") in (None, 0):
        t["concurrency"] = max(1, len(t.get("nodes") or [1]))
    return t


def _online_monitor(test: Mapping):
    """The run's online monitor when ``test["online-check"]`` asks for
    one, else None; a suite without a model runs unmonitored, with a
    warning."""
    if not test.get("online-check"):
        return None
    from jepsen_tpu_torch.checkers.facade import _model_from
    from jepsen_tpu_torch.checkers.online import OnlineLinearizable
    try:
        model = _model_from(None, test)
    except ValueError:
        log.warning("online-check requested but the test map has no "
                    "model (suite %s); monitoring disabled",
                    test.get("name"))
        return None
    opts = dict(test.get("online-opts") or {})
    opts.setdefault("device", test.get("device"))
    return OnlineLinearizable(model, **opts)


def run(test: Mapping) -> Dict[str, Any]:
    """Run a complete test (upstream ``jepsen.core/run!``). Returns the
    test map extended with ``"history"``, ``"results"``, ``"start-time"``,
    and ``"dir"`` (when stored).

    The whole run executes inside an :func:`jepsen_tpu_torch.obs.capture`
    scope with per-phase spans (setup / workers / teardown / check /
    store); ``results["obs"]`` carries the run's counters + engine
    ledger, and stored runs persist ``obs.jsonl`` + ``trace.json``
    next to the history (:func:`jepsen_tpu_torch.store.save_obs`).

    ``test["device"]``, when the test map has it, is resolved first
    (:func:`jepsen_tpu_torch.device.resolve`: ``None`` is the card,
    which must exist). A fault in the check or in the online monitor
    propagates after the history is on disk."""
    if "device" in test:
        test = dict(test)
        test["device"] = str(_device.resolve(test["device"]))
    with obs.capture() as obs_cap:
        return _run_captured(test, obs_cap)


def _run_captured(test: Mapping, obs_cap) -> Dict[str, Any]:
    from jepsen_tpu_torch import store as store_mod

    test = _normalize(test)
    test["start-time"] = _time.strftime("%Y%m%dT%H%M%S")
    store_dir = None
    log_handler = None
    if test.get("store", True):
        store_dir = store_mod.create_run_dir(test)
        test["dir"] = store_dir
        log_handler = store_mod.attach_log(store_dir)
    log.info("Running test %s", test.get("name"))

    online = _online_monitor(test)
    history = History(
        stream_path=f"{store_dir}/history.jsonl" if store_dir else None,
        observer=online.observe if online else None)
    run_state = _Run(history, _time.monotonic())
    test["active-processes"] = lambda: set(run_state.active)
    if online is not None:
        # fail fast: a violated prefix can never become valid again.
        # Chained after any caller-supplied callback
        user_cb = online.on_violation

        def _abort(v, _cb=user_cb):
            if _cb is not None:
                _cb(v)
            run_state.stop.set()

        online.on_violation = _abort
        online.start()

    try:
        with obs.span("run.setup", test=str(test.get("name"))):
            os_setup.setup_all(test)
            db_mod.setup_all(test)

        # workers -------------------------------------------------------------
        generator = gen(test.get("generator"))
        n = int(test["concurrency"])
        workers = [_Worker(test, run_state, i, generator) for i in range(n)]
        nemesis = test.get("nemesis")
        nem_worker = None
        if nemesis is not None:
            nemesis.setup(test)
            nem_worker = _Worker(test, run_state, 0, generator)
            nem_worker.process = NEMESIS
            nem_worker.client = None
            nem_ctx = contextvars.copy_context()
            nem_worker.thread = threading.Thread(
                target=lambda: nem_ctx.run(nem_worker._loop),
                daemon=True, name="jepsen-nemesis")
            # the nemesis IS its own client
            nem_worker._open_client = lambda: nemesis     # type: ignore
            nem_worker._close_client = lambda: None       # type: ignore
        run_state.active = set(range(n)) | ({NEMESIS} if nem_worker else set())

        with obs.span("run.workers", concurrency=n,
                      nemesis=nem_worker is not None):
            for w in workers:
                w.thread.start()
            if nem_worker:
                nem_worker.thread.start()
            limit = test.get("run-time-limit")
            end = None if limit is None else _time.monotonic() + limit
            for w in workers:
                w.thread.join(None if end is None else
                              max(0.0, end - _time.monotonic()))
                if w.thread.is_alive():
                    run_state.stop.set()
            run_state.stop.set()                # client phase over
            if nem_worker:
                nem_worker.thread.join(10)
            if nemesis is not None:
                try:
                    nemesis.teardown(test)
                except Exception:                       # noqa: BLE001
                    pass
    finally:
        history.close()
        if online is not None:
            # the monitor's thread stops with the workers, fault or not;
            # its final flush and verdict come after the check
            online.halt()
        with obs.span("run.teardown"):
            try:
                if not test.get("leave-db-running"):
                    db_mod.teardown_all(test)
                if store_dir:
                    db_mod.snarf_logs(test, store_dir)
                os_setup.teardown_all(test)
            except Exception as e:                      # noqa: BLE001
                log.warning("teardown failed: %s", e)

    test["history"] = history.snapshot()
    log.info("History complete (%d ops); analyzing", len(test["history"]))

    checker = test.get("checker")
    try:
        with obs.span("run.check", ops=len(test["history"])):
            results = (check_declining(checker, test, test["history"])
                       if checker is not None else {"valid": True})
        if online is not None:
            results["online-check"] = online.stop()
            if results["online-check"].get("valid") is False:
                # the online verdict is sound (no false alarms), so a
                # post-hoc "unknown" or a missing checker cannot mask it
                results["valid"] = False
        # the run's own observability record: counters + engine-decision
        # ledger (assertable by callers, serialized into results.json)
        results["obs"] = obs_cap.summary()
        test["results"] = results
        if store_dir:
            with obs.span("run.store"):
                store_mod.save(test, store_dir)
            store_mod.save_obs(store_dir, obs_cap)
        log.info("Analysis complete: valid? = %s", results.get("valid"))
    finally:
        if log_handler is not None:
            store_mod.detach_log(log_handler)
    return test

"""The dispatcher: long-lived lane threads between the admission queue
and the checkers on the card (a port of the reference package's
``jepsen_tpu/serve/engine.py``).

Each lane takes one coalesced dispatch group at a time and checks it
through the chains the command line uses, so the daemon's verdicts are
the standalone ones:

- a linearizable group of many: the staged lockstep lane first
  (:func:`facade.stage_check_many_packed`: the union prep and every K2
  walk queued, nothing fetched), else :func:`facade.auto_check_many_packed`;
- a group of one: :func:`facade.auto_check_packed` (chunk-lockstep on K2,
  K1, K4, ...);
- ``txn-list-append``: :func:`facade.auto_check_txn` a member (K8);
- a session's blocks (:meth:`Dispatcher._dispatch_session`), in order
  through :meth:`.session.Session.advance_block` and ``close``; the
  appends of many sessions of one walk geometry
  (:meth:`Dispatcher._dispatch_session_group`) in waves, one block of
  each session a wave and one K10 launch a wave
  (:func:`.session.advance_group`). Sessions take no recovery ladder
  and no breaker: their fault rule is the session module's, and a
  device fault there is counted as one here.

**The staged window.** A lane keeps up to ``pipeline_k`` staged groups
in flight: while group k walks on the card the lane thread stages group
k+1 and collects the predecessors whose events have completed; a full
window waits on the oldest (``pipeline.stall_s``). A group the stage
declines (a singleton, txn, an open breaker, armed faults, a batch the
lockstep lane would not take) first drains the window, so results
publish in order, then runs the blocking path. ``pipeline_k = 1`` never
stages. The kernels are ``ctypes`` calls that release the interpreter
lock, so the host's marshalling and the card's walks can overlap.

**Accounting.** A group's stage→collect wall is booked to the lane from
the end of its previous collect (``attr_mark``), so ``serve.device_s +
serve.pad_waste_s`` equals the dispatch wall, per lane and in all, and
the overlapped rest is ``pipeline.overlap_s``. Groups are not padded
(the reference pads to a power of two to bound its compiled geometries;
the kernels take any width), so ``serve.pad_waste_s`` stays 0.

**Recovery** (``serve/recovery.py``). An injected fault or a capacity
decline takes the reference's ladder: a bounded retry of the group,
bisection to corner a poison member, a host rescue of a failing
singleton, then quarantine; such failures on the card's route feed the
lane's circuit breaker, which sends groups to the host checkers while
open. A device fault, or any other engine fault, ends the group: each
member finishes ``error`` with the fault's text, with no retry, no
bisection and no host rescue; a device fault is counted
(``serve.device_faults``) and turns ``/healthz`` to 503. A dispatch hung
past ``dispatch_deadline_s`` aborts through the abort hook and its
survivors are requeued. Deadlines and cancellation compose into that
hook too.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import dispatch_core
from jepsen_tpu_torch.serve import faults, recovery
from jepsen_tpu_torch.serve import request as rq
from jepsen_tpu_torch.serve.coalesce import AdmissionQueue

log = logging.getLogger("jepsen.serve")

# the kernels the daemon's checks and sessions launch, built and loaded
# before the socket accepts: K1, K3 (lane_walk, keyed_walk), K2
# (batch_walk), K4, K5 (wide_walk, wide_keyed), K8 (txn_closure), K9
# (txn_inc_join) and K10 (mega_walk)
WARM_KERNELS = ("lane_walk", "keyed_walk", "batch_walk", "wide_walk",
                "wide_keyed", "txn_closure", "txn_inc_join", "mega_walk")

# the least seconds between two writes of ``serve/stats.json`` by the
# lanes (``shutdown`` writes it too): a session's blocks are many small
# dispatches, and the file's stats scan the journal's directory
STATS_FILE_S = 1.0

# the result causes of a group that ended on a fault (status "error")
DEVICE_FAULT = "device-fault"
ENGINE_FAULT = "fault"


class _StagedDispatch:
    """One group staged and not collected on its lane: its walks queued
    on the card (``handle``, a :class:`reach.StagedMany`), its dispatch
    bookkeeping done, its queue slot held until the collect publishes.
    ``cap_recs`` are the ledger records of the stage, stitched into each
    member's trace with the collect's."""

    __slots__ = ("batch", "kw", "hang", "t0", "handle", "cap_recs")

    def __init__(self, batch, kw, hang, t0, handle, cap_recs):
        self.batch = batch
        self.kw = kw
        self.hang = hang
        self.t0 = t0
        self.handle = handle
        self.cap_recs = cap_recs

    def ready(self) -> bool:
        return self.handle.ready()


def _profiler_start(path: str):
    """Start a ``torch.profiler`` capture (the card's activity too where
    there is one); a module-level function so tests can stub it."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _profiler_stop(prof, path: str) -> int:
    """Stop a capture, write its Chrome trace under ``path`` and return
    how many of its records ran on the card (kernels and copies)."""
    prof.stop()
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


class _TimeSeriesRing:
    """A rolling series of serving health, one point a dispatch: req/s
    since the last point, p50/p99 of the e2e histogram's delta, queue
    depth and requests in flight; bounded, and written into
    ``stats.json``."""

    def __init__(self, cap: int = 256) -> None:
        self._lock = threading.Lock()
        self._points: "deque[Dict[str, Any]]" = deque(maxlen=cap)
        self._prev_ts: Optional[float] = None
        self._prev_done = 0.0
        self._prev_hist: Optional[Dict[str, Any]] = None

    def sample(self, queue: AdmissionQueue,
               snap: Dict[str, Any]) -> None:
        now = time.monotonic()
        done = snap["counters"].get("serve.completed", 0.0)
        hist = snap["histograms"].get("serve.e2e_s")
        depth = queue.depth()
        inflight = sum(queue.inflight().values())
        with self._lock:
            dt = now - self._prev_ts if self._prev_ts is not None else None
            delta = obs.hist_delta(hist, self._prev_hist)
            p50 = obs.hist_quantile(delta, 0.50)
            p99 = obs.hist_quantile(delta, 0.99)
            self._points.append({
                "ts": round(time.time(), 3),
                "req_s": (round((done - self._prev_done) / dt, 3)
                          if dt and dt > 0 else None),
                "p50_s": round(p50, 6) if p50 is not None else None,
                "p99_s": round(p99, 6) if p99 is not None else None,
                "depth": depth, "inflight": inflight})
            self._prev_ts = now
            self._prev_done = done
            self._prev_hist = hist

    def points(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(p) for p in self._points]


class _Lane:
    """One lane's own state, touched only by its thread: its circuit
    breaker (a lane whose card route fails degrades alone), whether
    device work ran this dispatch, the attribution clock ``attr_mark``
    (the end of its last collected interval) and its window's peak."""

    def __init__(self, idx: int, breaker: recovery.CircuitBreaker) -> None:
        self.idx = idx
        self.breaker = breaker
        self.device_ran = False
        self.thread: Optional[threading.Thread] = None
        self.attr_mark = 0.0
        self.window_peak = 0


class Dispatcher:
    """The lane threads. ``start()``/``stop()`` bracket the daemon's
    life; ``drain()`` waits for the queue to empty. ``engine_kw["device"]``
    names where the checks run (default: the card)."""

    def __init__(self, queue: AdmissionQueue, registry: "rq.Registry",
                 *, engine_kw: Optional[Dict[str, Any]] = None,
                 store_root: Optional[str] = None, persist: bool = False,
                 retry_policy: Optional[recovery.RetryPolicy] = None,
                 breaker: Optional[recovery.CircuitBreaker] = None,
                 dispatch_deadline_s: Optional[float] = None,
                 journal: Optional[Any] = None, lanes: int = 1,
                 pipeline_k: Optional[int] = None) -> None:
        self.queue = queue
        self.registry = registry
        self.engine_kw = dict(engine_kw or {})
        self.device = _device.resolve(self.engine_kw.get("device"))
        self.engine_kw["device"] = self.device
        self.store_root = store_root
        self.persist = persist and store_root is not None
        self.retry = retry_policy or recovery.RetryPolicy()
        # lane 0 takes the given breaker, each further lane a fresh one
        # of the same policy; self.breaker is lane 0's
        proto = breaker or recovery.CircuitBreaker()
        self.lanes_n = max(1, int(lanes))
        self._lanes = [_Lane(0, proto)] + [
            _Lane(i, recovery.CircuitBreaker(threshold=proto.threshold,
                                             cooldown_s=proto.cooldown_s))
            for i in range(1, self.lanes_n)]
        self.breaker = proto
        self.pipeline_k = dispatch_core.pipeline_k(pipeline_k)
        self.dispatch_deadline_s = dispatch_deadline_s
        self.journal = journal
        self.sessions = None            # SessionRegistry (the daemon's)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.dispatch_counts: Dict[str, int] = {}
        self._counts_lock = threading.Lock()
        self._inflight_peak = 0
        # device faults seen: their count and the last one's text
        self.device_faults = 0
        self.device_fault: Optional[str] = None
        self.ring = _TimeSeriesRing()
        self._stats_written = float("-inf")
        # on-demand profiling (POST /profile): the next N dispatches run
        # under torch.profiler, the capture under the store root
        self._profile_lock = threading.Lock()
        self._profile_left = 0
        self._profile_dir: Optional[str] = None
        self._profiler = None
        self._profile_thread: Optional[int] = None
        self._profile_records: Optional[int] = None
        queue.on_timeout = self._finish_timeout_queued

    # -- lifecycle -------------------------------------------------------------
    def warm(self) -> None:
        """Build and load what the checks run, so no request pays for a
        build: the host libraries, and on the card the kernels of
        :data:`WARM_KERNELS` (one ``nvcc`` each, all started together)."""
        from jepsen_tpu_torch.checkers import preproc_native, wgl_native

        with obs.span("serve.warm", device=str(self.device)):
            preproc_native._lib()
            wgl_native._lib()
            if self.device.type != "cuda":
                return
            from jepsen_tpu_torch import _build
            from jepsen_tpu_torch.checkers import (reach_batch, reach_lane,
                                                   reach_pallas, reach_word)
            from jepsen_tpu_torch.txn import cycles

            _build.build_all(WARM_KERNELS)
            for load in (reach_lane._lib, reach_lane._keyed_lib,
                         reach_batch._lib, reach_pallas._lib,
                         reach_pallas._keyed_lib, cycles._lib,
                         cycles._inc_lib, reach_word._lib):
                load()

    def start(self) -> "Dispatcher":
        self.warm()
        obs.gauge("serve.lanes", self.lanes_n)
        for lane in self._lanes:
            t = threading.Thread(target=self._loop, args=(lane,),
                                 name=f"serve-dispatch-{lane.idx}",
                                 daemon=True)
            lane.thread = t
            t.start()
        self._thread = self._lanes[0].thread
        return self

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        end = time.monotonic() + timeout
        for lane in self._lanes:
            if lane.thread is not None:
                lane.thread.join(max(0.1, end - time.monotonic()))

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait until nothing is queued or in flight, judged from the
        queue alone: a group moves from queued to in flight atomically
        in ``next_batch`` and leaves only in ``mark_done``, after its
        results published."""
        if self._thread is None:
            return self.queue.depth() == 0
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if self.queue.depth() == 0 and not self.queue.inflight():
                return True
            time.sleep(0.01)
        return False

    # -- the loop ----------------------------------------------------------------
    def _loop(self, lane: _Lane) -> None:
        """A lane thread: the staged window of :attr:`pipeline_k` groups
        (the module's docstring)."""
        window: deque = deque()
        k = self.pipeline_k
        while not self._stop.is_set():
            batch = None
            if len(window) < k:
                # with staged work pending, poll fast so that ready
                # predecessors drain while the queue is idle
                batch = self.queue.next_batch(
                    timeout=(0.01 if window else 0.1), lane=lane.idx)
            if batch:
                self._profile_maybe_start()
                try:
                    staged = self._stage(batch, lane) if k > 1 else None
                except Exception as e:                  # noqa: BLE001
                    while window:
                        self._collect_one(window.popleft(), lane)
                    self._iteration(batch, lane, lambda: self._publish_fault(
                        batch, lane, e))
                    continue
                if staged is not None:
                    obs.count("pipeline.staged")
                    window.append(staged)
                    if len(window) > lane.window_peak:
                        lane.window_peak = len(window)
                        obs.gauge(f"pipeline.lane.{lane.idx}.inflight_peak",
                                  lane.window_peak)
                        self._note_inflight_peak(lane.window_peak)
                    while window and window[0].ready():
                        self._collect_one(window.popleft(), lane)
                    continue
                # not staged: drain the window first, so results publish
                # in order, then the blocking path
                while window:
                    self._collect_one(window.popleft(), lane)
                self._iteration(batch, lane,
                                lambda: self._dispatch(batch, lane))
                continue
            if window:
                stalled = len(window) >= k
                t_w = time.monotonic()
                self._collect_one(window.popleft(), lane)
                if stalled:
                    obs.count("pipeline.stall_s", time.monotonic() - t_w)
        while window:           # shutdown: publish what is in flight
            self._collect_one(window.popleft(), lane)
        # a capture armed for more dispatches than came is written here,
        # on the thread that started it (the profiler wants that)
        self._profile_force_stop()

    def _note_inflight_peak(self, peak: int) -> None:
        with self._counts_lock:
            if peak > self._inflight_peak:
                self._inflight_peak = peak
                obs.gauge("pipeline.inflight_peak", peak)

    def _iteration(self, batch: List["rq.CheckRequest"], lane: _Lane,
                   body) -> None:
        """One dispatch iteration: ``body()``, the last containment of a
        failure in the daemon's own bookkeeping (a member still open
        finishes ``error``; the lane thread lives on), then the queue
        slot's release and the stats."""
        try:
            body()
        except Exception as e:                          # noqa: BLE001
            log.error("dispatch iteration crashed: %r", e, exc_info=e)
            obs.engine_fallback("serve-dispatch", type(e).__name__,
                                lanes=len(batch), iteration=True)
            now = time.monotonic()
            for r in batch:
                if not r.terminal:
                    self._finish(r, {"valid": "unknown",
                                     "cause": ENGINE_FAULT,
                                     "error": f"{type(e).__name__}: {e}"},
                                 0.0, now)
        finally:
            t_stats = time.monotonic()
            self.queue.mark_done(batch, lane=lane.idx)
            obs.gauge("serve.inflight", 0)
            self._profile_maybe_stop()
            snap = obs.GLOBAL.snapshot()
            self.ring.sample(self.queue, snap)
            if time.monotonic() - self._stats_written >= STATS_FILE_S:
                self._write_stats_file(snap)
            obs.count("serve.lane.stats_s", time.monotonic() - t_stats)

    def _collect_one(self, staged: _StagedDispatch, lane: _Lane) -> None:
        self._iteration(staged.batch, lane,
                        lambda: self._collect_staged(staged, lane))

    # -- on-demand profiling ------------------------------------------------------
    def arm_profile(self, dispatches: int) -> str:
        """Arm ``torch.profiler`` around the next ``dispatches``
        dispatches; the capture lands in a fresh
        ``<store-root>/serve/profile-<ts>/``. Raises RuntimeError when
        already armed or without a store root."""
        if self.store_root is None:
            raise RuntimeError("profiling needs a store root")
        from jepsen_tpu_torch import store
        with self._profile_lock:
            if self._profile_left > 0 or self._profiler is not None:
                raise RuntimeError(f"profile already armed "
                                   f"({self._profile_left} dispatches "
                                   f"left)")
            d = store.serve_profile_dir(self.store_root)
            self._profile_dir = d
            self._profile_left = int(dispatches)
            self._profile_records = None
            return d

    def profile_state(self) -> Dict[str, Any]:
        with self._profile_lock:
            return {"armed": int(self._profile_left),
                    "active": self._profiler is not None,
                    "dir": self._profile_dir,
                    "device-records": self._profile_records}

    def _profile_maybe_start(self) -> None:
        with self._profile_lock:
            if self._profile_left <= 0 or self._profiler is not None:
                return
            try:
                self._profiler = _profiler_start(self._profile_dir)
                self._profile_thread = threading.get_ident()
                obs.decision("serve-profile", "route", cause="start",
                             dir=self._profile_dir,
                             dispatches=self._profile_left)
            except Exception as e:                      # noqa: BLE001
                log.warning("profiler start failed: %s", e)
                obs.engine_fallback("serve-profile", type(e).__name__)
                self._profile_left = 0

    def _profile_maybe_stop(self) -> None:
        """Count a dispatch of the capture, on the lane thread that
        started it, and stop it after its last."""
        with self._profile_lock:
            if self._profiler is None \
                    or self._profile_thread != threading.get_ident():
                return
            self._profile_left -= 1
            if self._profile_left <= 0:
                self._profile_stop_locked()

    def _profile_force_stop(self) -> None:
        """Stop this thread's capture, if it started one."""
        with self._profile_lock:
            if self._profiler is not None \
                    and self._profile_thread == threading.get_ident():
                self._profile_stop_locked()

    def _profile_stop_locked(self) -> None:
        try:
            n = _profiler_stop(self._profiler, self._profile_dir)
            self._profile_records = n
            obs.count("serve.profile.captures")
            obs.gauge("serve.profile.device_records", n)
        except Exception as e:                          # noqa: BLE001
            log.warning("profiler stop failed: %s", e)
            obs.engine_fallback("serve-profile", type(e).__name__)
        self._profiler = None
        self._profile_left = 0

    # -- engine attempts: the recovery ladder's rungs --------------------------------
    @staticmethod
    def _is_txn(model) -> bool:
        from jepsen_tpu_torch.txn.ops import ListAppend
        return isinstance(model, ListAppend)

    def _run_engine(self, batch: List["rq.CheckRequest"],
                    kw: Dict[str, Any], lane: _Lane,
                    feed_breaker: bool = True) -> List[Dict[str, Any]]:
        """One engine attempt of a (sub)group on the route the lane's
        breaker gives. Raises on failure. A failure the ladder takes
        feeds the breaker (not in the bisect hunt's sub-attempts:
        ``feed_breaker=False``; one poison request is not the card's
        health); a device fault does not, so no later group is sent to
        the host because of one."""
        from jepsen_tpu_torch.checkers import facade
        tenants = [r.tenant for r in batch]
        faults.fire("dispatch", tenants=tenants)
        if lane.breaker.route() == "host":
            obs.count("serve.breaker.degraded_dispatches")
            obs.decision("serve-breaker", "route", cause="host",
                         lanes=len(batch), lane=lane.idx)
            return self._run_host(batch, kw, fire_point=False)
        req0 = batch[0]
        try:
            faults.fire("device", tenants=tenants)
            lane.device_ran = True
            with obs.span("serve.dispatch", model=req0.model_name,
                          lanes=len(batch)):
                if self._is_txn(req0.model):
                    results = [facade.auto_check_txn(list(r.history), kw)
                               for r in batch]
                elif len(batch) == 1:
                    results = [facade.auto_check_packed(req0.model,
                                                        req0.packed, kw)]
                else:
                    results = facade.auto_check_many_packed(
                        req0.model, [r.packed for r in batch], kw)
        except Exception as e:
            if feed_breaker and recovery.ladder_takes(e):
                lane.breaker.record_failure()
            raise
        lane.breaker.record_success()
        return results

    def _run_host(self, batch: List["rq.CheckRequest"], kw: Dict[str, Any],
                  fire_point: bool = True) -> List[Dict[str, Any]]:
        """The degraded route, a member at a time on the host checkers
        (the Python WGL oracle; the host SCC for txn): the verdicts the
        card's chain gives, slower, marked ``degraded``. Taken while the
        breaker is open and as a failing singleton's rescue."""
        from jepsen_tpu_torch.checkers import facade, wgl_ref
        if fire_point:
            faults.fire("dispatch", tenants=[r.tenant for r in batch])
        out = []
        with obs.span("serve.dispatch-host", model=batch[0].model_name,
                      lanes=len(batch)):
            for r in batch:
                if self._is_txn(r.model):
                    res = facade.auto_check_txn(list(r.history),
                                                dict(kw, force_host=True))
                else:
                    res = wgl_ref.check_packed(
                        r.model, r.packed,
                        **facade._engine_kw(kw, facade._WGL_KW))
                    res.setdefault("engine", "wgl-cpu")
                res["degraded"] = True
                out.append(res)
        return out

    def _run_recover(self, batch: List["rq.CheckRequest"],
                     kw: Dict[str, Any], retries_left: int, lane: _Lane,
                     top_level: bool = True) -> List[Dict[str, Any]]:
        """The ladder for a failure it takes (:func:`recovery.ladder_takes`):
        attempt, bounded retries with backoff, bisection, a host rescue
        of a failing singleton, quarantine. Any other failure propagates
        at once."""
        from jepsen_tpu_torch.checkers import dispatch_core as dc
        attempt = 0
        while True:
            try:
                return self._run_engine(batch, kw, lane,
                                        feed_breaker=top_level)
            except Exception as e:                      # noqa: BLE001
                if not recovery.ladder_takes(e):
                    raise
                err = e
                log.warning("serve dispatch failed (lanes=%d, attempt=%d):"
                            " %r", len(batch), attempt, e)
                obs.engine_fallback("serve-dispatch", type(e).__name__,
                                    lanes=len(batch), attempt=attempt)
            if self._stop.is_set():
                return [{"valid": "unknown",
                         "error": f"{type(err).__name__}: {err}"}
                        for _ in batch]
            if retries_left <= 0:
                break
            retries_left -= 1
            obs.count("serve.retry.attempts")
            time.sleep(self.retry.delay(attempt))
            attempt += 1
        if len(batch) > 1:
            obs.count("serve.retry.bisects")
            obs.decision("serve-retry", "bisect", lanes=len(batch),
                         cause=type(err).__name__)
            lo, hi = recovery.bisect(batch)
            return self._run_recover(lo, kw, 0, lane, top_level=False) \
                + self._run_recover(hi, kw, 0, lane, top_level=False)
        req = batch[0]
        try:
            return dc.rescue_once("serve-retry", "host-rescue",
                                  lambda: self._run_host(batch, kw),
                                  id=req.id)
        except Exception as e:                          # noqa: BLE001
            if not recovery.ladder_takes(e):
                raise
            obs.count("serve.quarantined")
            obs.engine_fallback("serve-quarantine", type(e).__name__,
                                id=req.id, tenant=req.tenant,
                                ops=int(req.n_ops))
            log.warning("quarantining request %s: %r", req.id, e)
            return [{"valid": "unknown", "quarantined": True,
                     "cause": "quarantined",
                     "error": f"{type(e).__name__}: {e}"}]

    def _fault_results(self, batch: List["rq.CheckRequest"],
                       e: BaseException) -> List[Dict[str, Any]]:
        """A group that ended on a fault: each member's ``error`` result,
        recorded in the ledger; a device fault is also counted and kept
        for ``/healthz``."""
        text = f"{type(e).__name__}: {e}"
        cause = DEVICE_FAULT if recovery.is_device_fault(e) else ENGINE_FAULT
        log.error("serve dispatch %s (lanes=%d): %s", cause, len(batch),
                  text, exc_info=e)
        obs.decision("serve-dispatch", "fault", cause=cause,
                     error=text[:500], lanes=len(batch))
        if cause == DEVICE_FAULT:
            obs.count("serve.device_faults")
            with self._counts_lock:
                self.device_faults += 1
                self.device_fault = text
        return [{"valid": "unknown", "cause": cause, "error": text}
                for _ in batch]

    def _abort_hook(self, batch: List["rq.CheckRequest"], t0: float):
        """The group's ``should_abort``: the daemon stops, the dispatch
        hangs past its cap (recorded once; the survivors are requeued),
        or no member still wants its verdict. Returns ``(hook, hang)``,
        ``hang[0]`` set once the cap fired."""
        hang = [False]

        def _aborted() -> bool:
            if self._stop.is_set():
                return True
            if self.dispatch_deadline_s is not None \
                    and time.monotonic() - t0 > self.dispatch_deadline_s:
                if not hang[0]:
                    hang[0] = True
                    obs.engine_fallback(
                        "serve-hang", "DispatchDeadline", lanes=len(batch),
                        deadline_s=self.dispatch_deadline_s)
                return True
            now = time.monotonic()
            return all(r.cancel_requested or r.expired(now) for r in batch)

        return _aborted, hang

    def _begin(self, batch: List["rq.CheckRequest"], lane: _Lane,
               t0: float) -> None:
        """The dispatch bookkeeping of a group: counts, stamps, the
        queue-wait histogram, the tenants' ledgers."""
        req0 = batch[0]
        sig = f"{req0.model_name}/H{len(batch)}"
        with self._counts_lock:
            self.dispatch_counts[sig] = self.dispatch_counts.get(sig, 0) + 1
        obs.count("serve.dispatched", len(batch))
        obs.count(f"serve.lane.{lane.idx}.dispatched")
        obs.gauge("serve.inflight", len(batch))
        for r in batch:
            r.t_dispatch = t0
            obs.histogram("serve.queue_wait_s",
                          max(0.0, (r.t_coalesce or t0) - r.t_submit))
            self.registry.ledger_record(r.tenant, "dispatched", id=r.id,
                                        group=len(batch), ops=int(r.n_ops))

    def _engine_kw(self, req0: "rq.CheckRequest", abort) -> Dict[str, Any]:
        # the coalescer groups only requests with equal options, so the
        # first member's speak for the group
        kw = dict(self.engine_kw)
        kw.update(req0.opts)
        kw["should_abort"] = abort
        return kw

    def _dispatch(self, batch: List["rq.CheckRequest"],
                  lane: Optional[_Lane] = None) -> None:
        """The blocking path of one group: bookkeeping, the ladder, then
        :meth:`_publish`; a session's blocks take the session paths."""
        lane = lane or self._lanes[0]
        faults.fire("tick")
        if batch[0].session is not None:
            if len({r.session.id for r in batch}) > 1:
                # the coalescer builds one only of appends that share a
                # walk geometry
                self._dispatch_session_group(batch, lane)
            else:
                self._dispatch_session(batch, lane)
            return
        t0 = time.monotonic()
        self._begin(batch, lane, t0)
        abort, hang = self._abort_hook(batch, t0)
        kw = self._engine_kw(batch[0], abort)
        lane.device_ran = False
        # the lane thread's records are captured here and stitched into
        # every member's trace (captures are per thread)
        with obs.capture() as cap:
            try:
                results = self._run_recover(batch, kw,
                                            self.retry.max_retries, lane)
            except Exception as e:                      # noqa: BLE001
                results = self._fault_results(batch, e)
        obs.count("serve.lane.check_s", time.monotonic() - t0)
        self._publish(batch, results, lane, t0, cap.ledger, hang,
                      lane.device_ran)

    # -- sessions --------------------------------------------------------------
    def _session_abort(self, t0: float):
        """A session block's ``should_abort``: the dispatch cap applied to
        one advance (the session then ends ``error``, cause
        ``deadline``, not a wedged lane); None without a cap. A stopping
        daemon does not abort an advance: the block finishes and a
        restart replays the journal."""
        deadline_s = self.dispatch_deadline_s
        if deadline_s is None:
            return None
        fired = [False]

        def _aborted() -> bool:
            if time.monotonic() - t0 > deadline_s:
                if not fired[0]:
                    fired[0] = True
                    obs.engine_fallback("serve-hang", "DispatchDeadline",
                                        session=True, deadline_s=deadline_s)
                return True
            return False
        return _aborted

    def _session_begin(self, batch, lane: _Lane, sig: str) -> float:
        with self._counts_lock:
            self.dispatch_counts[sig] = self.dispatch_counts.get(sig, 0) + 1
        obs.count("serve.dispatched", len(batch))
        obs.count(f"serve.lane.{lane.idx}.dispatched")
        obs.gauge("serve.inflight", len(batch))
        return time.monotonic()

    def _session_stamp(self, r: "rq.CheckRequest", group: int,
                       **fields: Any) -> None:
        r.t_dispatch = time.monotonic()
        obs.histogram("serve.queue_wait_s",
                      max(0.0, (r.t_coalesce or r.t_dispatch) - r.t_submit))
        self.registry.ledger_record(r.tenant, "dispatched", id=r.id,
                                    group=group, ops=int(r.n_ops),
                                    session=r.session.id, kind=r.kind,
                                    **fields)

    def _session_publish(self, r: "rq.CheckRequest", res: Dict[str, Any],
                         recs, t_wall: float, count_fault: bool = True,
                         **fields: Any) -> None:
        """One block's verdict: its trace, the tenant's fallback records,
        a fault's journal marker and (``count_fault``) count, then
        :meth:`_finish`."""
        from jepsen_tpu_torch.serve.session import FAULT_CAUSES
        sess = r.session
        now = time.monotonic()
        r.t_collect = now
        r.stitch([{"ts": round(time.time(), 6), "stage": "session-advance",
                   "event": "advance", "session": sess.id, "seq": r.seq,
                   "wall_s": round(now - t_wall, 6), **fields}] + recs)
        for rec in recs:
            if rec.get("event") in ("fallback", "fault"):
                self.registry.ledger_record(
                    r.tenant, f"engine-{rec['event']}", id=r.id,
                    stage=rec.get("stage"), cause=rec.get("cause"))
        if res.get("cause") in FAULT_CAUSES and sess.faulted:
            self._session_ended(sess, count_fault)
        obs.histogram("serve.session.append_s", now - r.t_submit)
        self._finish(r, res, now - (r.t_dispatch or now), now)

    def _session_ended(self, sess, count_fault: bool) -> None:
        """A session a fault ended: out of the open census, its journal
        marker written (a restart does not replay it), and a device fault
        counted as a one-shot group's is."""
        if self.sessions is not None:
            self.sessions.mark_closed(sess)
        if self.journal is not None:
            self.journal.session_close_marker(sess.id, sess.result)
        if count_fault and sess.result.get("cause") == DEVICE_FAULT:
            obs.count("serve.device_faults")
            with self._counts_lock:
                self.device_faults += 1
                self.device_fault = sess.result.get("error")

    def _dispatch_session(self, batch: List["rq.CheckRequest"],
                          lane: _Lane) -> None:
        """One session's blocks in seq order (the coalescer sorted them):
        each append advances the carried state, a close resolves it. No
        recovery ladder, no breaker, no device-time attribution (the
        advances' wall is ``serve.session.advance_wall_s``)."""
        from jepsen_tpu_torch.serve.session import SessionClosed
        sess = batch[0].session
        t0 = self._session_begin(
            batch, lane, f"session/{batch[0].model_name}/A{len(batch)}")
        for r in batch:
            self._session_stamp(r, len(batch))
            with obs.capture() as cap:
                try:
                    if r.kind == "session-close":
                        res = sess.close()
                        if not sess.faulted:
                            if self.sessions is not None:
                                self.sessions.mark_closed(sess)
                            if self.journal is not None:
                                self.journal.session_close_marker(sess.id,
                                                                  res)
                    else:
                        res = sess.advance_block(
                            list(r.history), seq=r.seq,
                            should_abort=self._session_abort(r.t_dispatch))
                except SessionClosed as e:
                    # an append or close that raced the close
                    res = {"valid": "unknown", "cause": "closed",
                           "error": str(e)}
            recs = [rec for rec in cap.ledger
                    if rec.get("event") in ("fallback", "route", "selected",
                                            "fault")]
            self._session_publish(r, res, recs, r.t_dispatch)
        obs.count("serve.session.advance_wall_s", time.monotonic() - t0)

    def _dispatch_session_group(self, batch: List["rq.CheckRequest"],
                                lane: _Lane) -> None:
        """The appends of many sessions of one walk geometry, in waves:
        wave w is each session's w-th block, one K10 launch
        (:func:`.session.advance_group`)."""
        from jepsen_tpu_torch.serve import session as sessmod
        by_sess: Dict[str, List["rq.CheckRequest"]] = {}
        for r in batch:
            by_sess.setdefault(r.session.id, []).append(r)
        t0 = self._session_begin(
            batch, lane, f"session-mega/L{len(by_sess)}/A{len(batch)}")
        waves = [[rs[w] for rs in by_sess.values() if w < len(rs)]
                 for w in range(max(len(rs) for rs in by_sess.values()))]
        for wave in waves:
            tw = time.monotonic()
            for r in wave:
                self._session_stamp(r, len(batch), mega=len(wave))
            with obs.capture() as cap:
                results = sessmod.advance_group(
                    [(r.session, list(r.history), r.seq) for r in wave],
                    should_abort=self._session_abort(tw))
            recs = [rec for rec in cap.ledger
                    if rec.get("event") in ("fallback", "route", "selected",
                                            "fault")]
            counted = False
            for r, res in zip(wave, results):
                # the group's records (no session tag: the one
                # session-mega fallback) go to every member
                mine = [rec for rec in recs
                        if rec.get("session") in (None, True, r.session.id)]
                # one launch's device fault is counted once
                self._session_publish(r, res, mine, tw,
                                      count_fault=not counted,
                                      mega=len(wave))
                counted = counted or res.get("cause") == DEVICE_FAULT
        obs.count("serve.session.advance_wall_s", time.monotonic() - t0)

    def _publish_fault(self, batch: List["rq.CheckRequest"], lane: _Lane,
                       e: BaseException) -> None:
        """A group whose stage raised: its members finish on the fault."""
        t0 = time.monotonic()
        self._begin(batch, lane, t0)
        with obs.capture() as cap:
            results = self._fault_results(batch, e)
        self._publish(batch, results, lane, t0, cap.ledger, [False], True)

    def _publish(self, batch: List["rq.CheckRequest"], results,
                 lane: _Lane, t0: float, cap_ledger, hang,
                 device_ran: bool) -> None:
        """Results → attribution → stitched traces → finish or requeue:
        the tail of the blocking dispatch and of the staged collect."""
        t_pub = time.monotonic()
        if len(results) != len(batch):
            obs.engine_fallback("serve-dispatch", "ResultMisaligned",
                                lanes=len(batch), got=len(results))
            results = (list(results) + [{"valid": "unknown",
                                         "cause": ENGINE_FAULT,
                                         "error": "result misaligned"}]
                       * len(batch))[:len(batch)]
        t_collect = time.monotonic()
        elapsed = t_collect - t0
        # the lane's attribution clock: staged groups' walls overlap, so
        # each books the lane wall since the previous collect (collects
        # are in order on the lane's thread, so the intervals partition
        # the lane's busy wall); the overlapped rest is the window's gain
        attributed = max(0.0, t_collect - max(t0, lane.attr_mark))
        lane.attr_mark = t_collect
        overlap = elapsed - attributed
        if overlap > 1e-9:
            obs.count("pipeline.overlap_s", overlap)
            obs.count(f"pipeline.lane.{lane.idx}.overlap_s", overlap)
        # the group's wall shared by its members; no lane is padded, so
        # the pad's share is 0 and device_s alone makes up the wall
        n = len(batch)
        if device_ran:
            share = attributed / n
            obs.histogram("serve.dispatch_wall_s", attributed)
            obs.count("serve.device_s", share * n)
            obs.count("serve.pad_waste_s", 0.0)
            obs.count(f"serve.lane.{lane.idx}.device_s", share * n)
            obs.count(f"serve.lane.{lane.idx}.pad_waste_s", 0.0)
        else:
            # served on the host with the breaker open: not device time
            share = 0.0
            obs.count("serve.breaker.host_wall_s", elapsed)
        engine_recs = [r for r in cap_ledger
                       if r.get("event") in ("selected", "fallback",
                                             "swallowed", "route",
                                             "skipped", "fault")]
        disp_rec = {"ts": round(time.time(), 6), "stage": "serve-dispatch",
                    "event": "dispatch", "group": n, "real": n, "pad": 0,
                    "wall_s": round(elapsed, 6),
                    "device_s": round(share, 9), "pad_waste_s": 0.0}
        now = time.monotonic()
        for req, res in zip(batch, results):
            req.t_collect = t_collect
            req.device_s = share
            req.stitch([disp_rec] + engine_recs)
            self.registry.add_device_time(req.tenant, share)
            for r in engine_recs:
                if r.get("event") in ("fallback", "swallowed", "fault"):
                    self.registry.ledger_record(
                        req.tenant, f"engine-{r['event']}", id=req.id,
                        stage=r.get("stage"), cause=r.get("cause"))
            if (hang[0] and res.get("valid") not in (True, False)
                    and not res.get("quarantined")
                    and res.get("cause") not in (DEVICE_FAULT, ENGINE_FAULT)
                    and not req.cancel_requested and not req.expired(now)
                    and req.requeues < self.retry.max_requeues):
                # aborted past the dispatch cap: this survivor still
                # wants its verdict
                self._requeue(req)
            else:
                self._finish(req, res, elapsed, now)
        obs.count("serve.lane.publish_s", time.monotonic() - t_pub)

    # -- the staged window's stage and collect --------------------------------------
    def _stage(self, batch: List["rq.CheckRequest"],
               lane: _Lane) -> Optional[_StagedDispatch]:
        """Stage one group on the lockstep lane
        (:func:`facade.stage_check_many_packed`) and, when it is taken,
        do its dispatch bookkeeping and return its handle. None, with no
        side effect a request can see, when the group is not staged: a
        singleton, txn, a session's blocks, an open breaker, armed faults
        (their fire points are on the blocking path) or a batch the lane
        declines. A fault in the stage propagates."""
        from jepsen_tpu_torch.checkers import facade
        req0 = batch[0]
        if len(batch) < 2 or self._is_txn(req0.model) \
                or req0.session is not None \
                or lane.breaker.route() == "host" or faults.enabled():
            return None
        t0 = time.monotonic()
        abort, hang = self._abort_hook(batch, t0)
        kw = self._engine_kw(req0, abort)
        with obs.capture() as cap:
            with obs.span("pipeline.stage", model=req0.model_name,
                          lanes=len(batch)):
                handle = facade.stage_check_many_packed(
                    req0.model, [r.packed for r in batch], kw)
        # a declined stage's prep is spent too: the blocking path redoes it
        obs.count("serve.lane.stage_s", time.monotonic() - t0)
        if handle is None:
            return None
        self._begin(batch, lane, t0)
        return _StagedDispatch(batch, kw, hang, t0, handle,
                               list(cap.ledger))

    def _collect_staged(self, staged: _StagedDispatch, lane: _Lane) -> None:
        """Collect one staged group and publish it. A collect failure the
        ladder takes (a capacity decline of a failed member's own prep)
        runs the group through the ladder from its retained requests; any
        other ends the group on the fault."""
        batch = staged.batch
        t_col = time.monotonic()
        with obs.capture() as cap:
            try:
                with obs.span("serve.dispatch", model=batch[0].model_name,
                              lanes=len(batch), staged=True):
                    results = staged.handle.collect()
                lane.breaker.record_success()
            except Exception as e:                      # noqa: BLE001
                if not recovery.ladder_takes(e):
                    results = self._fault_results(batch, e)
                else:
                    obs.engine_fallback("serve-dispatch", type(e).__name__,
                                        lanes=len(batch), staged=True)
                    lane.breaker.record_failure()
                    try:
                        results = self._run_recover(
                            batch, staged.kw, self.retry.max_retries, lane)
                    except Exception as e2:             # noqa: BLE001
                        results = self._fault_results(batch, e2)
        obs.count("serve.lane.collect_s", time.monotonic() - t_col)
        self._publish(batch, results, lane, staged.t0,
                      staged.cap_recs + cap.ledger, staged.hang, True)

    # -- completion -----------------------------------------------------------------
    def _requeue(self, req: "rq.CheckRequest") -> None:
        req.requeues += 1
        req.status = rq.QUEUED
        req.t_coalesce = req.t_dispatch = req.t_collect = None
        obs.count("serve.retry.requeued")
        obs.decision("serve-retry", "requeued", id=req.id,
                     requeues=req.requeues)
        self.registry.ledger_record(req.tenant, "requeued", id=req.id,
                                    requeues=req.requeues)
        self.queue.submit(req, force=True)

    def _finish(self, req: "rq.CheckRequest", res: Dict[str, Any],
                elapsed: float, now: float) -> None:
        if res.get("cause") in (DEVICE_FAULT, ENGINE_FAULT):
            status = rq.ERROR
            obs.count("serve.errors")
        elif req.cancel_requested:
            status = rq.CANCELLED
            obs.count("serve.cancelled")
        elif res.get("quarantined"):
            status = rq.QUARANTINED
        elif req.expired(now) and res.get("valid") not in (True, False):
            # aborted (or still unknown) past the deadline: a timeout
            status = rq.TIMEOUT
            res = {"valid": "unknown", "cause": "deadline",
                   **{k: v for k, v in res.items() if k != "valid"}}
            obs.count("serve.timeout")
            obs.engine_fallback("serve-timeout", "DeadlineExpired",
                                tenant=req.tenant, ops=req.n_ops,
                                dispatched=True)
        else:
            # a conclusive verdict that finished late is still the verdict
            status = rq.DONE
            obs.count("serve.completed")
            # observed where serve.completed counts: the e2e histogram's
            # count equals the completed requests at every scrape
            obs.histogram("serve.e2e_s", now - req.t_submit)
            obs.histogram("serve.service_s",
                          now - (req.t_coalesce or req.t_dispatch
                                 or req.t_submit))
        # a session's blocks are not store runs: the session journal is
        # their durable record
        if self.persist and status == rq.DONE and req.session is None:
            try:
                req.t_done = now
                req.run_dir = self._persist(req, res)
            except Exception as e:                      # noqa: BLE001
                # the verdict publishes; the missing run dir is recorded
                log.warning("serve persist failed for %s: %s", req.id, e)
                obs.engine_fallback("serve-persist", type(e).__name__,
                                    id=req.id)
        self.registry.finish(req, status, res)
        self.registry.ledger_record(
            req.tenant, status, id=req.id, valid=res.get("valid"),
            engine=res.get("engine"), dispatch_s=round(elapsed, 6),
            device_s=round(req.device_s or 0.0, 9),
            latency_s=round(now - req.t_submit, 6))
        obs.count(f"serve.tenant.{self.registry.bucket_tenant(req.tenant)}"
                  f".{status}")

    def _finish_timeout_queued(self, req: "rq.CheckRequest") -> None:
        """A deadline that expired in the queue."""
        self.registry.finish(req, rq.TIMEOUT,
                             {"valid": "unknown", "cause": "deadline",
                              "queued-only": True})
        self.registry.ledger_record(req.tenant, rq.TIMEOUT, id=req.id,
                                    queued_only=True)
        obs.count(f"serve.tenant.{self.registry.bucket_tenant(req.tenant)}"
                  f".timeout")

    def _persist(self, req: "rq.CheckRequest", res: Dict[str, Any]) -> str:
        """The request as a store run dir, ``<root>/serve-<model>/<ts>-<id>/``."""
        from jepsen_tpu_torch import store
        faults.fire("persist", tenants=[req.tenant])
        out = dict(res)
        out["serve"] = {"id": req.id, "tenant": req.tenant,
                        "latency-s": round(time.monotonic() - req.t_submit,
                                           6),
                        "device-s": round(req.device_s or 0.0, 9),
                        "waterfall": req.waterfall(),
                        "trace": [dict(r) for r in req.trace]}
        return store.save_check(self.store_root, f"serve-{req.model_name}",
                                req.id, list(req.history), out)

    # -- stats ----------------------------------------------------------------------
    def stats(self, snap: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if snap is None:
            snap = obs.GLOBAL.snapshot()
        counters = {k: v for k, v in snap["counters"].items()
                    if k.startswith(("serve.", "engine.", "lockstep.",
                                     "donate.", "pipeline."))}
        with self._counts_lock:
            dispatch = dict(self.dispatch_counts)
            faults_seen = {"count": self.device_faults,
                           "last": self.device_fault}
        out = {
            "device": str(self.device),
            "pipeline_k": self.pipeline_k,
            "queue": {"depth": self.queue.depth(),
                      "max_depth": self.queue.max_depth,
                      "inflight": self.queue.inflight(),
                      "group": self.queue.group,
                      "max_inflight_per_tenant":
                          self.queue.max_inflight_per_tenant},
            "dispatch": dispatch,
            "counters": counters,
            "histograms": {k: obs.hist_summary(h)
                           for k, h in snap["histograms"].items()
                           if k.startswith("serve.")},
            "timeseries": self.ring.points(),
            "profile": self.profile_state(),
            "breaker": self.breaker.to_json(),
            "degraded": any(ln.breaker.degraded for ln in self._lanes),
            "device_faults": faults_seen,
            "retry": self.retry.to_json(),
            "lanes": {"n": self.lanes_n, "loads": self.queue.lane_loads(),
                      "breakers": [ln.breaker.to_json()
                                   for ln in self._lanes]},
        }
        if self.journal is not None:
            out["journal"] = self.journal.stats()
        if self.sessions is not None:
            # the results browser's open-sessions row
            out["sessions"] = self.sessions.census()
        out.update(self.registry.stats())
        return out

    def _write_stats_file(self, snap: Optional[Dict[str, Any]] = None
                          ) -> None:
        """The latest stats as ``<store-root>/serve/stats.json``, which
        the results browser reads (the lanes write it at most every
        :data:`STATS_FILE_S`); advisory, a failure is logged."""
        self._stats_written = time.monotonic()
        if not self.store_root:
            return
        try:
            d = os.path.join(self.store_root, "serve")
            os.makedirs(d, exist_ok=True)
            # a temporary a thread: lanes write at once
            tmp = os.path.join(d, f".stats.json.{threading.get_ident()}.tmp")
            with open(tmp, "w") as f:
                json.dump({"ts": time.time(), **self.stats(snap)}, f,
                          default=str)
            os.replace(tmp, os.path.join(d, "stats.json"))
        except Exception as e:                          # noqa: BLE001
            log.warning("stats file not written: %s", e)

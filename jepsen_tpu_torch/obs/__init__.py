"""Observability for the checker pipeline: a span tracer, process-wide
counters and gauges, and the engine-decision ledger, with the record
shapes of the reference package's ``obs`` core.

    from jepsen_tpu_torch import obs

    with obs.span("phase", detail=1):        # nestable, thread-safe
        obs.count("cache.hits")              # process-wide counter
        obs.decision("reach", "selected")    # ledger record

    with obs.capture() as cap:               # isolated assertion scope
        run_check()
    assert cap.fallbacks() == []

Every auto-chain stage transition lands in the ledger, so a test can
assert which engine decided a verdict and that no stage was dropped
silently. A run's record is exported next to its history as
``trace.json`` (Chrome/Perfetto ``trace_event``: :func:`export_trace`)
and ``obs.jsonl`` (one record a line: :func:`export_jsonl`). Set
``JEPSEN_TPU_NO_OBS=1`` to disable all recording.
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_ENABLED = not os.environ.get("JEPSEN_TPU_NO_OBS")

# one process-wide monotonic origin so span timestamps from every
# thread land on one comparable axis
_T0 = time.perf_counter()

_MAX_SPANS = 100_000
_MAX_LEDGER = 10_000


def _now_us() -> float:
    return (time.perf_counter() - _T0) * 1e6


class Recorder:
    """One sink of spans, counters and ledger records: the process-wide
    :data:`GLOBAL`, plus one per :func:`capture`."""

    __slots__ = ("_lock", "spans", "counters", "gauges", "ledger")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.spans: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Any] = {}
        self.ledger: List[Dict[str, Any]] = []

    def _append(self, store: list, cap: int, dropped: str,
                rec: Dict[str, Any]) -> None:
        with self._lock:
            if len(store) >= cap:
                self.counters[dropped] = self.counters.get(dropped, 0) + 1
                return
            store.append(rec)

    def add_span(self, ev: Dict[str, Any]) -> None:
        self._append(self.spans, _MAX_SPANS, "obs.dropped.spans", ev)

    def decide(self, rec: Dict[str, Any]) -> None:
        self._append(self.ledger, _MAX_LEDGER, "obs.dropped.ledger", rec)

    def count(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self.gauges[name] = value

    def snapshot(self) -> Dict[str, Any]:
        """Consistent copy of counters, gauges and the ledger (spans are
        exported separately: they can be large)."""
        with self._lock:
            return {"counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "ledger": [dict(r) for r in self.ledger]}

    def span_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self.spans]

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.counters.clear()
            self.gauges.clear()
            self.ledger.clear()


GLOBAL = Recorder()

# extra sinks registered by capture(); a ContextVar so captures nest and
# threads run under contextvars.copy_context() record into them too
_CAPTURES: "contextvars.ContextVar[Tuple[Recorder, ...]]" = \
    contextvars.ContextVar("jepsen_tpu_torch_obs_captures", default=())


def _sinks() -> Tuple[Recorder, ...]:
    return (GLOBAL,) + _CAPTURES.get()


class _Span:
    """Context manager recording one Chrome-trace ``"X"`` event on exit."""

    __slots__ = ("name", "args", "_ts")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._ts = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = _now_us()
        ev: Dict[str, Any] = {
            "name": self.name, "ph": "X", "ts": self._ts,
            "dur": end - self._ts, "pid": os.getpid(),
            "tid": threading.get_ident()}
        if self.args:
            ev["args"] = self.args
        if exc_type is not None:
            ev.setdefault("args", {})["error"] = exc_type.__name__
        if _ENABLED:
            for s in _sinks():
                s.add_span(ev)


def span(name: str, **args: Any) -> _Span:
    """``with obs.span("reach.walk", engine="reach-lane"): ...``"""
    return _Span(name, args)


def count(name: str, n: float = 1) -> None:
    """Bump a process-wide (and any captured) counter."""
    if _ENABLED:
        for s in _sinks():
            s.count(name, n)


def counters() -> Dict[str, float]:
    """Snapshot of the process-wide counters."""
    with GLOBAL._lock:
        return dict(GLOBAL.counters)


def gauge(name: str, value: Any) -> None:
    """Set a last-value-wins gauge (e.g. ``txn.core.n``)."""
    if _ENABLED:
        for s in _sinks():
            s.gauge(name, value)


def gauges() -> Dict[str, Any]:
    """Snapshot of the process-wide gauges."""
    with GLOBAL._lock:
        return dict(GLOBAL.gauges)


def decision(stage: str, event: str, cause: Optional[str] = None,
             **fields: Any) -> None:
    """Append ``{"ts", "stage", "event"[, "cause"], **fields}`` to the
    engine-decision ledger. ``event`` is ``"selected"``, ``"fallback"``,
    ``"skipped"``, ``"swallowed"`` or ``"route"``."""
    if not _ENABLED:
        return
    rec: Dict[str, Any] = {"ts": round(_now_us()), "stage": stage,
                           "event": event}
    if cause is not None:
        rec["cause"] = cause
    rec.update(fields)
    for s in _sinks():
        s.decide(rec)


def engine_selected(stage: str, **fields: Any) -> None:
    """An engine produced the conclusive verdict of a check."""
    count(f"engine.selected.{stage}")
    decision(stage, "selected", **fields)


def engine_fallback(stage: str, cause: str, **fields: Any) -> None:
    """A stage was abandoned and the chain moved on."""
    count(f"engine.fallback.{stage}.{cause}")
    decision(stage, "fallback", cause=cause, **fields)


def checker_swallowed(stage: str, cause: str, **fields: Any) -> None:
    """``check_safe`` turned a checker crash into ``"unknown"``."""
    count(f"checker.swallowed.{stage}.{cause}")
    decision(stage, "swallowed", cause=cause, **fields)


class Capture:
    """What was recorded while a :func:`capture` context was active."""

    def __init__(self) -> None:
        self._rec = Recorder()

    @property
    def spans(self) -> List[Dict[str, Any]]:
        return self._rec.span_events()

    @property
    def counters(self) -> Dict[str, float]:
        with self._rec._lock:
            return dict(self._rec.counters)

    @property
    def gauges(self) -> Dict[str, Any]:
        with self._rec._lock:
            return dict(self._rec.gauges)

    @property
    def ledger(self) -> List[Dict[str, Any]]:
        with self._rec._lock:
            return [dict(r) for r in self._rec.ledger]

    def _by_event(self, event: str) -> List[Dict[str, Any]]:
        return [r for r in self.ledger if r.get("event") == event]

    def selections(self) -> List[Dict[str, Any]]:
        return self._by_event("selected")

    def fallbacks(self) -> List[Dict[str, Any]]:
        return self._by_event("fallback")

    def skipped(self) -> List[Dict[str, Any]]:
        return self._by_event("skipped")

    def summary(self) -> Dict[str, Any]:
        """JSON-serializable counters + gauges + ledger (no spans)."""
        return self._rec.snapshot()


class _CaptureCtx:
    __slots__ = ("_cap", "_token")

    def __init__(self) -> None:
        self._cap = Capture()

    def __enter__(self) -> Capture:
        self._token = _CAPTURES.set(_CAPTURES.get() + (self._cap._rec,))
        return self._cap

    def __exit__(self, exc_type, exc, tb) -> None:
        _CAPTURES.reset(self._token)


def capture() -> _CaptureCtx:
    """``with obs.capture() as cap:`` — everything recorded in this
    context is also collected into ``cap``, isolated from captures on
    other threads."""
    return _CaptureCtx()


def reset() -> None:
    """Clear the process-wide recorder."""
    GLOBAL.clear()


# -- export --------------------------------------------------------------------

def _recorder_of(source: Optional[Any]) -> Recorder:
    if source is None:
        return GLOBAL
    if isinstance(source, Capture):
        return source._rec
    return source


def trace_events(source: Optional[Any] = None) -> List[Dict[str, Any]]:
    """The Chrome ``traceEvents`` list: every recorded span as a ``"X"``
    (complete) event, plus one metadata event naming the process."""
    rec = _recorder_of(source)
    meta = {"name": "process_name", "ph": "M", "pid": os.getpid(),
            "tid": 0, "args": {"name": "jepsen-tpu"}}
    return [meta] + rec.span_events()


def export_trace(path: str, source: Optional[Any] = None) -> str:
    """Write a Chrome/Perfetto ``trace_event`` JSON file."""
    data = {"traceEvents": trace_events(source),
            "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(data, f, default=str)
    return path


def export_jsonl(path: str, source: Optional[Any] = None) -> str:
    """Write ``obs.jsonl``: one JSON object per line, each tagged with a
    ``"type"`` of ``counter`` / ``gauge`` / ``decision`` / ``span``."""
    rec = _recorder_of(source)
    snap = rec.snapshot()
    with open(path, "w") as f:
        for name, value in sorted(snap["counters"].items()):
            f.write(json.dumps({"type": "counter", "name": name,
                                "value": value}, default=str) + "\n")
        for name, value in sorted(snap["gauges"].items()):
            f.write(json.dumps({"type": "gauge", "name": name,
                                "value": value}, default=str) + "\n")
        for r in snap["ledger"]:
            f.write(json.dumps({"type": "decision", **r},
                               default=str) + "\n")
        for e in rec.span_events():
            f.write(json.dumps({"type": "span", **e},
                               default=str) + "\n")
    return path

"""Observability for the checker pipeline: a span tracer, process-wide
counters, gauges and histograms, the engine-decision ledger and the
Prometheus text of the check daemon's ``GET /metrics``, with the record
shapes of the reference package's ``obs`` core and trace export.

    from jepsen_tpu_torch import obs

    with obs.span("phase", detail=1):        # nestable, thread-safe
        obs.count("cache.hits")              # process-wide counter
        obs.decision("reach", "selected")    # ledger record

    with obs.capture() as cap:               # isolated assertion scope
        run_check()
    assert cap.fallbacks() == []

    obs.histogram("serve.e2e_s", 0.25)       # fixed log-spaced buckets
    obs.prometheus_text()                    # the daemon's GET /metrics

Every auto-chain stage transition lands in the ledger, so a test can
assert which engine decided a verdict and that no stage was dropped
silently. A run's record is exported next to its history as
``trace.json`` (Chrome/Perfetto ``trace_event``: :func:`export_trace`)
and ``obs.jsonl`` (one record a line: :func:`export_jsonl`). Set
``JEPSEN_TPU_NO_OBS=1`` to disable all recording.
"""
from __future__ import annotations

import bisect
import contextvars
import json
import math
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_ENABLED = not os.environ.get("JEPSEN_TPU_NO_OBS")

# one process-wide monotonic origin so span timestamps from every
# thread land on one comparable axis
_T0 = time.perf_counter()

_MAX_SPANS = 100_000
_MAX_LEDGER = 10_000

# the one bucket layout of every histogram: ten buckets a decade from
# 1 µs to 1,000 s, so two snapshots merge and difference bucket by
# bucket; past the last edge a value lands in the +Inf bucket, and the
# recorded sum keeps the mean exact
HIST_EDGES: Tuple[float, ...] = tuple(
    round(10.0 ** (k / 10.0), 12) for k in range(-60, 31))


def _now_us() -> float:
    return (time.perf_counter() - _T0) * 1e6


class Recorder:
    """One sink of spans, counters, gauges, histograms and ledger
    records: the process-wide :data:`GLOBAL`, plus one per
    :func:`capture`."""

    __slots__ = ("_lock", "spans", "counters", "gauges", "ledger",
                 "hists")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.spans: List[Dict[str, Any]] = []
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Any] = {}
        self.ledger: List[Dict[str, Any]] = []
        self.hists: Dict[str, Dict[str, Any]] = {}

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

    def observe(self, name: str, value: float) -> None:
        """One histogram observation, Prometheus ``le`` semantics: bucket
        ``i`` counts values ``<= HIST_EDGES[i]``, the last slot is +Inf."""
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = {
                    "count": 0, "sum": 0.0,
                    "counts": [0] * (len(HIST_EDGES) + 1)}
            h["counts"][bisect.bisect_left(HIST_EDGES, value)] += 1
            h["count"] += 1
            h["sum"] += value

    def _hists_locked(self) -> Dict[str, Dict[str, Any]]:
        return {k: {"count": h["count"], "sum": h["sum"],
                    "counts": list(h["counts"])}
                for k, h in self.hists.items()}

    def snapshot(self) -> Dict[str, Any]:
        """Consistent copy of counters, gauges, histograms and the ledger
        (spans are exported separately: they can be large)."""
        with self._lock:
            return {"counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "histograms": self._hists_locked(),
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
            self.hists.clear()


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


def histogram(name: str, value: float) -> None:
    """Observe ``value`` into the histogram ``name`` (process-wide and any
    captures), in the buckets of :data:`HIST_EDGES`."""
    if _ENABLED:
        for s in _sinks():
            s.observe(name, value)


def histograms() -> Dict[str, Dict[str, Any]]:
    """Snapshot of the process-wide histograms: ``{name: {"count",
    "sum", "counts"}}``, ``counts`` aligned to :data:`HIST_EDGES` plus
    the +Inf slot."""
    with GLOBAL._lock:
        return GLOBAL._hists_locked()


def _empty_hist() -> Dict[str, Any]:
    return {"count": 0, "sum": 0.0, "counts": [0] * (len(HIST_EDGES) + 1)}


def hist_merge(a: Optional[Dict[str, Any]],
               b: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Bucket-wise sum of two histogram snapshots."""
    if a is None or b is None:
        src = a or b or _empty_hist()
        return {"count": src["count"], "sum": src["sum"],
                "counts": list(src["counts"])}
    return {"count": a["count"] + b["count"], "sum": a["sum"] + b["sum"],
            "counts": [x + y for x, y in zip(a["counts"], b["counts"])]}


def hist_delta(after: Optional[Dict[str, Any]],
               before: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """``after - before`` bucket by bucket: the observations between two
    snapshots of one histogram (a cell below zero, a reset between
    them, reads 0)."""
    if after is None:
        return _empty_hist()
    if before is None:
        return {"count": after["count"], "sum": after["sum"],
                "counts": list(after["counts"])}
    counts = [max(0, x - y) for x, y in zip(after["counts"],
                                            before["counts"])]
    return {"count": sum(counts),
            "sum": max(0.0, after["sum"] - before["sum"]),
            "counts": counts}


def hist_quantile(h: Optional[Dict[str, Any]], q: float) -> Optional[float]:
    """The ``q``-quantile (0..1) of a histogram snapshot, interpolated
    linearly inside the bucket that holds the rank; None when empty. The
    +Inf bucket reports the last edge (a floor)."""
    if not h or not h.get("count"):
        return None
    target = q * h["count"]
    acc = 0.0
    for i, c in enumerate(h["counts"]):
        if not c:
            continue
        acc += c
        if acc >= target:
            if i >= len(HIST_EDGES):
                return HIST_EDGES[-1]
            lo = HIST_EDGES[i - 1] if i > 0 else 0.0
            hi = HIST_EDGES[i]
            frac = (target - (acc - c)) / c
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
    return HIST_EDGES[-1]


def quantile_from_cumulative(pairs: List[Tuple[float, float]],
                             q: float) -> Optional[float]:
    """The quantile from Prometheus cumulative buckets ``[(le, count),
    ...]`` (any order, ``+Inf`` allowed): :func:`hist_quantile` on the
    parsed side of ``GET /metrics``."""
    pairs = sorted((float(le), float(v)) for le, v in pairs)
    if not pairs:
        return None
    total = pairs[-1][1]
    if total <= 0:
        return None
    target = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in pairs:
        if cum >= target:
            if math.isinf(le):
                return prev_le if prev_le > 0 else None
            width = cum - prev_cum
            frac = ((target - prev_cum) / width) if width > 0 else 1.0
            lo = prev_le if not math.isinf(prev_le) else 0.0
            return lo + (le - lo) * min(1.0, max(0.0, frac))
        prev_le, prev_cum = le, cum
    return pairs[-1][0] if not math.isinf(pairs[-1][0]) else None


def hist_summary(h: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Count, sum, mean, p50, p90 and p99 of one histogram snapshot."""
    if not h or not h.get("count"):
        return {"count": 0}
    n = h["count"]
    out = {"count": int(n), "sum": round(h["sum"], 6),
           "mean": round(h["sum"] / n, 6)}
    for label, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
        v = hist_quantile(h, q)
        out[label] = round(v, 6) if v is not None else None
    return out


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
    def histograms(self) -> Dict[str, Dict[str, Any]]:
        with self._rec._lock:
            return self._rec._hists_locked()

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
        for name, hist in sorted(snap["histograms"].items()):
            f.write(json.dumps({"type": "histogram", "name": name,
                                **hist}, default=str) + "\n")
        for r in snap["ledger"]:
            f.write(json.dumps({"type": "decision", **r},
                               default=str) + "\n")
        for e in rec.span_events():
            f.write(json.dumps({"type": "span", **e},
                               default=str) + "\n")
    return path


# -- Prometheus text exposition ------------------------------------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def _prom_name(name: str) -> str:
    s = _PROM_BAD.sub("_", str(name))
    if not s or s[0].isdigit():
        s = "_" + s
    return "jepsen_" + s


def _prom_val(v: Any) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(source: Optional[Any] = None) -> str:
    """Prometheus text exposition (format 0.0.4) of every counter,
    numeric gauge and histogram: the body of the daemon's ``GET
    /metrics``. A histogram emits its whole bucket ladder each scrape,
    so two scrapes difference bucket by bucket. Withheld: the per-tenant
    counters ``serve.tenant.<t>.*`` (tenant names come from clients:
    unbounded, and sanitising them can collide; ``GET /stats`` has
    them), and any name whose sanitised form collides with one already
    emitted (counted in ``jepsen_obs_prom_collisions``)."""
    snap = _recorder_of(source).snapshot()
    lines: List[str] = []
    emitted: Dict[str, str] = {}
    collisions = 0

    def _uniq(raw: str) -> Optional[str]:
        nonlocal collisions
        s = _prom_name(raw)
        prev = emitted.setdefault(s, raw)
        if prev == raw:
            return s
        collisions += 1
        return None

    for name, value in sorted(snap["counters"].items()):
        n = None if name.startswith("serve.tenant.") else _uniq(name)
        if n is not None:
            lines += [f"# TYPE {n} counter", f"{n} {_prom_val(value)}"]
    for name, value in sorted(snap["gauges"].items()):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        n = _uniq(name)
        if n is not None:
            lines += [f"# TYPE {n} gauge", f"{n} {_prom_val(value)}"]
    for name, hist in sorted(snap["histograms"].items()):
        n = _uniq(name)
        if n is None:
            continue
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for edge, c in zip(HIST_EDGES, hist["counts"]):
            cum += c
            lines.append(f'{n}_bucket{{le="{edge:g}"}} {cum}')
        cum += hist["counts"][len(HIST_EDGES)]
        lines.append(f'{n}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{n}_sum {_prom_val(hist['sum'])}")
        lines.append(f"{n}_count {hist['count']}")
    if collisions:
        lines += ["# TYPE jepsen_obs_prom_collisions gauge",
                  f"jepsen_obs_prom_collisions {collisions}"]
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str
                     ) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """A text exposition back to ``{metric: [(labels, value), ...]}``.
    Raises ValueError on a malformed sample line."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition line: {line!r}")
        labels = dict(_PROM_LABEL.findall(m.group(2) or ""))
        out.setdefault(m.group(1), []).append((labels, float(m.group(3))))
    return out

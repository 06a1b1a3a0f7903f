"""Latency / rate charts — upstream ``jepsen/src/jepsen/checker/perf.clj``,
which extracts per-op latency points and shells out to gnuplot; here the
extraction is NumPy and the plotting is matplotlib (no external
binaries). Where matplotlib is not installed the charts are skipped:
the checker is valid with ``"skipped": "matplotlib not installed"`` and
records ``obs.decision("perf", "skipped", cause="no-matplotlib")``.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers.facade import Checker
from jepsen_tpu_torch.op import FAIL, INFO, INVOKE, OK, Op

NS = 1e9


def latency_points(history: Sequence[Op]
                   ) -> Dict[str, List[Tuple[float, float]]]:
    """(time-of-invoke [s], latency [ms]) points grouped by completion type
    (upstream ``perf/latencies``). Requires op ``time`` in ns."""
    pending: Dict[Any, Op] = {}
    out: Dict[str, List[Tuple[float, float]]] = {OK: [], FAIL: [], INFO: []}
    for op in history:
        if op.process == "nemesis":
            continue
        if op.type == INVOKE:
            pending[op.process] = op
        else:
            inv = pending.pop(op.process, None)
            if inv is not None and inv.time >= 0 and op.time >= 0:
                out[op.type].append(
                    (inv.time / NS, (op.time - inv.time) / 1e6))
    return out


def rate_points(history: Sequence[Op], dt: float = 1.0
                ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Completions/sec in ``dt``-second windows, by type (upstream
    ``perf/rate``)."""
    times: Dict[str, List[float]] = {OK: [], FAIL: [], INFO: []}
    for op in history:
        if op.type != INVOKE and op.process != "nemesis" and op.time >= 0:
            times[op.type].append(op.time / NS)
    out = {}
    tmax = max((max(v) for v in times.values() if v), default=0.0)
    edges = np.arange(0.0, tmax + dt, dt)
    for typ, ts in times.items():
        hist, _ = np.histogram(ts, bins=edges) if len(edges) > 1 else \
            (np.zeros(0), None)
        out[typ] = (edges[:-1] if len(edges) > 1 else np.zeros(0), hist / dt)
    return out


def _plot_latency(history, path, title):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    pts = latency_points(history)
    fig, ax = plt.subplots(figsize=(10, 4))
    styles = {OK: ("#6db66d", "."), FAIL: ("#d66", "x"), INFO: ("#d6a76d", "+")}
    for typ, (color, marker) in styles.items():
        if pts[typ]:
            xs, ys = zip(*pts[typ])
            ax.semilogy(xs, ys, marker, color=color, label=typ, ms=3)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("latency (ms)")
    ax.set_title(title)
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _plot_rate(history, path, title):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    pts = rate_points(history)
    fig, ax = plt.subplots(figsize=(10, 4))
    colors = {OK: "#6db66d", FAIL: "#d66", INFO: "#d6a76d"}
    for typ, (xs, ys) in pts.items():
        if len(xs):
            ax.plot(xs, ys, color=colors[typ], label=typ)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("ops/s")
    ax.set_title(title)
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _skip(test: Optional[Mapping], opts: Optional[Mapping],
          chart: str) -> Optional[Dict[str, Any]]:
    """The chart's skip, or None when it can be drawn: no store dir (as
    upstream), or no matplotlib."""
    if not _out_dir(test, opts):
        return {"valid": True, "skipped": "no store dir"}
    if importlib.util.find_spec("matplotlib") is None:
        obs.decision("perf", "skipped", cause="no-matplotlib", chart=chart)
        return {"valid": True, "skipped": "matplotlib not installed"}
    return None


def _out_dir(test: Optional[Mapping], opts: Optional[Mapping]):
    return (opts or {}).get("dir") or (test or {}).get("dir") or \
        (test or {}).get("store_dir")


class LatencyGraph(Checker):
    """Writes ``latency-raw.png`` (upstream
    ``jepsen.checker/latency-graph``)."""
    name = "latency-graph"

    def check(self, test: Optional[Mapping], history: Sequence[Op],
              opts: Optional[Mapping] = None) -> Dict[str, Any]:
        skipped = _skip(test, opts, "latency-raw")
        if skipped is not None:
            return skipped
        path = os.path.join(_out_dir(test, opts), "latency-raw.png")
        _plot_latency(history, path, str((test or {}).get("name", "latency")))
        return {"valid": True, "file": path}


class RateGraph(Checker):
    """Writes ``rate.png`` (upstream ``jepsen.checker/rate-graph``)."""
    name = "rate-graph"

    def check(self, test: Optional[Mapping], history: Sequence[Op],
              opts: Optional[Mapping] = None) -> Dict[str, Any]:
        skipped = _skip(test, opts, "rate")
        if skipped is not None:
            return skipped
        path = os.path.join(_out_dir(test, opts), "rate.png")
        _plot_rate(history, path, str((test or {}).get("name", "rate")))
        return {"valid": True, "file": path}


def latency_graph() -> LatencyGraph:
    return LatencyGraph()


def rate_graph() -> RateGraph:
    return RateGraph()

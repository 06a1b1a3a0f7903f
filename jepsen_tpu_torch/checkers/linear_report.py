"""SVG rendering of a non-linearizable window — upstream
``knossos/src/knossos/linear/report.clj``: the famous
timeline diagrams Jepsen analyses embed, showing each process's op bars
around the operation that could not be linearized.

Independent implementation: plain SVG text, no dependencies. The rendered
window spans every op whose interval overlaps the failing op's invocation
(the ops the search could still reorder at the point of death), so a
reader can trace why no linearization order exists. It has an
event-time axis with tick marks, a legend,
crashed-op tails fading off the right edge (upstream draws crashed ops
running to infinity), and hover titles carrying the op, its process, and
its event interval.
"""
from __future__ import annotations

import html
from typing import Any, Dict, List, Mapping, Optional, Sequence

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch.op import INFO, OK, Op

_LANE_H = 34
_BAR_H = 22
_LEFT = 110
_WIDTH = 900
_COLORS = {OK: "#7fb77f", INFO: "#d6a76d", "stuck": "#d66a6a",
           "other": "#9db4c9"}
_LEGEND = [("completed", _COLORS[OK]),
           ("crashed (forever pending)", _COLORS[INFO]),
           ("stuck — cannot linearize", _COLORS["stuck"])]


def _fmt(op: Op) -> str:
    v = op.value
    return f"{op.f} {v!r}" if v is not None else f"{op.f}"


def _axis_ticks(t0: int, t1: int, n: int = 6) -> List[int]:
    """Round-ish tick positions across [t0, t1] (event indices — the
    diagram's time base is the history's total event order)."""
    span = max(1, t1 - t0)
    step = max(1, span // n)
    # snap the step to 1/2/5 x 10^k like a plot axis would
    mag = 1
    while step >= mag * 10:
        mag *= 10
    for nice in (1, 2, 5, 10):
        if step <= nice * mag:
            step = nice * mag
            break
    first = ((t0 + step - 1) // step) * step
    return list(range(first, t1 + 1, step))


def render_analysis(history: Sequence[Op], result: Mapping[str, Any],
                    path: Optional[str] = None) -> str:
    """Render the failing window of ``result`` (a ``{"valid": False, "op":
    ...}`` verdict from any linearizability engine) over ``history``.
    Returns the SVG text; writes it to ``path`` when given."""
    if result.get("valid") is not False or not result.get("op"):
        raise ValueError("result is not a non-linearizable verdict with op")
    entries = h.analysis_entries(history)
    stuck_idx = result["op"].get("index")
    stuck = next((e for e in entries if e.op.index == stuck_idx), None)
    if stuck is None:                       # fall back: match on content
        key = (result["op"].get("process"), result["op"].get("f"))
        stuck = next((e for e in entries
                      if (e.op.process, e.op.f) == key), entries[0])
    # window: entries overlapping the stuck op's interval
    lo, hi = stuck.inv_ev, stuck.ret_ev
    window = [e for e in entries
              if e.inv_ev <= hi and e.ret_ev >= lo]
    if not window:
        window = [stuck]
    t0 = min(e.inv_ev for e in window)
    t1 = max(min(e.ret_ev, hi + 2) for e in window) + 1
    span = max(1, t1 - t0)
    procs = sorted({e.process for e in window}, key=repr)
    rows = {p: i for i, p in enumerate(procs)}
    axis_y = 40 + _LANE_H * len(procs) + 8
    height = axis_y + 46
    right = _WIDTH - 20

    def x(ev: int) -> float:
        return _LEFT + (min(ev, t1) - t0) / span * (right - _LEFT)

    parts: List[str] = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{_WIDTH}" '
        f'height="{height}" font-family="sans-serif" font-size="12">',
        # crashed-op tail fade (upstream draws crashed bars running to
        # infinity; here they fade off the window's right edge)
        '<defs>'
        f'<linearGradient id="crashfade" x1="0" y1="0" x2="1" y2="0">'
        f'<stop offset="0" stop-color="{_COLORS[INFO]}" '
        'stop-opacity="1"/>'
        f'<stop offset="1" stop-color="{_COLORS[INFO]}" '
        'stop-opacity="0"/>'
        '</linearGradient></defs>',
        f'<text x="{_LEFT}" y="18" font-size="14" fill="#333">'
        f'Non-linearizable: {html.escape(_fmt(stuck.op))} '
        f'(process {html.escape(str(stuck.process))}) cannot be '
        f'linearized</text>']
    for p in procs:
        y = 40 + rows[p] * _LANE_H
        parts.append(f'<text x="8" y="{y + _BAR_H - 6}" fill="#555">'
                     f'process {html.escape(str(p))}</text>')
        parts.append(f'<line x1="{_LEFT}" y1="{y + _LANE_H - 4}" '
                     f'x2="{_WIDTH - 10}" y2="{y + _LANE_H - 4}" '
                     f'stroke="#eee"/>')
    for e in window:
        y = 40 + rows[e.process] * _LANE_H
        x0 = x(e.inv_ev)
        open_ended = e.crashed or e.ret_ev > t1
        x1 = right if open_ended else x(e.ret_ev)
        wdt = max(6.0, x1 - x0)
        if e is stuck:
            color = _COLORS["stuck"]
        elif e.crashed:
            color = _COLORS[INFO]
        else:
            color = _COLORS[OK]
        label = html.escape(_fmt(e.op))
        ret_txt = "&#8734;" if e.crashed else str(e.ret_ev)
        title = (f'{label} &#8212; process {html.escape(str(e.process))}, '
                 f'events {e.inv_ev}&#8211;{ret_txt}')
        if e.crashed:
            # solid bar for the known-pending span, then the fade tail
            solid_w = max(6.0, wdt * 0.55)
            parts.append(
                f'<rect x="{x0:.1f}" y="{y}" width="{solid_w:.1f}" '
                f'height="{_BAR_H}" rx="3" fill="{color}">'
                f'<title>{title}</title></rect>')
            parts.append(
                f'<rect x="{x0 + solid_w:.1f}" y="{y}" '
                f'width="{max(0.0, x1 - x0 - solid_w):.1f}" '
                f'height="{_BAR_H}" fill="url(#crashfade)">'
                f'<title>{title}</title></rect>')
        else:
            # Python < 3.12 rejects backslashes inside f-string
            # expressions, so the conditional attribute is hoisted out
            stroke = ' stroke="#a33" stroke-width="2"' if e is stuck else ""
            parts.append(
                f'<rect x="{x0:.1f}" y="{y}" width="{wdt:.1f}" '
                f'height="{_BAR_H}" rx="3" fill="{color}"{stroke}>'
                f'<title>{title}</title></rect>')
        parts.append(f'<text x="{x0 + 3:.1f}" y="{y + _BAR_H - 7}" '
                     f'fill="#fff"><title>{title}</title>{label}</text>')
    # event-time axis with tick marks
    parts.append(f'<line x1="{_LEFT}" y1="{axis_y}" x2="{right}" '
                 f'y2="{axis_y}" stroke="#999"/>')
    for tick in _axis_ticks(t0, t1):
        tx = x(tick)
        parts.append(f'<line x1="{tx:.1f}" y1="{axis_y}" x2="{tx:.1f}" '
                     f'y2="{axis_y + 5}" stroke="#999"/>')
        parts.append(f'<text x="{tx:.1f}" y="{axis_y + 17}" fill="#777" '
                     f'text-anchor="middle">{tick}</text>')
    parts.append(f'<text x="{right}" y="{axis_y + 17}" fill="#777" '
                 f'text-anchor="end" font-style="italic">event index'
                 f'</text>')
    # legend
    lx = _LEFT
    ly = axis_y + 28
    for name, color in _LEGEND:
        parts.append(f'<rect x="{lx}" y="{ly - 10}" width="12" '
                     f'height="12" rx="2" fill="{color}"/>')
        parts.append(f'<text x="{lx + 16}" y="{ly}" fill="#555">'
                     f'{name}</text>')
        lx += 16 + 7 * len(name) + 24
    parts.append("</svg>")
    svg = "\n".join(parts)
    if path:
        with open(path, "w") as f:
            f.write(svg)
    return svg

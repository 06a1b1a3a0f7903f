"""HTML op timeline — upstream ``jepsen/src/jepsen/checker/timeline.clj``:
one swim-lane per process, each operation a box spanning
its invocation→completion interval, colored by outcome. Written as a
self-contained HTML file (no hiccup, no external assets).
"""
from __future__ import annotations

import html as _html
from typing import Any, Dict, Mapping, Optional, Sequence

from jepsen_tpu_torch.checkers.facade import Checker
from jepsen_tpu_torch.op import FAIL, INFO, INVOKE, OK, Op

_COLORS = {OK: "#6db66d", FAIL: "#d66", INFO: "#d6a76d", "pending": "#aaa"}

_CSS = """
body { font-family: sans-serif; background: #fff; }
.lane { position: relative; height: 26px; border-bottom: 1px solid #eee; }
.lane .label { position: absolute; left: 0; width: 90px; font-size: 12px;
               line-height: 26px; color: #555; }
.ops { position: absolute; left: 100px; right: 0; top: 0; bottom: 0; }
.op { position: absolute; height: 20px; top: 2px; border-radius: 3px;
      font-size: 10px; overflow: hidden; white-space: nowrap;
      color: #fff; padding: 1px 3px; box-sizing: border-box; }
"""


def render(history: Sequence[Op], title: str = "timeline") -> str:
    """Render a history to a standalone HTML string."""
    ops = [op for op in history if op.process != "nemesis"]
    # pair invokes with completions per process
    lanes: Dict[Any, list] = {}
    pending: Dict[Any, Op] = {}
    spans = []
    tmax = 1
    for i, op in enumerate(ops):
        t = op.time if op.time >= 0 else (op.index if op.index >= 0 else i)
        tmax = max(tmax, t)
        if op.type == INVOKE:
            pending[op.process] = op.with_(time=t)
        else:
            inv = pending.pop(op.process, None)
            if inv is not None:
                spans.append((op.process, inv.time, t, op.type, inv.f,
                              op.value if op.type == OK else inv.value))
    for p, inv in pending.items():
        spans.append((p, inv.time, tmax, "pending", inv.f, inv.value))
    for p, *_ in spans:
        lanes.setdefault(p, [])
    rows = []
    for p in sorted(lanes, key=repr):
        boxes = []
        for proc, t0, t1, typ, f, v in spans:
            if proc != p:
                continue
            left = 100.0 * t0 / max(1, tmax)
            width = max(0.4, 100.0 * (t1 - t0) / max(1, tmax))
            label = _html.escape(f"{f} {v!r} [{typ}]")
            boxes.append(
                f'<div class="op" title="{label}" style="left:{left:.3f}%;'
                f'width:{width:.3f}%;background:{_COLORS.get(typ, "#888")}">'
                f'{_html.escape(str(f))}</div>')
        rows.append(f'<div class="lane"><div class="label">process '
                    f'{_html.escape(str(p))}</div>'
                    f'<div class="ops">{"".join(boxes)}</div></div>')
    return (f"<!doctype html><html><head><meta charset='utf-8'>"
            f"<title>{_html.escape(title)}</title><style>{_CSS}</style>"
            f"</head><body><h3>{_html.escape(title)}</h3>"
            f"{''.join(rows)}</body></html>")


class TimelineChecker(Checker):
    """Writes ``timeline.html`` into the test's store directory (upstream
    ``jepsen.checker.timeline/html``)."""
    name = "timeline"

    def check(self, test: Optional[Mapping], history: Sequence[Op],
              opts: Optional[Mapping] = None) -> Dict[str, Any]:
        out_dir = (opts or {}).get("dir") or (test or {}).get("dir") or \
            (test or {}).get("store_dir")
        doc = render(history, title=str((test or {}).get("name", "timeline")))
        if out_dir:
            import os
            path = os.path.join(out_dir, "timeline.html")
            with open(path, "w") as f:
                f.write(doc)
            return {"valid": True, "file": path}
        return {"valid": True, "html-bytes": len(doc)}


def html() -> TimelineChecker:
    return TimelineChecker()

"""The results browser (a port of the reference package's
``jepsen_tpu/web.py``, upstream ``jepsen/src/jepsen/web.clj``): a small
HTTP server over the store directory (:mod:`jepsen_tpu_torch.store`'s
run-dir layout, which both packages write) that lists the runs with
their verdict and anomaly badges, serves their artifacts, and renders
the check daemon's ``serve/stats.json`` as the ``/engine`` dashboard
(its open-session census included). Host only; it checks nothing.

    python -m jepsen_tpu_torch serve --store-root store --port 8080

``/files/<path>`` serves only files under the store root: a path that
resolves outside it (``..``, an absolute path, a symlink out) is a 404.
"""
from __future__ import annotations

import html
import json
import os
import urllib.parse
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from jepsen_tpu_torch import store


# the artifacts the checker/report pipeline writes into a run dir,
# in display order (upstream web.clj links the same set: results,
# history, timeline, perf charts, the linearizability diagram, logs)
_ARTIFACTS = ("results.json", "history.txt", "timeline.html",
              "latency-raw.png", "rate.png", "linear.svg",
              "jepsen.log")


def _badge(valid: str) -> str:
    """Upstream-style verdict badge: green valid, red invalid, amber
    for the checker's own ``"unknown"`` verdict, grey for anything
    else (a malformed results.json, an error string) — an
    indeterminate-but-well-formed verdict must not look the same as
    garbage."""
    color, label = {
        "True": ("#2e7d32", "valid"),
        "False": ("#c62828", "INVALID"),
        "unknown": ("#b07d2b", "unknown"),
    }.get(valid, ("#616161", valid or "?"))
    return (f"<span class='badge' style='background:{color}'>"
            f"{html.escape(label)}</span>")


# Elle anomaly classes the transactional checker reports, by severity
# color: write cycles darkest, the committed-read classes amber-red,
# inference-direct classes purple. Anything NOT in this table — an
# unknown anomaly string from a future checker or a malformed
# results.json — takes the existing grey badge path via _badge.
_ANOMALY_COLORS = {
    "G0": "#7b1fa2", "G1c": "#c2185b", "G-single": "#d84315",
    "G2": "#c62828", "G1a": "#ad1457",
    "incompatible-order": "#6a1b9a", "duplicate-append": "#6a1b9a",
}


def _anomaly_badge(name: str) -> str:
    color = _ANOMALY_COLORS.get(name)
    if color is None:
        return _badge(name)                 # unknown string: grey path
    return (f"<span class='badge' style='background:{color}'>"
            f"{html.escape(name)}</span>")


def _witness_html(res: dict) -> str:
    """The txn verdict's witness cycle as an ordered op list (one
    <li> per transaction, the edge type that leads OUT of it
    annotated), collapsed behind <details> so invalid rows stay
    scannable."""
    w = res.get("witness")
    if not isinstance(w, dict) or not w.get("cycle"):
        return ""
    items = []
    edges = w.get("edges") or []
    for i, t in enumerate(w["cycle"]):
        et = edges[i] if i < len(edges) else "?"
        items.append(
            f"<li>txn {html.escape(str(t.get('txn')))} "
            f"(p{html.escape(str(t.get('process')))}"
            f"@{html.escape(str(t.get('index')))}): "
            f"<code>{html.escape(json.dumps(t.get('value')))}</code> "
            f"&rarr;<b>{html.escape(str(et))}</b></li>")
    return (f"<details><summary>witness cycle "
            f"({len(items)} txns)</summary><ol>"
            + "".join(items) + "</ol></details>")


def _txn_cell(res: dict) -> str:
    """Anomaly-class badges + witness for a transactional verdict;
    empty for non-txn results."""
    anomalies = res.get("anomalies")
    if not isinstance(anomalies, list) or not anomalies:
        return ""
    badges = " ".join(_anomaly_badge(str(a)) for a in anomalies)
    return f" {badges}{_witness_html(res)}"


# mirrors txn.lattice.LEVELS (weak -> strong); kept local so the web
# view never imports the checker stack just to render a report
_LATTICE_LEVELS = ("read-committed", "causal", "pl-2", "si",
                   "serializable")


def _lattice_cell(res: dict) -> str:
    """Per-level lattice verdict badges for a consistency-checked txn
    result: one badge per reported level in lattice order, green
    where the level holds, red where violated, and the WEAKEST
    violated level (the first guarantee the history breaks walking up
    the lattice) outlined so it reads at a glance."""
    holds = res.get("holds")
    if not isinstance(holds, dict) or not holds:
        return ""
    wv = res.get("weakest-violated")
    out = []
    for lvl in _LATTICE_LEVELS:
        if lvl not in holds:
            continue
        ok = bool(holds[lvl])
        color = "#2e7d32" if ok else "#c62828"
        mark = "&#10003;" if ok else "&#10007;"
        extra = "outline:2px solid #ffab00;" if lvl == wv else ""
        out.append(
            f"<span class='badge' "
            f"style='background:{color};{extra}'>"
            f"{html.escape(lvl)} {mark}</span>")
    return (" " + " ".join(out)) if out else ""


def _run_row(root: str, name: str, run: str) -> str:
    valid = ""
    res: dict = {}
    res_path = os.path.join(run, "results.json")
    if os.path.exists(res_path):
        try:
            with open(res_path) as f:
                res = json.load(f)
            valid = str(res.get("valid"))
        except Exception:                               # noqa: BLE001
            valid = "?"
            res = {}
    rel = urllib.parse.quote(os.path.relpath(run, root))
    links = " ".join(
        f"<a href='/files/{rel}/{urllib.parse.quote(a)}'>"
        f"{html.escape(a)}</a>"
        for a in _ARTIFACTS
        if os.path.exists(os.path.join(run, a)))
    # txn verdicts may live at the top level (cli check / serve runs)
    # or composed under results.txn (suite runs)
    txn_res = res if ("anomalies" in res or "holds" in res) else \
        (res.get("results", {}) or {}).get("txn", {})
    if not isinstance(txn_res, dict):
        txn_res = {}
    txn_cell = _lattice_cell(txn_res) + _txn_cell(txn_res)
    return (f"<tr><td><a href='/files/{rel}/'>{html.escape(name)}</a>"
            f"</td><td>{html.escape(os.path.basename(run))}</td>"
            f"<td>{_badge(valid)}{txn_cell}</td>"
            f"<td class='artifacts'>{links}</td></tr>")


def _live_row(root: str) -> str:
    """When a check-serve daemon persists into this store (its stats
    snapshot exists), surface it: a 'live' row on top of the index
    linking the daemon's stats page and its persisted runs (the
    ``serve-<model>`` test groups below are those runs)."""
    stats_path = os.path.join(root, "serve", "stats.json")
    if not os.path.exists(stats_path):
        return ""
    n_done = ""
    try:
        with open(stats_path) as f:
            st = json.load(f)
        n = st.get("counters", {}).get("serve.completed")
        if n is not None:
            n_done = f" ({int(n)} checks served)"
    except Exception:                                   # noqa: BLE001
        pass
    return (f"<tr><td><a href='/engine'>live</a></td>"
            f"<td>check-serve daemon{html.escape(n_done)}</td>"
            f"<td>{_badge('live')}</td>"
            f"<td class='artifacts'><a href='/engine'>engine stats"
            f"</a></td></tr>")


_STYLE = ("<style>body{font-family:sans-serif;margin:2em}"
          "table{border-collapse:collapse}td,th{padding:4px 12px;"
          "border-bottom:1px solid #eee;text-align:left}"
          ".badge{color:#fff;border-radius:3px;padding:1px 7px;"
          "font-size:85%}"
          ".artifacts a{margin-right:.6em;font-size:90%}"
          ".spark{display:inline-block;vertical-align:middle;"
          "margin-right:2em}"
          ".spark .lbl{font-size:80%;color:#666}"
          "pre{background:#f6f6f6;padding:1em;overflow:auto}</style>")


def _sparkline(values, width: int = 220, height: int = 36) -> str:
    """Inline-SVG sparkline over a list of numbers (None gaps are
    skipped). No javascript — the /engine page is a meta-refresh
    dashboard, so each render is a fresh polyline."""
    pts = [(i, float(v)) for i, v in enumerate(values)
           if isinstance(v, (int, float))]
    if len(pts) < 2:
        return "<span style='color:#999'>&mdash;</span>"
    lo = min(v for _, v in pts)
    hi = max(v for _, v in pts)
    span_x = max(1, pts[-1][0] - pts[0][0])
    span_y = (hi - lo) or 1.0
    coords = " ".join(
        f"{(i - pts[0][0]) / span_x * width:.1f},"
        f"{height - 3 - (v - lo) / span_y * (height - 6):.1f}"
        for i, v in pts)
    return (f"<svg width='{width}' height='{height}'>"
            f"<polyline points='{coords}' fill='none' "
            f"stroke='#3b6ea5' stroke-width='1.5'/></svg>")


def _spark_row(points, key: str, label: str, fmt: str = "{:g}") -> str:
    vals = [p.get(key) for p in points]
    last = next((v for v in reversed(vals)
                 if isinstance(v, (int, float))), None)
    last_s = fmt.format(last) if last is not None else "?"
    return (f"<span class='spark'><span class='lbl'>{label} "
            f"(now {html.escape(last_s)})</span><br>"
            f"{_sparkline(vals)}</span>")


def _index_html(root: str) -> str:
    rows = [_run_row(root, name, run)
            for name, runs in store.tests(root).items()
            for run in reversed(runs)]
    return ("<!doctype html><title>jepsen-tpu results</title>"
            + _STYLE +
            "<h1>jepsen-tpu results</h1><table>"
            "<tr><th>test</th><th>run</th><th>valid?</th>"
            "<th>artifacts</th></tr>"
            + _live_row(root) + "".join(rows) + "</table>")


def _engine_html(root: str) -> str:
    """The ``/engine`` page: the check-serve daemon's latest stats
    snapshot (``<root>/serve/stats.json``, rewritten by the daemon
    after every dispatch) — a live auto-refreshing dashboard with
    sparklines over the daemon's rolling time-series ring (req/s,
    p50/p99, queue depth, in-flight), latency-histogram digests,
    per-tenant device-seconds, queue depth, per-tenant serve ledgers,
    per-geometry dispatch counts, and every ``serve.*`` counter."""
    stats_path = os.path.join(root, "serve", "stats.json")
    head = ("<!doctype html><title>jepsen-tpu engine</title>"
            "<meta http-equiv='refresh' content='2'>" + _STYLE
            + "<h1>check-serve daemon</h1>"
              "<p><a href='/'>&larr; results index</a> &middot; "
              "auto-refreshes every 2 s</p>")
    if not os.path.exists(stats_path):
        return (head + "<p>No daemon stats found — start one with "
                       "<code>python -m jepsen_tpu_torch check-serve"
                       "</code> (it writes "
                       "<code>serve/stats.json</code> under its "
                       "store root).</p>")
    try:
        with open(stats_path) as f:
            st = json.load(f)
    except Exception as e:                              # noqa: BLE001
        return head + f"<p>stats unreadable: {html.escape(str(e))}</p>"
    counters = st.get("counters", {})
    # degradation banner: breaker state (amber while not closed —
    # reusing the verdict badges' color path, "unknown" == amber) and
    # quarantined-request count, surfaced ABOVE the tables so a
    # degraded daemon is unmissable on the dashboard
    breaker = st.get("breaker") or {}
    bstate = breaker.get("state", "closed")
    n_quar = int(counters.get("serve.quarantined", 0))

    def _state_span(label: str, color: str) -> str:
        # same badge element/colors as the verdict badges (amber =
        # the "unknown" path, green = valid, red = INVALID)
        return (f"<span class='badge' style='background:{color}'>"
                f"{html.escape(label)}</span>")

    banner = ""
    if st.get("degraded") or bstate != "closed":
        banner += (
            "<p>" + _state_span(f"DEGRADED: breaker {bstate}",
                                "#b07d2b")
            + " device path unhealthy (consecutive failures: "
            f"{breaker.get('consecutive_failures', '?')}) — serving "
            "host-side, verdicts identical but slower</p>")
    elif breaker:
        banner += (f"<p>{_state_span('breaker closed', '#2e7d32')} "
                   f"device path healthy</p>")
    if n_quar:
        banner += (f"<p>{_state_span(f'{n_quar} quarantined', '#c62828')} "
                   f"poison member(s) isolated by the bisect retry; "
                   f"each answered a structured 500</p>")
    jstats = st.get("journal") or {}
    if jstats:
        banner += (f"<p>journal: {jstats.get('pending', 0)} pending, "
                   f"{jstats.get('terminal', 0)} terminal entries"
                   f"</p>")
    # open streaming sessions: count + oldest age + per-tenant spread
    # (green when live sessions are being served, the grey path when
    # none — same badge element/colors as the verdicts)
    sess = st.get("sessions") or {}
    if sess:
        n_open = int(sess.get("open", 0))
        if n_open:
            tenants_s = ", ".join(
                f"{html.escape(str(t))}: {c}" for t, c in
                sorted((sess.get("per-tenant") or {}).items()))
            banner += (
                "<p>" + _state_span(f"{n_open} open session"
                                    f"{'s' if n_open != 1 else ''}",
                                    "#2e7d32")
                + f" oldest {sess.get('oldest-age-s', '?')} s, "
                  f"{sess.get('appends', 0)} appends / "
                  f"{sess.get('ops', 0)} ops carried"
                + (f" &middot; {tenants_s}" if tenants_s else "")
                + "</p>")
        else:
            banner += (f"<p>{_state_span('no open sessions', '#616161')} "
                       f"{sess.get('closed', 0)} closed retained</p>")
    serve_rows = "".join(
        f"<tr><td>{html.escape(k)}</td><td>{v}</td></tr>"
        for k, v in sorted(counters.items())
        if k.startswith("serve."))
    disp_rows = "".join(
        f"<tr><td>{html.escape(k)}</td><td>{v}</td></tr>"
        for k, v in sorted(st.get("dispatch", {}).items()))
    tenants = st.get("tenants", {})
    tenant_rows = "".join(
        f"<tr><td>{html.escape(t)}</td>"
        f"<td>{html.escape(json.dumps(ev))}</td></tr>"
        for t, ev in sorted(tenants.items()))
    points = st.get("timeseries", [])
    sparks = ""
    if points:
        sparks = ("<h2>live (last %d dispatches)</h2><div>" %
                  len(points)
                  + _spark_row(points, "req_s", "req/s")
                  + _spark_row(points, "p50_s", "p50 s", "{:.3f}")
                  + _spark_row(points, "p99_s", "p99 s", "{:.3f}")
                  + _spark_row(points, "depth", "queue depth")
                  + _spark_row(points, "inflight", "in-flight")
                  + "</div>")
    hists = st.get("histograms", {})
    hist_rows = "".join(
        f"<tr><td>{html.escape(k)}</td><td>{h.get('count', 0)}</td>"
        f"<td>{h.get('p50', '')}</td><td>{h.get('p99', '')}</td>"
        f"<td>{h.get('mean', '')}</td></tr>"
        for k, h in sorted(hists.items()))
    dev_rows = "".join(
        f"<tr><td>{html.escape(t)}</td><td>{v}</td></tr>"
        for t, v in sorted(st.get("device-seconds", {}).items()))
    q = st.get("queue", {})
    return (head
            + banner
            + f"<p>queue depth {q.get('depth', '?')} / "
              f"{q.get('max_depth', '?')}, group width "
              f"{q.get('group', '?')}, per-tenant in-flight cap "
              f"{q.get('max_inflight_per_tenant', '?')}</p>"
            + sparks
            + ("<h2>latency histograms</h2><table>"
               "<tr><th>histogram</th><th>count</th><th>p50 s</th>"
               "<th>p99 s</th><th>mean s</th></tr>"
               + hist_rows + "</table>" if hist_rows else "")
            + ("<h2>device-seconds by tenant</h2><table>"
               "<tr><th>tenant</th><th>attributed s</th></tr>"
               + dev_rows + "</table>" if dev_rows else "")
            + "<h2>serve counters</h2><table>"
              "<tr><th>counter</th><th>value</th></tr>"
            + serve_rows + "</table>"
            + "<h2>dispatch groups (model/width)</h2><table>"
              "<tr><th>geometry</th><th>count</th></tr>"
            + disp_rows + "</table>"
            + "<h2>tenants</h2><table>"
              "<tr><th>tenant</th><th>events</th></tr>"
            + tenant_rows + "</table>"
            + "<h2>raw snapshot</h2><pre>"
            + html.escape(json.dumps(st, indent=2, default=str))
            + "</pre>")


class _Handler(SimpleHTTPRequestHandler):
    store_root = "store"

    def _html(self, body: str) -> None:
        data = body.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):                                   # noqa: N802
        if self.path in ("/", "/index.html"):
            self._html(_index_html(self.store_root))
            return
        if self.path.rstrip("/") == "/engine":
            self._html(_engine_html(self.store_root))
            return
        if self.path.startswith("/files/"):
            rel = urllib.parse.unquote(self.path[len("/files/"):])
            self.path = "/" + rel
            return SimpleHTTPRequestHandler.do_GET(self)
        self.send_error(404)

    def translate_path(self, path):
        root = os.path.realpath(self.store_root)
        path = urllib.parse.urlparse(path).path
        safe = os.path.normpath(urllib.parse.unquote(path)).lstrip("/")
        full = os.path.realpath(os.path.join(root, safe))
        if os.path.commonpath([root, full]) != root:
            # outside the store: a path that exists nowhere (404)
            return os.path.join(root, ".outside-the-store", "missing")
        return full

    def log_message(self, *args):                       # quiet
        pass


def serve(root: str = "store", port: int = 8080, block: bool = True,
          host: str = "127.0.0.1") -> Optional[ThreadingHTTPServer]:
    """Serve the store (upstream ``jepsen.web/serve!``, the command
    line's ``serve``) on ``host`` (loopback by default; ``port`` 0 picks
    a free one); ``block=False`` returns the server, serving on a
    thread."""
    handler = type("Handler", (_Handler,), {"store_root": root})
    httpd = ThreadingHTTPServer((host, port), handler)
    print(f"jepsen-tpu web: http://{host}:{httpd.server_address[1]}/ "
          f"(store root {root})", flush=True)
    if block:
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        return None
    import threading
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd

"""Open-loop load generator for the check daemon (``check-serve``).

Replays a mixed-geometry history workload (several sizes, several
tenants, a configurable fraction of known-violating histories) against
a running daemon at a target arrival rate and reports sustained req/s
plus p50/p99 verdict latency, split into two measurement windows so the
warm-cache effect is a number (window 2 runs on kernels already built
and loaded and on memo tables already cached; it should beat window 1).

Open-loop means arrivals are scheduled by the clock, not by
completions: if the daemon falls behind, the queue grows and
backpressure 429s show up in the report instead of the generator
slowing down.

Usage::

    python -m jepsen_tpu_torch.tools.loadgen --url URL [--quick]
    python -m jepsen_tpu_torch.tools.loadgen --self-host --rate 20 \
        --duration 10
    python -m jepsen_tpu_torch.tools.loadgen --self-host --quick --device cpu

``--self-host`` starts ``serve.Daemon`` in process on ``--device``: the
card unless ``--device cpu`` is given; without a card it raises.

Exit status: 0 iff at least one request completed AND every verdict
matched its history's known ground truth AND the latency cross-check
passed (the client-measured p50/p99 against the daemon's
histogram-derived quantiles over the /metrics delta: more than 15%
disagreement past the poll-resolution slack means a clock or stamping
bug). The report also splits queue wait from service time using the
daemon's stage timestamps, and carries the final ``/stats`` snapshot.
The same functions, flags, report keys and exit rule as the reference's
``tools/loadgen.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional, Tuple


def build_pool(*, sizes, tenants: int, violation_frac: float,
               model: str = "cas-register", seed: int = 7,
               kinds: Tuple[str, ...] = ("cas",)) -> List[Dict]:
    """Pre-generate the payload pool: one entry per (size, kind)
    pair per tenant slot, each a ready-to-POST body plus its known
    ground-truth verdict."""
    from jepsen_tpu_torch import fixtures

    pool: List[Dict] = []
    i = 0
    for kind in kinds:
        for n_ops in sizes:
            for t in range(tenants):
                i += 1
                hist = fixtures.gen_history(kind, n_ops=n_ops,
                                            processes=3,
                                            seed=seed + i)
                expect = True
                if (i * 1000 % 997) / 997.0 < violation_frac:
                    hist = fixtures.corrupt(hist, seed=seed + i)
                    expect = False
                pool.append({
                    "tenant": f"tenant-{t}",
                    "expect": expect,
                    "ops": len(hist),
                    "body": json.dumps({
                        "model": model,
                        "tenant": f"tenant-{t}",
                        "history": [op.to_dict() for op in hist],
                    }).encode(),
                })
    return pool


def build_txn_pool(*, tenants: int, seed: int = 7,
                   clean_sizes: Tuple[int, ...] = (12, 30)
                   ) -> List[Dict]:
    """``--mixed-consistency`` payload pool: transactional histories
    with KNOWN per-level lattice ground truth, each submitted at one
    requested consistency level (entries round-robin the level set,
    so one coalescer carries mixed-level traffic — same-level
    requests batch together, different-level sets form their own
    groups). Every entry carries the full expected ``holds`` map: the
    exit gate asserts the daemon's per-level verdicts, not just the
    boolean."""
    from jepsen_tpu_torch import fixtures
    from jepsen_tpu_torch.txn import lattice

    all_true = {lvl: True for lvl in lattice.LEVELS}
    all_false = {lvl: False for lvl in lattice.LEVELS}
    skew = {"read-committed": True, "causal": True, "pl-2": True,
            "si": False, "serializable": False}
    fixture_holds = {
        "write-skew": skew,
        "lost-update": all_false,
        "long-fork": dict(skew),
        "session-mr": {"read-committed": True, "causal": True,
                       "pl-2": False, "si": False,
                       "serializable": False},
    }
    variants: List[Tuple[str, List, Dict[str, bool]]] = []
    for i, n in enumerate(clean_sizes):
        variants.append(
            ("clean", fixtures.gen_txn_history(n, seed=seed + i),
             all_true))
    for kind in fixtures.TXN_LATTICE_KINDS:
        variants.append(
            (kind, fixtures.txn_anomaly_block(kind), fixture_holds[kind]))
    pool: List[Dict] = []
    i = 0
    for t in range(tenants):
        for name, hist, holds in variants:
            level = lattice.LEVELS[i % len(lattice.LEVELS)]
            i += 1
            pool.append({
                "tenant": f"tenant-{t}",
                "expect": holds[level],
                "expect_holds": dict(holds),
                "level": level, "kind": name,
                "ops": len(hist),
                "body": json.dumps({
                    "model": "txn-list-append",
                    "tenant": f"tenant-{t}",
                    "options": {"consistency": [level]},
                    "history": [op.to_dict() for op in hist],
                }).encode(),
            })
    return pool


def _post(url: str, body: bytes, path: str = "/check",
          timeout: float = 30.0) -> Tuple[int, Dict]:
    req = urllib.request.Request(
        url + path, data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except Exception:                               # noqa: BLE001
            return e.code, {}
    except Exception:                                   # noqa: BLE001
        # URLError / reset / socket timeout: transport failure, not an
        # HTTP status — the caller records it instead of losing the
        # request from the report's accounting
        return -1, {}


def _get(url: str, path: str) -> Tuple[int, Dict]:
    try:
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            # error statuses can carry structured bodies (e.g. the
            # 500 of a quarantined request) — keep them
            return e.code, json.loads(e.read())
        except Exception:                               # noqa: BLE001
            return e.code, {}
    except Exception:                                   # noqa: BLE001
        return -1, {}


def _get_text(url: str, path: str) -> Tuple[int, str]:
    try:
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, ""
    except Exception:                                   # noqa: BLE001
        return -1, ""


def fetch_hist_buckets(url: str,
                       metric: str = "jepsen_serve_e2e_s"
                       ) -> Optional[List[Tuple[float, float]]]:
    """Scrape /metrics and return the CUMULATIVE ``(le, count)``
    bucket pairs of one histogram (None when the endpoint or the
    series is missing)."""
    from jepsen_tpu_torch import obs

    code, text = _get_text(url, "/metrics")
    if code != 200 or not text:
        return None
    samples = obs.parse_prometheus(text)
    rows = samples.get(metric + "_bucket")
    if not rows:
        return None
    return sorted((float(labels["le"]), v) for labels, v in rows)


def wait_ready(url: str, timeout: float = 30.0) -> bool:
    """Poll /healthz until the daemon answers (a daemon started in the
    background is still importing and building)."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        try:
            code, _ = _get(url, "/healthz")
            if code == 200:
                return True
        except Exception:                               # noqa: BLE001
            pass
        time.sleep(0.2)
    return False


def _percentile(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    s = sorted(xs)
    i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[i]


def _window_report(records: List[Dict], t_start: float,
                   t_mid: float, t_end: float) -> List[Dict]:
    out = []
    for lo, hi in ((t_start, t_mid), (t_mid, t_end)):
        rs = [r for r in records if lo <= r["t_submit"] < hi]
        done = [r for r in rs if r["status"] == "done"]
        lats = [r["latency_s"] for r in done]
        span = max(1e-9, hi - lo)
        out.append({
            "submitted": len(rs),
            "completed": len(done),
            "rejected_429": sum(1 for r in rs
                                if r["status"] == "rejected"),
            "req_s": round(len(done) / span, 2),
            "p50_s": (round(_percentile(lats, 0.50), 4)
                      if lats else None),
            "p99_s": (round(_percentile(lats, 0.99), 4)
                      if lats else None),
        })
    return out


_POLL_MAX_S = 0.25

# The cross-check is resolution-aware: the daemon's histogram answers
# a quantile only to within its bucket (log-spaced, ratio 10^0.1), so
# the loadgen-side value is compared against the BUCKET INTERVAL
# around the histogram estimate, and the 15% bound applies to the
# distance OUTSIDE that interval. Client-side latency is additionally
# quantized by the poll schedule (a verdict is observed up to
# _POLL_MAX_S after it published) — that much absolute slack rides on
# top. Clock/stamping bugs (unit mixups, monotonic-vs-wall mixes, a
# stage stamped by the wrong thread) disagree by orders of magnitude,
# far past every bound here.
_XCHECK_REL = 0.15
_XCHECK_ABS_S = _POLL_MAX_S + 0.1
_BUCKET_RATIO = 10.0 ** 0.1


def crosscheck_quantiles(lg: Dict[str, Optional[float]],
                         before: Optional[List[Tuple[float, float]]],
                         after: Optional[List[Tuple[float, float]]]
                         ) -> Optional[Dict[str, Any]]:
    """Compare loadgen's own measured p50/p99 against the daemon's
    histogram-derived quantiles over the /metrics DELTA between two
    scrapes (the delta isolates the measured window from warmup
    traffic — cumulative buckets difference bucket-by-bucket).
    Returns the comparison dict (``"ok"`` False on >15% disagreement
    past the poll-resolution slack), or None when either side is
    unavailable."""
    from jepsen_tpu_torch import obs

    if before is None or after is None:
        return None
    b = {le: v for le, v in before}
    delta = [(le, v - b.get(le, 0.0)) for le, v in after]
    out: Dict[str, Any] = {}
    ok = True
    for label, q in (("p50", 0.50), ("p99", 0.99)):
        mine = lg.get(label)
        hist = obs.quantile_from_cumulative(delta, q)
        if mine is None or hist is None:
            out[label] = {"loadgen_s": mine, "hist_s": hist,
                          "ok": None}
            continue
        # distance from loadgen's value to the one-bucket interval
        # around the histogram estimate (inside the interval the two
        # agree as well as the histogram can resolve)
        lo, hi = hist / _BUCKET_RATIO, hist * _BUCKET_RATIO
        diff = max(0.0, lo - mine, mine - hi)
        rel = diff / max(mine, hist, 1e-9)
        this_ok = rel <= _XCHECK_REL or diff <= _XCHECK_ABS_S
        ok = ok and this_ok
        out[label] = {"loadgen_s": round(mine, 4),
                      "hist_s": round(hist, 4),
                      "rel": round(rel, 3), "ok": this_ok}
    out["ok"] = ok
    return out


def _await_ids(url: str, ids: List[str], poll_timeout: float) -> None:
    end = time.monotonic() + poll_timeout
    pending = set(ids)
    poll = 0.02
    while pending and time.monotonic() < end:
        for rid in list(pending):
            code, st = _get(url, f"/check/{rid}")
            if code in (200, 500) and st.get("status") in (
                    "done", "timeout", "cancelled", "quarantined"):
                pending.discard(rid)
        time.sleep(poll)
        poll = min(_POLL_MAX_S, poll * 1.5)


def warmup(url: str, pool: List[Dict], *, burst: int = 8,
           poll_timeout: float = 300.0) -> Dict[str, Any]:
    """Pay the cold-start once, before measurement. Two phases:

    1. one history per distinct size, sequentially — compiles the
       singleton-lane geometries and seeds the memo tables;
    2. concurrent bursts of ``burst`` same-size submissions — forms
       coalesced dispatch groups so the power-of-two group-width
       kernel geometries (the daemon pads widths to those) compile
       now, not inside the measured windows.

    After this the measured run reports steady-state serving — the
    regime a long-lived daemon actually lives in. (Skippable with
    --no-warmup to measure the cold wall itself.)"""
    t0 = time.monotonic()
    n = 0
    seen = set()
    for payload in pool:
        if payload["ops"] in seen:
            continue
        seen.add(payload["ops"])
        code, resp = _post(url, payload["body"])
        if code == 202:
            _await_ids(url, [resp["id"]], poll_timeout)
            n += 1
    by_size: Dict[int, List[Dict]] = {}
    for p in pool:
        by_size.setdefault(p["ops"], []).append(p)
    for size_pool in by_size.values():
        ids = []
        for i in range(burst):
            code, resp = _post(url, size_pool[i % len(size_pool)]
                               ["body"])
            if code == 202:
                ids.append(resp["id"])
        _await_ids(url, ids, poll_timeout)
        n += len(ids)
    return {"requests": n, "wall_s": round(time.monotonic() - t0, 3)}


def _flag_saturation(report: Dict[str, Any], rate: float) -> None:
    """The throughput-regression tripwire: a daemon sustaining under
    90% of the offered rate while the queue-overload waiver stayed
    EMPTY (no 429s, no backlog-regime p99 waiver) is quietly shedding
    throughput with every gate green. Sets ``report["saturated"]``
    loudly instead of leaving the ratio buried in the JSON."""
    sus = report.get("sustained_req_s")
    if sus is None or not rate:
        return
    waived = ((report.get("latency_crosscheck") or {})
              .get("p99_gate") == "waived-queue-overloaded")
    report["saturated"] = bool(
        sus / float(rate) < 0.9
        and not waived
        and not report.get("rejected_429", 0))


def find_capacity(url: str, pool: List[Dict], *, quick: bool = False,
                  start_rate: float = 8.0, max_rate: float = 512.0,
                  iters: int = 4,
                  urls: Optional[List[str]] = None) -> Dict[str, Any]:
    """Binary-search the offered rate to the daemon's max sustained
    req/s — the number the pipelined dispatch must actually move.
    Doubling phase finds the first UNSUSTAINED rate (sustained below
    90% of offered, or any 429/timeout), then bisection tightens the
    bracket. Probes are short open-loop bursts over the same payload
    pool as the fixed-rate run; every probe is recorded so a noisy
    bracket is visible in the artifact."""
    dur = 3.0 if quick else 6.0
    probes: List[Dict[str, Any]] = []

    def _probe(r: float) -> Tuple[bool, float]:
        rep = run_load(url, rate=r, duration=dur, pool=pool,
                       chaos_tolerant=False, urls=urls)
        rep.pop("_admit_lats", None)
        sus = float(rep.get("sustained_req_s") or 0.0)
        ok = (sus >= 0.9 * r
              and not rep.get("rejected_429", 0)
              and not rep.get("timeouts", 0))
        probes.append({"rate": round(r, 2),
                       "sustained_req_s": round(sus, 2), "ok": ok})
        return ok, sus

    lo, lo_sus = 0.0, 0.0
    r = max(1.0, float(start_rate))
    hi = None
    while hi is None and r <= max_rate:
        ok, sus = _probe(r)
        if ok:
            lo, lo_sus = r, sus
            r *= 2.0
        else:
            hi = r
    if hi is None:
        hi = r                  # sustained everything up to max_rate
    for _ in range(max(0, int(iters))):
        if hi - lo <= max(0.5, 0.05 * hi):
            break
        mid = (lo + hi) / 2.0
        ok, sus = _probe(mid)
        if ok:
            lo, lo_sus = mid, sus
        else:
            hi = mid
    return {"capacity_req_s": round(lo_sus or lo, 2),
            "highest_sustained_rate": round(lo, 2),
            "first_unsustained_rate": round(hi, 2),
            "probes": probes}


def run_load(url: str, *, rate: float, duration: float,
             pool: List[Dict], poll_s: float = 0.01,
             poll_timeout: float = 120.0,
             chaos_tolerant: bool = False,
             urls: Optional[List[str]] = None) -> Dict[str, Any]:
    """Drive the open-loop schedule; returns the report dict.

    ``urls`` (fleet mode): submissions round-robin client-side over
    the replica list (each request polls the replica it was admitted
    by), and the report gains ``per_replica`` submitted/completed/
    req_s splits beside the merged totals.

    ``chaos_tolerant`` (the chaos harness's mode): a connection
    refusal during a scripted daemon kill/restart is expected, not a
    failure — POSTs retry until the daemon returns, refusals are
    recorded as ``error-restart`` (distinct from ``error-net``) only
    when the daemon never comes back, pollers keep polling across the
    gap, and the report carries ``recovery``: the time from the first
    refusal to the first verdict observed after it
    (recovery-time-to-first-verdict)."""
    targets = list(urls) if urls else [url]
    records: List[Dict] = []
    rec_lock = threading.Lock()
    threads: List[threading.Thread] = []
    # restart-recovery bookkeeping (chaos-tolerant mode): first
    # connection refusal seen, and the first verdict after it
    chaos = {"first_refusal": None, "first_verdict_after": None,
             "refusals": 0}
    chaos_lock = threading.Lock()

    def _saw_refusal() -> None:
        with chaos_lock:
            chaos["refusals"] += 1
            if chaos["first_refusal"] is None:
                chaos["first_refusal"] = time.monotonic()

    def _saw_verdict() -> None:
        with chaos_lock:
            if chaos["first_refusal"] is not None \
                    and chaos["first_verdict_after"] is None:
                chaos["first_verdict_after"] = time.monotonic()

    def one(payload: Dict, t_sched: float, url: str) -> None:
        rec = {"tenant": payload["tenant"], "ops": payload["ops"],
               "expect": payload["expect"], "t_submit": t_sched,
               "status": "lost", "latency_s": None, "match": None,
               "replica": url}
        if payload.get("level"):
            rec["level"] = payload["level"]
            rec["kind"] = payload.get("kind")
        t0 = time.monotonic()
        code, resp = _post(url, payload["body"])
        if chaos_tolerant and code == -1:
            # the daemon is (presumably) mid-restart: keep trying
            # until it answers or the poll budget runs out
            _saw_refusal()
            end_post = time.monotonic() + poll_timeout
            while code == -1 and time.monotonic() < end_post:
                time.sleep(0.25)
                code, resp = _post(url, payload["body"])
            if code == -1:
                rec["status"] = "error-restart"
        if code == 429:
            rec["status"] = "rejected"
        elif code == -1:
            rec["status"] = ("error-restart" if chaos_tolerant
                             else "error-net")
        elif code != 202:
            rec["status"] = f"error-{code}"
        else:
            rid = resp["id"]
            # admission anchor: the daemon's e2e histogram starts at
            # ADMIT, while t0 includes submission-side blocking (HTTP
            # worker scheduling, retried POSTs) a saturated daemon
            # never sees — the crosscheck compares like with like
            # from this stamp (the open-loop client latency keeps t0)
            t_admit = time.monotonic()
            end = time.monotonic() + poll_timeout
            # exponential backoff to _POLL_MAX_S: hundreds of
            # in-flight pollers at a fixed 10 ms would out-traffic
            # the load they measure
            poll = poll_s
            while time.monotonic() < end:
                code, st = _get(url, f"/check/{rid}")
                if code == -1 and chaos_tolerant:
                    # daemon gap mid-poll: note it, keep polling —
                    # the journal replay owes us this verdict under
                    # the same id
                    _saw_refusal()
                if code in (200, 500) and st.get("status") in (
                        "done", "timeout", "cancelled",
                        "quarantined"):
                    rec["status"] = st["status"]
                    rec["latency_s"] = time.monotonic() - t0
                    rec["latency_admit_s"] = \
                        time.monotonic() - t_admit
                    valid = (st.get("result") or {}).get("valid")
                    rec["match"] = (valid == payload["expect"]
                                    if st["status"] == "done"
                                    else None)
                    if (rec["match"] and
                            payload.get("expect_holds") is not None):
                        # mixed-consistency pool: the boolean is not
                        # enough — the per-level holds map the daemon
                        # computed at the requested level must match
                        # the fixture's ground truth at that level
                        holds = (st.get("result") or {}).get(
                            "holds") or {}
                        want = {lvl: payload["expect_holds"][lvl]
                                for lvl in
                                (st.get("result") or {}).get(
                                    "consistency", [])}
                        rec["match"] = (
                            want != {} and
                            all(holds.get(lvl) == v
                                for lvl, v in want.items()))
                    if st["status"] == "done":
                        _saw_verdict()
                    # the daemon's stamped stage split (queue wait vs
                    # service) — reported beside the client-side wall
                    rec["queue_wait_s"] = st.get("queue-wait-s")
                    rec["service_s"] = st.get("service-s")
                    break
                time.sleep(poll)
                poll = min(_POLL_MAX_S, poll * 1.5)
        with rec_lock:
            records.append(rec)

    t_start = time.monotonic()
    t_end = t_start + duration
    i = 0
    while True:
        t_sched = t_start + i / rate
        if t_sched >= t_end:
            break
        now = time.monotonic()
        if t_sched > now:
            time.sleep(t_sched - now)
        payload = pool[i % len(pool)]
        th = threading.Thread(
            target=one,
            args=(payload, t_sched, targets[i % len(targets)]),
            daemon=True)
        th.start()
        threads.append(th)
        i += 1
    for th in threads:
        th.join(poll_timeout + 30)
    t_mid = t_start + duration / 2.0
    done = [r for r in records if r["status"] == "done"]
    mismatches = [r for r in records if r["match"] is False]
    wall = max(1e-9, time.monotonic() - t_start)
    report: Dict[str, Any] = {
        "target_rate": rate, "duration_s": duration,
        "submitted": len(records),
        "completed": len(done),
        "rejected_429": sum(1 for r in records
                            if r["status"] == "rejected"),
        "timeouts": sum(1 for r in records
                        if r["status"] == "timeout"),
        "verdict_mismatches": len(mismatches),
        "sustained_req_s": round(len(done) / wall, 2),
        **({"per_level": {
            lvl: {"completed": sum(1 for r in done
                                   if r.get("level") == lvl),
                  "mismatches": sum(1 for r in mismatches
                                    if r.get("level") == lvl)}
            for lvl in sorted({r["level"] for r in records
                               if r.get("level")})}}
           if any(r.get("level") for r in records) else {}),
        "p50_s": _percentile([r["latency_s"] for r in done], 0.50),
        "p99_s": _percentile([r["latency_s"] for r in done], 0.99),
        # admission-anchored quantiles: the window the daemon's e2e
        # histogram actually measures (202 -> terminal) — the
        # latency_crosscheck compares THESE against /metrics
        "p50_admit_s": _percentile(
            [r.get("latency_admit_s") for r in done
             if r.get("latency_admit_s") is not None], 0.50),
        "p99_admit_s": _percentile(
            [r.get("latency_admit_s") for r in done
             if r.get("latency_admit_s") is not None], 0.99),
        # raw admit-anchored samples, kept so run_loadgen can MERGE
        # them with the session-stream samples before the histogram
        # crosscheck (the daemon's e2e histogram covers every
        # completed request — mixed-traffic runs must compare like
        # against like); stripped from the report before return
        "_admit_lats": sorted(
            r["latency_admit_s"] for r in done
            if r.get("latency_admit_s") is not None),
        "windows": _window_report(records, t_start, t_mid,
                                  time.monotonic()),
        # queue-wait vs service-time split from the daemon's stage
        # timestamps (GET /check/<id> waterfall fields)
        "stage_split": {
            kind: {
                "p50_s": _percentile(vals, 0.50),
                "p99_s": _percentile(vals, 0.99),
                "mean_s": (round(sum(vals) / len(vals), 4)
                           if vals else None),
            }
            for kind, vals in (
                ("queue_wait",
                 [r["queue_wait_s"] for r in done
                  if isinstance(r.get("queue_wait_s"),
                                (int, float))]),
                ("service",
                 [r["service_s"] for r in done
                  if isinstance(r.get("service_s"),
                                (int, float))]))},
    }
    if len(targets) > 1:
        report["per_replica"] = {
            u: {"submitted": len(sub),
                "completed": len(dn),
                "req_s": round(len(dn) / wall, 2)}
            for u in targets
            for sub in [[r for r in records
                         if r.get("replica") == u]]
            for dn in [[r for r in sub if r["status"] == "done"]]}
    with chaos_lock:
        if chaos["refusals"]:
            rec_s = None
            if chaos["first_verdict_after"] is not None:
                rec_s = round(chaos["first_verdict_after"]
                              - chaos["first_refusal"], 3)
            report["recovery"] = {
                "refusals": chaos["refusals"],
                "restart_errors": sum(
                    1 for r in records
                    if r["status"] == "error-restart"),
                "recovery_to_first_verdict_s": rec_s,
            }
    code, stats = _get(targets[0], "/stats")
    if code == 200:
        report["stats"] = stats
        counters = stats.get("counters", {})
        report["fallbacks"] = {
            k: v for k, v in counters.items()
            if k.startswith(("engine.fallback.",
                             "checker.swallowed."))}
    if len(targets) > 1:
        report["replica_stats"] = {}
        for u in targets[1:]:
            code, st = _get(u, "/stats")
            if code == 200:
                report["replica_stats"][u] = st
    return report


def build_session_plans(*, n_sessions: int, ops_per_session: int,
                        appends: int, violation_frac: float,
                        seed: int = 7,
                        tenants: Optional[int] = None) -> List[Dict]:
    """Session traffic plans: each a known-ground-truth history split
    into append blocks (violating sessions get a corrupted stream, so
    the incremental verdict has something to catch). ``tenants``
    spreads sessions over that many tenant names (default 2 — the
    historical mixed-traffic shape; thousand-session mux runs need a
    spread wide enough to clear the per-tenant open-session cap)."""
    from jepsen_tpu_torch import fixtures

    n_tenants = max(1, int(tenants or 2))
    plans = []
    for i in range(n_sessions):
        hist = fixtures.gen_history("cas", n_ops=ops_per_session,
                                    processes=3, seed=seed + 100 + i)
        expect = True
        if (i * 997 % 101) / 101.0 < violation_frac:
            hist = fixtures.corrupt(hist, seed=seed + i)
            expect = False
        step = max(1, len(hist) // appends)
        blocks = [hist[j:j + step]
                  for j in range(0, len(hist), step)]
        plans.append({"tenant": f"sess-tenant-{i % n_tenants}",
                      "expect": expect,
                      "blocks": [[op.to_dict() for op in b]
                                 for b in blocks]})
    return plans


def fetch_counter(url: str, name: str) -> Optional[float]:
    """One counter's current value off /metrics (raw jepsen name,
    e.g. ``serve.session.appends``); None when the endpoint or the
    series is missing."""
    from jepsen_tpu_torch import obs

    code, text = _get_text(url, "/metrics")
    if code != 200 or not text:
        return None
    sane = "jepsen_" + "".join(
        c if (c.isalnum() or c == "_") else "_" for c in name)
    rows = obs.parse_prometheus(text).get(sane)
    return rows[0][1] if rows else None


_MUX_COUNTERS = ("serve.session.appends",
                 "serve.session.mega.groups",
                 "serve.session.mega.lanes")


def _mux_efficiency(before: Dict[str, Optional[float]],
                    after: Dict[str, Optional[float]]
                    ) -> Optional[Dict[str, Any]]:
    """Appends-per-dispatch over the measured window: a mega wave of
    L lanes replaces L solo dispatches with ONE kernel launch, so
    dispatches = appends - lanes + groups. 1.0 = no multiplexing."""
    deltas = {}
    for k in _MUX_COUNTERS:
        b, a = before.get(k), after.get(k)
        deltas[k] = (a or 0.0) - (b or 0.0) if a is not None else 0.0
    appends = deltas["serve.session.appends"]
    if appends <= 0:
        return None
    dispatches = max(
        1.0, appends - deltas["serve.session.mega.lanes"]
        + deltas["serve.session.mega.groups"])
    return {"appends": int(appends),
            "dispatches": int(dispatches),
            "mega_groups": int(deltas["serve.session.mega.groups"]),
            "mega_lanes": int(deltas["serve.session.mega.lanes"]),
            "mux_efficiency": round(appends / dispatches, 2)}


def run_session_traffic(url: str, plans: List[Dict], *,
                        cadence_s: float = 0.15,
                        wait_s: float = 60.0,
                        workers: Optional[int] = None,
                        poll_s: float = 0.05) -> Dict[str, Any]:
    """Drive long-lived sessions and gate their verdicts against
    ground truth: a valid stream must never be flagged, a violating
    stream must be flagged by close at the latest (earlier =
    streaming win, counted). Reports the per-append-latency
    distribution — the append-to-verdict number the session protocol
    exists for — plus the window's ``mux`` sub-object
    (appends-per-dispatch off the daemon's mega counters).

    The generator is a WORKER POOL over an event heap, not a thread per
    session: each session is a tiny state machine (open -> append ->
    poll verdict -> ... -> close) scheduled by due time, so five
    thousand live streams ride a few dozen threads. Small runs
    (sessions <= workers) post appends synchronously; large runs
    post with ``wait-s: 0`` and poll the verdict out — the async
    shape that lets thousands of appends sit queued at once, which
    is exactly what the daemon's mega-batch dispatch multiplexes
    into single kernel launches."""
    import heapq

    nworkers = int(workers or min(64, max(4, len(plans))))
    sync_wait = wait_s if len(plans) <= nworkers else 0.0
    results: List[Dict] = []
    lock = threading.Lock()
    cond = threading.Condition(lock)
    heap: List[Any] = []        # (due, tiebreak, idx)
    tick = [0]
    done = [0]

    class _S:                   # per-session state machine
        __slots__ = ("plan", "rec", "sid", "seq", "retried",
                     "pending", "t0", "deadline")

        def __init__(self, plan: Dict) -> None:
            self.plan = plan
            self.rec: Dict[str, Any] = {
                "expect": plan["expect"], "appends": 0,
                "latencies": [], "flagged_at": None, "final": None,
                "errors": 0}
            self.sid: Optional[str] = None
            self.seq = 0                # last submitted append seq
            self.retried = False
            self.pending: Optional[str] = None   # polled request id
            self.t0 = 0.0
            self.deadline = 0.0

    states = [_S(p) for p in plans]

    def _push(idx: int, due: float) -> None:
        with cond:
            tick[0] += 1
            heapq.heappush(heap, (due, tick[0], idx))
            cond.notify()

    def _settle(s: _S, idx: int, r: Dict) -> None:
        """One append verdict is in: record it and schedule the next
        block (or the close) a cadence later."""
        s.rec["appends"] += 1
        s.rec["latencies"].append(time.monotonic() - s.t0)
        if s.rec["flagged_at"] is None \
                and r.get("valid-so-far") is False:
            s.rec["flagged_at"] = s.seq
        s.pending = None
        s.retried = False
        _push(idx, time.monotonic() + cadence_s)

    def _fail_block(s: _S, idx: int) -> None:
        """An append gave out (transport / timeout / backpressure
        past the retry): count it and close the session out — its
        later blocks would only cascade seq-gap 409s."""
        s.rec["errors"] += 1
        s.seq = len(s.plan["blocks"])       # jump to the close step
        s.pending = None
        _push(idx, time.monotonic())

    def _step(idx: int) -> None:
        s = states[idx]
        if s.sid is None:
            code, resp = _post_json(url, "/session",
                                    {"model": "cas-register",
                                     "tenant": s.plan["tenant"]})
            if code != 201:
                s.rec["errors"] += 1
                s.rec["final"] = f"open-error-{code}"
                with cond:
                    results.append(s.rec)
                    done[0] += 1
                    cond.notify_all()
                return
            s.sid = resp["session"]
            s.rec["session"] = s.sid
            _push(idx, time.monotonic())
            return
        if s.pending is not None:
            # poll a 202'd append's verdict out of GET /check/<id>
            code, st = _get(url, f"/check/{s.pending}")
            if code == 200 and st.get("status") == "done" \
                    and st.get("result"):
                _settle(s, idx, st["result"])
            elif time.monotonic() > s.deadline:
                _fail_block(s, idx)
            else:
                _push(idx, time.monotonic() + poll_s)
            return
        if s.seq >= len(s.plan["blocks"]):
            t0c = time.monotonic()
            code, r = _post_json(url, f"/session/{s.sid}/close", {})
            if code == 200:
                s.rec["final"] = (r.get("result") or {}).get("valid")
                # the close dispatches the final check through the
                # same queue as everything else, so it lands in the
                # daemon's e2e histogram — time it client-side so the
                # merged crosscheck sample covers the same population
                s.rec["close_latency"] = time.monotonic() - t0c
            else:
                s.rec["errors"] += 1
                s.rec["final"] = f"close-error-{code}"
            with cond:
                results.append(s.rec)
                done[0] += 1
                cond.notify_all()
            return
        block = s.plan["blocks"][s.seq]
        if not s.retried:
            s.t0 = time.monotonic()
        s.seq += 1
        code, r = _post_json(
            url, f"/session/{s.sid}/append",
            {"history": block, "seq": s.seq, "wait-s": sync_wait})
        if code == 429 and not s.retried:
            # backpressure: retry once after the advised delay
            s.retried = True
            s.seq -= 1
            _push(idx, time.monotonic()
                  + float(r.get("retry-after-s", 1.0)))
            return
        if code == 202 and r.get("id"):
            # slow (or async wait-s: 0) dispatch: protocol-legal —
            # the verdict arrives via GET /check/<id>
            s.pending = r["id"]
            s.deadline = time.monotonic() + wait_s
            _push(idx, time.monotonic() + poll_s)
            return
        if code != 200:
            _fail_block(s, idx)
            return
        _settle(s, idx, r)

    def worker() -> None:
        while True:
            with cond:
                while True:
                    if done[0] >= len(plans):
                        return
                    now = time.monotonic()
                    if heap and heap[0][0] <= now:
                        _due, _t, idx = heapq.heappop(heap)
                        break
                    cond.wait(max(0.005,
                                  (heap[0][0] - now) if heap
                                  else 0.1))
            try:
                _step(idx)
            except Exception:                           # noqa: BLE001
                s = states[idx]
                s.rec["errors"] += 1
                s.rec["final"] = "generator-error"
                with cond:
                    results.append(s.rec)
                    done[0] += 1
                    cond.notify_all()

    mux_before = {k: fetch_counter(url, k) for k in _MUX_COUNTERS}
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(nworkers)]
    t0 = time.monotonic()
    for i in range(len(plans)):
        _push(i, t0)
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = max(1e-9, time.monotonic() - t0)
    mux_after = {k: fetch_counter(url, k) for k in _MUX_COUNTERS}
    cap_probe = probe_tenant_cap(url)
    lats = sorted(x for r in results for x in r["latencies"])
    mismatches = [r for r in results
                  if r["final"] is not r["expect"]]
    # a VALID stream flagged mid-run is a false alarm — as much a
    # verdict bug as a wrong close
    false_alarms = [r for r in results
                    if r["expect"] and r["flagged_at"] is not None]
    total_ops = sum(len(b) for p in plans for b in p["blocks"])
    n_appends = sum(r["appends"] for r in results)
    return {
        "sessions": len(plans),
        "appends": n_appends,
        "append_ops": total_ops,
        "errors": sum(r["errors"] for r in results),
        "wall_s": round(wall, 3),
        "sustained_append_ops_s": round(total_ops / wall, 1),
        "sustained_appends_s": round(n_appends / wall, 1),
        "mux": _mux_efficiency(mux_before, mux_after),
        "append_p50_s": (round(_percentile(lats, 0.50), 4)
                         if lats else None),
        "append_p99_s": (round(_percentile(lats, 0.99), 4)
                         if lats else None),
        # raw client samples for the merged histogram crosscheck
        # (appends AND closes ride the shared dispatch queue, so both
        # populations appear in the daemon's e2e histogram);
        # run_loadgen strips these before the report prints
        "_append_lats": lats,
        "_close_lats": sorted(
            r["close_latency"] for r in results
            if isinstance(r.get("close_latency"), (int, float))),
        "verdict_mismatches": len(mismatches),
        "false_alarms": len(false_alarms),
        "violating_sessions": sum(1 for r in results
                                  if not r["expect"]),
        "flagged_before_close": sum(
            1 for r in results
            if not r["expect"] and r["flagged_at"] is not None),
        "tenant_cap_probe": cap_probe,
    }


def probe_tenant_cap(url: str,
                     max_probe: int = 16) -> Optional[Dict[str, Any]]:
    """Assert the per-tenant open-session cap is ENFORCED: open empty
    sessions on one throwaway tenant until the daemon answers 429
    with cause ``tenant-cap``, then close them all. Skipped (None)
    when the daemon advertises no finite cap or it is larger than
    ``max_probe`` (probing a 64-cap daemon with 65 opens is not a
    smoke test's business); the ``enforced`` bit rides into the
    loadgen exit gate."""
    code, stats = _get(url, "/stats")
    cap = ((stats.get("sessions") or {}).get("tenant-cap")
           if code == 200 else None)
    if not cap or int(cap) > max_probe:
        return None
    cap = int(cap)
    opened: List[str] = []
    hit = None
    for _ in range(cap + 1):
        code, resp = _post_json(url, "/session",
                                {"model": "cas-register",
                                 "tenant": "cap-probe"})
        if code == 201:
            opened.append(resp["session"])
        elif code == 429:
            hit = resp
            break
        else:
            break
    for sid in opened:
        _post_json(url, f"/session/{sid}/close", {})
    enforced = (hit is not None
                and hit.get("cause") == "tenant-cap"
                and len(opened) == cap)
    return {"cap": cap, "opened": len(opened),
            "cause": (hit or {}).get("cause"), "enforced": enforced}


def _post_json(url: str, path: str, payload: Dict) -> Tuple[int, Dict]:
    # one transport ladder for the toolbox: delegate to _post (the
    # longer timeout covers synchronous session appends/closes)
    return _post(url, json.dumps(payload).encode(), path=path,
                 timeout=120.0)


def run_loadgen(opts: Dict[str, Any]) -> Dict[str, Any]:
    """Programmatic entry: ``opts`` mirrors the CLI flags. Self-hosts a
    daemon on ``opts["device"]`` (the card unless it names the CPU) when
    no url is given."""
    quick = bool(opts.get("quick"))
    rate = float(opts.get("rate") or (8.0 if quick else 20.0))
    duration = float(opts.get("duration") or (4.0 if quick else 20.0))
    tenants = int(opts.get("tenants") or 4)
    sizes = opts.get("sizes") or ([16, 32, 48] if quick
                                  else [32, 96, 200, 400])
    if opts.get("mixed_consistency"):
        # transactional pool: every payload is a txn history with a
        # known per-level lattice ground truth, submitted at one
        # requested level (levels round-robin across the pool)
        pool = build_txn_pool(tenants=tenants,
                              seed=int(opts.get("seed", 7)),
                              clean_sizes=((8, 16) if quick
                                           else (12, 30, 60)))
    else:
        pool = build_pool(sizes=sizes, tenants=tenants,
                          violation_frac=float(
                              opts.get("violation_frac", 0.25)),
                          model=opts.get("model", "cas-register"),
                          seed=int(opts.get("seed", 7)))
    url = opts.get("url")
    replicas = [u for u in (opts.get("replicas") or []) if u]
    if replicas:
        # fleet mode: client-side round-robin over the replica list;
        # the first replica doubles as the primary for warmup-era
        # probes and the stats scrape
        url = replicas[0]
    n_sessions = int(opts.get("n_sessions")
                     or (2 if quick else 4)) \
        if opts.get("sessions") else 0
    daemon = None
    if not url:
        from jepsen_tpu_torch import serve
        # thousand-session mux runs need queue room for every live
        # stream's one in-flight append (that backlog IS the lane
        # supply the mega dispatch multiplexes) — scaled only above
        # the default so small runs keep the historical bound
        qd = max(256, 2 * n_sessions)
        daemon = serve.Daemon(port=int(opts.get("port") or 0),
                              host="127.0.0.1",
                              device=opts.get("device"),
                              group=int(opts.get("group")
                                        or (8 if quick else 32)),
                              queue_depth=qd,
                              store_root=opts.get("store_root"),
                              persist=bool(opts.get("store_root")),
                              # small cap so probe_tenant_cap can
                              # assert enforcement with a handful of
                              # empty opens
                              session_tenant_cap=8).start()
        url = f"http://127.0.0.1:{daemon.port}"
    report: Dict[str, Any] = {}
    try:
        for u in (replicas or [url]):
            if not wait_ready(u, timeout=float(
                    opts.get("ready_timeout", 60.0))):
                report["error"] = f"daemon at {u} never became ready"
                return report
        if opts.get("warmup", True):
            burst = int(opts.get("warm_burst")
                        or (8 if quick else 16))
            if replicas:
                # every replica compiles its own kernel geometries:
                # an unwarmed sibling would bill its compile wall to
                # the measured windows and sink the scaling number
                report["warmup"] = {u: warmup(u, pool, burst=burst)
                                    for u in replicas}
            else:
                report["warmup"] = warmup(url, pool, burst=burst)
        # scrape the e2e histogram around the measured run: the delta
        # is the measured window's distribution, warmup excluded
        hist_before = fetch_hist_buckets(url)
        sess_result: Dict[str, Any] = {}
        sess_thread = None
        if opts.get("sessions"):
            # mixed traffic: long-lived sessions append at their
            # cadence WHILE the one-shot open-loop load runs — the
            # coalescer interleaves append groups with check groups,
            # which is the serving regime sessions actually face
            # tenant spread: the per-tenant open-session cap (8 on
            # the self-hosted daemon) must clear, and the per-tenant
            # in-flight allowance must not throttle the mux lanes
            sess_tenants = (opts.get("session_tenants")
                            or (2 if n_sessions <= 16
                                else max(2, -(-n_sessions // 6))))
            plans = build_session_plans(
                n_sessions=n_sessions,
                ops_per_session=int(opts.get("session_ops")
                                    or (240 if quick else 2000)),
                appends=int(opts.get("session_appends")
                            or (6 if quick else 12)),
                violation_frac=float(
                    opts.get("violation_frac", 0.25)),
                seed=int(opts.get("seed", 7)),
                tenants=int(sess_tenants))

            def _run_sessions() -> None:
                sess_result.update(run_session_traffic(
                    url, plans,
                    cadence_s=float(opts.get("session_cadence")
                                    or 0.1),
                    workers=opts.get("session_workers")))
            sess_thread = threading.Thread(target=_run_sessions,
                                           daemon=True)
            sess_thread.start()
        report.update(run_load(
            url, rate=rate, duration=duration, pool=pool,
            chaos_tolerant=bool(opts.get("chaos_tolerant")),
            urls=replicas or None))
        if sess_thread is not None:
            sess_thread.join(600)
            report["sessions"] = sess_result
        # the raw client samples exist only to feed the merged
        # crosscheck below — pull them out of the report (they'd
        # bloat every printed run, and thousand-session runs carry
        # tens of thousands of floats)
        one_shot_lats = report.pop("_admit_lats", None) or []
        sess_lats = []
        if isinstance(report.get("sessions"), dict):
            sess_lats = list(report["sessions"]
                             .pop("_append_lats", None) or [])
            sess_lats += list(report["sessions"]
                              .pop("_close_lats", None) or [])
        if replicas:
            # fleet summary: merged throughput over N replicas, and
            # the scaling efficiency against a caller-provided
            # 1-replica baseline (req/s at N / (N * req/s at 1))
            fleet: Dict[str, Any] = {
                "replicas": len(replicas),
                "per_replica": report.get("per_replica")}
            base = opts.get("baseline_req_s")
            if base:
                fleet["baseline_req_s"] = float(base)
                fleet["scaling_efficiency"] = round(
                    report.get("sustained_req_s", 0.0)
                    / (len(replicas) * float(base)), 3)
            report["fleet"] = fleet
            # the per-process daemon histograms cannot be compared
            # against the MERGED client quantiles: skip the
            # crosscheck in fleet mode (each replica's own histogram
            # stays scrapeable via its /metrics)
            _flag_saturation(report, rate)
            report["url"] = url
            return report
        hist_after = fetch_hist_buckets(url)
        # cross-check against the ADMISSION-anchored quantiles: the
        # daemon histogram measures admit->terminal, while the
        # client-side p99 additionally carries submission-side
        # blocking under a saturated queue (pre-admit wait the daemon
        # never sees) — see docs/SERVING.md
        # mixed-traffic runs (--sessions): the shared e2e histogram
        # records one-shots AND session appends AND closes, so the
        # one-shot quantiles alone compare a sub-population against
        # the whole (at mux scale the appends dominate and the
        # crosscheck fails spuriously) — merge the client-side
        # samples so both sides cover the same requests
        if sess_lats:
            merged = sorted(one_shot_lats + sess_lats)
            lg_q = {"p50": _percentile(merged, 0.50),
                    "p99": _percentile(merged, 0.99)}
        else:
            lg_q = {"p50": report.get("p50_admit_s"),
                    "p99": report.get("p99_admit_s")}
        xc = crosscheck_quantiles(lg_q, hist_before, hist_after)
        if xc is not None:
            xc["anchor"] = ("admission+session-stream" if sess_lats
                            else "admission")
            # queue-overloaded regime (sustained throughput well
            # below the offered rate, or admissions refused): the
            # tail is backlog — the client's p99 additionally carries
            # GIL/scheduler starvation of hundreds of in-flight
            # pollers, which the daemon histogram (admit->terminal on
            # the dispatch thread) never contains. The p99 gate is
            # WAIVED there (p50 stays binding — a mid-distribution
            # clock/stamping bug still fails); see docs/SERVING.md.
            qw = (report.get("stage_split") or {}) \
                .get("queue_wait") or {}
            overloaded = (
                # the daemon's own queue-wait split IS the regime
                # signal: a healthy run queues for milliseconds — a
                # MEDIAN wait past 0.5 s means the open-loop client
                # outran the daemon (backlog), and a tail stretched
                # far past the median means transient backlog bursts
                (qw.get("p50_s") or 0.0) > 0.5
                or (qw.get("p99_s") or 0.0)
                > max(1.0, 4.0 * (qw.get("p50_s") or 0.0))
                or report.get("sustained_req_s", rate) < 0.7 * rate
                or report.get("rejected_429", 0) > 0)
            p99g = xc.get("p99") or {}
            p50_ok = (xc.get("p50") or {}).get("ok")
            if (overloaded and p99g.get("ok") is False
                    and p50_ok is not False):
                xc["p99_gate"] = "waived-queue-overloaded"
                xc["ok"] = True
            report["latency_crosscheck"] = xc
        _flag_saturation(report, rate)
        if opts.get("find_capacity"):
            # capacity search AFTER the crosscheck scrape: its probe
            # traffic must not leak into the measured window's
            # histogram delta
            try:
                report["capacity"] = find_capacity(
                    url, pool, quick=quick,
                    start_rate=float(opts.get("capacity_start")
                                     or max(4.0, rate / 2.0)))
            except Exception as e:                      # noqa: BLE001
                report["capacity"] = {
                    "error": f"{type(e).__name__}: {e}"}
        report["url"] = url
        return report
    finally:
        if daemon is not None:
            report["drained"] = daemon.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="open-loop load generator for the jepsen-tpu "
                    "check daemon (PyTorch/CUDA port)")
    ap.add_argument("--url", default=None,
                    help="daemon base url; omitted = --self-host")
    ap.add_argument("--replicas", default=None,
                    help="fleet mode: comma-separated replica base "
                         "urls; submissions round-robin client-side "
                         "and the report carries per-replica req/s")
    ap.add_argument("--baseline-req-s", type=float, default=None,
                    help="1-replica sustained req/s baseline; with "
                         "--replicas the report then carries "
                         "scaling_efficiency = req_s_at_N / "
                         "(N * baseline)")
    ap.add_argument("--self-host", action="store_true",
                    help="start an in-process daemon on an ephemeral "
                         "port")
    ap.add_argument("--rate", type=float, default=None,
                    help="target arrival rate, req/s")
    ap.add_argument("--duration", type=float, default=None,
                    help="run length, seconds (two measurement "
                         "windows of half each)")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--model", default="cas-register")
    ap.add_argument("--mixed-consistency", action="store_true",
                    help="txn lattice pool: tenants submit "
                         "transactional histories at DIFFERENT "
                         "consistency levels through one coalescer; "
                         "the exit gate asserts every per-level "
                         "holds verdict against the fixture ground "
                         "truth (overrides --model)")
    ap.add_argument("--violation-frac", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--store-root", default=None,
                    help="self-hosted daemon persistence root")
    ap.add_argument("--quick", action="store_true",
                    help="small run: low rate, short duration, "
                         "tiny histories")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the cold-start warmup phase (measure "
                         "the compile wall inside the windows)")
    ap.add_argument("--chaos-tolerant", action="store_true",
                    help="expect a scripted daemon kill/restart: "
                         "retry refused POSTs, record refusals as "
                         "error-restart (not error-net), keep "
                         "polling across the gap, and report "
                         "recovery-time-to-first-verdict")
    ap.add_argument("--sessions", action="store_true",
                    help="mix long-lived streaming sessions into the "
                         "load (appends at --session-cadence) and "
                         "gate their incremental + close verdicts "
                         "against ground truth, reporting the "
                         "per-append latency distribution")
    ap.add_argument("--session-cadence", type=float, default=0.1,
                    help="seconds between one session's appends")
    ap.add_argument("--n-sessions", type=int, default=None,
                    help="how many live sessions to drive (the "
                         "worker-pool generator scales to 5000+; "
                         "default 2 with --quick, else 4)")
    ap.add_argument("--session-ops", type=int, default=None,
                    help="ops per session stream (default 240 with "
                         "--quick, else 2000)")
    ap.add_argument("--session-appends", type=int, default=None,
                    help="append blocks per session (default 6 with "
                         "--quick, else 12)")
    ap.add_argument("--session-workers", type=int, default=None,
                    help="worker threads of the session traffic "
                         "(default: min(64, n_sessions))")
    ap.add_argument("--device", default=None,
                    help="device of the --self-host daemon: the card by "
                         "default; 'cpu' runs the plain versions")
    ap.add_argument("--find-capacity", action="store_true",
                    help="after the fixed-rate run, binary-search the "
                         "offered rate to the daemon's max sustained "
                         "req/s and report it under 'capacity'")
    args = ap.parse_args(argv)
    if args.self_host and args.url:
        ap.error("--self-host and --url are mutually exclusive")
    if args.replicas and (args.self_host or args.url):
        ap.error("--replicas is mutually exclusive with "
                 "--url/--self-host")
    report = run_loadgen({
        "url": args.url,
        "replicas": ([u.strip() for u in args.replicas.split(",")
                      if u.strip()] if args.replicas else None),
        "baseline_req_s": args.baseline_req_s,
        "rate": args.rate,
        "duration": args.duration, "tenants": args.tenants,
        "model": args.model, "violation_frac": args.violation_frac,
        "mixed_consistency": args.mixed_consistency,
        "seed": args.seed, "store_root": args.store_root,
        "quick": args.quick, "warmup": not args.no_warmup,
        "chaos_tolerant": args.chaos_tolerant,
        "sessions": args.sessions,
        "session_cadence": args.session_cadence,
        "n_sessions": args.n_sessions,
        "session_ops": args.session_ops,
        "session_appends": args.session_appends,
        "session_workers": args.session_workers,
        "find_capacity": args.find_capacity,
        "device": args.device,
    })
    print(json.dumps(report, default=str))
    if report.get("error"):
        return 2
    return 0 if passes(report) else 1


def passes(report: Dict[str, Any]) -> bool:
    """The exit rule: at least one completion, every verdict equal to
    its ground truth, the sessions' gate (every close verdict right, no
    valid stream flagged, no transport error, an enforced tenant cap)
    and the latency cross-check."""
    ok = (report.get("completed", 0) > 0
          and report.get("verdict_mismatches", 0) == 0)
    # session gate: every close verdict equals its stream's ground
    # truth, no valid stream was ever flagged mid-run, no transport
    # errors — the streaming protocol's correctness bar
    sess = report.get("sessions")
    if sess is not None:
        if (sess.get("verdict_mismatches", 0)
                or sess.get("false_alarms", 0)
                or sess.get("errors", 0)
                or sess.get("appends", 0) == 0):
            ok = False
        # per-tenant cap: when the daemon advertises a probe-able
        # cap, the 429/tenant-cap refusal must actually fire
        cp = sess.get("tenant_cap_probe")
        if cp is not None and not cp.get("enforced"):
            ok = False
    # the histogram cross-check catches clock/stamping bugs: loadgen's
    # client-measured quantiles and the daemon's histogram-derived
    # ones must agree (>15% past the poll-resolution slack is a bug)
    xc = report.get("latency_crosscheck")
    if xc is not None and xc.get("ok") is False:
        ok = False
    return ok

if __name__ == "__main__":
    sys.exit(main())

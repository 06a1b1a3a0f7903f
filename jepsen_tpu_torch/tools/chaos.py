"""Self-nemesis chaos harness: Jepsen's discipline pointed at the
port's own check daemon.

Starts a REAL ``python -m jepsen_tpu_torch check-serve`` subprocess on
``--device`` (the card unless ``--device cpu`` is given), armed with a
seeded fault schedule (:mod:`jepsen_tpu_torch.serve.faults`, passed as
``--faults``), drives known-ground-truth load at it over real HTTP,
SIGKILLs the process mid-load, restarts it on the same store root, and
asserts the invariants we demand of etcd on ourselves:

1. **No lost acknowledgements.** Every request that got its 202 — in
   particular those queued/in-flight at the SIGKILL — reaches a
   terminal state after the journal replay, under its original id.
2. **No divergent verdicts.** Every ``done`` verdict equals the
   known ground truth AND the standalone facade differential
   recomputed in this process on the same device (witness op included
   for violations) — through injected dispatch crashes, device
   outages, persist failures, clock jumps, bisect retries, and
   degraded host-side serving.
3. **No silent faults.** Every injected fault type that fired shows
   up in the obs ledger (``serve.fault.*`` counters) WITH its
   visible consequence (``serve.retry.*``, ``serve.quarantined``,
   breaker transitions, ``serve-persist`` fallback) — and every
   scheduled core fault actually fired.
4. **Poison isolation.** The request from the poison tenant (its
   dispatch crashes every route) is quarantined with a structured
   500 while every co-tenant of its coalesced groups completes.
5. **Recovery.** The journal fully drains (no pending entries on
   disk, ``/healthz`` agrees) and the daemon ends non-degraded
   (breaker closed) — and the report carries the measured
   recovery-time-to-first-verdict across the kill.

The injected ``device`` point is an ``InjectedFault``, which feeds the
breaker; a real CUDA error ends its group ``device-fault`` and the
daemon exits 1, which this harness reports as a violation (a daemon
that dies before its kill, or never starts, fails the run).

Usage::

    python -m jepsen_tpu_torch.tools.chaos --quick     # one dispatch
                                         # fault + one SIGKILL/restart
    python -m jepsen_tpu_torch.tools.chaos --seed 7    # full gauntlet:
                                         # dispatch, device outage
                                         # (breaker), persist,
                                         # clock jump, poison, SIGKILL
    python -m jepsen_tpu_torch.tools.chaos --fleet --quick --device cpu

Exit 0 iff every invariant held. The JSON report goes to stdout.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

# one JSON-over-HTTP client for the tools: the loadgen's helpers keep
# structured error bodies (the quarantined 500) and classify transport
# failures as code -1
from jepsen_tpu_torch.tools import loadgen as _lg

# the directory that holds the package: the daemons' working directory
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_TERMINAL = ("done", "timeout", "cancelled", "quarantined")

_get = _lg._get


def _post(url: str, payload: Dict) -> Tuple[int, Dict]:
    return _lg._post(url, json.dumps(payload).encode())


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# -- daemon process management -------------------------------------------

class DaemonProc:
    def __init__(self, store_root: str, *, faults: str = "",
                 log_path: str, breaker_threshold: int = 3,
                 breaker_cooldown: float = 1.0,
                 group: int = 8, device: Optional[str] = None,
                 extra_args: Optional[List[str]] = None) -> None:
        self.port = _free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.log = open(log_path, "ab")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch", "check-serve",
             "--port", str(self.port), "--store-root", store_root,
             "--group", str(group),
             "--breaker-threshold", str(breaker_threshold),
             "--breaker-cooldown", str(breaker_cooldown)]
            + (["--faults", faults] if faults else [])
            + (["--device", device] if device else [])
            + list(extra_args or []),
            cwd=REPO, stdout=self.log, stderr=self.log)

    def ready(self, timeout: float = 120.0) -> bool:
        """Poll /healthz until the daemon answers; False at the timeout
        or as soon as the process has exited (a daemon that cannot start,
        say with no card for its device, fails the harness at once)."""
        end = time.monotonic() + timeout
        while time.monotonic() < end and self.proc.poll() is None:
            if _get(self.url, "/healthz")[0] == 200:
                return True
            time.sleep(0.2)
        return False

    def stop(self) -> None:
        """SIGKILL the process if it still runs (the harness's exits
        leave no daemon behind)."""
        if self.proc.poll() is None:
            self.sigkill()
        elif not self.log.closed:
            self.proc.wait()
            self.log.close()

    def sigkill(self) -> None:
        # the hard crash: no drain, no atexit, no flush — exactly the
        # fault the durable journal exists for
        os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait(30)
        self.log.close()

    def sigterm(self) -> int:
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(120)
        self.log.close()
        return rc


# -- workload ------------------------------------------------------------

def build_cases(*, seed: int, n: int, sizes, violation_frac: float,
                deadline_frac: float = 0.0,
                tenant_prefix: str = "chaos") -> List[Dict]:
    """Known-ground-truth payloads: each case carries its expected
    verdict and its ops (for the standalone differential)."""
    from jepsen_tpu_torch import fixtures
    cases = []
    for i in range(n):
        n_ops = sizes[i % len(sizes)]
        hist = fixtures.gen_history("cas", n_ops=n_ops, processes=3,
                                    seed=seed + i)
        expect = True
        if (i * 997 % 101) / 101.0 < violation_frac:
            hist = fixtures.corrupt(hist, seed=seed + i)
            expect = False
        payload: Dict[str, Any] = {
            "model": "cas-register",
            "tenant": f"{tenant_prefix}-{i % 3}",
            "history": [op.to_dict() for op in hist],
            "idempotency-key": f"{tenant_prefix}-key-{seed}-{i}",
        }
        if deadline_frac and (i * 31 % 17) / 17.0 < deadline_frac:
            # generous deadline: only an injected clock JUMP (not real
            # latency) can expire it
            payload["timeout-s"] = 600.0
        cases.append({"payload": payload, "expect": expect,
                      "ops": hist, "id": None, "final": None})
    return cases


def submit_cases(url: str, cases: List[Dict]) -> int:
    n = 0
    for c in cases:
        code, resp = _post(url, c["payload"])
        if code == 202:
            c["id"] = resp["id"]
            n += 1
        else:
            c["final"] = {"status": f"error-{code}", "resp": resp}
    return n


def poll_terminal(url: str, cases: List[Dict],
                  timeout: float = 300.0) -> Optional[float]:
    """Poll every admitted case to a terminal state; returns the
    monotonic instant the first ``done`` verdict was observed (the
    recovery clock's far edge), or None."""
    first_done = None
    end = time.monotonic() + timeout
    pending = [c for c in cases if c["id"] and c["final"] is None]
    while pending and time.monotonic() < end:
        for c in list(pending):
            code, st = _get(url, f"/check/{c['id']}")
            if code in (200, 500) and st.get("status") in _TERMINAL:
                c["final"] = st
                if st["status"] == "done" and first_done is None:
                    first_done = time.monotonic()
                pending.remove(c)
        time.sleep(0.1)
    return first_done


# -- the harness ---------------------------------------------------------

def run_chaos(opts: Dict[str, Any]) -> Dict[str, Any]:
    quick = bool(opts.get("quick"))
    seed = int(opts.get("seed", 7))
    keep_store = bool(opts.get("keep_store"))
    root = opts.get("store_root") or tempfile.mkdtemp(
        prefix="jepsen-chaos-")
    os.makedirs(root, exist_ok=True)
    log_path = os.path.join(root, "chaos-daemon.log")
    report: Dict[str, Any] = {"store_root": root, "seed": seed,
                              "quick": quick, "violations": []}

    def violate(msg: str) -> None:
        report["violations"].append(msg)

    # seeded fault schedule: invocation indices derived from the seed,
    # kept low so short CI runs reach them
    import random
    rng = random.Random(seed)
    if quick:
        schedule = f"dispatch@{rng.randint(2, 3)}"
        expected_faults = ["dispatch"]
        poison = False
    else:
        schedule = ";".join([
            f"dispatch@{rng.randint(2, 4)}",
            f"device@{rng.randint(5, 7)}x{opts.get('device_burst', 6)}",
            f"persist@{rng.randint(1, 3)}",
            f"clock-jump@{rng.randint(6, 9)}:3600",
            "poison=chaos-poison",
        ])
        expected_faults = ["dispatch", "device", "persist",
                           "clock_jump", "poison"]
        poison = True
    report["fault_schedule"] = schedule

    n_wave1 = 6 if quick else 14
    wave1 = build_cases(seed=seed, n=n_wave1,
                        sizes=[8, 12] if quick else [8, 12, 16],
                        violation_frac=0.3,
                        deadline_frac=0.0 if quick else 0.25)
    poison_case = None
    if poison:
        poison_case = build_cases(seed=seed + 500, n=1, sizes=[8],
                                  violation_frac=0.0,
                                  tenant_prefix="chaos-poison")[0]
        poison_case["payload"]["tenant"] = "chaos-poison"

    # ---- phase 1: armed daemon, drive the fault gauntlet ----
    device = opts.get("device")
    d1 = DaemonProc(root, faults=schedule, log_path=log_path,
                    device=device)
    try:
        if not d1.ready():
            violate("daemon 1 never became ready")
            d1.stop()
            return report
        submit_cases(d1.url, wave1)
        if poison_case is not None:
            submit_cases(d1.url, [poison_case])
        poll_terminal(d1.url, wave1, timeout=600)
        if poison_case is not None:
            poll_terminal(d1.url, [poison_case], timeout=120)

        # keep feeding filler dispatches until every scheduled fault's
        # invocation index has been reached (bounded)
        def fault_counters() -> Dict[str, float]:
            code, stats = _get(d1.url, "/stats")
            if code != 200:
                return {}
            return {k: v for k, v in stats.get("counters", {}).items()
                    if k.startswith("serve.fault.")}
        filler_budget = 12
        while filler_budget > 0:
            fc = fault_counters()
            missing = [f for f in expected_faults
                       if fc.get(f"serve.fault.{f}", 0) < 1]
            if not missing:
                break
            filler = build_cases(seed=seed + 900 + filler_budget, n=2,
                                 sizes=[8], violation_frac=0.0,
                                 tenant_prefix="filler")
            submit_cases(d1.url, filler)
            poll_terminal(d1.url, filler, timeout=120)
            wave1.extend(filler)
            filler_budget -= 1
        report["fault_counters"] = fault_counters()
        for f in expected_faults:
            if report["fault_counters"].get(f"serve.fault.{f}", 0) < 1:
                violate(f"scheduled fault {f!r} never fired")

        # fault CONSEQUENCES must be in the ledger too (no silent
        # recovery): scrape the counters the recovery machinery bumps
        code, stats1 = _get(d1.url, "/stats")
        c1 = stats1.get("counters", {}) if code == 200 else {}
        report["pre_kill_counters"] = {
            k: v for k, v in c1.items()
            if k.startswith(("serve.retry.", "serve.quarantined",
                             "serve.breaker.", "serve.journal."))}
        if c1.get("serve.retry.attempts", 0) < 1:
            violate("dispatch fault fired but no retry was recorded")
        if not quick:
            persist_falls = [k for k in c1
                            if k.startswith("engine.fallback."
                                            "serve-persist.")]
            if not persist_falls:
                violate("persist fault fired but no serve-persist "
                        "fallback recorded")
        if poison_case is not None:
            st = poison_case["final"] or {}
            if st.get("status") != "quarantined":
                violate(f"poison member not quarantined: {st}")
            if c1.get("serve.quarantined", 0) < 1:
                violate("no serve.quarantined counter")

        # ---- long-lived streaming session: opened + partially
        # appended BEFORE the SIGKILL; it must ride the crash — same
        # id, journaled appends replayed, frontier re-derived — and
        # reach the same final verdict as the standalone facade ----
        from jepsen_tpu_torch import fixtures as _fx
        sess_hist = _fx.gen_history("cas", n_ops=72, processes=3,
                                    seed=seed + 2000)
        sess_blocks = [sess_hist[i:i + 12]
                       for i in range(0, len(sess_hist), 12)]
        n_pre = len(sess_blocks) // 2
        sess_id = None
        code, resp = _lg._post_json(d1.url, "/session",
                                    {"model": "cas-register",
                                     "tenant": "chaos-sess"})
        if code != 201:
            violate(f"session open failed: {code} {resp}")
        else:
            sess_id = resp["session"]
            for seq in range(1, n_pre + 1):
                code, r = _lg._post_json(
                    d1.url, f"/session/{sess_id}/append",
                    {"history": [op.to_dict()
                                 for op in sess_blocks[seq - 1]],
                     "seq": seq, "wait-s": 120})
                if code != 200 or r.get("valid-so-far") is not True:
                    violate(f"pre-kill session append {seq} bad: "
                            f"{code} {r}")
        report["session_id"] = sess_id
        report["session_pre_kill_appends"] = n_pre

        # ---- phase 2: wave 2 posts, then SIGKILL mid-load ----
        wave2 = build_cases(seed=seed + 1000, n=4 if quick else 8,
                            sizes=[10, 14], violation_frac=0.3,
                            tenant_prefix="wave2")
        admitted2 = submit_cases(d1.url, wave2)
        report["wave2_admitted"] = admitted2
        rc = d1.proc.poll()
        if rc is not None:
            violate(f"daemon 1 exited {rc} before the kill")
        t_kill = time.monotonic()
        d1.sigkill()
        report["killed_pid"] = d1.proc.pid
    except Exception as e:                              # noqa: BLE001
        violate(f"phase 1 crashed: {type(e).__name__}: {e}")
        try:
            d1.sigkill()
        except Exception:                               # noqa: BLE001
            pass
        return report

    # ---- phase 3: restart (no faults), journal replay recovers ----
    d2 = DaemonProc(root, log_path=log_path, device=device)
    try:
        if not d2.ready():
            violate("daemon 2 never became ready after restart")
            d2.stop()
            return report
        # a duplicate POST with a wave-2 idempotency key must dedup to
        # the ORIGINAL id (the index survived the restart via the WAL)
        dup_target = next((c for c in wave2 if c["id"]), None)
        if dup_target is not None:
            code, resp = _post(d2.url, dup_target["payload"])
            if code != 202 or resp.get("id") != dup_target["id"] \
                    or not resp.get("deduped"):
                violate(f"idempotent re-POST did not dedup to the "
                        f"original id: {code} {resp}")
            report["dedup_across_restart"] = resp
        first_done = poll_terminal(d2.url, wave2, timeout=600)
        if first_done is not None:
            report["recovery_to_first_verdict_s"] = round(
                first_done - t_kill, 3)

        # ---- the session rode the SIGKILL: same id, journaled
        # appends replayed (no lost acks), frontier re-derived;
        # post-kill appends continue the stream and close must equal
        # the standalone facade on the full concatenated history ----
        if sess_id is not None:
            code, st = _get(d2.url, f"/session/{sess_id}")
            if code != 200 or st.get("status") != "open":
                violate(f"session {sess_id} lost across restart: "
                        f"{code} {st}")
            elif int(st.get("seq", -1)) != n_pre:
                violate(f"session replay lost appends: seq "
                        f"{st.get('seq')} != {n_pre}")
            else:
                report["session_replayed_appends"] = \
                    st.get("replayed-appends")
                # a RETRIED pre-kill append (its response was lost to
                # the crash, says the client) must dedup, not
                # double-advance the frontier
                code, r = _lg._post_json(
                    d2.url, f"/session/{sess_id}/append",
                    {"history": [op.to_dict()
                                 for op in sess_blocks[n_pre - 1]],
                     "seq": n_pre})
                if code != 200 or not r.get("deduped"):
                    violate(f"retried session append did not dedup: "
                            f"{code} {r}")
                for seq in range(n_pre + 1, len(sess_blocks) + 1):
                    code, r = _lg._post_json(
                        d2.url, f"/session/{sess_id}/append",
                        {"history": [op.to_dict() for op in
                                     sess_blocks[seq - 1]],
                         "seq": seq, "wait-s": 120})
                    if code != 200 \
                            or r.get("valid-so-far") is not True:
                        violate(f"post-kill session append {seq} "
                                f"bad: {code} {r}")
                code, r = _lg._post_json(
                    d2.url, f"/session/{sess_id}/close", {})
                sres = (r.get("result") or {}) if code == 200 else {}
                report["session_close"] = {
                    "valid": sres.get("valid"),
                    "engine": sres.get("engine"),
                    "incremental": sres.get("incremental")}
                if code != 200 or sres.get("valid") is not True:
                    violate(f"session close verdict wrong: "
                            f"{code} {r}")
                else:
                    from jepsen_tpu_torch import history as _h
                    from jepsen_tpu_torch import models as _models
                    from jepsen_tpu_torch.checkers import facade as _facade
                    stand = _facade.auto_check_packed(
                        _models.cas_register(), _h.pack(sess_hist),
                        {"device": device})
                    if stand["valid"] is not sres.get("valid"):
                        violate("session close diverges from the "
                                "standalone facade")

        # invariant 1: every 202 reached a terminal state
        for c in wave1 + wave2 + ([poison_case] if poison_case
                                  else []):
            if c["id"] and (c["final"] is None
                            or c["final"].get("status")
                            not in _TERMINAL):
                violate(f"request {c['id']} never reached a terminal "
                        f"state: {c['final']}")

        # invariant 2: verdicts equal ground truth AND the standalone
        # facade differential (bit-identical valid + witness op)
        from jepsen_tpu_torch import history as h
        from jepsen_tpu_torch import models
        from jepsen_tpu_torch.checkers import facade
        mismatches = 0
        for c in wave1 + wave2:
            st = c["final"] or {}
            if st.get("status") != "done":
                continue
            valid = (st.get("result") or {}).get("valid")
            if valid is not c["expect"]:
                mismatches += 1
                violate(f"verdict mismatch for {c['id']}: got "
                        f"{valid!r}, ground truth {c['expect']!r}")
                continue
            stand = facade.auto_check_packed(
                models.cas_register(), h.pack(c["ops"]),
                {"device": device})
            if stand["valid"] is not valid:
                mismatches += 1
                violate(f"daemon verdict diverges from standalone "
                        f"facade for {c['id']}")
            elif valid is False and \
                    st["result"].get("op") != stand.get("op"):
                mismatches += 1
                violate(f"witness op diverges for {c['id']}: "
                        f"{st['result'].get('op')} vs "
                        f"{stand.get('op')}")
        report["verdict_mismatches"] = mismatches
        report["checked_done"] = sum(
            1 for c in wave1 + wave2
            if (c["final"] or {}).get("status") == "done")

        # invariant 5: journal fully drained + non-degraded health
        code, hz = _get(d2.url, "/healthz")
        report["final_healthz"] = hz
        if code != 200 or hz.get("ok") is not True:
            violate(f"final /healthz not ok: {code} {hz}")
        if hz.get("degraded") is not False:
            violate(f"daemon still degraded after recovery: "
                    f"{hz.get('breaker')}")
        if (hz.get("journal") or {}).get("pending") != 0:
            violate(f"journal not drained: {hz.get('journal')}")
        jdir = os.path.join(root, "serve", "journal")
        pending_files = [f for f in os.listdir(jdir)
                         if f.endswith(".req.json")
                         and not os.path.exists(os.path.join(
                             jdir, f[:-len(".req.json")]
                             + ".done.json"))]
        if pending_files:
            violate(f"pending journal entries on disk: "
                    f"{pending_files}")
        rc = d2.sigterm()
        if rc != 0:
            violate(f"daemon 2 SIGTERM exit code {rc}")
    except Exception as e:                              # noqa: BLE001
        violate(f"phase 3 crashed: {type(e).__name__}: {e}")
        try:
            d2.sigkill()
        except Exception:                               # noqa: BLE001
            pass

    report["ok"] = not report["violations"]
    if not keep_store and report["ok"] and not opts.get("store_root"):
        shutil.rmtree(root, ignore_errors=True)
        report["store_root"] = None
    return report


# -- the fleet harness ---------------------------------------------------

def run_fleet(opts: Dict[str, Any]) -> Dict[str, Any]:
    """N-replica fleet over ONE store root: SIGKILL a replica
    mid-load and assert its leased work drains through the survivors.

    Gates (the fleet analogues of the single-daemon invariants):

    1. Every 202 — including those leased to the victim at the kill —
       reaches a terminal state via a SURVIVOR, with verdicts equal
       to ground truth and the standalone facade.
    2. Lease failover is visible: any entry the victim held at the
       kill shows up in survivor counters as expired+stolen.
    3. No double-dispatch: every terminal response is STABLE and
       bit-identical from every surviving replica (a second dispatch
       with a divergent outcome would flip one of them).
    4. Cross-replica idempotency: a duplicate POST to a *different*
       replica dedups to the original id through the shared journal.
    5. A streaming session pinned to the victim is adopted by a
       survivor after lease expiry and closes with the exact
       standalone-facade verdict.
    """
    quick = bool(opts.get("quick"))
    seed = int(opts.get("seed", 7))
    n_replicas = max(2, int(opts.get("replicas", 2)))
    keep_store = bool(opts.get("keep_store"))
    lease_ttl = 1.5
    root = opts.get("store_root") or tempfile.mkdtemp(
        prefix="jepsen-fleet-")
    os.makedirs(root, exist_ok=True)
    report: Dict[str, Any] = {"store_root": root, "seed": seed,
                              "quick": quick, "replicas": n_replicas,
                              "lease_ttl_s": lease_ttl,
                              "violations": []}

    def violate(msg: str) -> None:
        report["violations"].append(msg)

    device = opts.get("device")
    procs: List[DaemonProc] = []
    for i in range(n_replicas):
        procs.append(DaemonProc(
            root, log_path=os.path.join(root, f"fleet-r{i}.log"),
            device=device,
            extra_args=["--replica-id", f"r{i}",
                        "--lease-ttl", str(lease_ttl),
                        "--lanes", "2"]))
    urls = [p.url for p in procs]
    report["urls"] = urls
    victim, survivors = procs[0], procs[1:]

    def _stats(url: str) -> Dict[str, float]:
        code, st = _get(url, "/stats")
        return st.get("counters", {}) if code == 200 else {}

    try:
        for p in procs:
            if not p.ready():
                violate(f"replica {p.url} never became ready")
                for q in procs:
                    q.stop()
                return report

        # ---- wave 1: round-robin across every replica ----
        wave1 = build_cases(seed=seed, n=8 if quick else 16,
                            sizes=[8, 12] if quick else [8, 12, 16],
                            violation_frac=0.3, tenant_prefix="fleet")
        for i, c in enumerate(wave1):
            submit_cases(urls[i % len(urls)], [c])

        # gate 4: duplicate POST to a DIFFERENT replica than the one
        # that admitted it must dedup to the original id (the shared
        # journal index is the source of truth, not process memory)
        dup = next((c for c in wave1 if c["id"]), None)
        if dup is not None:
            code, resp = _post(urls[1], dup["payload"])
            if code not in (200, 202) or resp.get("id") != dup["id"] \
                    or not resp.get("deduped"):
                violate(f"cross-replica re-POST did not dedup to the "
                        f"original id: {code} {resp}")
            report["cross_replica_dedup"] = resp

        # every replica answers GET /check/<id> for every id (done
        # markers + journal are shared) — poll wave 1 via replica 1
        poll_terminal(urls[1], wave1, timeout=600)

        # ---- streaming session PINNED to the victim ----
        from jepsen_tpu_torch import fixtures as _fx
        sess_hist = _fx.gen_history("cas", n_ops=36 if quick else 72,
                                    processes=3, seed=seed + 2000)
        blk = 12
        sess_blocks = [sess_hist[i:i + blk]
                       for i in range(0, len(sess_hist), blk)]
        sess_id = None
        code, resp = _lg._post_json(victim.url, "/session",
                                    {"model": "cas-register",
                                     "tenant": "fleet-sess"})
        if code != 201:
            violate(f"session open on victim failed: {code} {resp}")
        else:
            sess_id = resp["session"]
            if resp.get("pinned-to") != "r0":
                violate(f"session not pinned to its opener: {resp}")
            code, r = _lg._post_json(
                victim.url, f"/session/{sess_id}/append",
                {"history": [op.to_dict() for op in sess_blocks[0]],
                 "seq": 1, "wait-s": 120})
            if code != 200 or r.get("valid-so-far") is not True:
                violate(f"pre-kill session append bad: {code} {r}")

        # ---- kill wave: submitted to the VICTIM, then SIGKILL
        # before it can finish — this is the leased work that must
        # drain through the survivors ----
        kill_wave = build_cases(seed=seed + 1000,
                                n=6 if quick else 10,
                                sizes=[12, 16], violation_frac=0.3,
                                tenant_prefix="kill")
        submit_cases(victim.url, kill_wave)
        rc = victim.proc.poll()
        if rc is not None:
            violate(f"replica r0 exited {rc} before the kill")
        t_kill = time.monotonic()
        victim.sigkill()
        report["killed"] = "r0"

        # the victim is dead, so its on-disk lease state is frozen
        # until the TTL: count the entries it still held
        jdir = os.path.join(root, "serve", "journal")
        victim_pending = []
        for f in os.listdir(jdir):
            if not f.endswith(".lease.json"):
                continue
            eid = f[:-len(".lease.json")]
            if os.path.exists(os.path.join(jdir,
                                           eid + ".done.json")):
                continue
            try:
                with open(os.path.join(jdir, f)) as fh:
                    holder = json.load(fh).get("replica")
            except (OSError, ValueError):
                continue
            if holder == "r0":
                victim_pending.append(eid)
        report["victim_pending_at_kill"] = len(victim_pending)

        # ---- gate 1: everything drains through the survivors ----
        first_done = poll_terminal(urls[1], kill_wave, timeout=600)
        if first_done is not None:
            report["failover_to_first_verdict_s"] = round(
                first_done - t_kill, 3)
        for c in wave1 + kill_wave:
            if c["id"] and (c["final"] is None
                            or c["final"].get("status")
                            not in _TERMINAL):
                violate(f"request {c['id']} never drained through "
                        f"the survivors: {c['final']}")

        # gate 2: if the victim held leases at the kill, the
        # survivors must have visibly expired + stolen them
        if victim_pending:
            stolen = sum(_stats(u).get("serve.lease.stolen", 0)
                         for u in urls[1:])
            if stolen < 1:
                violate(f"victim held {len(victim_pending)} leases "
                        f"but no survivor recorded a steal")
            report["leases_stolen"] = stolen

        # verdicts: ground truth + standalone facade differential
        from jepsen_tpu_torch import history as h
        from jepsen_tpu_torch import models
        from jepsen_tpu_torch.checkers import facade
        mismatches = 0
        for c in wave1 + kill_wave:
            st = c["final"] or {}
            if st.get("status") != "done":
                continue
            valid = (st.get("result") or {}).get("valid")
            if valid is not c["expect"]:
                mismatches += 1
                violate(f"verdict mismatch for {c['id']}: got "
                        f"{valid!r}, ground truth {c['expect']!r}")
                continue
            stand = facade.auto_check_packed(
                models.cas_register(), h.pack(c["ops"]),
                {"device": device})
            if stand["valid"] is not valid:
                mismatches += 1
                violate(f"fleet verdict diverges from standalone "
                        f"facade for {c['id']}")
            elif valid is False and \
                    st["result"].get("op") != stand.get("op"):
                mismatches += 1
                violate(f"witness op diverges for {c['id']}")
        report["verdict_mismatches"] = mismatches
        report["checked_done"] = sum(
            1 for c in wave1 + kill_wave
            if (c["final"] or {}).get("status") == "done")

        # gate 3: terminal responses are stable and identical from
        # EVERY surviving replica (double-dispatch with a divergent
        # outcome would flip one of these)
        for c in wave1 + kill_wave:
            if not c["id"] or (c["final"] or {}).get("status") \
                    not in _TERMINAL:
                continue
            for u in urls[1:]:
                code, st = _get(u, f"/check/{c['id']}")
                if st.get("status") != c["final"].get("status") or \
                        (st.get("result") or {}).get("valid") != \
                        (c["final"].get("result") or {}).get("valid"):
                    violate(f"terminal response for {c['id']} not "
                            f"identical across replicas: "
                            f"{st} vs {c['final']}")

        # ---- gate 5: the victim's session is adopted by a survivor
        # after lease expiry and closes with the facade verdict ----
        if sess_id is not None:
            surv = urls[1]
            adopted = False
            end = time.monotonic() + max(20.0, 6 * lease_ttl)
            for seq in range(2, len(sess_blocks) + 1):
                while True:
                    code, r = _lg._post_json(
                        surv, f"/session/{sess_id}/append",
                        {"history": [op.to_dict()
                                     for op in sess_blocks[seq - 1]],
                         "seq": seq, "wait-s": 120})
                    if code == 409 and r.get("cause") == \
                            "session-pinned":
                        # still leased to the dead victim — wait out
                        # the TTL, the survivor will adopt
                        if time.monotonic() > end:
                            violate(f"session never adopted: {r}")
                            break
                        time.sleep(0.3)
                        continue
                    break
                if code != 200 or r.get("valid-so-far") is not True:
                    violate(f"post-kill session append {seq} bad: "
                            f"{code} {r}")
                    break
                adopted = True
            if adopted:
                # adoption is counted on whichever path got there
                # first: the append handler (serve.session.adopted)
                # or the background fleet scan (serve.session.replayed
                # after a lease steal) — either way the takeover must
                # be in the ledger
                scount = _stats(surv)
                if scount.get("serve.session.adopted", 0) < 1 and \
                        scount.get("serve.session.replayed", 0) < 1:
                    violate("session continued on a survivor but no "
                            "adoption/replay was ever counted")
                code, r = _lg._post_json(
                    surv, f"/session/{sess_id}/close", {})
                sres = (r.get("result") or {}) if code == 200 else {}
                report["session_close"] = {
                    "valid": sres.get("valid"),
                    "incremental": sres.get("incremental")}
                stand = facade.auto_check_packed(
                    models.cas_register(), h.pack(sess_hist),
                    {"device": device})
                if code != 200 or \
                        sres.get("valid") is not stand["valid"]:
                    violate(f"adopted session close diverges from "
                            f"the standalone facade: {code} {r}")

        # survivors end healthy, drained, and exit clean
        for i, p in enumerate(survivors, start=1):
            code, hz = _get(p.url, "/healthz")
            if code != 200 or hz.get("ok") is not True:
                violate(f"replica r{i} final /healthz not ok: "
                        f"{code} {hz}")
            if hz.get("degraded") is not False:
                violate(f"replica r{i} degraded after failover")
        pending_files = [f for f in os.listdir(jdir)
                         if f.endswith(".req.json")
                         and not os.path.exists(os.path.join(
                             jdir, f[:-len(".req.json")]
                             + ".done.json"))]
        if pending_files:
            violate(f"pending journal entries on disk: "
                    f"{pending_files}")
        for i, p in enumerate(survivors, start=1):
            rc = p.sigterm()
            if rc != 0:
                violate(f"replica r{i} SIGTERM exit code {rc}")
    except Exception as e:                              # noqa: BLE001
        violate(f"fleet harness crashed: {type(e).__name__}: {e}")
        for p in procs:
            try:
                if p.proc.poll() is None:
                    p.sigkill()
            except Exception:                           # noqa: BLE001
                pass

    report["ok"] = not report["violations"]
    if not keep_store and report["ok"] and not opts.get("store_root"):
        shutil.rmtree(root, ignore_errors=True)
        report["store_root"] = None
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="self-nemesis chaos harness for the port's "
                    "check-serve daemon (seeded faults + SIGKILL/"
                    "restart)")
    ap.add_argument("--quick", action="store_true",
                    help="short run: one dispatch fault + one "
                         "SIGKILL/restart")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--fleet", action="store_true",
                    help="N-replica fleet over one store root: "
                         "SIGKILL one replica mid-load, gate on "
                         "lease failover through the survivors")
    ap.add_argument("--replicas", type=int, default=2,
                    help="fleet size for --fleet (default 2)")
    ap.add_argument("--store-root", default=None,
                    help="use (and keep) this store root instead of "
                         "a temp dir")
    ap.add_argument("--keep-store", action="store_true",
                    help="keep the temp store root for inspection")
    ap.add_argument("--device", default=None,
                    help="device of the daemons and of the in-process "
                         "differential: the card by default; 'cpu' "
                         "runs the plain versions")
    args = ap.parse_args(argv)
    opts = {"quick": args.quick, "seed": args.seed,
            "store_root": args.store_root,
            "keep_store": args.keep_store,
            "replicas": args.replicas, "device": args.device}
    report = run_fleet(opts) if args.fleet else run_chaos(opts)
    print(json.dumps(report, indent=2, default=str))
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())

"""The check daemon's wire protocol on the stdlib ``ThreadingHTTPServer``,
and :class:`Daemon`, which composes the serving layer (a port of the
reference package's ``jepsen_tpu/serve/http.py``; the protocol is
``docs/SERVING.md``'s):

- ``POST /check`` — submit a history, JSON (or ``Content-Type:
  application/edn``, the same map in EDN)::

      {"model": "cas-register",
       "history": [{"process": 0, "type": "invoke", "f": "read"}, ...],
       "tenant": "team-a",                 # or the X-Tenant header
       "timeout-s": 30.0,                  # optional deadline
       "idempotency-key": "job-17",        # duplicate POSTs answer the
                                           # first request's id
       "options": {"max_states": 100000}}  # engine options, allow-listed

  ``202 {"id", "status": "queued"}``; 400 on a malformed body, 413 past
  the body bound, 429 with ``Retry-After`` under backpressure, 503 while
  shutting down.
- ``GET /check/<id>`` — status, and once terminal the verdict (witness
  included), the stage ``waterfall``, the stitched ``trace`` and the
  attributed ``device-s``. A quarantined request or one that ended on a
  fault (status ``error``) answers 500. A verdict published before a
  restart answers from the journal. ``DELETE /check/<id>`` cancels a
  queued request (200), flags a dispatched one (200), 404 for an unknown
  id, 409 for a terminal one.
- ``GET /stats``, ``GET /metrics`` (Prometheus text), ``GET /healthz``
  (503 once a device fault was seen, naming it), ``POST /profile``
  (``{"dispatches": N}`` arms ``torch.profiler`` around the next N
  dispatches; the capture lands under ``<store-root>/serve/``).
- ``POST /session`` opens a streaming check session (``{"model",
  "tenant", "options"}``: 201 with its id; 429 past the open-session
  bound or the tenant's cap, cause ``tenant-cap``); ``POST
  /session/<id>/append`` ships one block (``{"history", "seq",
  "wait-s"}``) and answers its incremental verdict (200; 202 with a
  request id past ``wait-s``; 409 for a closed session or a seq gap; a
  retried seq dedups); ``POST /session/<id>/close`` answers the exact
  verdict of the whole history; ``GET /session/<id>`` is the status. An
  open and every append are journaled before their answer, so a session
  rides a restart with its id, its seq and its verdict; a session idle
  past ``session_idle_ttl_s`` is closed by the sweeper. A session a
  device fault ended answers ``status: "error"`` (its block 500).

Fleet mode (``replica_id=``): several daemons share one journal; each
admitted request carries a lease, a replica dispatches only what it
holds, and a background scan renews its leases and adopts entries whose
holder stopped renewing. Any replica answers ``GET /check/<id>`` from
the shared journal, and duplicate POSTs dedup across replicas.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import edn
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.op import Op
from jepsen_tpu_torch.serve import faults as _faults
from jepsen_tpu_torch.serve import recovery
from jepsen_tpu_torch.serve import journal as jr
from jepsen_tpu_torch.serve import request as rq
from jepsen_tpu_torch.serve import session as sn
from jepsen_tpu_torch.serve.coalesce import AdmissionQueue, Backpressure
from jepsen_tpu_torch.serve.engine import Dispatcher

log = logging.getLogger("jepsen.serve")

# engine options a client may set: the ones that cannot hurt co-tenants
_CLIENT_OPTS = ("max_states", "max_slots", "max_dense", "time_limit",
                "max_dense_txns", "consistency")

_MODEL_NAMES = ("register", "cas-register", "mutex", "multi-register",
                "set-model", "fifo-queue", "unordered-queue", "noop-model",
                "txn-list-append")


def _filter_opts(raw: Any, strict: bool = True) -> Dict[str, Any]:
    """The allow-listed client options, ``consistency`` canonicalised to
    its sorted levels (so every spelling of one level set coalesces).
    ``strict`` raises on an unknown level (the 400); replay drops it."""
    opts = {k: v for k, v in (raw or {}).items() if k in _CLIENT_OPTS}
    if "consistency" in opts:
        from jepsen_tpu_torch.txn import lattice
        try:
            opts["consistency"] = list(lattice.canon_levels(
                opts["consistency"]))
        except ValueError:
            if strict:
                raise
            obs.decision("serve-opts", "drop", cause="bad-consistency")
            del opts["consistency"]
    return opts


def resolve_model(name: str):
    """A model name (the command line's vocabulary) → a fresh model;
    ``txn-list-append`` is the transactional marker, whose groups go
    through ``facade.auto_check_txn``."""
    if name == "txn-list-append":
        from jepsen_tpu_torch.txn import ops as txn_ops
        return txn_ops.list_append_model()
    from jepsen_tpu_torch import models
    if name not in _MODEL_NAMES:
        raise ValueError(f"unknown model {name!r}; have {list(_MODEL_NAMES)}")
    return getattr(models, name.replace("-", "_"))()


def parse_check_body(body: bytes, content_type: str,
                     default_tenant: str = "anonymous"
                     ) -> Tuple[str, str, list, Dict[str, Any],
                                Optional[float], Optional[str]]:
    """A ``POST /check`` body → ``(tenant, model_name, ops, options,
    timeout_s, idempotency_key)``. Raises ValueError on malformed
    input."""
    text = body.decode("utf-8")
    if "edn" in (content_type or ""):
        vals = edn.loads_all(text)
        if len(vals) != 1:
            raise ValueError("expected one EDN map")
        data = edn.to_plain(vals[0])
    else:
        data = json.loads(text)
    if not isinstance(data, dict):
        raise ValueError("body must be a map")
    raw_hist = data.get("history")
    if not isinstance(raw_hist, list) or not raw_hist:
        raise ValueError("'history' must be a non-empty list of ops")
    ops = [Op.from_dict(d if isinstance(d, dict) else edn.to_plain(d))
           for d in raw_hist]
    if ops[0].index < 0:
        ops = h.index(ops)
    model_name = str(data.get("model", "cas-register"))
    # tenant names key bounded state: their length is capped here, their
    # number in the registry
    tenant = str(data.get("tenant") or default_tenant)[:64]
    options = _filter_opts(data.get("options"))
    timeout_s = data.get("timeout-s", data.get("timeout_s"))
    if timeout_s is not None:
        timeout_s = float(timeout_s)
        if timeout_s <= 0:
            raise ValueError("'timeout-s' must be positive")
    idem = data.get("idempotency-key", data.get("idempotency_key"))
    idem = str(idem)[:128] if idem is not None else None
    return tenant, model_name, ops, options, timeout_s, idem


class _Server(ThreadingHTTPServer):
    """A listen backlog for bursts: the default 5 resets connects the
    accept loop has not reached yet. Admission still bounds the work."""
    request_queue_size = 128


class Daemon:
    """The serving layer: registry, admission queue, dispatcher lanes,
    journal and HTTP server. ``device`` names where the checks run: the
    card unless the caller names the CPU; it is resolved before the port
    is bound, so without a card the constructor raises and binds
    nothing. ``start()`` returns once the socket listens;
    ``shutdown()`` stops admitting, drains and stops the lanes. Binds
    loopback by default: the endpoint accepts work.

    ``pipeline_k`` is the lanes' staged window (default
    :data:`dispatch_core.SERVE_PIPE_K`, 1 never stages; above 1 a mega
    group's next wave is stamped while K10 walks this one); ``faults``
    arms the self-nemesis (the grammar of :func:`.faults.arm_spec`).
    ``session_tenant_cap`` bounds a tenant's open sessions (0: no cap),
    ``session_idle_ttl_s`` closes sessions idle that long (None: never),
    and ``session_device=False`` sends every register-family session to
    the host monitor (the reference's ``JEPSEN_TPU_NO_SESSION_DEVICE``)."""

    def __init__(self, *, port: int = 8642, host: str = "127.0.0.1",
                 queue_depth: int = 256, max_inflight_per_tenant: int = 8,
                 group: int = 32, engine_kw: Optional[Dict[str, Any]] = None,
                 store_root: Optional[str] = None, persist: bool = False,
                 max_body_bytes: int = 32 << 20, journal: bool = True,
                 journal_keep_terminal: int = 256,
                 retry_policy: Optional[recovery.RetryPolicy] = None,
                 breaker: Optional[recovery.CircuitBreaker] = None,
                 dispatch_deadline_s: Optional[float] = None,
                 lanes: int = 1, replica_id: Optional[str] = None,
                 lease_ttl_s: float = 10.0, device=None,
                 pipeline_k: Optional[int] = None,
                 faults: Optional[str] = None,
                 session_tenant_cap: int = 64,
                 session_idle_ttl_s: Optional[float] = 3600.0,
                 session_device: bool = True) -> None:
        self.device = _device.resolve(device)
        # the queue bounds the request count, this the bytes of one
        self.max_body_bytes = int(max_body_bytes)
        if faults:
            _faults.arm_spec(faults)
        self.registry = rq.Registry()
        self.queue = AdmissionQueue(
            max_depth=queue_depth,
            max_inflight_per_tenant=max_inflight_per_tenant,
            group=group, lanes=lanes)
        self.journal: Optional[jr.Journal] = None
        if journal and store_root is not None:
            from jepsen_tpu_torch import store
            self.journal = jr.Journal(store.serve_journal_dir(store_root),
                                      keep_terminal=journal_keep_terminal)
        self.replica_id = str(replica_id) if replica_id else None
        self.lease_ttl_s = float(lease_ttl_s)
        self.fleet = self.replica_id is not None and self.journal is not None
        self._fleet_stop = threading.Event()
        self._fleet_thread: Optional[threading.Thread] = None
        # (tenant, idempotency key) -> request id: bounded, seeded from
        # the journal so dedup survives restarts, per tenant. _admitting
        # holds the ids whose admission is in flight on some HTTP thread.
        self._idem_lock = threading.Lock()
        self._idem: "OrderedDict[Any, str]" = OrderedDict()
        self._admitting: set = set()
        if self.journal is not None:
            self._idem.update(self.journal.idempotency_index())
        ekw = dict(engine_kw or {})
        ekw["device"] = self.device
        self.dispatcher = Dispatcher(
            self.queue, self.registry, engine_kw=ekw, store_root=store_root,
            persist=persist, retry_policy=retry_policy, breaker=breaker,
            dispatch_deadline_s=dispatch_deadline_s, journal=self.journal,
            lanes=lanes, pipeline_k=pipeline_k)
        # streaming sessions: their registry (the tenant cap, the idle
        # clock the sweeper reads) and where their engines run
        self.session_device = bool(session_device)
        self.sessions = sn.SessionRegistry(
            tenant_max_open=session_tenant_cap,
            idle_ttl_s=session_idle_ttl_s)
        self.dispatcher.sessions = self.sessions
        self._sweeper: Optional[threading.Thread] = None
        self._sweeper_stop = threading.Event()
        if self.journal is not None:
            jnl = self.journal

            def _on_terminal(req: "rq.CheckRequest") -> None:
                # every terminal transition marks its entry, so a restart
                # never resurrects finished or cancelled work
                jnl.finish(req.id, req.status, req.result)
                if self.fleet:
                    jnl.release(req.id, self.replica_id)

            self.registry.on_terminal = _on_terminal
        handler = type("Handler", (_Handler,), {"daemon_ref": self})
        self.httpd = _Server((host, port), handler)
        self._serve_thread: Optional[threading.Thread] = None
        self.accepting = True

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self, *, dispatch: bool = True) -> "Daemon":
        """Start the lanes (after building the kernels), replay the
        journal, start the fleet scan, then serve. ``dispatch=False``
        serves HTTP alone: admission runs, nothing dispatches."""
        if dispatch:
            self.dispatcher.start()
            self.replay_journal()
            self.replay_sessions()
            self._start_sweeper()
            self._start_fleet_scan()
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, name="serve-http", daemon=True)
        self._serve_thread.start()
        return self

    def shutdown(self, drain_timeout: float = 30.0) -> bool:
        self.accepting = False
        self._fleet_stop.set()
        self._sweeper_stop.set()
        if self._fleet_thread is not None:
            self._fleet_thread.join(5.0)
        if self._sweeper is not None:
            self._sweeper.join(5.0)
        drained = self.dispatcher.drain(timeout=drain_timeout)
        self.dispatcher.stop()
        if self._serve_thread is not None:
            # shutdown() handshakes with the serve loop: only when one ran
            self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(5.0)
        self.dispatcher._write_stats_file()
        return drained

    # -- journal replay --------------------------------------------------------
    def replay_journal(self) -> int:
        """Admit the journal's unfinished entries again under their own
        ids. A deadline is re-derived from the wall clock; a corrupt entry
        is quarantined (marked terminal), never looped on. Returns how
        many replayed."""
        if self.journal is None:
            return 0
        n = 0
        for rid in self.journal.pending_ids():
            if self.registry.get(rid) is not None:
                # live here already: in fleet mode the claim renews
                if self.fleet:
                    self.journal.claim(rid, replica=self.replica_id,
                                       ttl_s=self.lease_ttl_s)
                continue
            if self.fleet and not self.journal.claim(
                    rid, replica=self.replica_id, ttl_s=self.lease_ttl_s):
                continue            # a sibling's live lease
            entry = self.journal.load_entry(rid)
            try:
                if entry is None:
                    raise ValueError("unreadable journal entry")
                ops = jr.history_from_edn(entry["history-edn"])
                if not ops:
                    raise ValueError("empty journaled history")
                if ops[0].index < 0:
                    ops = h.index(ops)
                model = resolve_model(str(entry["model"]))
                packed = h.pack(ops)
            except Exception as e:                      # noqa: BLE001
                log.warning("journal entry %s unreplayable: %s", rid, e)
                obs.engine_fallback("serve-journal", type(e).__name__,
                                    id=rid, replay=True)
                self.journal.finish(
                    rid, rq.QUARANTINED,
                    {"valid": "unknown", "quarantined": True,
                     "cause": "journal-corrupt",
                     "error": f"{type(e).__name__}: {e}"})
                continue
            deadline = None
            timeout_s = entry.get("timeout-s")
            if timeout_s:
                elapsed = time.time() - float(entry.get("submitted-at")
                                              or time.time())
                deadline = time.monotonic() + max(0.0, float(timeout_s)
                                                  - elapsed)
            req = rq.CheckRequest(
                id=rid, tenant=str(entry.get("tenant") or "anonymous"),
                model_name=str(entry["model"]), model=model, packed=packed,
                history=ops, n_ops=int(packed.n),
                opts=_filter_opts(entry.get("options"), strict=False),
                deadline=deadline, idem_key=entry.get("idempotency-key"),
                journaled=True)
            self.registry.add(req)
            # past the bound: this work was admitted before
            self.queue.submit(req, force=True)
            self.registry.ledger_record(req.tenant, "replayed", id=rid,
                                        ops=int(packed.n))
            obs.count("serve.journal.replayed")
            n += 1
        if n:
            log.info("journal replay: %d request(s) readmitted", n)
        return n

    def _start_fleet_scan(self) -> None:
        """Fleet mode: every ``lease_ttl_s / 3`` replay again, which
        renews this replica's leases and steals expired ones (a killed
        sibling's work drains here)."""
        if not self.fleet or self._fleet_thread is not None:
            return
        interval = max(0.2, self.lease_ttl_s / 3.0)

        def _scan_loop() -> None:
            while not self._fleet_stop.wait(interval):
                try:
                    self.fleet_scan()
                except Exception:                       # noqa: BLE001
                    # the next tick retries; a lease it missed expires
                    # and is claimable, never lost
                    log.exception("fleet scan failed")

        self._fleet_thread = threading.Thread(
            target=_scan_loop, name="serve-fleet-scan", daemon=True)
        self._fleet_thread.start()

    def fleet_scan(self) -> int:
        """One renew-and-adopt pass; returns the requests and sessions
        adopted."""
        return self.replay_journal() + self.replay_sessions()

    # -- sessions: replay and the idle sweeper -----------------------------------
    def _new_session(self, sid: str, tenant: str, model_name: str, model,
                     opts: Dict[str, Any]) -> "sn.Session":
        return sn.Session(sid, tenant, model_name, model, opts,
                          device=self.device, use_device=self.session_device)

    def replay_sessions(self) -> int:
        """Make every journaled open session live again, its blocks
        replayed in seq order through the engine (the carried state is
        derived again from the stream: the session keeps its id, its seq
        and its verdict). Corrupt metadata gets a close marker, never a
        loop. Returns how many came back."""
        if self.journal is None:
            return 0
        n = 0
        for sid in self.journal.open_session_ids():
            if self.sessions.get(sid) is not None:
                # live here: in fleet mode the claim renews its pin
                if self.fleet:
                    self.journal.claim(sid, replica=self.replica_id,
                                       ttl_s=self.lease_ttl_s)
                continue
            if self.fleet and not self.journal.claim(
                    sid, replica=self.replica_id, ttl_s=self.lease_ttl_s):
                continue            # pinned to a live sibling
            if self._replay_one_session(sid):
                n += 1
        if n:
            log.info("session replay: %d session(s) derived again", n)
        return n

    def _replay_one_session(self, sid: str) -> bool:
        """Rebuild one journaled session through the engine (the boot's
        replay and a fleet adoption both come here). Whether a live
        session came out of it."""
        meta = self.journal.load_session(sid)
        try:
            if meta is None:
                raise ValueError("unreadable session entry")
            model_name = str(meta["model"])
            model = resolve_model(model_name)
            opts = _filter_opts(meta.get("options"), strict=False)
        except Exception as e:                          # noqa: BLE001
            log.warning("session %s unreplayable: %s", sid, e)
            obs.engine_fallback("serve-journal", type(e).__name__,
                                session=sid, replay=True)
            self.journal.session_close_marker(
                sid, {"valid": "unknown", "cause": "session-journal-corrupt",
                      "error": f"{type(e).__name__}: {e}"})
            return False
        sess = self._new_session(sid, str(meta.get("tenant") or "anonymous"),
                                 model_name, model, opts)
        blocks = self.journal.session_appends(sid)
        for seq, entry in blocks:
            if seq != sess.seq + 1:
                # a gap (a missing or torn block, never acknowledged):
                # replay stops here, and the client's retry re-applies
                # from this point
                obs.engine_fallback("serve-journal", "SeqGap", session=sid,
                                    seq=seq, expected=sess.seq + 1)
                break
            try:
                ops = jr.history_from_edn(entry["history-edn"])
            except Exception as e:                      # noqa: BLE001
                obs.engine_fallback("serve-journal", type(e).__name__,
                                    session=sid, seq=seq)
                break
            sess.advance_block(ops, seq=seq)
            if sess.faulted:
                # a fault of the card in the replay ends the session as
                # it would a live append
                self.dispatcher._session_ended(sess, True)
                return False
            sess.seq = seq
            sess.replayed += 1
        # the replayed stream is activity: no sweep right after a restart
        sess.last_active_mono = time.monotonic()
        try:
            self.sessions.add(sess)
        except RuntimeError as e:
            # past the bound: it stays journaled for a later restart
            log.warning("session %s not replayed: %s", sid, e)
            obs.engine_fallback("serve-journal", "SessionBound",
                                session=sid, replay=True)
            return False
        self.registry.ledger_record(sess.tenant, "session-replayed",
                                    session=sid, appends=len(blocks))
        obs.count("serve.session.replayed")
        return True

    def _start_sweeper(self) -> None:
        """The idle sweep: an abandoned open session holds its carried
        state on the card and a slot of its tenant's cap; sessions idle
        past the TTL are closed through the ordinary close (exact
        verdict, journal marker)."""
        ttl = self.sessions.idle_ttl_s
        if not ttl or self._sweeper is not None:
            return
        interval = max(1.0, min(30.0, float(ttl) / 4.0))

        def _sweep_loop() -> None:
            while not self._sweeper_stop.wait(interval):
                try:
                    self.expire_idle_sessions()
                except Exception:                       # noqa: BLE001
                    # the next tick retries; evictions are counted
                    log.exception("idle-session sweep failed")

        self._sweeper = threading.Thread(target=_sweep_loop,
                                         name="serve-session-sweeper",
                                         daemon=True)
        self._sweeper.start()

    def expire_idle_sessions(self) -> int:
        """Close open sessions idle past the registry's TTL
        (``serve.session.evicted_idle`` each). Returns the closes
        started."""
        ttl = self.sessions.idle_ttl_s
        if not ttl:
            return 0
        n = 0
        for sess in self.sessions.idle_open(float(ttl)):
            idle_s = round(time.monotonic() - sess.last_active_mono, 3)
            obs.count("serve.session.evicted_idle")
            self.registry.ledger_record(sess.tenant, "session-evicted-idle",
                                        session=sess.id, idle_s=idle_s)
            log.info("session %s idle %.1f s > ttl %.1f s: closed", sess.id,
                     idle_s, ttl)
            code, _ = self.session_close(sess.id)
            if code in (200, 202):
                n += 1
        return n

    # -- sessions: the endpoints (HTTP threads) ------------------------------------
    @staticmethod
    def _session_map(body: bytes, content_type: str) -> Dict[str, Any]:
        text = body.decode("utf-8") if body else "{}"
        if "edn" in (content_type or ""):
            vals = edn.loads_all(text)
            if len(vals) > 1:
                raise ValueError("expected one EDN map")
            data = edn.to_plain(vals[0]) if vals else {}
        else:
            data = json.loads(text) if text.strip() else {}
        if not isinstance(data, dict):
            raise ValueError("body must be a map")
        return data

    def session_open(self, body: bytes, content_type: str,
                     header_tenant: Optional[str]) -> Tuple[int, Dict]:
        if not self.accepting:
            return 503, {"error": "shutting down"}
        try:
            data = self._session_map(body, content_type)
            model_name = str(data.get("model", "cas-register"))
            model = resolve_model(model_name)
            tenant = str(data.get("tenant") or header_tenant
                         or "anonymous")[:64]
            options = _filter_opts(data.get("options"))
        except Exception as e:                          # noqa: BLE001
            return 400, {"error": f"{type(e).__name__}: {e}"}
        sid = sn.new_session_id()
        if self.journal is not None:
            try:
                # before the id is returned: journaled appends need it
                self.journal.session_open(sid, tenant=tenant,
                                          model_name=model_name,
                                          options=options)
            except OSError as e:
                obs.engine_fallback("serve-journal", type(e).__name__,
                                    session=sid)
                return 500, {"error": f"journal write failed: {e}"}
            if self.fleet:
                # pinned before the id is returned: a sibling's scan must
                # not adopt a session whose opener is still answering
                self.journal.claim(sid, replica=self.replica_id,
                                   ttl_s=self.lease_ttl_s)
        sess = self._new_session(sid, tenant, model_name, model, options)
        try:
            self.sessions.add(sess)
        except RuntimeError as e:
            if self.journal is not None:
                self.journal.discard_session(sid)
            out = {"error": str(e), "retry-after-s": 1.0}
            if isinstance(e, sn.TenantSessionCap):
                out["cause"] = "tenant-cap"
            return 429, out
        self.registry.ledger_record(tenant, "session-opened", session=sid,
                                    model=model_name)
        out = {"session": sid, "status": "open", "tenant": tenant,
               "model": model_name, "engine": sess.engine_name}
        if self.fleet:
            out["pinned-to"] = self.replica_id
        return 201, out

    @staticmethod
    def _parse_append(body: bytes, content_type: str):
        data = Daemon._session_map(body, content_type)
        raw = data.get("history")
        if not isinstance(raw, list) or not raw:
            raise ValueError("'history' must be a non-empty list of ops")
        ops = [Op.from_dict(d if isinstance(d, dict) else edn.to_plain(d))
               for d in raw]
        seq = data.get("seq")
        seq = int(seq) if seq is not None else None
        wait_s = float(data.get("wait-s", 30.0))
        return ops, seq, wait_s

    def _adopt_session(self, sid: str) -> Tuple[Optional["sn.Session"],
                                                Optional[Tuple[int, Dict]]]:
        """Fleet mode, a session not live here: pinned to a sibling with
        a live lease (409 naming it: the carried state is that replica's),
        else claimed and derived again from the journal here. ``(session,
        None)`` or ``(None, (code, payload))``."""
        if self.fleet and self.journal.load_session(sid) is not None:
            holder = self.journal.lease_live(sid)
            if holder is not None and holder != self.replica_id:
                return None, (409, {
                    "error": f"session {sid!r} is pinned to replica "
                             f"{holder!r}",
                    "session": sid, "pinned-to": holder,
                    "cause": "session-pinned"})
            if self.journal.claim(sid, replica=self.replica_id,
                                  ttl_s=self.lease_ttl_s) \
                    and self._replay_one_session(sid):
                sess = self.sessions.get(sid)
                if sess is not None:
                    obs.count("serve.session.adopted")
                    self.registry.ledger_record(
                        sess.tenant, "session-adopted", session=sid,
                        replica=self.replica_id)
                    return sess, None
        return None, (404, {"error": f"unknown session {sid!r}"})

    def _closed_reply(self, sid: str) -> Optional[Tuple[int, Dict]]:
        term = (self.journal.session_lookup_closed(sid)
                if self.journal is not None else None)
        if term is None:
            return None
        out = {"session": sid, "status": "closed",
               "recovered-from-journal": True}
        if term.get("result") is not None:
            out["result"] = term["result"]
        return 200, out

    def session_append(self, sid: str, body: bytes,
                       content_type: str) -> Tuple[int, Dict]:
        if not self.accepting:
            return 503, {"error": "shutting down"}
        sess = self.sessions.get(sid)
        if sess is None:
            if self._closed_reply(sid) is not None:
                return 409, {"error": f"session {sid!r} is closed",
                             "session": sid, "status": "closed"}
            sess, err = self._adopt_session(sid)
            if sess is None:
                return err
        try:
            ops, seq, wait_s = self._parse_append(body, content_type)
        except Exception as e:                          # noqa: BLE001
            return 400, {"error": f"{type(e).__name__}: {e}"}
        with sess.lock:
            # under the lock: an append racing a close gets its 409 and
            # journals nothing
            if sess.closed or sess.closing:
                return 409, {"error": f"session {sid!r} is closed",
                             "session": sid, "status": sess.status()["status"]}
            if seq is not None and seq <= sess.seq:
                # a retried block (its answer lost to a crash) dedups
                obs.count("serve.session.deduped")
                out = sess.status()
                out.update({"deduped": True, "seq": seq})
                return 200, out
            if seq is not None and seq != sess.seq + 1:
                # a gap is a protocol error, never renumbered
                return 409, {"error": f"seq gap: expected {sess.seq + 1}, "
                                      f"got {seq}",
                             "session": sid, "seq": sess.seq}
            this_seq = sess.seq + 1
            if self.journal is not None:
                try:
                    self.journal.session_append_entry(sid, this_seq, ops)
                except OSError as e:
                    obs.engine_fallback("serve-journal", type(e).__name__,
                                        session=sid)
                    return 500, {"error": f"journal write failed: {e}"}
            # no deadline: a journaled block is part of the session's
            # stream, and expiring it queued would leave a hole
            req = rq.CheckRequest(
                id=rq.new_request_id(), tenant=sess.tenant,
                model_name=sess.model_name, model=sess.model, packed=None,
                history=ops, n_ops=len(ops), opts=dict(sess.opts),
                kind="session-append", session=sess, seq=this_seq)
            try:
                self.registry.add(req)
                self.queue.submit(req)
            except Backpressure as e:
                self.registry.remove(req.id)
                if self.journal is not None:
                    self.journal.discard_session_append(sid, this_seq)
                self.registry.ledger_record(sess.tenant, "rejected",
                                            cause="backpressure",
                                            session=sid)
                return 429, {"error": str(e), "retry-after-s": 1.0}
            sess.seq = this_seq
        return self._session_wait(req, wait_s, sid, this_seq)

    @staticmethod
    def _session_wait(req: "rq.CheckRequest", wait_s: float, sid: str,
                      seq: int) -> Tuple[int, Dict]:
        """The block's verdict once it publishes within ``wait-s`` (500
        when a fault ended the session), else 202 with the request id
        for ``GET /check/<id>``."""
        if req.done_event.wait(wait_s) and req.result is not None:
            out = dict(req.result)
            out["id"] = req.id
            out["status"] = req.status
            return (500 if req.status == rq.ERROR else 200), out
        return 202, {"id": req.id, "session": sid, "seq": seq,
                     "status": req.status}

    def session_close(self, sid: str, body: bytes = b"") -> Tuple[int, Dict]:
        sess = self.sessions.get(sid)
        if sess is None:
            closed = self._closed_reply(sid)
            if closed is not None:
                return closed
            sess, err = self._adopt_session(sid)
            if sess is None:
                return err
        if sess.closed:
            return 200, {"session": sid,
                         "status": sess.status()["status"],
                         "result": dict(sess.result or {})}
        try:
            wait_s = float((json.loads(body.decode() or "{}") or {})
                           .get("wait-s", 120.0)) if body else 120.0
        except Exception:                               # noqa: BLE001
            wait_s = 120.0      # a malformed wait-s: the close goes on
        with sess.lock:
            if sess.closing:
                return 409, {"error": f"close of {sid!r} already in "
                                      f"flight"}
            sess.closing = True
            req = rq.CheckRequest(
                id=rq.new_request_id(), tenant=sess.tenant,
                model_name=sess.model_name, model=sess.model, packed=None,
                history=(), n_ops=len(sess.ops), opts=dict(sess.opts),
                kind="session-close", session=sess, seq=sess.seq + 1)
            try:
                self.registry.add(req)
                self.queue.submit(req)
            except Backpressure as e:
                sess.closing = False
                self.registry.remove(req.id)
                return 429, {"error": str(e), "retry-after-s": 1.0}
        if req.done_event.wait(wait_s) and req.result is not None:
            if not sess.closed:
                # the close's dispatch crashed: the session is still open
                return 500, {"session": sid, "status": "open", "id": req.id,
                             "error": "close failed; retry",
                             "result": dict(req.result)}
            return (500 if sess.faulted else 200), {
                "session": sid, "status": sess.status()["status"],
                "id": req.id, "result": dict(req.result)}
        return 202, {"id": req.id, "session": sid, "status": req.status}

    def session_status(self, sid: str) -> Tuple[int, Dict]:
        sess = self.sessions.get(sid)
        if sess is not None:
            return 200, sess.status()
        closed = self._closed_reply(sid)
        if closed is not None:
            return closed
        if self.fleet and self.journal.load_session(sid) is not None:
            # any replica tells where a session lives; only appends and
            # closes adopt
            return 200, {"session": sid, "status": "open", "fleet": True,
                         "pinned-to": self.journal.lease_live(sid)}
        return 404, {"error": f"unknown session {sid!r}"}

    # -- admission (HTTP threads) ------------------------------------------------
    def _reserve_idem(self, tenant: str, idem: str,
                      req_id: str) -> Optional[str]:
        """Claim (tenant, key) for ``req_id``, atomically: the id that
        already holds it, or None when ``req_id`` now does."""
        with self._idem_lock:
            known = self._idem.get((tenant, idem))
            if known is not None:
                return known
            self._idem[(tenant, idem)] = req_id
            self._admitting.add(req_id)
            while len(self._idem) > 4096:
                self._idem.popitem(last=False)
            return None

    def _settle_idem(self, tenant: str, idem: Optional[str], req_id: str,
                     admitted: bool) -> None:
        """End a reservation: keep the mapping when admitted, retract it
        when the admission failed."""
        if idem is None:
            return
        with self._idem_lock:
            self._admitting.discard(req_id)
            if not admitted and self._idem.get((tenant, idem)) == req_id:
                self._idem.pop((tenant, idem), None)

    def _known_reply(self, known: str) -> Optional[Tuple[int, Dict]]:
        """The dedup reply for a known id, from the registry, the
        journal's marker, or (fleet) a sibling's pending entry; None when
        no tier knows it."""
        req = self.registry.get(known)
        if req is not None:
            return 202, {"id": known, "status": req.status,
                         "tenant": req.tenant, "deduped": True}
        if self.journal is None:
            return None
        term = self.journal.lookup_terminal(known)
        if term is not None:
            return 202, {"id": known, "status": term.get("status", "done"),
                         "deduped": True}
        if self.fleet and self.journal.load_entry(known) is not None:
            return 202, {"id": known, "status": "queued", "deduped": True,
                         "fleet": True,
                         "claimed-by": self.journal.lease_live(known)}
        return None

    def _dedup_response(self, tenant: str, idem: str,
                        known: str) -> Optional[Tuple[int, Dict]]:
        """A duplicate POST mapped onto the first request. While that
        request's admission is in flight on another thread it is waited
        out (a journal write and a queue insert). Once it is not, the
        tiers are read again under ``_idem_lock`` before the reservation
        is retracted: the winner adds its request to the registry before
        it leaves ``_admitting``, so a duplicate that read the registry
        just before the add sees it here and dedups, where the
        reference's check-then-act window admitted a second request
        (``jepsen_tpu/serve/http.py:1017-1048`` against ``:1136-1149``).
        None: the winner's admission failed (or its entry aged out of
        every tier), and the caller admits afresh."""
        deadline = time.monotonic() + 5.0
        while True:
            reply = self._known_reply(known)
            if reply is None:
                with self._idem_lock:
                    if known not in self._admitting:
                        reply = self._known_reply(known)
                        if reply is None:
                            if self._idem.get((tenant, idem)) == known:
                                self._idem.pop((tenant, idem), None)
                            return None
            if reply is not None:
                obs.count("serve.journal.deduped")
                return reply
            if time.monotonic() >= deadline:
                # a winner stalled this long: fail this duplicate loudly
                return 503, {"error": "idempotent admission of "
                             f"{known!r} still in flight"}
            time.sleep(0.002)

    def submit(self, body: bytes, content_type: str,
               header_tenant: Optional[str]) -> Tuple[int, Dict]:
        if not self.accepting:
            return 503, {"error": "shutting down"}
        # the admission's host time, read by the serve metrics: the
        # parse (JSON or EDN, then Op.from_dict), the pack, the journal
        t_parse = time.monotonic()
        try:
            tenant, model_name, ops, options, timeout_s, idem = \
                parse_check_body(body, content_type,
                                 default_tenant=header_tenant or "anonymous")
            model = resolve_model(model_name)
            t_pack = time.monotonic()
            packed = h.pack(ops)
            from jepsen_tpu_torch.txn.ops import ListAppend, micro_ops
            if isinstance(model, ListAppend):
                # a malformed txn is this client's 400, not a dispatch
                # fault of its co-tenants
                for op in ops:
                    if op.f == "txn":
                        micro_ops(op.value)
        except Exception as e:                          # noqa: BLE001
            return 400, {"error": f"{type(e).__name__}: {e}"}
        t_packed = time.monotonic()
        obs.count("serve.admit.parse_s", t_pack - t_parse)
        obs.count("serve.admit.pack_s", t_packed - t_pack)
        req = rq.CheckRequest(
            id=rq.new_request_id(), tenant=tenant, model_name=model_name,
            model=model, packed=packed, history=ops, n_ops=int(packed.n),
            opts=options,
            deadline=(time.monotonic() + timeout_s if timeout_s else None),
            idem_key=idem)
        while idem is not None:
            known = self._reserve_idem(tenant, idem, req.id)
            if known is None and self.fleet:
                # a sibling may hold the key: the shared journal's index
                sibling = self.journal.idempotency_index().get(
                    (tenant, idem))
                if sibling is not None and sibling != req.id:
                    self._settle_idem(tenant, idem, req.id, admitted=False)
                    known = sibling
            if known is None:
                break
            dup = self._dedup_response(tenant, idem, known)
            if dup is not None:
                return dup
            # the known id was retracted: claim the key again
        if self.journal is not None:
            # durable before the 202; the append precedes the queue, so a
            # crash between them replays the request (at least once)
            try:
                self.journal.append(
                    req_id=req.id, tenant=tenant, model_name=model_name,
                    options=options, timeout_s=timeout_s,
                    idempotency_key=idem, history=ops)
                req.journaled = True
                if self.fleet:
                    # leased before the 202: a sibling's scan never
                    # adopts it
                    self.journal.claim(req.id, replica=self.replica_id,
                                       ttl_s=self.lease_ttl_s)
            except OSError as e:
                obs.engine_fallback("serve-journal", type(e).__name__,
                                    append=True)
                self._settle_idem(tenant, idem, req.id, admitted=False)
                return 500, {"error": f"journal write failed: {e}"}
            obs.count("serve.admit.journal_s", time.monotonic() - t_packed)
        try:
            self.registry.add(req)
            self.queue.submit(req)
        except Backpressure as e:
            # the id never reached the client: retract it everywhere
            self.registry.remove(req.id)
            if self.journal is not None:
                self.journal.discard(req.id)
            self._settle_idem(tenant, idem, req.id, admitted=False)
            self.registry.ledger_record(tenant, "rejected",
                                        cause="backpressure")
            return 429, {"error": str(e), "retry-after-s": 1.0}
        self._settle_idem(tenant, idem, req.id, admitted=True)
        self.registry.ledger_record(tenant, "admitted", id=req.id,
                                    ops=int(packed.n))
        return 202, {"id": req.id, "status": req.status, "tenant": tenant,
                     "ops": int(packed.n)}

    def lookup(self, req_id: str) -> Tuple[int, Dict]:
        req = self.registry.get(req_id)
        if req is None:
            term = (self.journal.lookup_terminal(req_id)
                    if self.journal is not None else None)
            if term is not None:
                out: Dict[str, Any] = {
                    "id": req_id, "status": term.get("status", "done"),
                    "recovered-from-journal": True}
                if term.get("result") is not None:
                    out["result"] = term["result"]
                return (500 if out["status"] in (rq.QUARANTINED, rq.ERROR)
                        else 200), out
            if self.fleet and self.journal.load_entry(req_id) is not None:
                return 200, {"id": req_id, "status": "queued",
                             "fleet": True,
                             "claimed-by": self.journal.lease_live(req_id)}
            return 404, {"error": f"unknown request {req_id!r}"}
        code = 500 if req.status in (rq.QUARANTINED, rq.ERROR) else 200
        return code, req.to_json()

    def profile(self, body: bytes) -> Tuple[int, Dict]:
        """Arm the profiler for the next N dispatches: 400 on a bad body,
        409 when already armed or without a store root."""
        try:
            data = json.loads(body) if body else {}
            n = int(data.get("dispatches", 1))
            if not 1 <= n <= 1000:
                raise ValueError("dispatches must be in 1..1000")
        except Exception as e:                          # noqa: BLE001
            return 400, {"error": f"{type(e).__name__}: {e}"}
        try:
            d = self.dispatcher.arm_profile(n)
        except RuntimeError as e:
            return 409, {"error": str(e)}
        except OSError as e:
            return 500, {"error": f"{type(e).__name__}: {e}"}
        return 202, {"profile-dir": d, "dispatches": n}

    def cancel(self, req_id: str) -> Tuple[int, Dict]:
        req = self.registry.get(req_id)
        if req is None:
            # journaled but not replayed: its marker keeps a restart
            # from resurrecting it
            if self.journal is not None \
                    and self.journal.cancel_pending(req_id):
                obs.count("serve.cancelled")
                return 200, {"id": req_id, "status": rq.CANCELLED,
                             "cancelled-in-journal": True}
            return 404, {"error": f"unknown request {req_id!r}"}
        if req.terminal:
            return 409, {"error": f"request {req_id!r} is {req.status}",
                         **req.to_json()}
        queued = self.queue.cancel(req_id)
        if queued is not None:
            obs.count("serve.cancelled")
            obs.count(f"serve.tenant."
                      f"{self.registry.bucket_tenant(req.tenant)}.cancelled")
            self.registry.finish(queued, rq.CANCELLED,
                                 {"valid": "unknown", "cause": "cancelled"})
            self.registry.ledger_record(req.tenant, "cancelled", id=req_id)
        else:
            # walking: the abort hook and the publish read the flag
            req.cancel_requested = True
        return 200, req.to_json()

    def stats(self) -> Dict[str, Any]:
        out = self.dispatcher.stats()
        if self.fleet:
            out["fleet"] = {"replica": self.replica_id,
                            "lease-ttl-s": self.lease_ttl_s,
                            "leases": self.journal.stats()["leases"]}
        return out

    def health(self) -> Tuple[int, Dict[str, Any]]:
        """``ok`` while no device fault was seen (200; else 503 with the
        last fault's text); ``degraded`` while a breaker routes to the
        host."""
        d = self.dispatcher
        out: Dict[str, Any] = {"ok": d.device_faults == 0,
                               "degraded": d.breaker.degraded,
                               "breaker": d.breaker.to_json(),
                               "device": str(self.device)}
        if d.device_faults:
            out["device-faults"] = d.device_faults
            out["device-fault"] = d.device_fault
        if self.journal is not None:
            out["journal"] = {"pending": self.journal.pending_count()}
        if self.fleet:
            out["fleet"] = {"replica": self.replica_id,
                            "lease-ttl-s": self.lease_ttl_s}
        return (200 if out["ok"] else 503), out


class _Handler(BaseHTTPRequestHandler):
    daemon_ref: Daemon = None           # type: ignore[assignment]
    protocol_version = "HTTP/1.1"

    def _reply(self, code: int, payload: Dict) -> None:
        self._reply_raw(code, json.dumps(payload, default=str).encode(),
                        "application/json")

    def _reply_raw(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if code == 429:
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:                          # noqa: N802
        path = self.path.rstrip("/")
        n = int(self.headers.get("Content-Length") or 0)
        if n > self.daemon_ref.max_body_bytes:
            # refused before reading: the bound must not cost the memory
            self._reply(413, {"error": f"body {n} bytes exceeds "
                              f"{self.daemon_ref.max_body_bytes}"})
            return
        body = self.rfile.read(n) if n else b""
        if path == "/profile":
            self._reply(*self.daemon_ref.profile(body))
        elif path == "/session":
            self._reply(*self.daemon_ref.session_open(
                body, self.headers.get("Content-Type", ""),
                self.headers.get("X-Tenant")))
        elif path.startswith("/session/"):
            sid, _, action = path[len("/session/"):].partition("/")
            if action == "append":
                self._reply(*self.daemon_ref.session_append(
                    sid, body, self.headers.get("Content-Type", "")))
            elif action == "close":
                self._reply(*self.daemon_ref.session_close(sid, body))
            else:
                self._reply(404, {"error": "POST /session/<id>/append or "
                                  "/session/<id>/close"})
        elif path == "/check":
            ctype = self.headers.get("Content-Type", "")
            if ctype and not any(t in ctype for t in ("json", "edn")):
                self._reply(415, {"error": f"unsupported content type "
                                  f"{ctype!r}: application/json or "
                                  f"application/edn"})
                return
            self._reply(*self.daemon_ref.submit(
                body, ctype, self.headers.get("X-Tenant")))
        else:
            self._reply(404, {"error": "POST /check, /session or /profile "
                              "only"})

    def do_GET(self) -> None:                           # noqa: N802
        path = self.path.split("?", 1)[0]
        route = path.rstrip("/")
        if path.startswith("/check/"):
            self._reply(*self.daemon_ref.lookup(
                path[len("/check/"):].strip("/")))
        elif path.startswith("/session/"):
            self._reply(*self.daemon_ref.session_status(
                path[len("/session/"):].strip("/")))
        elif route == "/stats":
            self._reply(200, self.daemon_ref.stats())
        elif route == "/metrics":
            self._reply_raw(200, obs.prometheus_text().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
        elif route == "/healthz":
            self._reply(*self.daemon_ref.health())
        else:
            self._reply(404, {"error": f"no route {path!r}"})

    def do_DELETE(self) -> None:                        # noqa: N802
        path = self.path.split("?", 1)[0]
        if path.startswith("/check/"):
            self._reply(*self.daemon_ref.cancel(
                path[len("/check/"):].strip("/")))
        else:
            self._reply(404, {"error": "DELETE /check/<id> only"})

    def log_message(self, *args) -> None:
        pass

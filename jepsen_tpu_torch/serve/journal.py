"""The check daemon's admission journal, a write-ahead log of admitted
checks and of streaming sessions, so that a crash (SIGKILL included)
loses no admitted request and no acknowledged append (a port of the
reference package's ``jepsen_tpu/serve/journal.py``). The files are the
reference's, so a journal either daemon wrote replays in the other.

- **Append before the 202.** Every admitted request is journaled (EDN
  history, engine options, tenant, deadline, idempotency key) before
  the client sees its 202.
- **Completion marker.** A terminal transition writes a ``done`` marker
  with the status and the result, so ``GET /check/<id>`` answers across
  a restart.
- **Replay.** At start, entries without a marker are admitted again
  under their own ids; a deadline is re-derived from the wall clock (a
  deadline that passed while the daemon was down replays as a timeout).
- **Idempotency.** The (tenant, key) → id index is rebuilt from the
  journal at start, so duplicate POSTs dedup across restarts.
- **Cancellation sticks.** ``DELETE /check/<id>`` of an entry not yet
  replayed writes its ``cancelled`` marker.
- **Bounded.** Terminal pairs past ``keep_terminal`` are collected
  oldest first (``serve.journal.gc``); pending entries never are.

Layout: ``<id>.req.json`` and ``<id>.done.json`` under
``<store-root>/serve/journal/``, written to a temporary file, fsynced
and renamed, so a torn write is an absent entry; a corrupt one found
anyway is quarantined at replay.

**Sessions.** ``<sid>.sess.json`` is written before an opened session's
id is returned, ``<sid>.a<seq:06d>.sapp.json`` holds each append block
(EDN, as a request's history) before its verdict is computed, and
``<sid>.sdone.json`` is the close marker with the close's result (the
first marker wins). A restart replays every session without a marker,
its blocks in seq order through the engine, so the carried state is
derived again from the stream. Closed sessions past ``keep_terminal``
are collected oldest marker first, open ones never.

**Fleet mode** (several daemons over one journal) adds a lease a
claimed entry, ``<id>.lease.json``: the replica's id and a wall-clock
expiry. A fresh claim hard-links a complete temporary file into place
(atomic with its content); renewals and steals of expired leases go
through an ``flock`` on ``.fleet.lock``, so two replicas racing for one
entry admit exactly one.
"""
from __future__ import annotations

import contextlib
import fcntl
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch import edn
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.op import Op
from jepsen_tpu_torch.serve import faults

log = logging.getLogger("jepsen.serve.journal")

_REQ_SUFFIX = ".req.json"
_DONE_SUFFIX = ".done.json"
_SESS_SUFFIX = ".sess.json"
_SAPP_MID = ".a"
_SAPP_SUFFIX = ".sapp.json"
_SDONE_SUFFIX = ".sdone.json"
_LEASE_SUFFIX = ".lease.json"


def history_to_edn(history) -> str:
    """One EDN op map a line, as a run's ``history.edn``."""
    return "\n".join(edn.dumps(op.to_dict()) for op in history)


def history_from_edn(text: str) -> List[Op]:
    return [Op.from_dict(edn.to_plain(d)) for d in edn.loads_all(text)]


class Journal:
    """The write-ahead log. HTTP threads append, lane threads mark
    completion, ``/stats`` reads counts; ``_finishes`` is touched under
    ``self._lock``."""

    def __init__(self, root: str, *, keep_terminal: int = 256,
                 fsync: bool = True, gc_every: int = 32) -> None:
        self.root = root
        self.keep_terminal = int(keep_terminal)
        self.fsync = bool(fsync)
        self.gc_every = max(1, int(gc_every))
        self._lock = threading.Lock()
        self._finishes = 0
        os.makedirs(root, exist_ok=True)

    # -- low level -----------------------------------------------------------
    def _write(self, path: str, payload: Dict[str, Any]) -> None:
        try:
            faults.fire("journal-write")
        except faults.InjectedFault:
            # the injected corruption: a valid but garbage-shaped entry,
            # and the writer believes it succeeded
            with open(path, "w") as f:
                json.dump({"corrupted": True}, f)
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if self.fsync:
            # the rename must be durable too: without the directory's
            # fsync a host crash after the 202 can lose the entry
            dfd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    def _req_path(self, req_id: str) -> str:
        return os.path.join(self.root, req_id + _REQ_SUFFIX)

    def _done_path(self, req_id: str) -> str:
        return os.path.join(self.root, req_id + _DONE_SUFFIX)

    # -- append / finish -------------------------------------------------------
    def append(self, *, req_id: str, tenant: str, model_name: str,
               options: Dict[str, Any], timeout_s: Optional[float],
               idempotency_key: Optional[str], history) -> None:
        """Record one admitted request, before its 202. Raises on an IO
        failure: a request that cannot be journaled is not admitted."""
        self._write(self._req_path(req_id), {
            "id": req_id, "tenant": tenant, "model": model_name,
            "options": dict(options or {}), "timeout-s": timeout_s,
            "idempotency-key": idempotency_key,
            "submitted-at": round(time.time(), 6),
            "history-edn": history_to_edn(history)})
        obs.count("serve.journal.appended")

    def _write_marker(self, entry_path: str, done_path: str,
                      payload: Dict[str, Any],
                      result: Optional[Dict[str, Any]],
                      **obs_kw: Any) -> None:
        """The terminal marker of a request or a session. The first
        marker wins (the exists checks and the write share the lock, so a
        cancel cannot clobber a published verdict's marker); an unknown
        entry is a no-op. A failed write is recorded, never raised: the
        entry then replays after a crash (at least once, never lost).
        Every marker moves the collection's cadence."""
        if result is not None:
            try:
                payload["result"] = json.loads(json.dumps(result,
                                                          default=str))
            except (TypeError, ValueError):
                pass        # the marker keeps the status without it
        with self._lock:
            if not os.path.exists(entry_path) or os.path.exists(done_path):
                return
            try:
                self._write(done_path, payload)
            except OSError as e:
                log.warning("journal marker failed for %s: %s", done_path,
                            e)
                obs.engine_fallback("serve-journal", type(e).__name__,
                                    **obs_kw)
                return
            self._finishes += 1
            due = self._finishes % self.gc_every == 0
        if due:
            self.gc()

    def finish(self, req_id: str, status: str,
               result: Optional[Dict[str, Any]] = None) -> None:
        """Mark a journaled request terminal (:meth:`_write_marker`; a
        session's block has no entry of its own, so it is a no-op)."""
        self._write_marker(self._req_path(req_id), self._done_path(req_id),
                           {"id": req_id, "status": status,
                            "ts": round(time.time(), 6)}, result, id=req_id)

    def discard(self, req_id: str) -> None:
        """Remove an entry that was never admitted (a backpressure
        retraction after the append), its lease with it."""
        for p in (self._req_path(req_id), self._done_path(req_id),
                  self._lease_path(req_id)):
            with contextlib.suppress(OSError):
                os.unlink(p)

    def cancel_pending(self, req_id: str) -> bool:
        """Write the ``cancelled`` marker of a pending entry, so that a
        restart cannot resurrect it. True when this call cancelled it (a
        racing verdict's marker wins or this one does, never both)."""
        if not os.path.exists(self._req_path(req_id)) \
                or os.path.exists(self._done_path(req_id)):
            return False
        self.finish(req_id, "cancelled",
                    {"valid": "unknown", "cause": "cancelled"})
        term = self.lookup_terminal(req_id)
        return bool(term) and term.get("status") == "cancelled"

    # -- leases (fleet mode) -----------------------------------------------------
    def _lease_path(self, entry_id: str) -> str:
        return os.path.join(self.root, entry_id + _LEASE_SUFFIX)

    @contextlib.contextmanager
    def _fleet_lock(self):
        """The cross-process critical section of lease renewal and steal:
        an ``flock`` on ``.fleet.lock`` (replicas of a fleet share one
        store root on one host)."""
        fd = os.open(os.path.join(self.root, ".fleet.lock"),
                     os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)

    @staticmethod
    def _read_lease(path: str) -> Optional[Dict[str, Any]]:
        """A lease's payload, or None when absent, torn (stealable: its
        writer died mid-write) or garbage-shaped (quarantined aside as
        ``.corrupt``, counted ``serve.lease.corrupt``, never trusted)."""
        try:
            with open(path) as f:
                holder = json.load(f)
        except (OSError, ValueError):
            return None
        bad = not isinstance(holder, dict)
        if not bad:
            try:
                float(holder.get("expires-at") or 0.0)
            except (TypeError, ValueError):
                bad = True
        if bad:
            obs.count("serve.lease.corrupt")
            obs.decision("serve-lease", "quarantine", cause="bad-payload",
                         path=os.path.basename(path))
            with contextlib.suppress(OSError):
                os.replace(path, path + ".corrupt")
            return None
        return holder

    def claim(self, entry_id: str, *, replica: str, ttl_s: float) -> bool:
        """Claim an entry for ``replica`` for ``ttl_s`` wall-clock
        seconds. True when this replica now holds it: a fresh claim, a
        renewal of its own live lease, or a steal of an expired or torn
        one; False when another replica holds a live lease (or the write
        failed)."""
        path = self._lease_path(entry_id)
        replica = str(replica)
        now = time.time()
        payload = {"id": entry_id, "replica": replica,
                   "expires-at": round(now + float(ttl_s), 6),
                   "claimed-at": round(now, 6)}
        try:
            faults.fire("lease-write")
        except faults.InjectedFault:
            # the injected corruption: a lease its claimer believes in,
            # with a junk expiry that every reader must reject
            payload["expires-at"] = "garbage"
        # the complete payload in a private file, hard-linked into place:
        # the lease appears with its content (an O_EXCL create and a
        # write would show an empty file a reader takes for torn)
        tmp = path + f".{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            try:
                os.link(tmp, path)
            except FileExistsError:
                return self._claim_slow(path, payload, replica)
        except OSError as e:
            obs.engine_fallback("serve-lease", type(e).__name__,
                                id=entry_id)
            return False
        finally:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
        obs.count("serve.lease.claimed")
        return True

    def _claim_slow(self, path: str, payload: Dict[str, Any],
                    replica: str) -> bool:
        """An existing lease: renew our own, refuse a live foreign one,
        steal an expired or torn one, under the fleet lock."""
        with self._fleet_lock():
            holder = self._read_lease(path)
            live = (holder is not None
                    and float(holder.get("expires-at") or 0.0) > time.time())
            if live and holder.get("replica") != replica:
                return False
            try:
                self._write(path, payload)
            except OSError as e:
                obs.engine_fallback("serve-lease", type(e).__name__,
                                    id=payload["id"])
                return False
            if live:
                obs.count("serve.lease.renewed")
            elif holder is not None:
                obs.count("serve.lease.expired")
                obs.count("serve.lease.stolen")
                obs.decision("serve-lease", "steal",
                             cause=str(holder.get("replica")),
                             id=payload["id"], by=replica)
            else:
                obs.count("serve.lease.claimed")
            return True

    def release(self, entry_id: str, replica: str) -> None:
        """Drop this replica's lease (its entry went terminal); a foreign
        lease (ours expired and was stolen) stays."""
        path = self._lease_path(entry_id)
        with self._fleet_lock():
            holder = self._read_lease(path)
            if holder is None or holder.get("replica") != str(replica):
                return
            try:
                os.unlink(path)
            except OSError:
                return          # it expires anyway
        obs.count("serve.lease.released")

    def lease_holder(self, entry_id: str) -> Optional[Dict[str, Any]]:
        """The lease's payload, or None when unclaimed or torn."""
        return self._read_lease(self._lease_path(entry_id))

    def lease_live(self, entry_id: str) -> Optional[str]:
        """The replica holding a live lease on the entry, or None."""
        holder = self.lease_holder(entry_id)
        if holder is None or float(
                holder.get("expires-at") or 0.0) <= time.time():
            return None
        return str(holder.get("replica"))

    def leases(self) -> Dict[str, Dict[str, Any]]:
        """Every lease's payload by entry id."""
        out: Dict[str, Dict[str, Any]] = {}
        for n in self._names():
            if n.endswith(_LEASE_SUFFIX):
                eid = n[:-len(_LEASE_SUFFIX)]
                holder = self.lease_holder(eid)
                if holder is not None:
                    out[eid] = holder
        return out

    # -- sessions ----------------------------------------------------------------
    def _sess_path(self, sid: str) -> str:
        return os.path.join(self.root, sid + _SESS_SUFFIX)

    def _sapp_path(self, sid: str, seq: int) -> str:
        return os.path.join(self.root,
                            f"{sid}{_SAPP_MID}{seq:06d}{_SAPP_SUFFIX}")

    def _sdone_path(self, sid: str) -> str:
        return os.path.join(self.root, sid + _SDONE_SUFFIX)

    def session_open(self, sid: str, *, tenant: str, model_name: str,
                     options: Dict[str, Any]) -> None:
        """Record an opened session, before its id is returned: its
        journaled appends need an entry to replay into."""
        self._write(self._sess_path(sid), {
            "session": sid, "tenant": tenant, "model": model_name,
            "options": dict(options or {}),
            "opened-at": round(time.time(), 6)})
        obs.count("serve.journal.session_opened")

    def session_append_entry(self, sid: str, seq: int, history) -> None:
        """Record one append block, before its verdict is computed: a
        crash mid-advance replays it."""
        self._write(self._sapp_path(sid, seq), {
            "session": sid, "seq": int(seq),
            "appended-at": round(time.time(), 6),
            "history-edn": history_to_edn(history)})
        obs.count("serve.journal.session_appended")

    def discard_session_append(self, sid: str, seq: int) -> None:
        """Retract a block whose admission bounced (the client had a 429,
        not a verdict)."""
        with contextlib.suppress(OSError):
            os.unlink(self._sapp_path(sid, seq))

    def session_close_marker(self, sid: str,
                             result: Optional[Dict[str, Any]] = None
                             ) -> None:
        """Mark a session closed (the first marker wins): a restart
        neither replays nor revives it, and its result survives."""
        self._write_marker(self._sess_path(sid), self._sdone_path(sid),
                           {"session": sid, "ts": round(time.time(), 6)},
                           result, session=sid)

    def open_session_ids(self) -> List[str]:
        """Sessions with an entry and no close marker, oldest first."""
        names = self._names()
        done = {n[:-len(_SDONE_SUFFIX)] for n in names
                if n.endswith(_SDONE_SUFFIX)}
        return self._mtime_sorted(
            [n[:-len(_SESS_SUFFIX)] for n in names
             if n.endswith(_SESS_SUFFIX)
             and n[:-len(_SESS_SUFFIX)] not in done], self._sess_path)

    def open_session_count(self) -> int:
        names = self._names()
        done = {n[:-len(_SDONE_SUFFIX)] for n in names
                if n.endswith(_SDONE_SUFFIX)}
        return sum(1 for n in names if n.endswith(_SESS_SUFFIX)
                   and n[:-len(_SESS_SUFFIX)] not in done)

    def load_session(self, sid: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._sess_path(sid)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def session_lookup_closed(self, sid: str) -> Optional[Dict[str, Any]]:
        """The close marker (with the close's result), or None."""
        try:
            with open(self._sdone_path(sid)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def session_appends(self, sid: str) -> List[Tuple[int, Dict[str, Any]]]:
        """A session's journaled blocks, ``(seq, entry)`` in seq order. A
        corrupt entry is skipped with a recorded fallback (a torn append
        was never acknowledged; replay stops at the gap it leaves)."""
        prefix = sid + _SAPP_MID
        out: List[Tuple[int, Dict[str, Any]]] = []
        for n in sorted(self._names()):
            if not (n.startswith(prefix) and n.endswith(_SAPP_SUFFIX)):
                continue
            try:
                with open(os.path.join(self.root, n)) as f:
                    entry = json.load(f)
                out.append((int(entry["seq"]), entry))
            except (OSError, ValueError, KeyError, TypeError) as e:
                obs.engine_fallback("serve-journal", type(e).__name__,
                                    session=sid, entry=n)
        out.sort(key=lambda t: t[0])
        return out

    def discard_session(self, sid: str) -> None:
        """Remove every file of one session (the collection of closed
        sessions, or an open refused after its entry was written)."""
        prefix = sid + _SAPP_MID
        for n in self._names():
            if n.startswith(prefix) and n.endswith(_SAPP_SUFFIX):
                with contextlib.suppress(OSError):
                    os.unlink(os.path.join(self.root, n))
        for p in (self._sess_path(sid), self._sdone_path(sid),
                  self._lease_path(sid)):
            with contextlib.suppress(OSError):
                os.unlink(p)

    def _gc_sessions(self) -> int:
        """Collect closed sessions past ``keep_terminal``, oldest close
        marker first; open sessions are never touched."""
        closed = [n[:-len(_SDONE_SUFFIX)] for n in self._names()
                  if n.endswith(_SDONE_SUFFIX)]
        excess = len(closed) - self.keep_terminal
        if excess <= 0:
            return 0
        for sid in self._mtime_sorted(closed, self._sdone_path)[:excess]:
            self.discard_session(sid)
        obs.count("serve.journal.session_gc", excess)
        return excess

    # -- views -------------------------------------------------------------------
    def _names(self) -> List[str]:
        try:
            return os.listdir(self.root)
        except OSError:
            return []

    def _ids(self) -> Dict[str, bool]:
        """id → has a done marker, from one directory scan."""
        names = self._names()
        done = {n[:-len(_DONE_SUFFIX)] for n in names
                if n.endswith(_DONE_SUFFIX)}
        return {n[:-len(_REQ_SUFFIX)]: n[:-len(_REQ_SUFFIX)] in done
                for n in names if n.endswith(_REQ_SUFFIX)}

    def _mtime_sorted(self, ids: List[str], path_of) -> List[str]:
        def _mtime(x: str) -> float:
            try:
                return os.path.getmtime(path_of(x))
            except OSError:
                return 0.0
        return sorted(ids, key=lambda x: (_mtime(x), x))

    def pending_ids(self) -> List[str]:
        """Unfinished entries, oldest first (by the entry's mtime)."""
        return self._mtime_sorted(
            [rid for rid, fin in self._ids().items() if not fin],
            self._req_path)

    def pending_count(self) -> int:
        return sum(1 for fin in self._ids().values() if not fin)

    def load_entry(self, req_id: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._req_path(req_id)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def lookup_terminal(self, req_id: str) -> Optional[Dict[str, Any]]:
        """The done marker (status and result), or None."""
        try:
            with open(self._done_path(req_id)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def idempotency_index(self) -> Dict[Any, str]:
        """(tenant, key) → request id over every journaled entry, pending
        and terminal. Keys are per tenant: one tenant's key never maps
        onto another tenant's request."""
        out: Dict[Any, str] = {}
        for rid in self._ids():
            e = self.load_entry(rid)
            if e and e.get("idempotency-key"):
                out[(str(e.get("tenant") or "anonymous"),
                     str(e["idempotency-key"]))] = rid
        return out

    # -- GC ----------------------------------------------------------------------
    def gc(self) -> int:
        """Collect terminal pairs past ``keep_terminal``, oldest marker
        first, then closed sessions (:meth:`_gc_sessions`); pending
        entries and open sessions are never touched. Returns how many
        requests and sessions went."""
        ids = [rid for rid, fin in self._ids().items() if fin]
        excess = max(0, len(ids) - self.keep_terminal)
        for rid in self._mtime_sorted(ids, self._done_path)[:excess]:
            self.discard(rid)
        if excess:
            obs.count("serve.journal.gc", excess)
        return excess + self._gc_sessions()

    def stats(self) -> Dict[str, Any]:
        ids = self._ids()
        pending = sum(1 for fin in ids.values() if not fin)
        return {"pending": pending, "terminal": len(ids) - pending,
                "sessions-open": self.open_session_count(),
                "leases": sum(1 for n in self._names()
                              if n.endswith(_LEASE_SUFFIX)),
                "keep_terminal": self.keep_terminal, "root": self.root}

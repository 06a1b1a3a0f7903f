"""Fault injection for the check daemon, the self-nemesis (a port of
the reference package's ``jepsen_tpu/serve/faults.py``). Named fault
points sit on the serving path, each a no-op until armed:

- ``tick``          top of every dispatch (never raises; the clock of
                    scheduled clock jumps);
- ``dispatch``      entry of every engine attempt, the card's and the
                    host's (a poison request fails wherever it runs);
- ``device``        entry of the card's route only (an outage: the
                    circuit breaker's food);
- ``persist``       entry of the store write of a verdict;
- ``journal-write`` inside ``Journal._write``: the write lands a valid
                    but garbage-shaped entry and reports success (replay
                    must quarantine it);
- ``lease-write``   inside ``Journal.claim``: the claim writes a lease
                    with a junk expiry that its claimer believes it holds;
- ``clock-jump``    fires at its ``tick`` and moves the deadline clock
                    (:func:`clock_skew`) forward;
- ``session-advance`` a session's advance on the card (the register
                    family's before its feed, the txn engine's after
                    inference): the session takes the host monitor;
- ``session-mega``  a mega group's K10 launch: one ``session-mega``
                    fallback, every staged member re-advanced alone.

An injected fault is an :class:`InjectedFault`, which takes the
daemon's recovery ladder (retry, bisect, host rescue, quarantine); a
device fault never does (``serve/recovery.py``). Faults are armed by
:func:`arm` or by :func:`arm_spec`, which ``Daemon(faults=...)`` and
``check-serve --faults`` call with the reference's grammar, entries
joined by ``;``:

- ``point@N``      fire on the Nth invocation of ``point`` (1-based);
- ``point@NxK``    fire on invocations N to N+K-1;
- ``clock-jump@N:S`` at the Nth ``tick``, jump the deadline clock S
  seconds forward (for good);
- ``poison=T``     raise at every ``dispatch`` whose group holds tenant T.

A fault that fires counts ``serve.fault.<name>`` and appends a
``serve-fault``/``injected`` record to the ``obs`` ledger. Firing
depends on invocation counts only, never on time or chance.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

from jepsen_tpu_torch import obs


class InjectedFault(RuntimeError):
    """Raised at an armed fault point."""


_lock = threading.RLock()
_armed: List[Dict[str, Any]] = []
_invocations: Dict[str, int] = {}
_skew_s: float = 0.0


def arm(point: str, *, at: int = 1, times: int = 1,
        skew_s: Optional[float] = None, tenant: Optional[str] = None,
        name: Optional[str] = None) -> None:
    """Arm one fault at ``point`` on invocations ``at`` to
    ``at + times - 1``. ``tenant`` restricts a ``dispatch`` fault to
    groups holding that tenant (it then fires on every matching
    invocation, up to ``times``); ``skew_s`` makes the entry a clock
    jump applied at its ``tick`` instead of a raise."""
    with _lock:
        _armed.append({"point": point, "at": int(at), "times": int(times),
                       "skew_s": skew_s, "tenant": tenant, "fired": 0,
                       "name": name or point})


def reset() -> None:
    """Disarm everything and clear the clock jump."""
    global _skew_s
    with _lock:
        _armed.clear()
        _invocations.clear()
        _skew_s = 0.0


def enabled() -> bool:
    return bool(_armed)


def clock_skew() -> float:
    """Seconds the deadline clock has jumped forward."""
    return _skew_s


def arm_spec(spec: str) -> int:
    """Arm every entry of ``spec`` (the grammar above); returns how many
    were armed. Raises ValueError on a malformed entry."""
    n = 0
    for raw in (spec or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        if raw.startswith("poison="):
            arm("dispatch", tenant=raw[len("poison="):], times=1 << 30,
                name="poison")
            n += 1
            continue
        point, _, when = raw.partition("@")
        point = point.strip()
        arg = None
        if ":" in when:
            when, _, args = when.partition(":")
            arg = float(args)
        times = 1
        if "x" in when:
            when, _, ks = when.partition("x")
            times = int(ks)
        at = int(when or 1)
        if point == "clock-jump":
            arm("tick", at=at, times=times,
                skew_s=arg if arg is not None else 3600.0,
                name="clock_jump")
        else:
            arm(point, at=at, times=times, name=point)
        n += 1
    return n


def fire(point: str, tenants: Optional[Sequence[str]] = None) -> None:
    """Invoke a fault point: raise :class:`InjectedFault` when an armed
    raising fault matches, apply a due clock jump, else nothing."""
    global _skew_s
    if not _armed:
        return
    with _lock:
        inv = _invocations.get(point, 0) + 1
        _invocations[point] = inv
        due: Optional[Dict[str, Any]] = None
        for f in _armed:
            if f["point"] != point:
                continue
            if f["tenant"] is not None:
                if not tenants or f["tenant"] not in tenants \
                        or f["fired"] >= f["times"]:
                    continue
            elif not f["at"] <= inv < f["at"] + f["times"]:
                continue
            f["fired"] += 1
            due = f
            break
        if due is None:
            return
        name = due["name"]
        skew = due["skew_s"]
        if skew is not None:
            _skew_s += float(skew)
    obs.count("serve.fault." + name.replace("-", "_"))
    obs.decision("serve-fault", "injected", cause=name, point=point,
                 invocation=inv, tenants=sorted(set(tenants or ())) or None)
    if skew is None:
        raise InjectedFault(f"injected fault {name!r} at {point} "
                            f"invocation {inv}")


def fired_counts() -> Dict[str, int]:
    """name → times fired."""
    with _lock:
        out: Dict[str, int] = {}
        for f in _armed:
            if f["fired"]:
                out[f["name"]] = out.get(f["name"], 0) + f["fired"]
        return out

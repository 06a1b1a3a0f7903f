"""The persisted autotune table: measured winners of the port's kernel
bodies, on disk. The counterpart of the reference package's
``checkers/autotune.py``.

A sweep measures two bodies of one function on one geometry and records
the faster; route selection consults the record before its default.
The table is ``<persist-root>/autotune.json``
(:func:`jepsen_tpu_torch.store.persist_root`: ``JEPSEN_TPU_CACHE_DIR``,
else ``<store-root>/.cache``; off under ``JEPSEN_TPU_NO_PERSIST``, and
then :func:`winner` answers None and :func:`record` writes nothing). Its
schema, its keys (``kind|backend|geometry``) and its geometry buckets
(:func:`walk_key`, :func:`lockstep_key`, :func:`closure_key`) are the
reference's, strings byte for byte. The kinds read here:

- ``walk`` (:func:`walk_key`): ``word`` or ``dense``, the single
  history's post-hoc walk (``reach._posthoc_body``); written by
  ``python -m jepsen_tpu_torch.tools.ablate_lane --bodies``;
- ``lockstep`` (:func:`lockstep_key`): the same choice for one lockstep
  group (``reach_batch._lockstep_body``);
- ``group`` (``default``): the lockstep group width of
  ``facade.auto_check_many_packed`` and ``stage_check_many_packed``;
- ``session-mega`` (``crossover``): the width from which sessions
  advance as a group (``serve.session.mega_crossover``).

An entry is keyed on the backend it was measured on (``cuda`` or
``cpu``) and records the torch version, the device's name and an id of
the kernel sources (:func:`kernel_source_id`, a hash of ``csrc/``). A
lookup from another torch, another card or other kernel sources counts
``autotune.stale`` and answers None: a winner measured elsewhere is
folklore. Records are atomic (a temporary file and ``os.replace``) and
never fail the measurement that made them (``autotune.record_failed``).
Counters: ``autotune.hit``, ``.miss``, ``.stale``, ``.record``,
``.record_failed``. A corrupt table reads as empty (counted stale).
"""
from __future__ import annotations

import functools
import glob
import hashlib
import json
import os
import threading
from typing import Any, Dict, Optional

import torch

from jepsen_tpu_torch import obs

_VERSION = 1

# the loaded table, re-read when the file's mtime changes, so a sweep in
# another process is picked up without a restart
_CACHE: Dict[str, Any] = {}
_LOCK = threading.Lock()

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")


def table_path() -> Optional[str]:
    """``<persist-root>/autotune.json``, or None when persistence is
    off."""
    from jepsen_tpu_torch import store
    root = store.persist_root()
    if root is None:
        return None
    return os.path.join(root, "autotune.json")


def backend() -> str:
    """The backend a lookup without one is keyed under: ``cuda`` where
    there is a card, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def device_name(backend_name: str) -> str:
    """The name of the device an entry of ``backend_name`` is measured
    on: the card's (``torch.cuda.get_device_name``), or ``cpu``."""
    if backend_name == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name()
    return backend_name


@functools.lru_cache(maxsize=1)
def kernel_source_id() -> str:
    """The kernel sources' id: a hash of every file of ``csrc/``, names
    and bytes, so that an edited kernel makes its winners stale."""
    digest = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(_CSRC, "*"))):
        digest.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            digest.update(f.read())
    return digest.hexdigest()[:16]


def _stamp(backend_name: str) -> Dict[str, str]:
    """What an entry must match to be live: torch, device, kernels."""
    return {"torch": str(torch.__version__),
            "device": device_name(backend_name),
            "kernels": kernel_source_id()}


def _entry_key(kind: str, be: str, geom_key: str) -> str:
    return f"{kind}|{be}|{geom_key}"


def _bucket_pow2(x: int) -> int:
    return 1 << max(0, (max(int(x), 1) - 1).bit_length())


def walk_key(S: int, W: int, M: int, returns: int) -> str:
    """Geometry bucket of the post-hoc returns walk: exact (W, M), the
    states and the return count bucketed to powers of two."""
    return f"S{_bucket_pow2(S)}-W{int(W)}-M{int(M)}" \
           f"-R{_bucket_pow2(returns)}"


def lockstep_key(S: int, W: int, M: int, H: int) -> str:
    """Geometry bucket of one lockstep group."""
    return f"S{_bucket_pow2(S)}-W{int(W)}-M{int(M)}-H{_bucket_pow2(H)}"


def closure_key(n: int) -> str:
    """Geometry bucket of the txn closure: the padded node count."""
    return f"Np{_bucket_pow2(n)}"


def _load() -> Dict[str, Any]:
    path = table_path()
    if path is None:
        return {}
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return {}                   # no table yet: winner() counts a miss
    with _LOCK:
        if _CACHE.get("path") == path and _CACHE.get("mtime") == mtime:
            return _CACHE["data"]
    try:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError("autotune table is not a map")
    except (OSError, ValueError):
        obs.count("autotune.stale")     # corrupt: read as empty
        return {}
    with _LOCK:
        _CACHE.update({"path": path, "mtime": mtime, "data": data})
    return data


def winner(kind: str, geom_key: str, *,
           backend_name: Optional[str] = None) -> Optional[str]:
    """The recorded winner for ``(kind, backend, geom_key)``, or None
    (no table, a miss, or a stale entry). ``backend_name`` defaults to
    :func:`backend`; a check passes its device's type."""
    if table_path() is None:
        return None
    data = _load()
    if not data:
        obs.count("autotune.miss")
        return None
    if data.get("version") != _VERSION:
        obs.count("autotune.stale")
        return None
    be = backend_name if backend_name is not None else backend()
    entries = data.get("entries")
    entry = entries.get(_entry_key(kind, be, geom_key)) \
        if isinstance(entries, dict) else None
    if not isinstance(entry, dict):
        obs.count("autotune.miss")
        return None
    if any(entry.get(k) != v for k, v in _stamp(be).items()):
        obs.count("autotune.stale")
        return None
    obs.count("autotune.hit")
    return str(entry["body"]) if entry.get("body") else None


def record(kind: str, geom_key: str, body: str, *,
           metric: Optional[float] = None,
           detail: Optional[Dict[str, Any]] = None,
           backend_name: Optional[str] = None) -> Optional[str]:
    """Persist a measured winner (an atomic read, modify and write).
    Returns the table's path, or None when persistence is off or the
    disk refused the write. ``metric`` is the measured figure of merit
    (higher is better; kept for the reader, selection reads only
    ``body``)."""
    path = table_path()
    if path is None:
        return None
    try:
        data = _load()
        if data.get("version") != _VERSION or \
                not isinstance(data.get("entries"), dict):
            data = {"version": _VERSION, "entries": {}}
        be = backend_name if backend_name is not None else backend()
        entry: Dict[str, Any] = {"body": body, **_stamp(be)}
        if metric is not None:
            entry["metric"] = round(float(metric), 6)
        if detail:
            entry["detail"] = detail
        data["entries"][_entry_key(kind, be, geom_key)] = entry
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        with _LOCK:
            _CACHE.clear()          # the next lookup re-reads the file
        obs.count("autotune.record")
        return path
    except OSError:
        obs.count("autotune.record_failed")
        return None

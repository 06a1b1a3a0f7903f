"""Result persistence — upstream ``jepsen/src/jepsen/store.clj``:
``store/<test-name>/<timestamp>/`` directories with the serialized test,
history, results, and logs, plus a ``latest`` symlink.

The upstream serializes with fressian (JVM binary); here the formats are
JSONL for histories (crash-safe, append-only), JSON for results, and EDN
exports for interop with upstream tooling (``history.edn`` readable by
real Jepsen / knossos and vice versa via
:func:`jepsen_tpu_torch.history.load_edn`). The layout is the
``jepsen_tpu`` package's, so a run dir either package writes loads in
the other. Host only.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Mapping, Optional

from jepsen_tpu_torch import edn
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch.op import Op

log = logging.getLogger("jepsen.store")

# keys that are live objects, not data — skipped when serializing the test
# map (the upstream stores fressian handlers for these; we store repr)
_LIVE_KEYS = ("client", "db", "os", "net", "nemesis", "generator", "checker",
              "model", "remote", "cluster", "active-processes", "history",
              "results")


# -- the persistent memo tier's root -----------------------------------------
#
# A fresh process re-ran the memo BFS for every alphabet it had already
# enumerated: the disk tier (:mod:`jepsen_tpu_torch.checkers.reach`)
# lives under the store dir, ``<store-root>/.cache/memo``, so a recheck
# of a stored run starts warm. ``JEPSEN_TPU_NO_PERSIST=1`` turns it off;
# ``JEPSEN_TPU_CACHE_DIR`` moves it. The names are the reference's, so
# one switch covers both packages. There is no compilation cache: the
# port's warm start for its kernels is ``_build/``.

_PERSIST_STATE: Dict[str, Any] = {}


def persist_root(store_root: Optional[str] = None) -> Optional[str]:
    """Root directory of the persistent caches, or None when persistence
    is off (``JEPSEN_TPU_NO_PERSIST``). ``JEPSEN_TPU_CACHE_DIR`` when
    set, else ``<store-root>/.cache``: ``store_root``, or the last root
    a run recorded (:func:`create_run_dir`), or ``store``. The
    environment is read at every call."""
    if os.environ.get("JEPSEN_TPU_NO_PERSIST"):
        return None
    d = os.environ.get("JEPSEN_TPU_CACHE_DIR")
    if d:
        return d
    root = store_root or _PERSIST_STATE.get("root") or "store"
    return os.path.join(root, ".cache")


def create_run_dir(test: Mapping) -> str:
    root = test.get("store-root", "store")
    # key the caches under THIS run's store root for the rest of the
    # process, as the reference's enable_compilation_cache records it:
    # only while persistence is on
    if persist_root(root) is not None:
        _PERSIST_STATE["root"] = root
    name = str(test.get("name", "test")).replace("/", "_")
    ts = test.get("start-time") or "run"
    d = os.path.join(root, name, ts)
    n = 0
    base = d
    while os.path.exists(d):
        n += 1
        d = f"{base}-{n}"
    os.makedirs(d, exist_ok=True)
    _symlink_latest(os.path.join(root, name), d)
    _symlink_latest(root, d)
    return d


def _symlink_latest(parent: str, target: str) -> None:
    link = os.path.join(parent, "latest")
    try:
        if os.path.islink(link):
            os.unlink(link)
        os.symlink(os.path.relpath(target, parent), link)
    except OSError:                                     # e.g. on Windows
        pass


def attach_log(run_dir: str) -> logging.Handler:
    """Tee the jepsen logger into ``<dir>/jepsen.log`` (upstream logback
    config writes the same file). Returns the handler; callers must pass
    it to :func:`detach_log` when the run ends or handlers accumulate
    across runs in one process."""
    handler = logging.FileHandler(os.path.join(run_dir, "jepsen.log"))
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s [%(name)s] %(message)s"))
    logging.getLogger("jepsen").addHandler(handler)
    return handler


def detach_log(handler: logging.Handler) -> None:
    logging.getLogger("jepsen").removeHandler(handler)
    handler.close()


def _serializable_test(test: Mapping) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in test.items():
        if k in _LIVE_KEYS:
            if v is not None:
                out[k] = repr(v)
        else:
            try:
                json.dumps(v)
                out[k] = v
            except (TypeError, ValueError):
                out[k] = repr(v)
    return out


def save(test: Mapping, run_dir: Optional[str] = None) -> str:
    """Persist a completed test (upstream ``store/save!``): ``test.json``,
    ``results.json`` + ``results.edn``, ``history.jsonl`` (if not already
    streamed), ``history.edn``, ``history.txt``."""
    run_dir = run_dir or test.get("dir") or create_run_dir(test)
    history: List[Op] = test.get("history", [])

    with open(os.path.join(run_dir, "test.json"), "w") as f:
        json.dump(_serializable_test(test), f, indent=2, default=str)

    results = test.get("results", {})
    with open(os.path.join(run_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2, default=str)
    with open(os.path.join(run_dir, "results.edn"), "w") as f:
        f.write(edn.dumps(results) + "\n")

    jsonl = os.path.join(run_dir, "history.jsonl")
    if not os.path.exists(jsonl):
        h.save_jsonl(history, jsonl)
    h.save_edn(history, os.path.join(run_dir, "history.edn"))
    with open(os.path.join(run_dir, "history.txt"), "w") as f:
        for op in history:
            f.write(f"{op.process}\t{op.type}\t{op.f}\t{op.value!r}\n")
    return run_dir


def save_check(root: str, name: str, run_id: str, history: List[Op],
               results: Mapping) -> str:
    """Persist one standalone check (the ``check`` command's
    ``--store-root``) as a browsable run dir —
    ``<root>/<name>/<ts>-<run_id>/``. Delegates to :func:`save`, so the
    artifact set (``results.json``/``.edn``, ``history.jsonl``/
    ``.edn``/``.txt``, ``test.json``) is one."""
    import time as _time
    ts = _time.strftime("%Y%m%dT%H%M%S", _time.gmtime())
    d = os.path.join(root, str(name).replace("/", "_"),
                     f"{ts}-{run_id}")
    os.makedirs(d, exist_ok=True)
    return save({"name": name, "history": list(history),
                 "results": results}, run_dir=d)


def save_obs(run_dir: str, capture: Optional[Any] = None) -> None:
    """Persist the run's observability record next to its history:
    ``obs.jsonl`` (spans + counters + engine-decision ledger, one JSON
    object per line) and ``trace.json`` (Chrome/Perfetto
    ``trace_event`` — load in ``chrome://tracing`` or ui.perfetto.dev).
    ``capture`` is the run's :class:`jepsen_tpu_torch.obs.Capture`
    (None exports the process-wide recorder). Best-effort: persistence
    failures must never fail a completed run."""
    from jepsen_tpu_torch import obs
    try:
        obs.export_jsonl(os.path.join(run_dir, "obs.jsonl"), capture)
        obs.export_trace(os.path.join(run_dir, "trace.json"), capture)
    except Exception as e:                              # noqa: BLE001
        log.warning("obs export to %s failed: %s", run_dir, e)


def serve_journal_dir(root: str) -> str:
    """The check-serve daemon's admission journal,
    ``<root>/serve/journal/`` (created), beside its ``stats.json``
    (:mod:`jepsen_tpu_torch.serve.journal`)."""
    d = os.path.join(root, "serve", "journal")
    os.makedirs(d, exist_ok=True)
    return d


def serve_profile_dir(root: str) -> str:
    """A fresh directory (created) for one capture of the daemon's
    on-demand profiler, ``<root>/serve/profile-<ts>[-n]/``."""
    import time as _time
    base = os.path.join(root, "serve", "profile-"
                        + _time.strftime("%Y%m%dT%H%M%S", _time.gmtime()))
    d, n = base, 0
    while os.path.exists(d):
        n += 1
        d = f"{base}-{n}"
    os.makedirs(d, exist_ok=True)
    return d


def load_history(run_dir: str) -> List[Op]:
    """Load a stored history for offline re-analysis (the upstream
    re-check path)."""
    jsonl = os.path.join(run_dir, "history.jsonl")
    if os.path.exists(jsonl):
        return h.load_jsonl(jsonl)
    p = os.path.join(run_dir, "history.edn")
    if os.path.exists(p):
        return h.load_edn(p)
    raise FileNotFoundError(f"no history in {run_dir}")


def load_results(run_dir: str) -> Dict[str, Any]:
    with open(os.path.join(run_dir, "results.json")) as f:
        return json.load(f)


def tests(root: str = "store") -> Dict[str, List[str]]:
    """Map test name → sorted run dirs (upstream ``store/tests``)."""
    out: Dict[str, List[str]] = {}
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if name == "latest" or not os.path.isdir(d):
            continue
        runs = sorted(
            os.path.join(d, r) for r in os.listdir(d)
            if r != "latest" and os.path.isdir(os.path.join(d, r)))
        if runs:
            out[name] = runs
    return out


def latest(root: str = "store") -> Optional[str]:
    link = os.path.join(root, "latest")
    if os.path.islink(link) or os.path.isdir(link):
        return os.path.realpath(link)
    return None

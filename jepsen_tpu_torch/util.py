"""Small shared utilities — upstream: ``jepsen/src/jepsen/util.clj``:
the helpers shared by history packing, EDN and the transactional
checker, and those of the test runner (``majority``, ``node_names``,
``with_retry``, ``meh`` ...)."""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Optional, TypeVar

T = TypeVar("T")


def hashable(v: Any) -> Any:
    """Deep-freeze a JSON/EDN-style value into a hashable equivalent
    (lists → tuples, dicts → sorted kv-tuples, sets → frozensets)."""
    if isinstance(v, list):
        return tuple(hashable(x) for x in v)
    if isinstance(v, tuple):
        return tuple(hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted(((hashable(k), hashable(x)) for k, x in v.items()),
                            key=repr))
    if isinstance(v, (set, frozenset)):
        return frozenset(hashable(x) for x in v)
    return v


def hashable_seq(v: Any) -> tuple:
    """``tuple(hashable(x) for x in v)`` with the common-case fast path:
    when ``tuple(v)`` already hashes (list-append read values are almost
    always flat int/str lists), return it directly. ``hashable`` is the
    identity on hashable elements, so the two forms are equal; a nested
    unhashable raises TypeError from ``hash`` and takes the deep-freeze
    path."""
    try:
        tv = tuple(v)
        hash(tv)
        return tv
    except TypeError:
        return tuple(hashable(x) for x in v)


# built eagerly: a lazy first-entrant build races (two threads could
# each install their own lock and count depth without exclusion)
_GC_PAUSE_LOCK = threading.Lock()
_GC_PAUSE_DEPTH = 0
_GC_PAUSE_RESUME = False


@contextmanager
def gc_paused():
    """Pause the cyclic GC across a bulk-allocation phase. The txn
    collect/infer loops build millions of long-lived tuples; every
    gen0/gen1 collection re-scans the growing survivor set, which turns
    a linear host pass super-linear. Nothing allocated there is cyclic
    garbage. Re-entrant and thread-counted: the first entrant disables
    (only if GC was on), the last exit re-enables; a caller that had GC
    off keeps it off."""
    import gc
    global _GC_PAUSE_DEPTH, _GC_PAUSE_RESUME
    with _GC_PAUSE_LOCK:
        _GC_PAUSE_DEPTH += 1
        if _GC_PAUSE_DEPTH == 1:
            _GC_PAUSE_RESUME = gc.isenabled()
            if _GC_PAUSE_RESUME:
                gc.disable()
    try:
        yield
    finally:
        with _GC_PAUSE_LOCK:
            _GC_PAUSE_DEPTH -= 1
            if _GC_PAUSE_DEPTH == 0 and _GC_PAUSE_RESUME:
                gc.enable()


def majority(n: int) -> int:
    """Smallest majority of ``n`` nodes (upstream ``jepsen.util/majority``)."""
    return n // 2 + 1


def node_names(nodes) -> list:
    """Normalize a suite's ``nodes`` argument: a count becomes
    ``["n1", ..., "nN"]``, a bare string is ONE node name (not a char
    sequence), anything else is taken as a list of names."""
    if isinstance(nodes, int):
        return [f"n{i + 1}" for i in range(nodes)]
    if isinstance(nodes, str):
        return [nodes]
    return list(nodes)


def relative_time_nanos(start: float) -> int:
    """Nanoseconds since ``start`` (a ``time.monotonic()`` instant) —
    upstream ``jepsen.util/relative-time-nanos``."""
    return int((time.monotonic() - start) * 1e9)


def with_retry(fn: Callable[[], T], retries: int = 3,
               delay: float = 0.1,
               exceptions: tuple = (Exception,)) -> T:
    """Call ``fn``, retrying on failure (upstream ``jepsen.util/with-retry``)."""
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203
            last = e
            if attempt < retries:
                time.sleep(delay * (2 ** attempt))
    assert last is not None
    raise last


def meh(fn: Callable[[], T]) -> Optional[T]:
    """Run ``fn``, swallowing exceptions (upstream ``jepsen.util/meh``)."""
    try:
        return fn()
    except Exception:
        return None


def map_vals(f: Callable[[Any], Any], d: dict) -> dict:
    """Map ``f`` over a dict's values (upstream ``jepsen.util/map-vals``)."""
    return {k: f(v) for k, v in d.items()}


def pprint_str(x: Any) -> str:
    """Pretty-print to a string (upstream ``jepsen.util/pprint-str``)."""
    import pprint
    return pprint.pformat(x, width=78)


def log_op(op: Any) -> None:
    """Log one operation in the jepsen console style (upstream
    ``jepsen.util/log-op``)."""
    import logging
    logging.getLogger("jepsen.ops").info(
        "%s\t%s\t%s\t%r", op.process, op.type, op.f, op.value)


class with_thread_name:
    """Context manager renaming the current thread (upstream
    ``jepsen.util/with-thread-name``) — thread names show in log lines."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import threading
        self._old = threading.current_thread().name
        threading.current_thread().name = self.name
        return self

    def __exit__(self, *exc):
        import threading
        threading.current_thread().name = self._old

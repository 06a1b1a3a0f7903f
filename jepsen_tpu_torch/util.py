"""Small shared utilities — upstream: ``jepsen/src/jepsen/util.clj``:
the helpers shared by history packing, EDN and the transactional
checker."""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any


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

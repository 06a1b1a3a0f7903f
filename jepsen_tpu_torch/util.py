"""Small shared utilities — upstream: ``jepsen/src/jepsen/util.clj``.
Only the helper shared by history packing and EDN lives here so far."""
from __future__ import annotations

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

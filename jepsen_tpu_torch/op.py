"""Operation representation — upstream: ``knossos/src/knossos/op.clj`` and the
op maps threaded through ``jepsen/src/jepsen/core.clj`` (see SURVEY.md §2.2).

An operation is a small record ``{process, type, f, value, time, index}``:

- ``process`` — logical process id (int), or the string ``"nemesis"``.
- ``type`` — one of ``invoke`` / ``ok`` / ``fail`` / ``info``.
- ``f`` — the function, e.g. ``"read"`` / ``"write"`` / ``"cas"``.
- ``value`` — argument or result (op-dependent; ``None`` for an unknown read).
- ``time`` — nanoseconds since test start (-1 if unrecorded).
- ``index`` — dense position in the history (-1 until indexed).

Unlike the upstream Clojure maps, ``Op`` is a slotted dataclass for speed, but
converts losslessly to/from plain dicts (the JSONL wire format) via
``to_dict`` / ``from_dict``; unknown keys ride along in ``extra``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Union

INVOKE = "invoke"
OK = "ok"
FAIL = "fail"
INFO = "info"

TYPES = (INVOKE, OK, FAIL, INFO)

Process = Union[int, str]

_CORE_KEYS = ("process", "type", "f", "value", "time", "index")


@dataclass(frozen=True, slots=True)
class Op:
    process: Process
    type: str
    f: Optional[str]
    value: Any = None
    time: int = -1
    index: int = -1
    extra: Optional[Dict[str, Any]] = field(default=None, compare=False)

    def __post_init__(self) -> None:
        if self.type not in TYPES:
            raise ValueError(f"bad op type {self.type!r}; want one of {TYPES}")

    # -- predicates (upstream knossos.op/invoke? ok? fail? info?) ------------
    @property
    def is_invoke(self) -> bool:
        return self.type == INVOKE

    @property
    def is_ok(self) -> bool:
        return self.type == OK

    @property
    def is_fail(self) -> bool:
        return self.type == FAIL

    @property
    def is_info(self) -> bool:
        return self.type == INFO

    @property
    def is_nemesis(self) -> bool:
        return self.process == "nemesis"

    def with_(self, **kw: Any) -> "Op":
        return replace(self, **kw)

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "process": self.process,
            "type": self.type,
            "f": self.f,
            "value": self.value,
        }
        if self.time >= 0:
            d["time"] = self.time
        if self.index >= 0:
            d["index"] = self.index
        if self.extra:
            d.update(self.extra)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Op":
        extra = {k: v for k, v in d.items() if k not in _CORE_KEYS}
        return cls(
            process=d["process"],
            type=d["type"],
            f=d.get("f"),
            value=d.get("value"),
            time=d.get("time", -1),
            index=d.get("index", -1),
            extra=extra or None,
        )

    def __repr__(self) -> str:  # compact, jepsen-log-like
        return (f"Op({self.process} {self.type} {self.f}"
                f" {self.value!r}@{self.index})")


# -- constructors (upstream knossos.op/invoke ok fail info) ------------------

def invoke(process: Process, f: str, value: Any = None, **kw: Any) -> Op:
    return Op(process, INVOKE, f, value, **kw)


def ok(process: Process, f: str, value: Any = None, **kw: Any) -> Op:
    return Op(process, OK, f, value, **kw)


def fail(process: Process, f: str, value: Any = None, **kw: Any) -> Op:
    return Op(process, FAIL, f, value, **kw)


def info(process: Process, f: str, value: Any = None, **kw: Any) -> Op:
    return Op(process, INFO, f, value, **kw)

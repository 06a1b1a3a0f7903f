"""Minimal EDN reader/writer for Jepsen interop.

Upstream Jepsen persists histories and results as EDN (``history.edn``,
``results.edn`` via ``jepsen.store``; knossos ships recorded test histories
as EDN under ``data/`` — SURVEY.md §2.2, §4). This is a small, dependency-free
subset parser sufficient for those files: maps, vectors, lists, sets,
keywords, symbols, strings, numbers, nil/true/false, and ``#tag`` forms
(tags are dropped, the tagged value kept).

Keywords parse to plain strings without the colon (``:invoke`` → ``"invoke"``)
— matching this framework's string-typed ops. ``dumps`` writes the keys that
Jepsen expects as keywords (``:process :type :f :value :time :index``) back
as keywords so round-trips stay Jepsen-readable.
"""
from __future__ import annotations

import re
from typing import Any, List, Tuple

from jepsen_tpu_torch.util import hashable

_WS = set(" \t\n\r,")
_DELIM = set("()[]{}\"") | _WS
# strings that may be safely written as EDN keywords (:name tokens)
_KEYWORD_RE = re.compile(r"^[A-Za-z*+!_?<>=.-][A-Za-z0-9*+!_?<>=.#:/-]*$")
_KEYWORD_KEYS = {"process", "type", "f", "value", "time", "index", "valid?",
                 "read", "write", "cas", "invoke", "ok", "fail", "info",
                 "nemesis", "acquire", "release", "add", "lock", "unlock",
                 "enqueue", "dequeue", "start", "stop", "txn",
                 # list-append micro-op kinds (Elle's [:append k v] /
                 # [:r k vs] vectors round-trip as keywords)
                 "append", "r"}


class Keyword(str):
    """A parsed keyword; subclass of str so it compares equal to the bare
    name (``Keyword("read") == "read"``)."""
    __slots__ = ()


class Symbol(str):
    __slots__ = ()


def loads(text: str) -> Any:
    vals = loads_all(text)
    if len(vals) != 1:
        raise ValueError(f"expected one EDN form, got {len(vals)}")
    return vals[0]


def loads_all(text: str) -> List[Any]:
    vals: List[Any] = []
    i = 0
    n = len(text)
    while True:
        i = _skip_discards(text, i)
        if i >= n:
            return vals
        v, i = _read(text, i)
        vals.append(v)


def _skip_discards(s: str, i: int) -> int:
    """Skip whitespace and any ``#_form`` discard forms."""
    while True:
        i = _skip_ws(s, i)
        if s.startswith("#_", i):
            j = _skip_ws(s, i + 2)
            if j >= len(s):
                raise ValueError("#_ discard with nothing to discard")
            _, i = _read(s, j)
        else:
            return i


def _skip_ws(s: str, i: int) -> int:
    n = len(s)
    while i < n:
        c = s[i]
        if c in _WS:
            i += 1
        elif c == ";":  # comment to EOL
            while i < n and s[i] != "\n":
                i += 1
        else:
            break
    return i


def _read(s: str, i: int) -> Tuple[Any, int]:
    c = s[i]
    if c == "{":
        return _read_map(s, i + 1)
    if c == "[":
        return _read_seq(s, i + 1, "]")
    if c == "(":
        return _read_seq(s, i + 1, ")")
    if c == '"':
        return _read_string(s, i + 1)
    if c == "#":
        if i + 1 < len(s) and s[i + 1] == "{":
            vals, j = _read_seq(s, i + 2, "}")
            return set(hashable(v) for v in vals), j
        if s.startswith("#_", i):  # discard form, then read the next value
            return _read(s, _skip_discards(s, i))
        # tagged literal: read tag symbol then value; keep value
        j = i + 1
        while j < len(s) and s[j] not in _DELIM:
            j += 1
        return _read(s, _skip_ws(s, j))
    if c == ":":
        j = i + 1
        while j < len(s) and s[j] not in _DELIM:
            j += 1
        return Keyword(s[i + 1:j]), j
    if c == "\\":  # character literal
        j = i + 1
        while j < len(s) and s[j] not in _DELIM:
            j += 1
        name = s[i + 1:j]
        chars = {"newline": "\n", "space": " ", "tab": "\t", "return": "\r"}
        return chars.get(name, name[:1]), j
    # token: number, nil, true, false, symbol
    j = i
    while j < len(s) and s[j] not in _DELIM:
        j += 1
    tok = s[i:j]
    return _token(tok), j


def _token(tok: str) -> Any:
    if tok == "nil":
        return None
    if tok == "true":
        return True
    if tok == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok.rstrip("M"))
    except ValueError:
        pass
    if tok.endswith("N"):
        try:
            return int(tok[:-1])
        except ValueError:
            pass
    return Symbol(tok)


def _read_string(s: str, i: int) -> Tuple[str, int]:
    out: List[str] = []
    while i < len(s):
        c = s[i]
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            i += 1
            esc = s[i]
            out.append({"n": "\n", "t": "\t", "r": "\r", '"': '"',
                        "\\": "\\"}.get(esc, esc))
        else:
            out.append(c)
        i += 1
    raise ValueError("unterminated string")


def _read_seq(s: str, i: int, close: str) -> Tuple[List[Any], int]:
    out: List[Any] = []
    while True:
        i = _skip_discards(s, i)
        if i >= len(s):
            raise ValueError(f"unterminated sequence, expected {close}")
        if s[i] == close:
            return out, i + 1
        v, i = _read(s, i)
        out.append(v)


def _read_map(s: str, i: int) -> Tuple[dict, int]:
    vals, i = _read_seq(s, i, "}")
    if len(vals) % 2:
        raise ValueError("map literal with odd number of forms")
    return {hashable(vals[k]): vals[k + 1] for k in range(0, len(vals), 2)}, i


def to_plain(v: Any) -> Any:
    """Deep-convert parsed EDN to plain Python: keywords/symbols → str,
    vectors → lists. Composite map keys (vectors/maps, stored hashably as
    tuples) stay tuples so the result remains a legal dict."""
    if isinstance(v, (Keyword, Symbol)):
        return str(v)
    if isinstance(v, dict):
        return {_plain_key(k): to_plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [to_plain(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return {_plain_key(x) for x in v}
    return v


def _plain_key(k: Any) -> Any:
    """Like :func:`to_plain` but keeps the result hashable (tuples stay
    tuples) so it can serve as a dict key or set element."""
    if isinstance(k, (Keyword, Symbol)):
        return str(k)
    if isinstance(k, (tuple, frozenset)):
        return type(k)(_plain_key(x) for x in k)
    return k


def dumps(v: Any) -> str:
    out: List[str] = []
    _emit(v, out, keyword_context=False)
    return "".join(out)


def _emit(v: Any, out: List[str], keyword_context: bool) -> None:
    if v is None:
        out.append("nil")
    elif v is True:
        out.append("true")
    elif v is False:
        out.append("false")
    elif isinstance(v, Keyword):
        out.append(":" + v)
    elif isinstance(v, str):
        if keyword_context and v in _KEYWORD_KEYS and " " not in v:
            out.append(":" + v)
        else:
            out.append('"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"')
    elif isinstance(v, (int, float)):
        out.append(repr(v))
    elif isinstance(v, dict):
        out.append("{")
        first = True
        for k, x in v.items():
            if not first:
                out.append(", ")
            first = False
            key = (Keyword(k) if isinstance(k, str) and not
                   isinstance(k, (Keyword, Symbol)) and _KEYWORD_RE.match(k)
                   else k)
            _emit(key, out, False)
            out.append(" ")
            _emit(x, out, keyword_context=True)
        out.append("}")
    elif isinstance(v, (list, tuple)):
        out.append("[")
        for j, x in enumerate(v):
            if j:
                out.append(" ")
            _emit(x, out, keyword_context)
        out.append("]")
    elif isinstance(v, (set, frozenset)):
        out.append("#{")
        for j, x in enumerate(sorted(v, key=repr)):
            if j:
                out.append(" ")
            _emit(x, out, keyword_context)
        out.append("}")
    else:
        _emit(str(v), out, keyword_context)

"""History preprocessing — upstream: ``knossos/src/knossos/history.clj``
(``index``, ``pair-index``, ``complete``) plus the history vector built by
``jepsen/src/jepsen/core.clj``'s worker loop (SURVEY.md §2.2, §3.2).

A history is a list of :class:`~jepsen_tpu_torch.op.Op` in wall-clock order:
``invoke`` events interleaved with their ``ok`` / ``fail`` / ``info``
completions. This module turns that into the analyzable form used by every
checker:

- :func:`index` — assign dense integer ``index`` to each event.
- :func:`pair` — match each invocation with its completion (per process).
- :func:`analysis_entries` — the checker's input: failed ops stripped
  (a ``fail`` completion asserts the op did not take effect), nemesis ops
  dropped, invoke values completed from the ``ok`` event (a read's observed
  value lives on the completion), crashed ops (``info`` / dangling invokes)
  kept forever-pending. Matches knossos verdict semantics (SURVEY.md §7
  "hard parts" #4).
- :func:`pack` — structure-of-arrays int encoding for the device solver.

Serialization: :func:`save_jsonl` / :func:`load_jsonl` (this framework's
native crash-safe append format) and :func:`load_edn` / :func:`save_edn`
(interop with Jepsen's on-disk ``history.edn`` and the knossos ``data/``
fixtures).
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch import edn
from jepsen_tpu_torch.op import FAIL, INFO, INVOKE, OK, Op
from jepsen_tpu_torch.util import hashable


def index(history: Sequence[Op]) -> List[Op]:
    """Assign dense integer ``index`` to every op (upstream
    ``knossos.history/index``)."""
    return [op.with_(index=i) for i, op in enumerate(history)]


@dataclass(frozen=True)
class Pair:
    """An invocation and its completion (``None`` when the op never
    completed — the process crashed)."""
    invoke: Op
    complete: Optional[Op]

    @property
    def crashed(self) -> bool:
        return self.complete is None or self.complete.type == INFO

    @property
    def failed(self) -> bool:
        return self.complete is not None and self.complete.type == FAIL


def pair(history: Sequence[Op]) -> List[Pair]:
    """Match invocations to completions, one outstanding op per process
    (upstream ``knossos.history/pair-index``). Ops must be ``index``-ed.

    Nemesis and bare ``info`` events without a pending invocation are
    ignored — they carry no client semantics.
    """
    pending: Dict[Any, Op] = {}
    pairs: List[Pair] = []
    for op in history:
        if op.process == "nemesis":
            continue
        if op.type == INVOKE:
            if op.process in pending:
                raise ValueError(
                    f"process {op.process} invoked {op} while "
                    f"{pending[op.process]} is still pending")
            pending[op.process] = op
        else:
            inv = pending.pop(op.process, None)
            if inv is None:
                # completion with no invocation: stray info (e.g. nemesis on a
                # numeric process) — ignore, like knossos does.
                continue
            pairs.append(Pair(inv, op))
    # dangling invokes = crashed ops, forever pending
    for inv in pending.values():
        pairs.append(Pair(inv, None))
    pairs.sort(key=lambda p: p.invoke.index)
    return pairs


@dataclass(frozen=True)
class Entry:
    """One logical operation, ready for analysis.

    ``eid`` is the dense entry id (invocation order). ``inv_ev``/``ret_ev``
    are event ranks usable for real-time ordering; ``ret_ev`` is
    ``INF_EV`` (> any real rank) for crashed ops. ``op`` is the merged op:
    ``f`` from the invocation, ``value`` preferring the completion's (the
    observed result), as in ``knossos.history/complete``.
    """
    eid: int
    op: Op
    inv_ev: int
    ret_ev: int
    crashed: bool

    @property
    def process(self) -> Any:
        return self.op.process


def analysis_entries(history: Sequence[Op]) -> List[Entry]:
    """History → entries for the linearizability search.

    Drops nemesis ops and failed pairs; completes values; keeps crashed ops
    pending forever (they may have taken effect at any later point, or
    never — the searches explore both).
    """
    hist = history
    if any(op.index < 0 for op in hist):
        hist = index(list(hist))
    inf_ev = 2 * len(hist) + 2
    entries: List[Entry] = []
    for p in pair(hist):
        if p.failed:
            continue
        inv, comp = p.invoke, p.complete
        value = inv.value
        crashed = p.crashed
        if comp is not None and comp.type == OK:
            value = comp.value if comp.value is not None else inv.value
        merged = inv.with_(value=value)
        entries.append(Entry(
            eid=len(entries),
            op=merged,
            inv_ev=inv.index,
            ret_ev=comp.index if (comp is not None and not crashed) else inf_ev,
            crashed=crashed,
        ))
    return entries


@dataclass(frozen=True)
class PackedHistory:
    """Structure-of-arrays encoding of the analysis entries (SURVEY.md §7.1).

    Entries are sorted by invocation; ``inv_ev``/``ret_ev`` int32 event
    ranks (``ret_ev = inf_ev`` for crashed ops); ``op_id`` indexes into
    ``distinct_ops`` (the per-history distinct (f, value) alphabet that the
    model memo table is built over); ``crashed`` marks forever-pending ops.
    Only these arrays cross into the device solver.
    """
    n: int
    inv_ev: np.ndarray      # i32[n]
    ret_ev: np.ndarray      # i32[n]
    op_id: np.ndarray       # i32[n]
    crashed: np.ndarray     # bool[n]
    inf_ev: int
    distinct_ops: Tuple[Op, ...]
    entries: Tuple[Entry, ...]
    # hashable (f, value) identity per distinct op, aligned with
    # ``distinct_ops`` — precomputed at pack time so the per-key batch
    # checkers (union-alphabet mapping, memo-cache signatures) never
    # recompute ``hashable`` over thousands of keys' op values
    op_keys: Tuple[Any, ...] = ()

    @property
    def n_ok(self) -> int:
        return int(self.n - self.crashed.sum())


def pack(history: Sequence[Op]) -> PackedHistory:
    """Pack a raw history into int arrays; the model-specific transition
    table is layered on by :func:`jepsen_tpu_torch.models.memo.memo`."""
    entries = analysis_entries(history)
    return pack_entries(entries)


def pack_entries(entries: Sequence[Entry]) -> PackedHistory:
    # the checkers' candidate scan requires invocation order; enforce it
    # here rather than trusting callers.
    entries = sorted(entries, key=lambda e: e.inv_ev)
    n = len(entries)
    inf_ev = max([2] + [e.ret_ev for e in entries] + [e.inv_ev + 1 for e in entries])
    inv_ev = np.zeros(n, np.int32)
    ret_ev = np.zeros(n, np.int32)
    op_id = np.zeros(n, np.int32)
    crashed = np.zeros(n, bool)
    distinct: Dict[Tuple[Any, Any], int] = {}
    ops: List[Op] = []
    for i, e in enumerate(entries):
        inv_ev[i] = e.inv_ev
        ret_ev[i] = e.ret_ev
        crashed[i] = e.crashed
        key = (e.op.f, hashable(e.op.value))
        if key not in distinct:
            distinct[key] = len(ops)
            ops.append(e.op)
        op_id[i] = distinct[key]
    return PackedHistory(
        n=n, inv_ev=inv_ev, ret_ev=ret_ev, op_id=op_id, crashed=crashed,
        inf_ev=int(inf_ev), distinct_ops=tuple(ops), entries=tuple(entries),
        op_keys=tuple(distinct))


def op_keys_of(packed: PackedHistory) -> Tuple[Any, ...]:
    """The hashable distinct-op identities of ``packed``, from the
    pack-time cache when present (PackedHistory instances built by
    other constructors may lack it)."""
    if len(packed.op_keys) == len(packed.distinct_ops):
        return packed.op_keys
    return tuple((op.f, hashable(op.value)) for op in packed.distinct_ops)


# -- serialization -----------------------------------------------------------

def save_jsonl(history: Iterable[Op], path: str) -> None:
    with open(path, "w") as f:
        for op in history:
            f.write(json.dumps(op.to_dict(), default=str) + "\n")


def load_jsonl(path: str) -> List[Op]:
    out: List[Op] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(Op.from_dict(json.loads(line)))
    return index(out) if out and out[0].index < 0 else out


def load_edn(path: str) -> List[Op]:
    """Read a Jepsen/knossos EDN history (a top-level vector of op maps, or
    one op map per line as in ``history.edn``)."""
    with open(path) as f:
        text = f.read()
    data = edn.loads_all(text)
    if len(data) == 1 and isinstance(data[0], list):
        data = data[0]
    ops = [Op.from_dict(edn.to_plain(d)) for d in data]
    return index(ops) if ops and ops[0].index < 0 else ops


def save_edn(history: Iterable[Op], path: str) -> None:
    with open(path, "w") as f:
        for op in history:
            f.write(edn.dumps(op.to_dict()) + "\n")

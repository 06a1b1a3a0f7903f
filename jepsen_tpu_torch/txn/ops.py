"""Transactional operations — the Elle-style list-append / rw-register
workload shape (Kingsbury & Alvaro, *Elle*, VLDB 2020; upstream
``jepsen.tests.cycle.append``), as in the reference's
``jepsen_tpu/txn/ops.py``.

A transaction op is an :class:`~jepsen_tpu_torch.op.Op` with ``f == "txn"``
whose value is a vector of micro-ops::

    [["append", k, v], ["r", k, [v1, v2, ...]]]

mirroring Elle's ``[[:append k v] [:r k vs]]``. On the invocation the
read micro-ops carry ``None`` (the observed version lives on the ``ok``
completion, exactly like register reads). The EDN round-trip rides
:mod:`jepsen_tpu_torch.edn` unchanged — ``:append`` / ``:r`` parse to plain
strings and are written back as keywords.

This module provides the op constructors/validators, the
invoke/complete pairing (:func:`collect` — committed txns kept,
``fail`` txns set aside for G1a detection, ``info`` txns kept with
their reads untrusted), and :func:`pack_txns` — the dense int-tensor
encoding of a txn history (txn id / kind / key code / value code per
micro-op, flat read-version arrays) in the narrowest dtypes
:func:`idx_dtype` admits (the reference's ``transfer.idx_dtype`` rule,
kept here because the port has no ``transfer`` module yet).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch.models import Model, StepResult, inconsistent
from jepsen_tpu_torch.op import Op
from jepsen_tpu_torch.util import hashable

APPEND = "append"
READ = "r"

# read spellings accepted on the wire; canonicalized to READ
_READ_ALIASES = (READ, "read")


def idx_dtype(n1: int):
    """Narrowest signed dtype holding indices in [-1, ``n1``): int8,
    int16, else int32 (the reference's ``transfer.idx_dtype``)."""
    if n1 <= np.iinfo(np.int8).max:
        return np.int8
    if n1 <= np.iinfo(np.int16).max:
        return np.int16
    return np.int32


class MalformedTxn(ValueError):
    """A txn op whose value is not a vector of well-formed micro-ops."""


@dataclass(frozen=True, slots=True)
class ListAppend(Model):
    """Marker model routing a history to the TRANSACTIONAL checker
    (``facade.auto_check_txn``) instead of the linearizability engines.
    It carries no sequential step semantics — dependency-cycle search
    over the inferred wr/ww/rw graph replaces the state walk — so
    ``step`` refuses every op rather than pretend otherwise."""

    def step(self, op: Op) -> StepResult:
        return inconsistent(
            "ListAppend is a transactional model: route through "
            "facade.auto_check_txn, not the linearizable engines")


def list_append_model() -> ListAppend:
    return ListAppend()


def is_txn_op(op: Op) -> bool:
    return op.f == "txn"


def micro_ops(value: Any) -> List[Tuple[str, Any, Any]]:
    """Normalize a txn op value to ``[(kind, key, val), ...]`` with
    ``kind`` in {"append", "r"}; read vals are None (unobserved) or a
    list of observed values. Raises :class:`MalformedTxn` otherwise."""
    if not isinstance(value, (list, tuple)):
        raise MalformedTxn(f"txn value must be a vector, got {value!r}")
    out: List[Tuple[str, Any, Any]] = []
    for m in value:
        # tuple-unpack instead of isinstance+len: one bytecode op on
        # the well-formed path (a hot loop of collect); a str of length
        # 3 unpacks too, but its chars then fail the kind dispatch below
        # like any junk
        if type(m) is not list and type(m) is not tuple:
            raise MalformedTxn(f"micro-op must be [kind k v], got {m!r}")
        try:
            kind, k, v = m
        except ValueError:
            raise MalformedTxn(
                f"micro-op must be [kind k v], got {m!r}") from None
        if kind == APPEND:
            out.append((APPEND, k, v))
        elif kind in _READ_ALIASES:
            if v is None:
                out.append((READ, k, None))
            elif isinstance(v, (list, tuple)):
                out.append((READ, k, list(v)))
            else:
                raise MalformedTxn(f"read version must be a vector or "
                                   f"nil, got {v!r}")
        else:
            raise MalformedTxn(f"unknown micro-op kind {kind!r}")
    return out


def txn(process: Any, micros: Sequence[Sequence[Any]], type: str = "invoke",
        **kw: Any) -> Op:
    """Construct a txn op (type defaults to the invocation)."""
    return Op(process, type, "txn", [list(m) for m in micros], **kw)


@dataclass(frozen=True)
class Txn:
    """One logical transaction ready for dependency inference.

    ``tid`` is dense over the KEPT (ok + info) transactions; ``micros``
    come from the completion when the txn returned ``ok`` (reads
    carry their observed versions) and from the invocation otherwise
    (an ``info`` txn's reads stay ``None`` — a version observed by a
    crashed client never reached anyone and cannot order anything).

    ``end`` is the completion op's history index for ``ok`` txns and
    ``-1`` for crashed ones — the start/commit interval
    (``op.index``, ``end``) the snapshot-isolation lattice level turns
    into commit-order edges. A crashed txn has no commit point, so it
    emits no such edges.
    """
    tid: int
    op: Op
    micros: Tuple[Tuple[str, Any, Any], ...]
    crashed: bool
    end: int = -1

    @property
    def process(self) -> Any:
        return self.op.process

    @property
    def index(self) -> int:
        return self.op.index

    def describe(self) -> Dict[str, Any]:
        return {"txn": self.tid, "process": self.process,
                "index": self.index, "crashed": self.crashed,
                "value": [list(m) for m in self.micros]}


@dataclass(frozen=True)
class FailedTxn:
    """A ``fail`` txn — definitely took no effect, but its attempted
    appends matter: a read observing one is a G1a aborted read."""
    op: Op
    micros: Tuple[Tuple[str, Any, Any], ...]


def collect(history: Sequence[Op]
            ) -> Tuple[List[Txn], List[FailedTxn]]:
    """Pair txn invocations with completions: ``ok`` txns keep the
    completed micro-ops, ``info`` (crashed) txns keep the invoked ones
    with reads untrusted, ``fail`` txns go to the aborted-append side
    table. Non-txn ops (nemesis, mixed workloads) are skipped."""
    hist = list(history)
    if any(op.index < 0 for op in hist):
        hist = h.index(hist)
    txns: List[Txn] = []
    fails: List[FailedTxn] = []
    for p in h.pair(hist):
        inv = p.invoke
        if not is_txn_op(inv):
            continue
        if p.failed:
            fails.append(FailedTxn(op=inv, micros=tuple(
                micro_ops(inv.value))))
            continue
        comp = p.complete
        value = inv.value
        if comp is not None and comp.type == "ok" \
                and comp.value is not None:
            value = comp.value
        micros = tuple(micro_ops(value))
        if p.crashed:
            # reads of a crashed txn never returned: blank them so the
            # inference cannot trust a version nobody observed
            micros = tuple((k, key, None) if k == READ else (k, key, v)
                           for k, key, v in micros)
        # the invocation op identifies the txn (process/index); the
        # completed micro-ops live in ``micros`` — the completed value is
        # not grafted back onto the op (a dataclasses.replace per txn),
        # a field no consumer reads
        end = -1
        if not p.crashed and comp is not None and comp.index >= 0:
            end = comp.index
        txns.append(Txn(tid=len(txns), op=inv,
                        micros=micros, crashed=p.crashed, end=end))
    return txns, fails


@dataclass(frozen=True)
class PackedTxns:
    """Dense int encoding of a txn history (structure-of-arrays, like
    :class:`~jepsen_tpu_torch.history.PackedHistory` for the linear
    engines):
    one row per micro-op, keys and per-key append values int-coded,
    read versions flattened into one code array with offset/length
    indexing. Every array is in the narrowest signed dtype
    :func:`idx_dtype` admits for its code space."""
    n_txns: int
    n_micros: int
    txn_id: np.ndarray       # idx[n_micros]
    kind: np.ndarray         # i8[n_micros]; 0 = append, 1 = read
    key_id: np.ndarray       # idx[n_micros]
    val_code: np.ndarray     # idx[n_micros]; appends only, reads -1
    read_off: np.ndarray     # i32[n_micros]; reads only, else -1
    read_len: np.ndarray     # idx[n_micros]; -1 = unknown read
    read_vals: np.ndarray    # idx[sum read lens]
    keys: Tuple[Any, ...]            # key_id -> key
    key_vals: Tuple[Tuple[Any, ...], ...]  # key_id -> (code -> value)

    @property
    def wire_bytes(self) -> int:
        return sum(int(a.nbytes) for a in
                   (self.txn_id, self.kind, self.key_id, self.val_code,
                    self.read_off, self.read_len, self.read_vals))


KIND_APPEND = 0
KIND_READ = 1


def pack_txns(txns: Sequence[Txn]) -> PackedTxns:
    """Int-code a collected txn history into dense tensors."""
    keys: Dict[Any, int] = {}
    vals: List[Dict[Any, int]] = []          # per key: value -> code

    def key_code(k: Any) -> int:
        hk = hashable(k)
        if hk not in keys:
            keys[hk] = len(keys)
            vals.append({})
        return keys[hk]

    def val_code_of(kid: int, v: Any) -> int:
        hv = hashable(v)
        m = vals[kid]
        if hv not in m:
            m[hv] = len(m)
        return m[hv]

    rows: List[Tuple[int, int, int, int, int, int]] = []
    read_flat: List[int] = []
    for t in txns:
        for kind, k, v in t.micros:
            kid = key_code(k)
            if kind == APPEND:
                rows.append((t.tid, KIND_APPEND, kid,
                             val_code_of(kid, v), -1, -1))
            else:
                if v is None:
                    rows.append((t.tid, KIND_READ, kid, -1, -1, -1))
                else:
                    off = len(read_flat)
                    read_flat.extend(val_code_of(kid, x) for x in v)
                    rows.append((t.tid, KIND_READ, kid, -1, off, len(v)))
    n_micros = len(rows)
    arr = np.asarray(rows, np.int64).reshape(n_micros, 6)
    max_val = max([1] + [len(m) for m in vals])
    # narrowest signed dtypes for each code space
    dt_tid = idx_dtype(max(len(txns), 1))
    dt_key = idx_dtype(max(len(keys), 1))
    dt_val = idx_dtype(max_val)
    dt_len = idx_dtype(max([1] + [r[5] for r in rows]))
    return PackedTxns(
        n_txns=len(txns), n_micros=n_micros,
        txn_id=arr[:, 0].astype(dt_tid),
        kind=arr[:, 1].astype(np.int8),
        key_id=arr[:, 2].astype(dt_key),
        val_code=arr[:, 3].astype(dt_val),
        read_off=arr[:, 4].astype(np.int32),
        read_len=arr[:, 5].astype(dt_len),
        read_vals=np.asarray(read_flat, np.int64).astype(dt_val),
        keys=tuple(sorted(keys, key=lambda k: keys[k])),
        key_vals=tuple(tuple(sorted(m, key=lambda v: m[v]))
                       for m in vals))

"""Model memoization — upstream: ``knossos/src/knossos/model/memo.clj``
(SURVEY.md §2.2): for a given history, precompute the reachable
(state × distinct-op) transition table so that states become small ints and
the search becomes pure table lookups. The device walk consumes this
table: it never steps a Python model, it reads ``T[state, op_id]``.

``memo(model, packed)`` BFS-enumerates states reachable from ``model`` under
the history's distinct op alphabet and returns a :class:`Memo` with:

- ``table`` — int32 ``[n_states, n_ops]``; ``-1`` marks an inconsistent
  (illegal) transition.
- ``states`` — state id → model object, for reporting.
- ``entry_op`` — convenience alias of ``packed.op_id``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch.history import PackedHistory
from jepsen_tpu_torch.models import Model, StepResult, inconsistent, \
    is_inconsistent
from jepsen_tpu_torch.op import Op


class StateExplosion(RuntimeError):
    """Raised when the reachable state space exceeds ``max_states`` — the
    caller should fall back to an un-memoized (object-stepping) search."""


@dataclass(frozen=True, slots=True)
class BoundedSetModel(Model):
    """Int-coded grow-only set over a BOUNDED element universe
    ``{0..universe-1}`` (ROADMAP item 3(a) opening move): state is one
    bitmask int, so the reachable space is at most ``2**universe`` and
    the memo BFS — hence the dense-walk device engines — admits set
    workloads that :class:`~jepsen_tpu_torch.models.SetModel` (frozenset
    state, unbounded alphabet) would push to host checking.

    ``add v`` (0 <= v < universe) sets bit ``v``; ``read`` with value
    ``None`` matches any state, otherwise the observed collection must
    equal the current contents exactly. Differentially equivalent to
    ``SetModel`` on in-universe histories (tests/test_models.py)."""
    mask: int = 0
    universe: int = 12

    def step(self, op: Op) -> StepResult:
        if op.f == "add":
            v = op.value
            if not isinstance(v, int) or not 0 <= v < self.universe:
                return inconsistent(
                    f"add {v!r} outside universe 0..{self.universe - 1}")
            return BoundedSetModel(self.mask | (1 << v), self.universe)
        if op.f == "read":
            if op.value is None:
                return self
            try:
                got = frozenset(int(x) for x in op.value)
            except (TypeError, ValueError):
                return inconsistent(f"unreadable set value {op.value!r}")
            here = frozenset(i for i in range(self.universe)
                             if self.mask >> i & 1)
            if got == here:
                return self
            return inconsistent(f"read {sorted(got)}, expected "
                                f"{sorted(here)}")
        return inconsistent(f"bounded-set cannot {op.f}")


@dataclass(frozen=True, slots=True)
class BoundedQueueModel(Model):
    """Int-coded FIFO queue over a bounded unique-value universe
    ``{0..universe-1}`` (the :class:`BoundedSetModel` trick applied to
    :class:`~jepsen_tpu_torch.models.FIFOQueue`): the pending items are one
    base-``(universe+1)`` int (little-endian, head at the lowest
    digit, digit ``v+1`` = value ``v``), so the reachable space is
    the arrangements of distinct values — 1957 states at the default
    ``universe=6`` — and queue workloads reach the memoized dense
    ``reach`` engine instead of host-only checking.

    Enqueueing a value that is already PENDING is inconsistent (the
    unique-value workloads never produce one; this is what keeps the
    state space to arrangements). Dequeue matches
    :class:`~jepsen_tpu_torch.models.FIFOQueue` exactly: empty-queue
    dequeue is inconsistent, a ``None`` value pops unchecked.
    Differentially equivalent to ``FIFOQueue`` on in-universe
    unique-enqueue histories (tests/test_models.py)."""
    code: int = 0
    universe: int = 6

    def _items(self) -> List[int]:
        base, c, out = self.universe + 1, self.code, []
        while c:
            out.append(c % base - 1)
            c //= base
        return out                              # head first

    def step(self, op: Op) -> StepResult:
        base = self.universe + 1
        if op.f == "enqueue":
            v = op.value
            if not isinstance(v, int) or not 0 <= v < self.universe:
                return inconsistent(
                    f"enqueue {v!r} outside universe "
                    f"0..{self.universe - 1}")
            items = self._items()
            if v in items:
                return inconsistent(f"enqueue of pending value {v!r}")
            return BoundedQueueModel(
                self.code + (v + 1) * base ** len(items),
                self.universe)
        if op.f == "dequeue":
            if not self.code:
                return inconsistent("dequeue from empty queue")
            head = self.code % base - 1
            if op.value is not None and head != op.value:
                return inconsistent(
                    f"dequeued {op.value!r}, expected {head!r}")
            return BoundedQueueModel(self.code // base, self.universe)
        return inconsistent(f"bounded-queue cannot {op.f}")


@dataclass(frozen=True, slots=True)
class BoundedMapModel(Model):
    """Int-coded register map over bounded key/value universes: keys
    ``{0..keys-1}``, values ``{0..vals-1}``, state one base-
    ``(vals+1)`` int (digit ``k`` is ``v+1``, 0 = unset) — at most
    ``(vals+1)**keys`` reachable states (625 at the defaults), the
    memo-friendly :class:`~jepsen_tpu_torch.models.MultiRegister`. Op
    values follow multi-register: ``{key: v}`` maps or ``[[k v]...]``
    pairs; ``read`` skips ``None``-valued keys and asserts the rest
    (an unset key reads as ``None``)."""
    code: int = 0
    keys: int = 4
    vals: int = 4

    def _pairs(self, op: Op):
        kvs = op.value
        if isinstance(kvs, dict):
            return list(kvs.items())
        if isinstance(kvs, (list, tuple)):
            return [tuple(p) for p in kvs]
        return None

    def step(self, op: Op) -> StepResult:
        items = self._pairs(op)
        if items is None:
            return inconsistent(f"bad bounded-map value {op.value!r}")
        base = self.vals + 1
        if op.f == "write":
            code = self.code
            for k, v in items:
                if not isinstance(k, int) or not 0 <= k < self.keys:
                    return inconsistent(
                        f"write key {k!r} outside 0..{self.keys - 1}")
                if not isinstance(v, int) or not 0 <= v < self.vals:
                    return inconsistent(
                        f"write {v!r} outside 0..{self.vals - 1}")
                digit = code // base ** k % base
                code += (v + 1 - digit) * base ** k
            return BoundedMapModel(code, self.keys, self.vals)
        if op.f == "read":
            for k, v in items:
                if v is None:
                    continue
                if not isinstance(k, int) or not 0 <= k < self.keys:
                    return inconsistent(
                        f"read key {k!r} outside 0..{self.keys - 1}")
                digit = self.code // base ** k % base
                here = digit - 1 if digit else None
                if v != here:
                    return inconsistent(
                        f"read {v!r} at {k!r}, expected {here!r}")
            return self
        return inconsistent(f"bounded-map cannot {op.f}")


@dataclass(frozen=True)
class Memo:
    table: np.ndarray            # i32[n_states, n_ops]; -1 = inconsistent
    states: Tuple[Model, ...]    # state id -> model
    distinct_ops: Tuple[Op, ...]
    initial: int = 0

    @property
    def n_states(self) -> int:
        return len(self.states)

    @property
    def n_ops(self) -> int:
        return len(self.distinct_ops)


def memo(model: Model, packed: PackedHistory,
         max_states: int = 1_000_000) -> Memo:
    """Enumerate reachable states of ``model`` under ``packed.distinct_ops``
    and build the dense transition table."""
    return memo_ops(model, packed.distinct_ops, max_states=max_states)


def memo_ops(model: Model, distinct_ops: Sequence[Op],
             max_states: int = 1_000_000) -> Memo:
    ops = tuple(distinct_ops)
    state_ids: Dict[Model, int] = {model: 0}
    states: List[Model] = [model]
    rows: List[List[int]] = []
    frontier = [model]
    while frontier:
        next_frontier: List[Model] = []
        for s in frontier:
            row: List[int] = []
            for op in ops:
                s2 = s.step(op)
                if is_inconsistent(s2):
                    row.append(-1)
                    continue
                if s2 not in state_ids:
                    if len(states) >= max_states:
                        raise StateExplosion(
                            f"more than {max_states} reachable states for "
                            f"{type(model).__name__} over {len(ops)} ops")
                    state_ids[s2] = len(states)
                    states.append(s2)
                    next_frontier.append(s2)
                row.append(state_ids[s2])
            rows.append(row)
        frontier = next_frontier
    table = np.asarray(rows, np.int32).reshape(len(states), len(ops))
    return Memo(table=table, states=tuple(states), distinct_ops=ops)

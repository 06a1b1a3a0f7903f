"""Sequential consistency models — upstream: ``knossos/src/knossos/model.clj``
(SURVEY.md §2.2): pure specifications ``step(model, op) -> model' |
Inconsistent``. Models are immutable, hashable values so the memo layer
(:mod:`jepsen_tpu_torch.models.memo`) can enumerate reachable states and int-code
transitions for the device solver.

Provided models match the upstream set: :class:`Register`,
:class:`CASRegister`, :class:`Mutex`, :class:`MultiRegister`,
:class:`SetModel`, :class:`FIFOQueue`, :class:`UnorderedQueue`,
:class:`NoOp`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Optional, Tuple, Union

from jepsen_tpu_torch.op import Op


@dataclass(frozen=True, slots=True)
class Inconsistent:
    """Returned by ``step`` when the op is illegal in this state (upstream
    ``knossos.model/inconsistent``)."""
    msg: str

    def __bool__(self) -> bool:
        return False


StepResult = Union["Model", Inconsistent]


class Model:
    """Base sequential specification (upstream ``knossos.model/Model``)."""

    def step(self, op: Op) -> StepResult:
        raise NotImplementedError

    # models are frozen dataclasses in subclasses; hashable by construction.


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(x: Any) -> bool:
    return isinstance(x, Inconsistent)


def _as_tuple2(value: Any) -> Tuple[Any, Any]:
    if isinstance(value, (list, tuple)) and len(value) == 2:
        return value[0], value[1]
    raise ValueError(f"expected [old new] pair, got {value!r}")


@dataclass(frozen=True, slots=True)
class Register(Model):
    """A read/write register (upstream ``knossos.model/register``).

    ``read`` with value ``None`` matches any state (an unobserved read);
    otherwise the read value must equal the state. ``write v`` sets state.
    """
    value: Any = None

    def step(self, op: Op) -> StepResult:
        if op.f == "write":
            return Register(op.value)
        if op.f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(f"read {op.value!r}, expected {self.value!r}")
        return inconsistent(f"register cannot {op.f}")


@dataclass(frozen=True, slots=True)
class CASRegister(Model):
    """Compare-and-set register (upstream ``knossos.model/cas-register``):
    ``read`` / ``write v`` / ``cas [old new]``."""
    value: Any = None

    def step(self, op: Op) -> StepResult:
        if op.f == "write":
            return CASRegister(op.value)
        if op.f == "cas":
            old, new = _as_tuple2(op.value)
            if self.value == old:
                return CASRegister(new)
            return inconsistent(f"cas {old!r}->{new!r} from {self.value!r}")
        if op.f == "read":
            if op.value is None or op.value == self.value:
                return self
            return inconsistent(f"read {op.value!r}, expected {self.value!r}")
        return inconsistent(f"cas-register cannot {op.f}")


@dataclass(frozen=True, slots=True)
class Mutex(Model):
    """A lock (upstream ``knossos.model/mutex``): ``acquire`` / ``release``."""
    locked: bool = False

    def step(self, op: Op) -> StepResult:
        if op.f in ("acquire", "lock"):
            if self.locked:
                return inconsistent("cannot acquire a held lock")
            return Mutex(True)
        if op.f in ("release", "unlock"):
            if not self.locked:
                return inconsistent("cannot release a free lock")
            return Mutex(False)
        return inconsistent(f"mutex cannot {op.f}")


@dataclass(frozen=True, slots=True)
class MultiRegister(Model):
    """A map of independent registers (upstream
    ``knossos.model/multi-register``). Op values are ``{key: v}`` maps (or
    ``[[k v] ...]`` pairs): ``read`` asserts every given key's value,
    ``write`` sets every given key."""
    registers: Tuple[Tuple[Any, Any], ...] = ()

    def _as_dict(self) -> Dict[Any, Any]:
        return dict(self.registers)

    def step(self, op: Op) -> StepResult:
        kvs = op.value
        if isinstance(kvs, dict):
            items = list(kvs.items())
        elif isinstance(kvs, (list, tuple)):
            items = [tuple(p) for p in kvs]
        else:
            return inconsistent(f"bad multi-register value {kvs!r}")
        regs = self._as_dict()
        if op.f == "write":
            for k, v in items:
                regs[k] = v
            return MultiRegister(tuple(sorted(regs.items(), key=repr)))
        if op.f == "read":
            for k, v in items:
                if v is not None and regs.get(k) != v:
                    return inconsistent(
                        f"read {v!r} at {k!r}, expected {regs.get(k)!r}")
            return self
        return inconsistent(f"multi-register cannot {op.f}")


@dataclass(frozen=True, slots=True)
class SetModel(Model):
    """A grow-only set (upstream ``knossos.model/set``): ``add v`` /
    ``read`` (value = full set contents)."""
    elements: FrozenSet[Any] = frozenset()

    def step(self, op: Op) -> StepResult:
        if op.f == "add":
            return SetModel(self.elements | {op.value})
        if op.f == "read":
            if op.value is None:
                return self
            got = frozenset(op.value)
            if got == self.elements:
                return self
            return inconsistent(f"read {sorted(map(repr, got))}, expected "
                                f"{sorted(map(repr, self.elements))}")
        return inconsistent(f"set cannot {op.f}")


@dataclass(frozen=True, slots=True)
class FIFOQueue(Model):
    """FIFO queue (upstream ``knossos.model/fifo-queue``): ``enqueue v`` /
    ``dequeue`` (value = dequeued element)."""
    items: Tuple[Any, ...] = ()

    def step(self, op: Op) -> StepResult:
        if op.f == "enqueue":
            return FIFOQueue(self.items + (op.value,))
        if op.f == "dequeue":
            if not self.items:
                return inconsistent("dequeue from empty queue")
            if op.value is not None and self.items[0] != op.value:
                return inconsistent(
                    f"dequeued {op.value!r}, expected {self.items[0]!r}")
            return FIFOQueue(self.items[1:])
        return inconsistent(f"fifo-queue cannot {op.f}")


@dataclass(frozen=True, slots=True)
class UnorderedQueue(Model):
    """Bag/unordered queue (upstream ``knossos.model/unordered-queue``)."""
    items: FrozenSet[Tuple[Any, int]] = frozenset()

    def step(self, op: Op) -> StepResult:
        counts = dict(self.items)
        if op.f == "enqueue":
            counts[op.value] = counts.get(op.value, 0) + 1
            return UnorderedQueue(frozenset(counts.items()))
        if op.f == "dequeue":
            if op.value not in counts or counts[op.value] <= 0:
                return inconsistent(f"dequeued absent {op.value!r}")
            counts[op.value] -= 1
            if counts[op.value] == 0:
                del counts[op.value]
            return UnorderedQueue(frozenset(counts.items()))
        return inconsistent(f"unordered-queue cannot {op.f}")


@dataclass(frozen=True, slots=True)
class NoOp(Model):
    """Accepts every op (upstream ``knossos.model/noop``)."""

    def step(self, op: Op) -> StepResult:
        return self


# canonical constructors, knossos-style lowercase names
def register(value: Any = None) -> Register:
    return Register(value)


def cas_register(value: Any = None) -> CASRegister:
    return CASRegister(value)


def mutex() -> Mutex:
    return Mutex(False)


def multi_register(values: Optional[Dict[Any, Any]] = None) -> MultiRegister:
    return MultiRegister(tuple(sorted((values or {}).items(), key=repr)))


def set_model() -> SetModel:
    return SetModel()


def fifo_queue() -> FIFOQueue:
    return FIFOQueue()


def unordered_queue() -> UnorderedQueue:
    return UnorderedQueue()


def noop_model() -> NoOp:
    return NoOp()


def bounded_set(universe: int = 12) -> "Model":
    """Int-coded bounded set (state = one bitmask int, <= 2**universe
    reachable states) — the memo-friendly set model that lets set
    workloads reach the dense-walk device engines. Lazy import: the
    class lives in :mod:`jepsen_tpu_torch.models.memo` beside the memoizer
    it exists for."""
    from jepsen_tpu_torch.models.memo import BoundedSetModel
    return BoundedSetModel(0, universe)


def bounded_queue(universe: int = 6) -> "Model":
    """Int-coded bounded FIFO queue (state = one base-(universe+1)
    int; the arrangements of distinct pending values — 1957 states at
    the default) — the memo-friendly :class:`FIFOQueue` that lets
    queue workloads reach the dense-walk device engines."""
    from jepsen_tpu_torch.models.memo import BoundedQueueModel
    return BoundedQueueModel(0, universe)


def bounded_map(keys: int = 4, vals: int = 4) -> "Model":
    """Int-coded bounded register map (state = one base-(vals+1) int,
    <= (vals+1)**keys reachable states) — the memo-friendly
    :class:`MultiRegister`."""
    from jepsen_tpu_torch.models.memo import BoundedMapModel
    return BoundedMapModel(0, keys, vals)

"""Workload generators — upstream ``jepsen/src/jepsen/generator.clj``.

The upstream-era protocol is ``(op gen test process) -> op | nil``, called
concurrently by every worker thread; most combinators guard internal atoms.
Here a generator is any object with ``op(test, process) -> dict | None``
(``None`` = exhausted, the worker exits); stateful combinators synchronize
internally, so one generator instance may be shared by all workers exactly
as upstream.

Emitted ops are *partial* dicts — ``{"f": ..., "value": ...}`` — that the
runner completes with ``process``/``type``/``time``/``index``. A generator
may also emit ``{"sleep": seconds}`` (the worker naps, upstream
``gen/sleep``) or ``{"pending": True}`` (nothing *yet* — try again; used by
``stagger``-style pacing and ``phases`` hand-off).

Plain data is promoted automatically: a dict is a generator of itself
forever? — no: a dict is ``once``; a list/tuple is ``seq``; a callable
``() -> dict | None`` is wrapped. (Upstream promotes maps to endless
repeats in the *new* generator era; this code follows the classic era where
``gen/once`` wraps single maps, which is what the combinators below
expect.)
"""
from __future__ import annotations

import itertools
import logging
import random
import threading
import time as _time
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Union

log = logging.getLogger("jepsen.generator")

OpSketch = Optional[Dict[str, Any]]
NEMESIS = "nemesis"


class Generator:
    """Base generator (upstream ``jepsen.generator/Generator`` protocol)."""

    def op(self, test: Mapping, process: Any) -> OpSketch:
        raise NotImplementedError


GenLike = Union[Generator, Dict[str, Any], Sequence, Callable[[], OpSketch], None]


def gen(g: GenLike) -> Generator:
    """Promote plain data to a generator (see module docstring)."""
    if g is None:
        return Void()
    if isinstance(g, Generator):
        return g
    if isinstance(g, dict):
        return Once(g)
    if callable(g):
        return Fn(g)
    if isinstance(g, (list, tuple)):
        return Seq(g)
    raise TypeError(f"cannot promote {type(g).__name__} to a generator")


class Void(Generator):
    """Immediately exhausted (upstream ``gen/void``)."""

    def op(self, test, process):
        return None


class Once(Generator):
    """Emit one op sketch to exactly one worker, then exhaust (upstream
    ``gen/once``)."""

    def __init__(self, sketch: Dict[str, Any]):
        self._sketch = sketch
        self._lock = threading.Lock()
        self._done = False

    def op(self, test, process):
        with self._lock:
            if self._done:
                return None
            self._done = True
            return dict(self._sketch)


class Repeat(Generator):
    """Emit the same sketch forever (or ``n`` times) (new-era map promotion
    / ``gen/repeat``)."""

    def __init__(self, sketch: Dict[str, Any], n: Optional[int] = None):
        self._sketch = sketch
        self._n = n
        self._lock = threading.Lock()

    def op(self, test, process):
        if self._n is None:
            return dict(self._sketch)
        with self._lock:
            if self._n <= 0:
                return None
            self._n -= 1
            return dict(self._sketch)


class Fn(Generator):
    """Each call invokes ``f`` (no args, or (test, process) if it accepts
    them) for a fresh sketch — the workhorse for random workloads."""

    def __init__(self, f: Callable):
        self._f = f
        try:
            import inspect
            self._arity = len(inspect.signature(f).parameters)
        except (TypeError, ValueError):
            self._arity = 0

    def op(self, test, process):
        return self._f(test, process) if self._arity >= 2 else self._f()


class Seq(Generator):
    """Drain an iterable of sketches/sub-generators, one element at a time;
    each element serves to exhaustion before the next (upstream
    ``gen/seq``). Thread-safe; the current element's ``op`` runs OUTSIDE
    the lock (it may block, e.g. a ``Synchronize`` barrier — holding the
    lock would deadlock the other workers the barrier waits for)."""

    def __init__(self, xs: Iterable):
        self._it = iter(xs)
        self._cur: Optional[Generator] = None
        self._done = False
        self._lock = threading.Lock()

    def op(self, test, process):
        while True:
            with self._lock:
                if self._done:
                    return None
                if self._cur is None:
                    try:
                        self._cur = gen(next(self._it))
                    except StopIteration:
                        self._done = True
                        return None
                cur = self._cur
            sketch = cur.op(test, process)
            if sketch is not None:
                return sketch
            with self._lock:
                if self._cur is cur:        # only the first observer advances
                    self._cur = None


def seq(*gens: GenLike) -> Seq:
    return Seq(gens)


def concat(*gens: GenLike) -> Seq:
    """Serve each generator to exhaustion, in order (upstream
    ``gen/concat``)."""
    return Seq(gens)


def cycle(g: GenLike, times: Optional[int] = None) -> Seq:
    """Serve ``g`` repeatedly (upstream ``gen/cycle``). A shared Generator
    instance stays exhausted, so pass plain data (re-promoted fresh each
    round) or a factory callable returning a fresh generator per round."""
    n = itertools.count() if times is None else range(times)
    if callable(g) and not isinstance(g, Generator):
        return Seq(g() for _ in n)
    return Seq(g for _ in n)


class Mix(Generator):
    """Uniform random choice among sub-generators per op; exhausted members
    drop out (upstream ``gen/mix``)."""

    def __init__(self, gens: Sequence[GenLike], seed: Optional[int] = None):
        self._gens: List[Generator] = [gen(g) for g in gens]
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def op(self, test, process):
        while True:
            with self._lock:
                if not self._gens:
                    return None
                g = self._rng.choice(self._gens)
            sketch = g.op(test, process)
            if sketch is not None:
                return sketch
            with self._lock:
                if g in self._gens:
                    self._gens.remove(g)


def mix(*gens: GenLike, seed: Optional[int] = None) -> Mix:
    return Mix(list(gens), seed=seed)


class Stagger(Generator):
    """Uniform-random delay (mean ``dt``) before each op, desynchronizing
    workers (upstream ``gen/stagger``)."""

    def __init__(self, dt: float, g: GenLike, seed: Optional[int] = None):
        self._dt = dt
        self._gen = gen(g)
        self._rng = random.Random(seed)

    def op(self, test, process):
        _time.sleep(self._rng.uniform(0, 2 * self._dt))
        return self._gen.op(test, process)


def stagger(dt: float, g: GenLike) -> Stagger:
    return Stagger(dt, g)


class Delay(Generator):
    """Fixed delay before every op (upstream ``gen/delay``)."""

    def __init__(self, dt: float, g: GenLike):
        self._dt = dt
        self._gen = gen(g)

    def op(self, test, process):
        _time.sleep(self._dt)
        return self._gen.op(test, process)


def delay(dt: float, g: GenLike) -> Delay:
    return Delay(dt, g)


class Sleep(Generator):
    """Emit a single ``{"sleep": dt}`` directive (upstream ``gen/sleep``)."""

    def __init__(self, dt: float):
        self._once = Once({"sleep": dt})

    def op(self, test, process):
        return self._once.op(test, process)


def sleep(dt: float) -> Sleep:
    return Sleep(dt)


class TimeLimit(Generator):
    """Exhaust ``dt`` seconds after the first op is requested (upstream
    ``gen/time-limit``)."""

    def __init__(self, dt: float, g: GenLike):
        self._dt = dt
        self._gen = gen(g)
        self._deadline: Optional[float] = None
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            if self._deadline is None:
                self._deadline = _time.monotonic() + self._dt
            expired = _time.monotonic() >= self._deadline
        if expired:
            return None
        return self._gen.op(test, process)


def time_limit(dt: float, g: GenLike) -> TimeLimit:
    return TimeLimit(dt, g)


class Limit(Generator):
    """At most ``n`` ops total (upstream ``gen/limit``)."""

    def __init__(self, n: int, g: GenLike):
        self._n = n
        self._gen = gen(g)
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            if self._n <= 0:
                return None
            self._n -= 1
        sketch = self._gen.op(test, process)
        if sketch is None:
            with self._lock:
                self._n = 0
        return sketch


def limit(n: int, g: GenLike) -> Limit:
    return Limit(n, g)


class On(Generator):
    """Route to ``g`` only for processes satisfying ``pred``; others see
    exhaustion (upstream ``gen/on`` / ``gen/filter`` over processes)."""

    def __init__(self, pred: Callable[[Any], bool], g: GenLike):
        self._pred = pred
        self._gen = gen(g)

    def op(self, test, process):
        if not self._pred(process):
            return None
        return self._gen.op(test, process)


def on(pred: Callable[[Any], bool], g: GenLike) -> On:
    return On(pred, g)


def nemesis_gen(nem: GenLike, clients: GenLike = None) -> Generator:
    """Nemesis process sees ``nem``; clients see ``clients`` (upstream
    two-arity ``gen/nemesis``)."""
    if clients is None:
        return On(lambda p: p == NEMESIS, nem)
    return Partition({True: gen(nem), False: gen(clients)},
                     lambda p: p == NEMESIS)


def clients_gen(cli: GenLike, nem: GenLike = None) -> Generator:
    """Clients see ``cli``; nemesis sees ``nem`` (upstream
    ``gen/clients``)."""
    if nem is None:
        return On(lambda p: p != NEMESIS, cli)
    return Partition({True: gen(nem), False: gen(cli)},
                     lambda p: p == NEMESIS)


class Partition(Generator):
    """Dispatch on ``key_fn(process)`` to a table of sub-generators."""

    def __init__(self, table: Dict[Any, Generator],
                 key_fn: Callable[[Any], Any]):
        self._table = table
        self._key_fn = key_fn

    def op(self, test, process):
        g = self._table.get(self._key_fn(process))
        return None if g is None else g.op(test, process)


class Each(Generator):
    """A fresh generator (from ``factory``) per process — every process
    sees the whole sequence (upstream ``gen/each``)."""

    def __init__(self, factory: Callable[[], GenLike]):
        self._factory = factory
        self._per: Dict[Any, Generator] = {}
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            g = self._per.get(process)
            if g is None:
                g = self._per[process] = gen(self._factory())
        return g.op(test, process)


def each(factory: Callable[[], GenLike]) -> Each:
    return Each(factory)


class FilterOps(Generator):
    """Only ops whose sketch satisfies ``pred`` pass through (upstream
    ``gen/filter``)."""

    def __init__(self, pred: Callable[[Dict[str, Any]], bool], g: GenLike):
        self._pred = pred
        self._gen = gen(g)

    def op(self, test, process):
        while True:
            sketch = self._gen.op(test, process)
            if sketch is None or self._pred(sketch):
                return sketch


def filter_ops(pred: Callable[[Dict[str, Any]], bool], g: GenLike) -> FilterOps:
    return FilterOps(pred, g)


class FMap(Generator):
    """Transform each emitted sketch (upstream ``gen/map`` /
    value-rewriting helpers)."""

    def __init__(self, f: Callable[[Dict[str, Any]], Dict[str, Any]],
                 g: GenLike):
        self._f = f
        self._gen = gen(g)

    def op(self, test, process):
        sketch = self._gen.op(test, process)
        return None if sketch is None else self._f(sketch)


def fmap(f: Callable[[Dict[str, Any]], Dict[str, Any]], g: GenLike) -> FMap:
    return FMap(f, g)


class Log(Generator):
    """Log a message once, then exhaust (upstream ``gen/log``)."""

    def __init__(self, msg: str):
        self._msg = msg
        self._lock = threading.Lock()
        self._done = False

    def op(self, test, process):
        with self._lock:
            if not self._done:
                log.info("%s", self._msg)
                self._done = True
        return None


def log_gen(msg: str) -> Log:
    return Log(msg)


class Synchronize(Generator):
    """Barrier: no client process proceeds into ``g`` until every active
    client process has exhausted whatever preceded this generator and
    arrived here (upstream ``gen/synchronize``). The runner declares the
    worker set via ``test["active-processes"]`` (a live set maintained by
    :mod:`jepsen_tpu_torch.core`); the nemesis is excluded — it never routes
    through client-side barriers. Without an active set, the first
    arrival passes."""

    def __init__(self, g: GenLike):
        self._gen = gen(g)
        self._arrived: set = set()
        self._open = False
        self._cond = threading.Condition()

    def op(self, test, process):
        active = test.get("active-processes") if hasattr(test, "get") else None
        if active and process != NEMESIS:
            with self._cond:
                self._arrived.add(process)
                while not self._open:
                    want = {p for p in active() if p != NEMESIS}
                    if self._arrived >= want:
                        break
                    # wait with timeout: the active set shrinks as workers
                    # exit, so re-check periodically
                    self._cond.wait(timeout=0.05)
                self._open = True
                self._cond.notify_all()
        return self._gen.op(test, process)


def synchronize(g: GenLike) -> Synchronize:
    return Synchronize(g)


def phases(*gens: GenLike) -> Seq:
    """Each phase runs to global exhaustion before the next begins; every
    phase is barrier-synchronized (upstream ``gen/phases``)."""
    return Seq([Synchronize(g) for g in gens])


def then(a: GenLike, b: GenLike) -> Seq:
    """``b`` after ``a`` (upstream ``gen/then``, reversed args)."""
    return Seq([a, b])


# -- stock workload sketches --------------------------------------------------

def r() -> Dict[str, Any]:
    return {"f": "read", "value": None}


def w(rng: Optional[random.Random] = None, hi: int = 5) -> Dict[str, Any]:
    return {"f": "write", "value": (rng or random).randint(0, hi - 1)}


def cas(rng: Optional[random.Random] = None, hi: int = 5) -> Dict[str, Any]:
    rng = rng or random
    return {"f": "cas", "value": [rng.randint(0, hi - 1),
                                  rng.randint(0, hi - 1)]}


def register_workload(hi: int = 5, seed: Optional[int] = None) -> Mix:
    """The classic etcd-style r/w/cas mix."""
    rng = random.Random(seed)
    return Mix([Fn(lambda: r()), Fn(lambda: w(rng, hi)),
                Fn(lambda: cas(rng, hi))], seed=seed)


class UniqueValues(Generator):
    """Emit ``{"f": f, "value": n}`` with ``n`` unique and increasing —
    the stock source for set-add / enqueue workloads whose checkers
    account for each attempted value individually."""

    def __init__(self, f: str):
        self._f = f
        self._counter = itertools.count()
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            return {"f": self._f, "value": next(self._counter)}


def unique_values(f: str) -> UniqueValues:
    return UniqueValues(f)


class TxnWorkload(Generator):
    """Elle-style list-append transactions (upstream
    ``jepsen.tests.cycle.append``): each op is ``{"f": "txn", "value":
    [["append", k, v], ["r", k, None], ...]}`` — 1..``max_len``
    micro-ops over ``keys`` keys, appends carrying per-key UNIQUE
    increasing values (the traceability precondition the inference
    depends on; uniqueness is guarded by one lock across workers).
    ``single_key=True`` confines every txn to one key (the CAS-based
    etcd/redis tiers commit a txn as one per-key compare-and-set)."""

    def __init__(self, keys: int = 3, max_len: int = 4,
                 read_p: float = 0.5, seed: Optional[int] = None,
                 key_prefix: str = "t", single_key: bool = False):
        self._keys = [f"{key_prefix}{i}" for i in range(keys)]
        self._max_len = max(1, max_len)
        self._read_p = read_p
        self._rng = random.Random(seed)
        self._next: Dict[str, int] = {k: 0 for k in self._keys}
        self._single = single_key
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            rng = self._rng
            n = rng.randint(1, self._max_len)
            if self._single:
                pool = [rng.choice(self._keys)] * n
            else:
                pool = [rng.choice(self._keys) for _ in range(n)]
            micros = []
            for k in pool:
                if rng.random() < self._read_p:
                    micros.append(["r", k, None])
                else:
                    v = self._next[k]
                    self._next[k] = v + 1
                    micros.append(["append", k, v])
            return {"f": "txn", "value": micros}


def txn_workload(keys: int = 3, max_len: int = 4, read_p: float = 0.5,
                 seed: Optional[int] = None,
                 single_key: bool = False) -> TxnWorkload:
    return TxnWorkload(keys=keys, max_len=max_len, read_p=read_p,
                       seed=seed, single_key=single_key)


# -- independent-keys generators (upstream jepsen.independent) ---------------

class SequentialKeys(Generator):
    """One key at a time: serve ``factory(key)`` wrapped as ``[key, v]``
    values until exhausted, then the next key (upstream
    ``independent/sequential-generator``)."""

    def __init__(self, keys: Iterable, factory: Callable[[Any], GenLike]):
        self._keys = iter(keys)
        self._factory = factory
        self._cur: Optional[Generator] = None
        self._key: Any = None
        self._lock = threading.Lock()

    def op(self, test, process):
        with self._lock:
            while True:
                if self._cur is not None:
                    sketch = self._cur.op(test, process)
                    if sketch is not None:
                        if "f" in sketch:
                            sketch = dict(sketch)
                            sketch["value"] = [self._key,
                                               sketch.get("value")]
                        return sketch
                    self._cur = None
                try:
                    self._key = next(self._keys)
                except StopIteration:
                    return None
                self._cur = gen(self._factory(self._key))


def sequential_generator(keys: Iterable,
                         factory: Callable[[Any], GenLike]) -> SequentialKeys:
    return SequentialKeys(keys, factory)


class ConcurrentKeys(Generator):
    """``n`` keys served concurrently, each by a dedicated group of
    processes (upstream ``independent/concurrent-generator``). Processes
    are assigned to groups by ``process % n`` (nemesis excluded); when a
    key's generator exhausts, its group moves to the next key."""

    def __init__(self, n: int, keys: Iterable,
                 factory: Callable[[Any], GenLike]):
        self._n = n
        self._keys = iter(keys)
        self._factory = factory
        self._groups: Dict[int, Optional[Dict[str, Any]]] = {}
        self._lock = threading.Lock()

    def _fresh(self):
        try:
            key = next(self._keys)
        except StopIteration:
            return None
        return {"key": key, "gen": gen(self._factory(key))}

    def op(self, test, process):
        if process == NEMESIS:
            return None
        group = int(process) % self._n
        while True:
            with self._lock:
                if group not in self._groups:
                    self._groups[group] = self._fresh()
                slot = self._groups[group]
            if slot is None:
                return None
            sketch = slot["gen"].op(test, process)
            if sketch is not None:
                if "f" in sketch:
                    sketch = dict(sketch)
                    sketch["value"] = [slot["key"], sketch.get("value")]
                return sketch
            with self._lock:
                if self._groups.get(group) is slot:
                    self._groups[group] = self._fresh()


def concurrent_generator(n: int, keys: Iterable,
                         factory: Callable[[Any], GenLike]) -> ConcurrentKeys:
    return ConcurrentKeys(n, keys, factory)

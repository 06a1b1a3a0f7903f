"""History fixtures & generators for tests and benchmarks.

Upstream analogue: the recorded EDN histories shipped in ``knossos/data/``
(cas-register runs from real etcd tests, both linearizable and known-bad —
SURVEY.md §4). Here equivalents are *synthesized*: :func:`gen_history` simulates concurrent clients against a
genuinely atomic object (each op commits at a random instant between its
invocation and response), so its output is linearizable by construction;
:func:`corrupt` then plants a read of a never-written value, making the
history provably non-linearizable.

Given the same seed, every generator here emits the same history, op for
op, as its counterpart in the reference package, so differential tests can
feed one input to both.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

from jepsen_tpu_torch import models as m
from jepsen_tpu_torch.op import Op, fail, info, invoke, ok


def gen_history(kind: str = "cas", n_ops: int = 100, processes: int = 5,
                values: int = 5, crash_p: float = 0.0,
                seed: Optional[int] = None,
                keys: int = 1) -> List[Op]:
    """Generate a linearizable-by-construction history.

    ``kind``: ``"register"`` (read/write), ``"cas"`` (read/write/cas),
    ``"mutex"`` (acquire/release), ``"multi"`` (multi-key read/write — op
    values are ``{key: value}`` maps over ``keys`` keys).

    Simulation: each process cycles IDLE → INVOKED → COMMITTED → RETURNED;
    at every tick one random process advances one stage. The commit applies
    the op to a live atomic object, so some serialization of all committed
    ops is consistent with real time. A CAS whose precondition fails at
    commit returns ``fail`` (it did not take effect), as in the etcd tests.
    With probability ``crash_p`` an op ends ``info`` instead of returning —
    whether or not it committed, exercising both crashed-op branches.
    """
    rng = random.Random(seed)
    gen_op, apply_op = _SIM_KINDS[kind]
    state: Dict[str, Any] = {"kind": kind, "values": values, "keys": keys,
                             "reg": None, "locked": None,
                             "map": {k: None for k in range(keys)}}
    # per-process: None = idle, else [op_f, op_value, committed, result]
    pending: List[Optional[list]] = [None] * processes
    history: List[Op] = []
    invoked = 0
    while invoked < n_ops or any(p is not None for p in pending):
        p = rng.randrange(processes)
        st = pending[p]
        if st is None:
            if invoked >= n_ops:
                continue
            f, v = gen_op(rng, state, p)
            if f is None:
                continue
            pending[p] = [f, v, False, None]
            history.append(invoke(p, f, v))
            invoked += 1
        elif not st[2]:
            if crash_p and rng.random() < crash_p:
                # crash before the op ever took effect
                history.append(info(p, st[0], st[1]))
                pending[p] = None
                continue
            # commit: apply atomically to the live object
            okay, result = apply_op(rng, state, p, st[0], st[1])
            st[2] = True
            st[3] = (okay, result)
        else:
            okay, result = st[3]
            if crash_p and rng.random() < crash_p:
                history.append(info(p, st[0], st[1]))
            elif okay:
                history.append(ok(p, st[0], result))
            else:
                history.append(fail(p, st[0], st[1]))
            pending[p] = None
    return [op.with_(index=i, time=i) for i, op in enumerate(history)]


def _gen_rw(rng, state, p) -> Tuple[Optional[str], Any]:
    if rng.random() < 0.5:
        return "read", None
    return "write", rng.randrange(state["values"])


def _apply_rw(rng, state, p, f, v):
    if f == "read":
        return True, state["reg"]
    state["reg"] = v
    return True, v


def _gen_cas(rng, state, p) -> Tuple[Optional[str], Any]:
    r = rng.random()
    if r < 0.34:
        return "read", None
    if r < 0.67:
        return "write", rng.randrange(state["values"])
    return "cas", [rng.randrange(state["values"]),
                   rng.randrange(state["values"])]


def _apply_cas(rng, state, p, f, v):
    if f == "cas":
        old, new = v
        if state["reg"] == old:
            state["reg"] = new
            return True, v
        return False, v
    return _apply_rw(rng, state, p, f, v)


def _gen_mutex(rng, state, p) -> Tuple[Optional[str], Any]:
    # a process alternates acquire/release attempts
    if state.get(("held", p)):
        return "release", None
    return "acquire", None


def _apply_mutex(rng, state, p, f, v):
    if f == "acquire":
        if state["locked"] is None:
            state["locked"] = p
            state[("held", p)] = True
            return True, None
        return False, None
    if state["locked"] == p:
        state["locked"] = None
        state[("held", p)] = False
        return True, None
    return False, None


def _gen_multi(rng, state, p) -> Tuple[Optional[str], Any]:
    k = rng.randrange(state["keys"])
    if rng.random() < 0.5:
        return "read", {k: None}
    return "write", {k: rng.randrange(state["values"])}


def _apply_multi(rng, state, p, f, v):
    if f == "read":
        return True, {k: state["map"][k] for k in v}
    state["map"].update(v)
    return True, v


_SIM_KINDS = {
    "register": (_gen_rw, _apply_rw),
    "cas": (_gen_cas, _apply_cas),
    "mutex": (_gen_mutex, _apply_mutex),
    "multi": (_gen_multi, _apply_multi),
}


class _LazyEntries:
    """Tuple-like view that builds :class:`jepsen_tpu_torch.history.Entry`
    objects on demand: a many-million-op benchmark input must not
    materialize an object per op (entries are read only to report a
    failure)."""

    def __init__(self, inv_ev, ret_ev, op_id, proc, ops):
        self._inv, self._ret = inv_ev, ret_ev
        self._oid, self._proc, self._ops = op_id, proc, ops

    def __len__(self) -> int:
        return len(self._inv)

    def __getitem__(self, i: int):
        from jepsen_tpu_torch.history import Entry

        tmpl = self._ops[int(self._oid[i])]
        op = tmpl.with_(process=int(self._proc[i]),
                        index=int(self._inv[i]), time=int(self._inv[i]))
        return Entry(eid=int(i), op=op, inv_ev=int(self._inv[i]),
                     ret_ev=int(self._ret[i]), crashed=False)


def gen_packed(kind: str = "cas", n_ops: int = 100, processes: int = 5,
               values: int = 5, seed: Optional[int] = None):
    """Benchmark-history generator: the tick-loop simulation of
    :func:`gen_history` (register and cas kinds, no crashes) run in C++
    (``native/preproc.cpp`` ``jt_gen_history``), emitting a
    :class:`~jepsen_tpu_torch.history.PackedHistory` directly, with lazily
    built entries. Linearizable by construction, as :func:`gen_history`'s
    output; failed CAS attempts are stripped as the analysis does. Other
    kinds pack :func:`gen_history`'s output.

    For a given seed the history differs from :func:`gen_history`'s (a
    different generator: same distribution, not the same stream); it is
    the reference package's ``gen_packed`` history, array for array."""
    import numpy as np

    from jepsen_tpu_torch import history as h
    from jepsen_tpu_torch.checkers import preproc_native
    from jepsen_tpu_torch.util import hashable

    kinds = {"register": 0, "cas": 1}
    if kind not in kinds:
        return h.pack(gen_history(kind, n_ops=n_ops, processes=processes,
                                  values=values, seed=seed))
    if seed is None:
        # as gen_history(seed=None): fresh randomness on every call
        seed = random.SystemRandom().randrange(1 << 31)
    inv_ev, ret_ev, opid_raw, proc, count = preproc_native.gen_history(
        seed, n_ops, processes, values, kinds[kind])
    order = np.argsort(inv_ev, kind="stable")  # entries by invocation
    inv_ev, ret_ev = inv_ev[order], ret_ev[order]
    opid_raw, proc = opid_raw[order], proc[order]
    # dense alphabet over the identities present
    V = values
    present, op_id = np.unique(opid_raw, return_inverse=True)
    ops = []
    for enc in present.tolist():
        if enc == 0:
            f, v = "read", None
        elif enc <= V:
            f, v = "read", enc - 1
        elif enc <= 2 * V:
            f, v = "write", enc - 1 - V
        else:
            a, b = divmod(enc - 1 - 2 * V, V)
            f, v = "cas", [a, b]
        ops.append(invoke(0, f, v))
    inf_ev = 2 * n_ops + 2          # > any event rank (2 per op at most)
    entries = _LazyEntries(inv_ev, ret_ev, op_id.astype(np.int32), proc,
                           ops)
    return h.PackedHistory(
        n=count, inv_ev=inv_ev, ret_ev=ret_ev,
        op_id=np.ascontiguousarray(op_id, np.int32),
        crashed=np.zeros(count, bool), inf_ev=inf_ev,
        distinct_ops=tuple(ops), entries=entries,  # type: ignore[arg-type]
        op_keys=tuple((op.f, hashable(op.value)) for op in ops))


def gen_txn_history(n_txns: int = 50, keys: int = 3, processes: int = 5,
                    max_len: int = 4, read_p: float = 0.5,
                    crash_p: float = 0.0, key_rotate: int = 0,
                    seed: Optional[int] = None) -> List[Op]:
    """Generate a serializable-by-construction list-append txn history:
    the same tick simulation as :func:`gen_history`, committing each
    whole transaction atomically against live per-key lists at a random
    instant between invocation and response (so SOME serial order — the
    commit order — explains every read). Appends are per-key unique
    (Elle's traceability precondition). With ``crash_p`` a txn may end
    ``info``, committed or not — both crashed-op branches.

    ``key_rotate`` retires a key after that many appends and swaps in a
    fresh one (how real Jepsen list-append workloads bound list
    growth): without it every read copies an ever-growing list and a
    100k-txn history costs O(n^2) to build and to check. The bench
    rung uses rotation; small differential trials don't need it."""
    rng = random.Random(seed)
    key_names = [f"t{i}" for i in range(keys)]
    lists: Dict[str, list] = {k: [] for k in key_names}
    next_v: Dict[str, int] = {k: 0 for k in key_names}
    n_retired = 0

    def _maybe_rotate(k: str) -> None:
        nonlocal n_retired
        if key_rotate and len(lists[k]) >= key_rotate \
                and k in key_names:
            n_retired += 1
            fresh = f"t{keys + n_retired - 1}r"
            key_names[key_names.index(k)] = fresh
            lists[fresh] = []
            next_v[fresh] = 0
    pending: List[Optional[list]] = [None] * processes  # [micros, committed, result]
    history: List[Op] = []
    invoked = 0
    while invoked < n_txns or any(p is not None for p in pending):
        p = rng.randrange(processes)
        st = pending[p]
        if st is None:
            if invoked >= n_txns:
                continue
            micros = []
            for _ in range(rng.randint(1, max_len)):
                k = rng.choice(key_names)
                if rng.random() < read_p:
                    micros.append(["r", k, None])
                else:
                    micros.append(["append", k, next_v[k]])
                    next_v[k] += 1
            pending[p] = [micros, False, None]
            history.append(invoke(p, "txn", [list(x) for x in micros]))
            invoked += 1
        elif not st[1]:
            if crash_p and rng.random() < crash_p:
                history.append(info(p, "txn", st[0]))
                pending[p] = None
                continue
            # atomic commit: every micro-op against the live lists
            result = []
            for kind, k, v in st[0]:
                if kind == "append":
                    # a rotated-away key still commits (the txn chose
                    # it at invocation); its list just stops growing
                    # for future txns
                    lists[k].append(v)
                    result.append(["append", k, v])
                    _maybe_rotate(k)
                else:
                    result.append(["r", k, list(lists[k])])
            st[1] = True
            st[2] = result
        else:
            if crash_p and rng.random() < crash_p:
                history.append(info(p, "txn", st[0]))
            else:
                history.append(ok(p, "txn", st[2]))
            pending[p] = None
    return [op.with_(index=i, time=i) for i, op in enumerate(history)]


#: crafted list-append blocks with one known dependency cycle each
#: (fresh keys; timing-independent — the cycles come purely from the
#: read observations, which is all the inference consults)
TXN_ANOMALY_KINDS = ("G0", "G1c", "G-single", "G2")

#: lattice-level fixtures: each is invalid at a KNOWN
#: weakest level and valid at everything below it, with every txn
#: sequential (non-overlapping) so the commit-order lane is total —
#: the ground truths the lattice differential tests assert:
#:
#:   write-skew   -> weakest violated: si    (G-SIb; causal/pl-2 hold)
#:   lost-update  -> invalid at EVERY level  (G0 + G-SIa: the
#:                                            blind overwrite also
#:                                            reverses a write order)
#:   long-fork    -> weakest violated: si    (G-SIb + G2; the
#:                                            canonical SI anomaly)
#:   session-mr   -> weakest violated: pl-2  (monotonic-reads;
#:                                            causal holds)
TXN_LATTICE_KINDS = ("write-skew", "lost-update", "long-fork",
                     "session-mr")


def txn_anomaly_block(kind: str, key_prefix: str = "z",
                      process0: int = 100) -> List[Op]:
    """A self-contained txn block whose inferred graph contains
    exactly one cycle of class ``kind`` (sequential ops, fresh keys —
    append it to any history without disturbing it). The
    :data:`TXN_LATTICE_KINDS` kinds additionally pin the WEAKEST
    violated consistency level (see the table above)."""
    ka, kb = f"{key_prefix}a", f"{key_prefix}b"
    p = process0

    def seq(*txns, procs=None):
        out = []
        for i, t in enumerate(txns):
            pi = p + (i if procs is None else procs[i])
            out.append(invoke(pi, "txn",
                              [[k, kk, None if k == "r" else v]
                               for k, kk, v in t]))
            out.append(ok(pi, "txn", [list(x) for x in t]))
        return out

    if kind == "G0":
        # ww(ka): T1<T2 but ww(kb): T2<T1 — a pure write cycle
        return seq([("append", ka, 1), ("append", kb, 1)],
                   [("append", ka, 2), ("append", kb, 2)],
                   [("r", ka, [1, 2]), ("r", kb, [2, 1])])
    if kind == "G1c":
        # each txn reads the OTHER's append: wr both ways
        return seq([("append", ka, 1), ("r", kb, [1])],
                   [("r", ka, [1]), ("append", kb, 1)])
    if kind == "G-single":
        # T1 misses T2's append to ka (rw) but reads its kb append
        # (wr back): exactly one anti-dependency edge
        return seq([("r", ka, []), ("r", kb, [1])],
                   [("append", ka, 1), ("append", kb, 1)],
                   [("r", ka, [1])])
    if kind == "G2":
        # two anti-dependencies and nothing stronger
        return seq([("r", ka, []), ("append", kb, 1)],
                   [("r", kb, []), ("append", ka, 1)],
                   [("r", ka, [1]), ("r", kb, [1])])
    if kind == "write-skew":
        # the classic skew, SEQUENTIALLY: T2 starts after T1
        # committed yet still reads ka=[] — fine under causal (no
        # ww/wr cycle), a G-SIb write skew under strong-session SI
        # (rw T2->T1 closed by the commit-order edge T1->T2)
        return seq([("r", ka, []), ("r", kb, []), ("append", ka, 1)],
                   [("r", ka, []), ("r", kb, []), ("append", kb, 1)],
                   [("r", ka, [1]), ("r", kb, [1])])
    if kind == "lost-update":
        # T2 read-modify-writes over T1 without seeing T1's committed
        # append, and the recovered kb order runs BACKWARD through
        # commit order: a G0 write cycle (fails read-committed, hence
        # every level) plus the time-travel G-SIa edge ww T2->T1 with
        # T1 committed before T2 even started
        return seq([("r", ka, []), ("append", ka, 1),
                    ("append", kb, 1)],
                   [("r", ka, []), ("append", ka, 2),
                    ("append", kb, 2)],
                   [("r", ka, [1, 2]), ("r", kb, [2, 1])])
    if kind == "long-fork":
        # two readers observe the two independent writes in OPPOSITE
        # orders — the canonical SI anomaly. No ww/wr cycle (causal
        # holds); both rw edges close through commit order (G-SIb),
        # and the four-txn rw/wr cycle is a G2 under serializability.
        return seq([("append", ka, 1)],
                   [("append", kb, 1)],
                   [("r", ka, [1]), ("r", kb, [])],
                   [("r", ka, []), ("r", kb, [1])])
    if kind == "session-mr":
        # one process's reads SHRINK: txn2 sees [1,2], txn3 (same
        # process) sees [1] — a monotonic-reads session violation
        # (weakest violated: pl-2; causal still holds, there is no
        # ww/wr cycle)
        return seq([("append", ka, 1), ("append", ka, 2)],
                   [("r", ka, [1, 2])],
                   [("r", ka, [1])],
                   procs=[0, 1, 1])
    raise ValueError(f"unknown txn anomaly kind {kind!r}")


def model_for(kind: str) -> m.Model:
    return {
        "register": m.register(),
        "cas": m.cas_register(),
        "mutex": m.mutex(),
        "multi": m.multi_register(),
    }[kind]


def corrupt(history: List[Op], seed: Optional[int] = None,
            bad_value: Any = 999_999) -> List[Op]:
    """Make a history non-linearizable: rewrite one successful read's
    observed value to a value no write ever produced. For register-family
    models such a read can never be linearized, so the result is provably
    invalid."""
    rng = random.Random(seed)
    idxs = [i for i, op in enumerate(history)
            if op.type == "ok" and op.f == "read"]
    if not idxs:
        raise ValueError("history has no successful reads to corrupt")
    i = rng.choice(idxs)
    out = list(history)
    victim = out[i]
    bad = (dict.fromkeys(victim.value, bad_value)
           if isinstance(victim.value, dict) else bad_value)
    out[i] = victim.with_(value=bad)
    return out

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

"""P-compositional (per-object) decomposition of multi-register histories.

Upstream analogue: none — knossos checks multi-register monolithically
(``knossos.model/multi-register`` steps the whole map, so its reachable
state space is the *product* over registers), and ``jepsen.independent``
only helps when the workload itself was keyed with ``ktuple``. This module
exploits Herlihy & Wing's locality theorem instead: a history over multiple
independent objects is linearizable iff each per-object subhistory is.
When every multi-register op touches exactly one key, the history splits
into per-key **register** histories, checked as one batched call of
:func:`jepsen_tpu_torch.checkers.reach.check_many` on the card (its
lockstep lane on K2, or its native keyed lane on K3 / K5), turning an
exponential product-state search into a batch over keys.

Soundness gates (bail to the monolithic engines by returning ``None``):

- every op is a ``read``/``write`` whose value is a one-entry ``{key: v}``
  map (or a one-element ``[[k, v]]`` pair list) — an op spanning keys is
  a transaction, and locality does not apply;
- keys must be hashable.

Crashed ops stay within their key's subhistory (a crashed single-key
write can only ever affect that register), so the split preserves the
forever-pending semantics exactly.

Only a capacity decline of the batch (``DenseOverflow``,
``ConcurrencyOverflow``, ``StateExplosion``) sends the keys one by one
through the ``auto`` chain; any other error propagates.
"""
from __future__ import annotations

import itertools
import time as _time
from dataclasses import replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import models, obs
from jepsen_tpu_torch.models.memo import Memo, StateExplosion
from jepsen_tpu_torch.op import Op


def _op_items(op: Op) -> Optional[List[Any]]:
    """The ``(key, value)`` pairs a multi-register op touches, or None
    when the op is not multi-register shaped."""
    if op.f not in ("read", "write"):
        return None
    v = op.value
    if isinstance(v, dict):
        return list(v.items())
    if (isinstance(v, (list, tuple)) and
            all(isinstance(p, (list, tuple)) and len(p) == 2 for p in v)):
        return [tuple(p) for p in v]
    return None


def split(history: Sequence[Op] = (), *,
          entries: Optional[Sequence[h.Entry]] = None
          ) -> Optional[Dict[Any, List[h.Entry]]]:
    """Split analysis entries by the single key each op touches, rewriting
    op values from ``{k: v}`` to the bare ``v`` a register model steps.
    Returns ``None`` when the history is not per-key decomposable."""
    if entries is None:
        entries = h.analysis_entries(history)
    groups: Dict[Any, List[h.Entry]] = {}
    for e in entries:
        items = _op_items(e.op)
        if items is None:
            return None
        if len(items) != 1:
            return None                 # multi-key transaction: not local
        (k, val), = items
        try:
            hash(k)
        # not decomposable: None routes the caller
        except TypeError:
            return None
        groups.setdefault(k, []).append(replace(e, op=e.op.with_(value=val)))
    return groups


def split_projections(history: Sequence[Op] = (), *,
                      entries: Optional[Sequence[h.Entry]] = None
                      ) -> Optional[Dict[Any, List[h.Entry]]]:
    """PROJECT analysis entries onto every key each op touches — the
    transactional sibling of :func:`split`. A multi-key transaction
    contributes its per-key component to each key's subhistory. A
    linearization of the full history projects to a linearization of
    every per-key history (each transaction applies atomically, so its
    projection acts atomically on each key), so an INVALID projection
    soundly proves the full history non-linearizable; valid projections
    prove nothing about cross-key atomicity. Crashed transactions
    project as per-key crashed ops — each key explores fire-or-not
    independently, a superset of the real all-or-nothing behaviors,
    preserving soundness of the invalid direction. Returns None when
    the history is not multi-register shaped."""
    if entries is None:
        entries = h.analysis_entries(history)
    groups: Dict[Any, List[h.Entry]] = {}
    for e in entries:
        items = _op_items(e.op)
        if items is None:
            return None
        for k, val in items:
            try:
                hash(k)
            # not decomposable: None routes the caller
            except TypeError:
                return None
            groups.setdefault(k, []).append(
                replace(e, op=e.op.with_(value=val)))
    return groups


def check(model: models.Model, history: Sequence[Op], *,
          max_states: int = 100_000, max_slots: int = 20,
          max_dense: int = 1 << 22, device=None,
          time_limit: Optional[float] = None, should_abort=None,
          max_configs: Optional[int] = None,
          frontier0: Optional[int] = None,
          max_frontier: Optional[int] = None
          ) -> Optional[Dict[str, Any]]:
    """Check a multi-register history by per-key decomposition on
    ``device`` (default: the card). Returns ``None`` when not applicable
    (wrong model, multi-key transactions); otherwise a merged verdict
    shaped like ``independent.checker``'s: valid iff every key's
    register subhistory is linearizable."""
    if not isinstance(model, models.MultiRegister):
        return None
    return check_packed(model, h.pack(history), max_states=max_states,
                        max_slots=max_slots, max_dense=max_dense,
                        device=device, time_limit=time_limit,
                        should_abort=should_abort, max_configs=max_configs,
                        frontier0=frontier0, max_frontier=max_frontier)


def check_packed(model: models.Model, packed: h.PackedHistory, *,
                 max_states: int = 100_000, max_slots: int = 20,
                 max_dense: int = 1 << 22,
                 device=None,
                 time_limit: Optional[float] = None, should_abort=None,
                 max_configs: Optional[int] = None,
                 frontier0: Optional[int] = None,
                 max_frontier: Optional[int] = None
                 ) -> Optional[Dict[str, Any]]:
    """Packed-level :func:`check` (splits ``packed.entries`` — callers
    that already packed the history pay no second preprocessing pass)."""
    if not isinstance(model, models.MultiRegister):
        return None
    t0 = _time.monotonic()
    groups = split(entries=packed.entries)
    if groups is None:
        return None
    return _check_groups(model, groups, t0, "decompose",
                         max_states=max_states, max_slots=max_slots,
                         max_dense=max_dense, device=device,
                         time_limit=time_limit, should_abort=should_abort,
                         max_configs=max_configs, frontier0=frontier0,
                         max_frontier=max_frontier)


def check_transactional(model: models.Model, packed: h.PackedHistory, *,
                        max_states: int = 100_000, max_slots: int = 20,
                        max_dense: int = 1 << 22,
                        device=None,
                        time_limit: Optional[float] = None,
                        should_abort=None,
                        max_configs: Optional[int] = None,
                        frontier0: Optional[int] = None,
                        max_frontier: Optional[int] = None
                        ) -> Optional[Dict[str, Any]]:
    """Sound per-key PROJECTION screen for multi-key transactional
    histories (the shape :func:`check` must decline): an invalid
    projection proves the full history non-linearizable (with the
    per-key witness); all-valid projections cannot certify cross-key
    atomicity, so the verdict is an explicit ``"unknown"`` with the
    reason — the answer :mod:`facade`'s auto chain gives when the
    monolithic product-space engines explode, instead of dying or
    hanging. Returns None when the history is not multi-register
    shaped at all."""
    if not isinstance(model, models.MultiRegister):
        return None
    t0 = _time.monotonic()
    groups = split_projections(entries=packed.entries)
    if groups is None:
        return None
    out = _check_groups(model, groups, t0, "decompose-projection",
                        max_states=max_states, max_slots=max_slots,
                        max_dense=max_dense, device=device,
                        time_limit=time_limit, should_abort=should_abort,
                        max_configs=max_configs, frontier0=frontier0,
                        max_frontier=max_frontier)
    if out.get("valid") is True:
        out["valid"] = "unknown"
        out["cause"] = (
            "multi-key transactions: every per-key projection is "
            "linearizable, but projections cannot certify cross-key "
            "atomicity (locality does not apply to transactions)")
    return out


class _KeyWalk:
    """Per-key projection walk with exact config sets ⟨value,
    fired-pending-subset⟩ — the per-key face of Lowe's JIT
    linearization, kept on host because its job is not the verdict but
    the per-window VALUE CLOSURE: the set of values this key can hold
    at any moment of the current window, under any linearization of
    its pending projected ops. Sound per-component bound for the joint
    walk: a linearization of the full transactional history projects
    to a per-key linearization (each transaction applies atomically),
    so every joint state's k-component lies in key k's closure."""

    def __init__(self, init: Any, max_configs: int):
        self.configs = {(init, frozenset())}
        self.pending: Dict[int, Tuple[str, Any]] = {}   # eid -> (f, v)
        self.max_configs = max_configs
        self._avals: Optional[set] = {init}
        self._clo: Optional[set] = None     # cached window closure

    def invoke(self, eid: int, f: str, v: Any) -> None:
        self.pending[eid] = (f, v)
        self._avals = None
        self._clo = None

    def _closure(self) -> set:
        if self._clo is not None:
            return self._clo
        seen = set(self.configs)
        frontier = list(seen)
        while frontier:
            val, fired = frontier.pop()
            for eid, (f, pv) in self.pending.items():
                if eid in fired:
                    continue
                if f == "read":
                    if pv is not None and pv != val:
                        continue
                    nxt = (val, fired | {eid})
                else:
                    nxt = (pv, fired | {eid})
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
            if len(seen) > self.max_configs:
                raise StateExplosion(
                    f"per-key closure beyond {self.max_configs}")
        self._clo = seen
        return seen

    def values(self) -> set:
        """Value closure of the current window (cached between events
        touching this key)."""
        if self._avals is None:
            self._avals = {v for v, _ in self._closure()}
        return self._avals

    def project(self, eid: int) -> None:
        """Return of entry ``eid``'s component on this key: closure,
        keep configs that fired it, retire the pending slot."""
        clo = self._closure()
        self.configs = {(v, fired - {eid}) for v, fired in clo
                        if eid in fired}
        del self.pending[eid]
        self._avals = None
        self._clo = None
        if not self.configs:
            # the PROJECTION is already invalid — the joint walk will
            # agree; keep a non-empty set so memo construction can
            # finish (the dense engine produces the exact witness)
            self.configs = {(v, fired - {eid}) for v, fired in clo}
            if not self.configs:
                self.configs = {(None, frozenset())}


def _regs_model(keys: Sequence[Any], combo: Sequence[Any]
                ) -> models.MultiRegister:
    return models.MultiRegister(
        tuple(sorted(zip(keys, combo), key=repr)))


def check_restricted_product(model: models.Model,
                             packed: h.PackedHistory, *,
                             max_states: int = 100_000,
                             max_slots: int = 20,
                             max_dense: int = 1 << 22,
                             max_product: int = 4096,
                             max_key_configs: int = 65536,
                             should_abort=None, device=None
                             ) -> Optional[Dict[str, Any]]:
    """EXACT verdict for multi-key transactional histories whose full
    product space explodes the memo BFS:
    restrict the product to the states jointly reachable at some
    window. Per-key projection walks (:class:`_KeyWalk`) yield each
    key's exact per-window value closure; any live joint config's
    k-component lies in that closure (locality of the projection), so
    the union over windows of the per-key closure PRODUCTS contains
    every product state the dense walk can ever occupy — typically
    O(history) states where the alphabet BFS needs ``values**keys``.
    The restricted transition table is then just stepped over those
    states (transitions leaving the set are provably never taken by a
    live config and map to -1), and the standard dense device engine
    runs unchanged via memo injection.

    Returns the dense engine's verdict dict (engine
    ``decompose-product``) or ``None`` when the history is not
    multi-register transactional shaped; raises
    :class:`~jepsen_tpu_torch.models.memo.StateExplosion` when even the
    restricted space exceeds the budget — the caller's projection
    screen then provides the sound unknown. The dense engine runs on
    ``device`` (default: the card): K1, or K4 above 32 states. Upstream
    analogue: none (knossos only offers the monolithic product
    search)."""
    from jepsen_tpu_torch.checkers import reach

    if not isinstance(model, models.MultiRegister):
        return None
    t0 = _time.monotonic()
    per_op_items = []
    for e in packed.entries:
        items = _op_items(e.op)
        if items is None:
            return None
        per_op_items.append(items)
    init = dict(model.registers)
    keys = sorted({k for items in per_op_items for k, _ in items},
                  key=repr)
    if not keys:
        return None
    try:
        for k in keys:
            hash(k)
    # not decomposable: None routes the caller
    except TypeError:
        return None
    walks = {k: _KeyWalk(init.get(k), max_key_configs) for k in keys}
    evs = []
    for e, items in zip(packed.entries, per_op_items):
        evs.append((e.inv_ev, 0, e, items))
        if not e.crashed:
            evs.append((e.ret_ev, 1, e, items))
    evs.sort(key=lambda t: (t[0], t[1]))
    state_ids: Dict[Tuple[Any, ...], int] = {}
    last_sig: List[Any] = [None]

    def intern_window() -> None:
        vals = [sorted(walks[k].values(), key=repr) for k in keys]
        sig = tuple(map(tuple, vals))
        if sig == last_sig[0]:          # unchanged closures: same combos
            return
        last_sig[0] = sig
        size = 1
        for v in vals:
            size *= len(v)
        if size > max_product:
            raise StateExplosion(
                f"window product {size} beyond {max_product}")
        for combo in itertools.product(*vals):
            if combo not in state_ids:
                state_ids[combo] = len(state_ids)
                if len(state_ids) > max_states:
                    raise StateExplosion(
                        f"restricted product beyond {max_states}")

    intern_window()                     # the initial window
    for _rank, kind, e, items in evs:
        if should_abort is not None and should_abort():
            return {"valid": "unknown", "cause": "aborted",
                    "engine": "decompose-product"}
        if kind == 0:
            for k, v in items:
                walks[k].invoke(e.eid, e.op.f, v)
        else:
            intern_window()             # fires happen at returns
            # unique keys: a pair-list value may name a key twice
            # (last-write-wins in the model; one projection per key)
            for k in {k for k, _v in items}:
                walks[k].project(e.eid)
    # restricted transition table over the interned product states
    combos = sorted(state_ids, key=lambda c: state_ids[c])
    init_combo = tuple(init.get(k) for k in keys)
    if init_combo not in state_ids:     # defensive; interned above
        state_ids[init_combo] = len(state_ids)
        combos.append(init_combo)
    states = tuple(_regs_model(keys, c) for c in combos)
    op_parsed = [(op.f, _op_items(op), dict(_op_items(op) or ()))
                 for op in packed.distinct_ops]
    table = np.full((len(combos), len(packed.distinct_ops)), -1,
                    np.int32)
    for si, combo in enumerate(combos):
        regs = dict(zip(keys, combo))
        for oi, (f, items, as_dict) in enumerate(op_parsed):
            if f == "read":
                if all(v is None or regs.get(k) == v for k, v in items):
                    table[si, oi] = si
            else:
                nxt = dict(regs)
                nxt.update(as_dict)
                tid = state_ids.get(tuple(nxt.get(k) for k in keys))
                if tid is not None:
                    table[si, oi] = tid
    memo = Memo(table=table, states=states,
                distinct_ops=packed.distinct_ops,
                initial=state_ids[init_combo])
    out = reach.check_packed(model, packed, max_states=max_states,
                             max_slots=max_slots, max_dense=max_dense,
                             should_abort=should_abort, memo=memo,
                             device=device)
    out["engine"] = "decompose-product"
    out["product-states"] = len(combos)
    out["key-count"] = len(keys)
    out["time-s"] = _time.monotonic() - t0
    return out


def _check_groups(model: models.MultiRegister,
                  groups: Dict[Any, List[h.Entry]], t0: float,
                  engine: str, *, max_states: int, max_slots: int,
                  max_dense: int, device,
                  time_limit: Optional[float], should_abort,
                  max_configs: Optional[int], frontier0: Optional[int],
                  max_frontier: Optional[int]) -> Dict[str, Any]:
    keys = sorted(groups, key=repr)
    if not keys:
        return {"valid": True, "engine": engine, "key-count": 0,
                "time-s": _time.monotonic() - t0}
    init = dict(model.registers)
    # batch keys that share an initial value (check_many takes one model)
    buckets: List[Tuple[Any, List[Any]]] = []
    for k in keys:
        iv = init.get(k)
        for b in buckets:
            if b[0] == iv:
                b[1].append(k)
                break
        else:
            buckets.append((iv, [k]))
    from jepsen_tpu_torch.checkers import reach
    from jepsen_tpu_torch.checkers.events import ConcurrencyOverflow

    deadline = _time.monotonic() + time_limit if time_limit else None

    def remaining() -> Optional[float]:
        return None if deadline is None else deadline - _time.monotonic()

    results: Dict[Any, Dict[str, Any]] = {}
    for iv, ks in buckets:
        reg = models.register(iv)
        packed_list = [h.pack_entries(groups[k]) for k in ks]
        try:
            rs = reach.check_many(reg, packed_list, max_states=max_states,
                                  max_slots=max_slots, max_dense=max_dense,
                                  device=device)
            results.update(zip(ks, rs))
        except (reach.DenseOverflow, ConcurrencyOverflow,
                StateExplosion) as batch_exc:
            # the batch does not fit: the per-key auto chain (shared
            # with the facade), each key picking the engine that fits
            # it, within the time budget
            obs.engine_fallback("reach-many",
                                type(batch_exc).__name__,
                                keys=len(ks))
            from jepsen_tpu_torch.checkers import facade
            for k, p in zip(ks, packed_list):
                rem = remaining()
                if (rem is not None and rem <= 0) or (
                        should_abort is not None and should_abort()):
                    results[k] = {"valid": "unknown", "cause": "timeout"}
                    continue
                kw = {"max_states": max_states, "max_slots": max_slots,
                      "max_dense": max_dense}
                if device is not None:
                    kw["device"] = device
                if rem is not None:
                    kw["time_limit"] = rem
                if should_abort is not None:
                    kw["should_abort"] = should_abort
                for name, v in (("max_configs", max_configs),
                                ("frontier0", frontier0),
                                ("max_frontier", max_frontier)):
                    if v is not None:
                        kw[name] = v
                results[k] = facade.auto_check_packed(reg, p, kw)
    valids = [r.get("valid") for r in results.values()]
    if all(v is True for v in valids):
        valid: Any = True
    elif any(v is False for v in valids):
        valid = False
    else:
        valid = "unknown"
    failures = [k for k in keys if results[k].get("valid") is False]
    out: Dict[str, Any] = {
        "valid": valid, "engine": engine, "key-count": len(keys),
        "failures": failures, "time-s": _time.monotonic() - t0}
    if failures:
        k = failures[0]
        out["key"] = k
        fr = dict(results[k])
        if "op" in fr:
            out["op"] = fr["op"]
        out["key-result"] = fr
    return out

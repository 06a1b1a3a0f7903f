"""Just-in-time linearization engine — upstream
``knossos/src/knossos/linear.clj`` (G. Lowe, *Testing for Linearizability*,
2017) with the packed config-set structures of
``knossos/src/knossos/linear/config.clj``. Host work in numpy: no
kernel computes this search.

The search advances a *set of configurations* ⟨model-state,
pending-unlinearized ops⟩ through the history's real-time event stream:

- **invoke**: the op joins every configuration's pending set.
- **return**: pending ops are fired (linearized) to a fixpoint — every
  linearization order of every subset is covered, with global dedup — and
  only configurations that linearized the returning op survive. An empty
  survivor set is a linearizability violation at exactly that event.

Firing is deferred to return events (the "just-in-time" idea): between
returns, pending sets only grow, so any linearization performed earlier is
still reachable by the closure at the next return.

Where the dense device engine (:mod:`.reach`) materializes the *entire*
``states × 2**W`` config space as one boolean tensor, this engine keeps the
reachable set sparse — the upstream's trade: cheap per-event work on
well-behaved histories, death by config-set explosion on adversarial ones
(reported as ``valid == "unknown"``, which the competition checker
(:func:`jepsen_tpu_torch.checkers.facade.linearizable` with
``algorithm="competition"``) resolves by racing the other engines).

Config-set representations, mirroring the upstream's array/set variants:

- :class:`ArrayConfigSet` — configs packed into one sorted ``uint64``
  vector (``state_id << 32 | pending_mask``); fire steps are vectorized
  NumPy gathers and the dedup is ``np.unique``. Used when the history
  needs ≤ 32 pending-op slots.
- :class:`SetConfigSet` — a plain set of ``(state_id, mask)`` tuples with
  unbounded Python-int masks; handles arbitrary concurrency.

Model states are int-coded lazily (like :mod:`.wgl_ref`), so models with
huge or unbounded alphabets work without a full
:mod:`jepsen_tpu_torch.models.memo` state enumeration.
"""
from __future__ import annotations

import heapq
import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch.models import Model, is_inconsistent
from jepsen_tpu_torch.op import Op

KIND_INVOKE = 0
KIND_RETURN = 1

_MASK32 = np.uint64(0xFFFFFFFF)


class _LazyTable:
    """Lazily int-coded model states with per-op dense transition columns
    (the vectorizable face of ``knossos.model.memo`` without the up-front
    reachable-state enumeration). ``-1`` = inconsistent, ``-2`` = not yet
    computed."""

    def __init__(self, model: Model, distinct_ops: Sequence[Op]):
        self.states: List[Model] = [model]
        self.state_ids: Dict[Model, int] = {model: 0}
        self.ops = tuple(distinct_ops)
        self._cols: Dict[int, np.ndarray] = {}

    def step(self, sid: int, oid: int) -> int:
        s2 = self.states[sid].step(self.ops[oid])
        if is_inconsistent(s2):
            return -1
        nid = self.state_ids.setdefault(s2, len(self.states))
        if nid == len(self.states):
            self.states.append(s2)
        return nid

    def column(self, oid: int, sids: np.ndarray) -> np.ndarray:
        """Dense transition column for op ``oid``, guaranteed computed at
        every state id in ``sids``."""
        col = self._cols.get(oid)
        if col is None or len(col) < len(self.states):
            new = np.full(len(self.states), -2, np.int64)
            if col is not None:
                new[:len(col)] = col
            self._cols[oid] = col = new
        for sid in np.unique(sids):
            if col[sid] == -2:
                col[sid] = self.step(int(sid), oid)
        return col


class SetConfigSet:
    """Set-backed config set (upstream ``set-config-set``): configs are
    ``(state_id, pending_mask)`` tuples, masks unbounded Python ints."""

    rep = "set"

    def __init__(self) -> None:
        self.configs: set = {(0, 0)}

    def __len__(self) -> int:
        return len(self.configs)

    def invoke(self, slot: int) -> None:
        bit = 1 << slot
        self.configs = {(sid, mask | bit) for sid, mask in self.configs}

    def closure(self, pending: Dict[int, int], table: _LazyTable,
                budget: Callable[[int], Optional[dict]]) -> Optional[dict]:
        frontier = self.configs
        while frontier:
            bad = budget(len(self.configs))
            if bad:
                return bad
            fresh = set()
            for sid, mask in frontier:
                for slot, oid in pending.items():
                    bit = 1 << slot
                    if not mask & bit:
                        continue
                    nid = table.step(sid, oid)
                    if nid < 0:
                        continue
                    cfg = (nid, mask & ~bit)
                    if cfg not in self.configs and cfg not in fresh:
                        fresh.add(cfg)
            self.configs |= fresh
            frontier = fresh
        return None

    def project_return(self, slot: int) -> None:
        bit = 1 << slot
        self.configs = {c for c in self.configs if not c[1] & bit}

    def stash(self):
        """O(1) reference to the current container (safe to keep across
        :meth:`project_return`, which rebinds rather than mutates)."""
        return self.configs

    @staticmethod
    def decode(stash, limit: int) -> List[tuple]:
        """Up to ``limit`` ``(state_id, pending_mask)`` pairs from a
        stashed container — the raw material for knossos-style
        ``final-configs`` evidence."""
        out = []
        for c in stash:
            out.append(c)
            if len(out) >= limit:
                break
        return out


class ArrayConfigSet:
    """Array-backed config set (upstream ``array-config-set``): one sorted
    unique ``uint64`` vector, ``state_id << 32 | pending_mask``. Fires are
    vectorized column gathers; dedup is sorted-merge."""

    rep = "array"

    def __init__(self) -> None:
        self.keys = np.zeros(1, np.uint64)          # initial config (0, 0)

    def __len__(self) -> int:
        return len(self.keys)

    def invoke(self, slot: int) -> None:
        # the slot was free, so the bit is clear in every config: OR is a
        # uniform addition and preserves sortedness/uniqueness
        self.keys = self.keys | np.uint64(1 << slot)

    def closure(self, pending: Dict[int, int], table: _LazyTable,
                budget: Callable[[int], Optional[dict]]) -> Optional[dict]:
        frontier = self.keys
        while frontier.size:
            bad = budget(len(self.keys))
            if bad:
                return bad
            masks = frontier & _MASK32
            sids = (frontier >> np.uint64(32)).astype(np.int64)
            parts = []
            for slot, oid in pending.items():
                bit = np.uint64(1 << slot)
                sel = (masks & bit) != 0
                if not sel.any():
                    continue
                col = table.column(oid, sids[sel])
                tgt = col[sids[sel]]
                legal = tgt >= 0
                if not legal.any():
                    continue
                parts.append(tgt[legal].astype(np.uint64) << np.uint64(32)
                             | (masks[sel][legal] & ~bit))
            if not parts:
                break
            cand = np.unique(np.concatenate(parts))
            # keep only configs not already present (self.keys is sorted)
            pos = np.searchsorted(self.keys, cand)
            pos_c = np.minimum(pos, len(self.keys) - 1)
            fresh = cand[self.keys[pos_c] != cand]
            if not fresh.size:
                break
            self.keys = np.union1d(self.keys, fresh)
            frontier = fresh
        return None

    def project_return(self, slot: int) -> None:
        bit = np.uint64(1 << slot)
        self.keys = self.keys[(self.keys & bit) == 0]

    def stash(self):
        """O(1) reference to the current key vector (safe to keep across
        :meth:`project_return`, which rebinds rather than mutates)."""
        return self.keys

    @staticmethod
    def decode(stash, limit: int) -> List[tuple]:
        """Up to ``limit`` ``(state_id, pending_mask)`` pairs from a
        stashed key vector — the raw material for knossos-style
        ``final-configs`` evidence."""
        return [(int(k >> np.uint64(32)), int(k & _MASK32))
                for k in stash[:limit]]


def check(model: Model, history: Sequence[Op], *,
          time_limit: Optional[float] = None,
          max_configs: int = 2_000_000,
          rep: str = "auto",
          should_abort: Optional[Callable[[], bool]] = None
          ) -> Dict[str, Any]:
    """Check ``history`` against ``model`` by just-in-time linearization.
    Returns the knossos-style verdict map (``valid`` True / False /
    ``"unknown"``); on failure adds ``op`` (the operation whose return no
    configuration could satisfy)."""
    packed = h.pack(history)
    return check_packed(model, packed, time_limit=time_limit,
                        max_configs=max_configs, rep=rep,
                        should_abort=should_abort)


def check_packed(model: Model, packed: h.PackedHistory, *,
                 time_limit: Optional[float] = None,
                 max_configs: int = 2_000_000,
                 rep: str = "auto",
                 should_abort: Optional[Callable[[], bool]] = None
                 ) -> Dict[str, Any]:
    n = packed.n
    if n == 0 or packed.n_ok == 0:
        return {"valid": True, "engine": "linear", "configs-explored": 0}

    # -- event stream + slot assignment (no width cap: the set rep handles
    # any concurrency; crashed ops hold their slot forever) ------------------
    evs = []
    for i in range(n):
        evs.append((int(packed.inv_ev[i]), KIND_INVOKE, i))
        if not packed.crashed[i]:
            evs.append((int(packed.ret_ev[i]), KIND_RETURN, i))
    evs.sort()
    free: List[int] = []
    hi = 0
    slot_of: Dict[int, int] = {}
    slots = np.zeros(len(evs), np.int32)
    for e, (_, k, i) in enumerate(evs):
        if k == KIND_INVOKE:
            s = heapq.heappop(free) if free else hi
            if s == hi:
                hi += 1
            slot_of[i] = s
            slots[e] = s
        else:
            s = slot_of.pop(i)
            slots[e] = s
            heapq.heappush(free, s)         # reuse after project_return
    W = max(hi, 1)

    if rep == "auto":
        rep = "array" if W <= 32 else "set"
    if rep == "array" and W > 32:
        raise ValueError(f"array config set supports <=32 slots, need {W}")
    configs = ArrayConfigSet() if rep == "array" else SetConfigSet()

    table = _LazyTable(model, packed.distinct_ops)
    start = _time.monotonic()
    peak = 1
    explored = 0

    def budget(live: int) -> Optional[Dict[str, Any]]:
        nonlocal peak
        peak = max(peak, live)
        if live > max_configs:
            return {"valid": "unknown", "cause": "config-set-explosion",
                    "engine": "linear", "rep": configs.rep,
                    "max-config-set": peak}
        if should_abort is not None and should_abort():
            return {"valid": "unknown", "cause": "aborted",
                    "engine": "linear", "rep": configs.rep}
        if time_limit is not None and _time.monotonic() - start > time_limit:
            return {"valid": "unknown", "cause": "timeout",
                    "engine": "linear", "rep": configs.rep}
        return None

    pending: Dict[int, int] = {}            # slot -> op id (live invocations)
    last_ok: Optional[int] = None           # entry of last linearized return
    for e, (_rank, k, i) in enumerate(evs):
        s = int(slots[e])
        if k == KIND_INVOKE:
            pending[s] = int(packed.op_id[i])
            configs.invoke(s)
            explored += len(configs)
            continue
        bad = configs.closure(pending, table, budget)
        if bad:
            bad["configs-explored"] = explored
            return bad
        explored += len(configs)
        # O(1) stash of the closure set's container: project_return
        # REBINDS (never mutates) it in both reps, so on the failure
        # path this reference still holds the knossos-style final
        # configs at the failing event — no per-return copying
        stash = configs.stash()
        configs.project_return(s)
        if len(configs) == 0:
            pend_before = dict(pending)      # still includes slot s
            final = [
                {"model": str(table.states[sid]),
                 "linearized-pending": [
                     str(table.ops[pend_before[sl]])
                     for sl in sorted(pend_before)
                     if not (mask >> sl) & 1]}
                for sid, mask in configs.decode(stash, 16)]
            out = {"valid": False, "engine": "linear",
                   "rep": configs.rep,
                   "op": packed.entries[i].op.to_dict(),
                   "final-configs": final,
                   "configs-explored": explored, "max-config-set": peak,
                   "states-materialized": len(table.states)}
            if last_ok is not None:
                out["previous-ok"] = packed.entries[last_ok].op.to_dict()
            return out
        del pending[s]
        last_ok = i
    return {"valid": True, "engine": "linear", "rep": configs.rep,
            "configs-explored": explored, "max-config-set": peak,
            "final-config-count": len(configs),
            "states-materialized": len(table.states)}

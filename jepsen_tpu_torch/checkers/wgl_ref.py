"""CPU reference Wing-Gong-Lowe linearizability search.

Upstream: ``knossos/src/knossos/wgl.clj`` (SURVEY.md §2.2, §3.2) — Wing &
Gong's (1993) search over linearization orders with Lowe's (2017)
memoization of ⟨linearized-set, model-state⟩ configurations.

This implementation is breadth-first over *configurations* ``(state_id,
linearized_mask)`` rather than the upstream's recursive DFS over a mutable
doubly-linked list: each BFS level linearizes exactly one more operation, so
the structure mirrors a frontier search over the same configurations and
serves as the oracle of the device walk, while exploring the same configuration space the
upstream memo set ``HashSet<⟨BitSet, state⟩>`` deduplicates.

Semantics (matching knossos; SURVEY.md §7 "hard parts" #4):

- ``fail`` completions are stripped in preprocessing (the op never happened).
- ``info``/crashed ops stay forever-pending: they may linearize at any point
  after invocation (explored like any candidate) or never (simply left
  unlinearized — validity only requires every ``ok`` op to linearize).
- An op may be linearized next iff no *unlinearized* op completed before its
  invocation: ``inv(x) < min(ret(y) for unlinearized y)``.
- Exceeding ``time_limit`` or ``max_configs`` yields ``valid == "unknown"``
  (upstream ``knossos.search`` timeout / memory-watchdog behaviour).

Model states are int-coded lazily (only states actually reached by legal
linearization prefixes are materialized), which keeps models with large
alphabets tractable without the full BFS table of
:mod:`jepsen_tpu_torch.models.memo`.
"""
from __future__ import annotations

import time as _time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch.models import Model, is_inconsistent
from jepsen_tpu_torch.op import Op

INF = 1 << 60


def check(model: Model, history: Sequence[Op], *,
          time_limit: Optional[float] = None,
          max_configs: int = 5_000_000,
          strategy: str = "dfs",
          should_abort: Optional[Callable[[], bool]] = None
          ) -> Dict[str, Any]:
    """Check ``history`` against ``model``. Returns a knossos-style map:
    ``{"valid": True|False|"unknown", "configs-explored": int, ...}``; on
    failure adds ``"op"`` (the op that could not be linearized) and
    ``"max-linearized"`` (the deepest coverage of ok ops reached).

    ``strategy="dfs"`` matches the upstream recursive search (fast first
    witness on valid histories); ``strategy="bfs"`` explores level-by-level,
    bit-exactly mirroring a frontier search. Both use the same memo
    set and explore the same configuration space.
    """
    entries = h.analysis_entries(history)
    packed = h.pack_entries(entries)
    return check_packed(model, packed, time_limit=time_limit,
                        max_configs=max_configs, strategy=strategy,
                        should_abort=should_abort)


def check_packed(model: Model, packed: h.PackedHistory, *,
                 time_limit: Optional[float] = None,
                 max_configs: int = 5_000_000,
                 strategy: str = "dfs",
                 should_abort: Optional[Callable[[], bool]] = None
                 ) -> Dict[str, Any]:
    n = packed.n
    if n == 0:
        return {"valid": True, "configs-explored": 0}
    inv_ev = packed.inv_ev
    ret_ev = [int(r) if not c else INF
              for r, c in zip(packed.ret_ev, packed.crashed)]
    inv = [int(x) for x in inv_ev]
    op_id = [int(x) for x in packed.op_id]
    ok_mask = 0
    for i in range(n):
        if not packed.crashed[i]:
            ok_mask |= 1 << i
    if ok_mask == 0:
        return {"valid": True, "configs-explored": 0}

    # lazy int-coding of model states
    states: List[Model] = [model]
    state_ids: Dict[Model, int] = {model: 0}
    trans: Dict[Tuple[int, int], int] = {}
    distinct_ops = packed.distinct_ops

    def step(sid: int, oid: int) -> int:
        key = (sid, oid)
        cached = trans.get(key)
        if cached is not None:
            return cached
        s2 = states[sid].step(distinct_ops[oid])
        if is_inconsistent(s2):
            res = -1
        else:
            res = state_ids.setdefault(s2, len(states))
            if res == len(states):
                states.append(s2)
        trans[key] = res
        return res

    start = _time.monotonic()
    seen: Set[Tuple[int, int]] = {(0, 0)}
    explored = 0
    best_cover = 0
    # every configuration reaching the deepest ok-coverage (capped 16);
    # expand() always runs on (0, 0) first, so the initial config is
    # captured without a placeholder
    best_configs: List[Tuple[int, int]] = []
    full = (1 << n) - 1
    found: List[Any] = []

    def expand(sid: int, mask: int) -> List[Tuple[int, int]]:
        """Candidate successors of a configuration: unlinearized i in
        invocation order while inv[i] < min ret over unlinearized j < i
        (scan order)."""
        nonlocal explored, best_cover
        explored += 1
        cover = (mask & ok_mask).bit_count()
        if cover > best_cover or not best_configs:
            best_cover = cover
            best_configs.clear()
            best_configs.append((sid, mask))
        elif cover == best_cover and len(best_configs) < 16:
            best_configs.append((sid, mask))
        out: List[Tuple[int, int]] = []
        m = INF
        rest = full & ~mask
        i = _lowest_bit(rest)
        while 0 <= i < n:
            if inv[i] >= m:
                break
            sid2 = step(sid, op_id[i])
            if sid2 >= 0:
                mask2 = mask | (1 << i)
                if (mask2 & ok_mask) == ok_mask:
                    found.append(True)
                    return out
                cfg = (sid2, mask2)
                if cfg not in seen:
                    seen.add(cfg)
                    out.append(cfg)
            m = min(m, ret_ev[i])
            rest &= ~(1 << i)
            i = _lowest_bit(rest)
        return out

    def over_budget() -> Optional[Dict[str, Any]]:
        if should_abort is not None and should_abort():
            return {"valid": "unknown", "cause": "aborted",
                    "configs-explored": explored}
        if time_limit is not None and _time.monotonic() - start > time_limit:
            return {"valid": "unknown", "cause": "timeout",
                    "configs-explored": explored}
        if len(seen) > max_configs:
            return {"valid": "unknown", "cause": "config-set-explosion",
                    "configs-explored": explored}
        return None

    if strategy == "bfs":
        frontier: List[Tuple[int, int]] = [(0, 0)]
        while frontier and not found:
            bad = over_budget()
            if bad:
                return bad
            nxt: List[Tuple[int, int]] = []
            for k, (sid, mask) in enumerate(frontier):
                if k % 4096 == 4095:
                    bad = over_budget()
                    if bad:
                        return bad
                nxt.extend(expand(sid, mask))
                if found:
                    break
            frontier = nxt
    elif strategy == "dfs":
        stack: List[Tuple[int, int]] = [(0, 0)]
        tick = 0
        while stack and not found:
            tick += 1
            if tick % 4096 == 0:
                bad = over_budget()
                if bad:
                    return bad
            sid, mask = stack.pop()
            stack.extend(reversed(expand(sid, mask)))
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    if found:
        return {"valid": True, "configs-explored": explored,
                "states-materialized": len(states)}

    # exhausted: non-linearizable. Report the first ok op that the deepest
    # configuration could not linearize, plus the deepest configurations
    # themselves (knossos's :final-paths analogue: model state + the
    # linearized ops CONCURRENT with the stuck op — the same
    # pending-window scope the device engines decode).
    sid, mask = best_configs[0] if best_configs else (0, 0)
    stuck = _lowest_bit(ok_mask & ~mask)
    op = packed.entries[stuck].op.to_dict() if stuck >= 0 else None
    final = []
    for s2, m2 in best_configs:
        # window relative to each config's OWN stuck op (tied configs
        # may be stuck on different ops)
        stuck2 = _lowest_bit(ok_mask & ~m2)
        if stuck2 >= 0:
            lin = [str(packed.entries[i].op) for i in range(n)
                   if (m2 >> i) & 1 and i != stuck2
                   and ret_ev[i] > inv[stuck2]]
        else:
            lin = []
        if not lin:             # fully-sequential window: show the tail
            lin = [str(packed.entries[i].op)
                   for i in range(n) if (m2 >> i) & 1][-8:]
        final.append({"model": repr(states[s2]),
                      "linearized-pending": lin})
    return {"valid": False, "op": op, "max-linearized": best_cover,
            "configs-explored": explored,
            "final-configs": final,
            "final-state": repr(states[sid])}


def _lowest_bit(x: int) -> int:
    if x == 0:
        return -1
    return (x & -x).bit_length() - 1

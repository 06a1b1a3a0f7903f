"""Key-independent workloads — upstream ``jepsen/src/jepsen/independent.clj``:
lift a single-key checker over N independent keys. Op values are
``[key, subvalue]`` tuples; the checker splits the history per key, runs
the inner checker on each sub-history, and merges.

When the inner checker is ``Linearizable`` (``auto`` or ``reach``), all
keys go to the card at once (:func:`jepsen_tpu_torch.checkers.reach.check_many`:
one launch of the keyed kernel walks every key's returns); the upstream
runs per-key Knossos analyses on a thread pool.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers.facade import Checker, Linearizable, check_safe
from jepsen_tpu_torch.op import Op
from jepsen_tpu_torch.util import hashable


def ktuple(key: Any, value: Any) -> List[Any]:
    """An independent op value ``[key, subvalue]`` (upstream
    ``jepsen.independent/tuple``)."""
    return [key, value]


def is_ktuple(value: Any) -> bool:
    return isinstance(value, (list, tuple)) and len(value) == 2


def split_history(history: Sequence[Op]) -> Dict[Any, List[Op]]:
    """Group ops by key, unwrapping ``[key, subvalue]`` values. Ops without
    tuple values (e.g. nemesis) are dropped, as upstream."""
    out: Dict[Any, List[Op]] = {}
    for op in history:
        if op.process == "nemesis" or not is_ktuple(op.value):
            continue
        k, v = op.value
        out.setdefault(hashable(k), []).append(op.with_(value=v))
    return {k: h.index(ops) for k, ops in out.items()}


class IndependentChecker(Checker):
    """Apply ``inner`` to each key's sub-history; valid iff every key is
    (upstream ``jepsen.independent/checker``)."""
    name = "independent"

    def __init__(self, inner: Checker):
        self.inner = inner

    def check(self, test: Optional[Mapping], history: Sequence[Op],
              opts: Optional[Mapping] = None) -> Dict[str, Any]:
        with obs.span("independent.split", ops=len(history)):
            subs = split_history(history)
        keys = sorted(subs.keys(), key=repr)
        results: Dict[Any, Dict[str, Any]] = {}
        if isinstance(self.inner, Linearizable) and \
                self.inner.algorithm in ("auto", "reach"):
            results = self._check_batched(test, subs, keys, opts)
        else:
            for k in keys:
                results[k] = check_safe(self.inner, test, subs[k], opts)
        valids = [r.get("valid") for r in results.values()]
        if all(v is True for v in valids):
            valid: Any = True
        elif any(v is False for v in valids):
            valid = False
        else:
            valid = "unknown"
        failures = [k for k, r in results.items() if r.get("valid") is False]
        return {"valid": valid, "key-count": len(keys),
                "failures": failures, "results": results}

    def _check_batched(self, test, subs, keys, opts):
        """One batched check on the card for every key that packs;
        per-key checking for the rest, and for all keys when the explicit
        ``reach`` algorithm's batch does not fit the dense engine."""
        from jepsen_tpu_torch.checkers import reach
        from jepsen_tpu_torch.checkers.events import ConcurrencyOverflow
        from jepsen_tpu_torch.checkers.facade import (
            _REACH_MANY_KW, _engine_kw, _model_from, auto_check_many_packed)
        from jepsen_tpu_torch.models.memo import StateExplosion

        model = _model_from(self.inner.model, test)
        kw = dict(self.inner.opts)
        if self.inner.device is not None:
            kw.setdefault("device", self.inner.device)
        if opts:
            kw.update(opts)
        packs, fits, results = {}, [], {}
        with obs.span("facade.pack", histories=len(keys)):
            for k in keys:
                try:
                    packs[k] = h.pack(subs[k])
                    fits.append(k)
                except Exception as e:                  # noqa: BLE001
                    results[k] = {"valid": "unknown",
                                  "error": f"{type(e).__name__}: {e}"}
        if self.inner.algorithm == "auto":
            batch = auto_check_many_packed(model,
                                           [packs[k] for k in fits], kw)
            for k, r in zip(fits, batch):
                results[k] = r
            return results
        try:
            batch = reach.check_many(model, [packs[k] for k in fits],
                                     **_engine_kw(kw, _REACH_MANY_KW))
            for k, r in zip(fits, batch):
                results[k] = r
        except (reach.DenseOverflow, ConcurrencyOverflow, StateExplosion):
            for k in fits:
                results[k] = check_safe(self.inner, test, subs[k], opts)
        return results


def checker(inner: Checker) -> IndependentChecker:
    return IndependentChecker(inner)

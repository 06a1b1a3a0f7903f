"""The composable ``Checker`` API — upstream ``jepsen/src/jepsen/checker.clj``:
``linearizable`` delegating to the search engines (as the upstream
delegates to Knossos via ``knossos.competition/analysis``), and
``check_safe``.

API shape: ``checker.check(test, history, opts) -> dict`` with at least a
``"valid"`` key (``True`` / ``False`` / ``"unknown"``), the model carried
by the checker (or the test map).
"""
from __future__ import annotations

import logging
import traceback as _traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.op import Op


class Checker:
    """Base checker (upstream ``jepsen.checker/Checker`` protocol)."""

    name = "checker"

    def check(self, test: Optional[Mapping], history: Sequence[Op],
              opts: Optional[Mapping] = None) -> Dict[str, Any]:
        raise NotImplementedError


def check_safe(checker: Checker, test: Optional[Mapping],
               history: Sequence[Op],
               opts: Optional[Mapping] = None) -> Dict[str, Any]:
    """Run a checker, turning exceptions into ``{"valid": "unknown"}``
    (upstream ``jepsen.checker/check-safe``) — never silently: the
    traceback is logged, returned under ``"traceback"``, and recorded in
    the ``obs`` ledger."""
    try:
        return checker.check(test, history, opts)
    except Exception as e:                              # noqa: BLE001
        name = getattr(checker, "name", type(checker).__name__)
        tb = _traceback.format_exc()
        logging.getLogger("jepsen.checker").warning(
            "checker %s crashed (returning unknown): %s", name, e,
            exc_info=e)
        obs.checker_swallowed(name, type(e).__name__, ops=len(history))
        return {"valid": "unknown",
                "error": f"{type(e).__name__}: {e}",
                "traceback": tb}


def _model_from(model: Optional[Model], test: Optional[Mapping]) -> Model:
    if model is not None:
        return model
    if test is not None and test.get("model") is not None:
        return test["model"]
    raise ValueError("no model given (checker or test['model'])")


@dataclass
class Linearizable(Checker):
    """Linearizability via the search engines (upstream
    ``jepsen.checker/linearizable``).

    ``algorithm``:

    - ``"auto"`` (default): the dense-reachability engine on the card,
      then the C++ WGL search, then the sparse frontier (its crashed-op
      quotient first), then for multi-register models the restricted
      product and the transactional screen, then the Python oracle
      (:func:`auto_check_packed`). For ``MultiRegister`` the per-key
      decomposition runs first.
    - ``"reach"`` — the dense engine alone
      (:mod:`jepsen_tpu_torch.checkers.reach`).
    - ``"chunklock"`` — the chunk-lockstep engine alone
      (:mod:`jepsen_tpu_torch.checkers.reach_chunklock`), with its
      ``n_chunks``, ``e_pad`` and ``suffix`` options.
    - ``"frontier"`` — the sparse frontier engine
      (:mod:`jepsen_tpu_torch.checkers.frontier`), with its
      ``frontier0`` and ``max_frontier`` options.
    - ``"decompose"`` — the per-key split of single-key multi-register
      histories into a batched register check
      (:mod:`jepsen_tpu_torch.checkers.decompose`).
    - ``"wgl-native"`` — the C++ WGL search
      (:mod:`jepsen_tpu_torch.checkers.wgl_native`).
    - ``"wgl-cpu"`` — the Python oracle
      (:mod:`jepsen_tpu_torch.checkers.wgl_ref`).

    ``device`` (or ``opts["device"]``) names where the device engines
    run: the card by default; ``"cpu"`` runs the plain PyTorch versions.
    """
    model: Optional[Model] = None
    algorithm: str = "auto"
    opts: Dict[str, Any] = field(default_factory=dict)
    device: Optional[str] = None
    name = "linearizable"

    def check(self, test, history, opts=None):
        from jepsen_tpu_torch.checkers import reach, wgl_ref

        model = _model_from(self.model, test)
        kw = dict(self.opts)
        if self.device is not None:
            kw.setdefault("device", self.device)
        if opts:
            kw.update({k: v for k, v in opts.items() if k != "model"})
        algorithm = kw.pop("algorithm", self.algorithm)
        if algorithm == "reach":
            return reach.check(model, history, **_engine_kw(kw, _REACH_KW))
        if algorithm == "chunklock":
            from jepsen_tpu_torch.checkers import reach_chunklock
            return reach_chunklock.check_packed(
                model, h.pack(history), **_engine_kw(kw, _CHUNKLOCK_KW))
        if algorithm == "frontier":
            from jepsen_tpu_torch.checkers import frontier
            return frontier.check(model, history,
                                  **_engine_kw(kw, _FRONTIER_KW))
        if algorithm == "decompose":
            from jepsen_tpu_torch.checkers import decompose
            res = decompose.check(model, history,
                                  **_engine_kw(kw, _DECOMPOSE_KW))
            if res is None:
                return {"valid": "unknown", "cause": "not-decomposable",
                        "engine": "decompose"}
            return res
        if algorithm == "wgl-native":
            from jepsen_tpu_torch.checkers import wgl_native
            return wgl_native.check(model, history,
                                    **_engine_kw(kw, _NATIVE_KW))
        if algorithm == "wgl-cpu":
            return wgl_ref.check(model, history, **_engine_kw(kw, _WGL_KW))
        if algorithm == "auto":
            from jepsen_tpu_torch import models as _models
            with obs.span("facade.pack", ops=len(history)):
                packed = h.pack(history)
            if isinstance(model, _models.MultiRegister):
                # P-compositionality (Herlihy & Wing locality): a history
                # of single-key ops splits into per-key register
                # histories, one batched device call. A decomposed
                # "unknown" is returned as it is: the monolithic product
                # space is strictly harder
                from jepsen_tpu_torch.checkers import decompose
                with obs.span("facade.decompose", ops=packed.n):
                    res = decompose.check_packed(
                        model, packed, **_engine_kw(kw, _DECOMPOSE_KW))
                if res is not None:
                    obs.engine_selected(res.get("engine", "decompose"),
                                        ops=packed.n, valid=res.get("valid"))
                    return res
                obs.decision("decompose", "skipped",
                             cause="not-decomposable", ops=packed.n)
            return auto_check_packed(model, packed, kw)
        raise NotImplementedError(f"algorithm {algorithm!r} not ported")


def linearizable(model: Optional[Model] = None,
                 algorithm: str = "auto", **opts: Any) -> Linearizable:
    return Linearizable(model=model, algorithm=algorithm, opts=opts)


def auto_check_packed(model: Model, packed, kw: Mapping) -> Dict[str, Any]:
    """The ``auto`` chain at the packed level, first conclusive verdict
    wins: dense engine on ``kw["device"]`` (default: the card) → C++ WGL
    → sparse frontier (its crashed-op quotient first) → restricted
    product / transactional screen (multi-register models) → Python
    oracle. Shared by :class:`Linearizable` and the per-key fallback of
    :mod:`jepsen_tpu_torch.checkers.decompose`.

    Only a capacity decline moves the chain on (``DenseOverflow``,
    ``StateExplosion``, ``ConcurrencyOverflow``, ``FrontierOverflow``,
    or a stage's ``unknown``); any other error propagates.

    A ``time_limit`` in ``kw`` budgets the chain as a whole: each
    wall-clock-limited stage receives only the time remaining, and the
    device stages poll the deadline through their abort hooks. Every
    stage transition lands in the engine-decision ledger: exactly one
    ``"selected"`` record per call and one ``"fallback"`` record per
    abandoned stage."""
    import time as _time

    from jepsen_tpu_torch import models as _models
    from jepsen_tpu_torch.checkers import frontier, reach, wgl_native, wgl_ref
    from jepsen_tpu_torch.checkers.events import ConcurrencyOverflow
    from jepsen_tpu_torch.models.memo import StateExplosion

    kw = dict(kw)
    kw["device"] = _device.resolve(kw.get("device"))
    geom = {"ops": packed.n, "ok-ops": packed.n_ok}
    t_stage = _time.monotonic()

    def _selected(res: Dict[str, Any], default_stage: str
                  ) -> Dict[str, Any]:
        obs.engine_selected(res.get("engine", default_stage), **geom,
                            valid=res.get("valid"),
                            elapsed_s=round(_time.monotonic() - t_stage,
                                            6))
        return res

    def _fellback(stage: str, cause: str) -> None:
        nonlocal t_stage
        obs.engine_fallback(stage, cause, **geom,
                            elapsed_s=round(_time.monotonic() - t_stage,
                                            6))
        t_stage = _time.monotonic()

    tl = kw.get("time_limit")
    deadline = _time.monotonic() + tl if tl else None

    def _spent() -> bool:
        return deadline is not None and _time.monotonic() >= deadline

    def _budgeted(ekw: Dict[str, Any]) -> Dict[str, Any]:
        if deadline is not None:
            ekw["time_limit"] = max(1e-3, deadline - _time.monotonic())
        return ekw

    def _with_deadline_abort(ekw: Dict[str, Any]) -> Dict[str, Any]:
        """Compose the chain deadline into a stage's should_abort hook
        (for stages budgeted by abort polling, not time_limit)."""
        if deadline is not None:
            user_abort = ekw.get("should_abort")
            ekw["should_abort"] = (
                (lambda: user_abort() or _spent())
                if user_abort is not None else _spent)
        return ekw

    exploded = False                # product-space memo blow-ups seen
    try:
        ekw = _with_deadline_abort(_engine_kw(kw, _REACH_KW))
        with obs.span("facade.reach", **geom):
            res = reach.check_packed(model, packed, **ekw)
        if res.get("valid") in (True, False):
            return _selected(res, "reach")
        _fellback("reach", f"unknown:{res.get('cause', '?')}")
    except (reach.DenseOverflow, StateExplosion) as e:
        exploded = True
        _fellback("reach", type(e).__name__)
    except ConcurrencyOverflow as e:
        _fellback("reach", type(e).__name__)
    if not _spent():
        try:
            with obs.span("facade.wgl-native", **geom):
                res = wgl_native.check_packed(
                    model, packed, **_budgeted(_engine_kw(kw, _NATIVE_KW)))
            if res.get("valid") in (True, False):
                res["engine"] = "wgl-native-fallback"
                return _selected(res, "wgl-native-fallback")
            _fellback("wgl-native", f"unknown:{res.get('cause', '?')}")
        except StateExplosion as e:
            exploded = True         # un-memoizable / product blow-up
            _fellback("wgl-native", type(e).__name__)
    if not _spent():
        try:
            # the crashed-op quotient can survive crash-heavy histories
            # that explode the exact C++ search
            with obs.span("facade.frontier", **geom):
                res = frontier.check_packed(
                    model, packed,
                    **_budgeted(_engine_kw(kw, _FRONTIER_KW)))
            if res.get("valid") in (True, False):
                res["engine"] = "frontier-fallback"
                return _selected(res, "frontier-fallback")
            _fellback("frontier", f"unknown:{res.get('cause', '?')}")
        except (frontier.FrontierOverflow, ConcurrencyOverflow,
                StateExplosion) as e:
            _fellback("frontier", type(e).__name__)
    if isinstance(model, _models.MultiRegister):
        # multi-key transactional histories on an exploding product
        # space: first the restricted product (per-key value closures
        # bound the jointly reachable product states; an exact verdict
        # by the dense engine over them)
        from jepsen_tpu_torch.checkers import decompose
        if not _spent():
            try:
                rp = decompose.check_restricted_product(
                    model, packed,
                    **_with_deadline_abort(_engine_kw(kw, _REACH_KW)))
                if rp is not None and rp.get("valid") in (True, False):
                    return _selected(rp, "restricted-product")
            except (StateExplosion, reach.DenseOverflow,
                    ConcurrencyOverflow) as e:
                _fellback("restricted-product", type(e).__name__)
        # then the sound per-key projection screen: an invalid
        # projection proves non-linearizability; all-valid projections
        # give an explicit "unknown" with its reason, returned when the
        # memoized engines already refused the product space
        try:
            tx = decompose.check_transactional(
                model, packed, **_budgeted(_engine_kw(kw, _DECOMPOSE_KW)))
        except (StateExplosion, reach.DenseOverflow,
                ConcurrencyOverflow) as e:
            tx = None
            _fellback("transactional-screen", type(e).__name__)
        if tx is not None and (tx.get("valid") is False or exploded
                               or _spent()):
            return _selected(tx, "transactional-screen")
    if _spent():
        obs.decision("auto-chain", "timeout", **geom)
        return {"valid": "unknown", "cause": "timeout",
                "engine": "auto-chain"}
    with obs.span("facade.wgl-cpu", **geom):
        res = wgl_ref.check_packed(model, packed,
                                   **_budgeted(_engine_kw(kw, _WGL_KW)))
    res["engine"] = "wgl-cpu-fallback"
    return _selected(res, "wgl-cpu-fallback")


def auto_check_txn(history: Sequence[Op],
                   kw: Optional[Mapping] = None) -> Dict[str, Any]:
    """The transactional (Elle-style) route: list-append dependency
    inference and cycle search on the closure (:mod:`jepsen_tpu_torch.txn`,
    on ``kw["device"]``, default the card), the host SCC reference by
    decision. Exactly one ``"selected"`` ledger record per call names the
    engine that produced the verdict, as :func:`auto_check_packed` does."""
    import time as _time

    from jepsen_tpu_torch import txn as txn_mod

    ekw = _engine_kw(kw or {}, _TXN_KW)
    t0 = _time.monotonic()
    with obs.span("facade.txn", ops=len(history)):
        res = txn_mod.check_history(history, **ekw)
    obs.engine_selected(res.get("engine", "txn"), txns=res.get("txns"),
                        edges=res.get("edges"),
                        valid=res.get("valid"),
                        elapsed_s=round(_time.monotonic() - t0, 6))
    return res


def auto_check_many_packed(model: Model, packed_list,
                           kw: Mapping) -> List[Dict[str, Any]]:
    """The ``auto`` chain for many packed histories at once (the
    ``independent`` checker's keys): the batched dense engine
    (:func:`reach.check_many`) on ``kw["device"]`` (default: the card),
    falling back to the per-history :func:`auto_check_packed` chain
    only when a history does not fit the dense engine
    (:class:`~jepsen_tpu_torch.checkers.reach.DenseOverflow`,
    :class:`~jepsen_tpu_torch.checkers.events.ConcurrencyOverflow`,
    :class:`~jepsen_tpu_torch.models.memo.StateExplosion`); any other
    error propagates. In the per-history chain one failing history
    yields an ``"unknown"`` (check-safe semantics), recorded in the
    ledger. Results align with ``packed_list``."""
    from jepsen_tpu_torch.checkers import reach
    from jepsen_tpu_torch.checkers.events import ConcurrencyOverflow
    from jepsen_tpu_torch.models.memo import StateExplosion

    ekw = _engine_kw(kw, _REACH_MANY_KW)
    ekw["device"] = _device.resolve(kw.get("device"))
    try:
        with obs.span("facade.check-many", histories=len(packed_list)):
            out = reach.check_many(model, packed_list, **ekw)
        obs.engine_selected("reach-many", histories=len(packed_list),
                            engines=sorted({r.get("engine", "?")
                                            for r in out}))
        return out
    except (reach.DenseOverflow, ConcurrencyOverflow,
            StateExplosion) as e:
        obs.engine_fallback("reach-many", type(e).__name__,
                            histories=len(packed_list))
    out = []
    for p in packed_list:
        try:
            out.append(auto_check_packed(model, p, kw))
        except Exception as e:                          # noqa: BLE001
            obs.checker_swallowed("auto-chain", type(e).__name__,
                                  ops=p.n)
            out.append({"valid": "unknown",
                        "error": f"{type(e).__name__}: {e}"})
    return out


# keyword subsets understood by each engine; user opts are filtered so one
# checker config can carry opts for every algorithm it may route to.
_REACH_KW = ("max_states", "max_slots", "max_dense", "should_abort",
             "device")
_REACH_MANY_KW = _REACH_KW          # check_many takes the same options
_CHUNKLOCK_KW = ("max_states", "max_slots", "max_dense", "n_chunks",
                 "e_pad", "suffix", "device")
_WGL_KW = ("time_limit", "max_configs", "strategy", "should_abort")
_NATIVE_KW = ("time_limit", "max_configs", "max_states", "abort_flag")
_FRONTIER_KW = ("max_states", "frontier0", "max_frontier", "time_limit",
                "should_abort", "device")
_DECOMPOSE_KW = _REACH_KW + ("time_limit", "max_configs", "frontier0",
                             "max_frontier")
_TXN_KW = ("device", "max_dense_txns", "force_host", "consistency")


def _engine_kw(kw: Mapping, allowed: Sequence[str]) -> Dict[str, Any]:
    return {k: v for k, v in kw.items() if k in allowed}


@dataclass
class Compose(Checker):
    """Run several named checkers; valid iff all are (upstream
    ``jepsen.checker/compose``)."""
    checkers: Dict[str, Checker]
    name = "compose"

    def check(self, test, history, opts=None):
        results = {name: check_safe(c, test, history, opts)
                   for name, c in self.checkers.items()}
        valids = [r.get("valid") for r in results.values()]
        if all(v is True for v in valids):
            valid: Any = True
        elif any(v is False for v in valids):
            valid = False
        else:
            valid = "unknown"
        return {"valid": valid, "results": results}


def compose(checkers: Dict[str, Checker]) -> Compose:
    return Compose(checkers)

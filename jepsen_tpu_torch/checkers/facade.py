"""The composable ``Checker`` API — upstream ``jepsen/src/jepsen/checker.clj``:
``linearizable`` delegating to the search engines (as the upstream
delegates to Knossos via ``knossos.competition/analysis``), the
data-invariant checkers (``set``, ``counter``, ``queue``,
``total-queue``), ``compose``, ``noop``, ``unbridled-optimism``,
``stats``, ``check_safe`` and ``check_declining``.

API shape: ``checker.check(test, history, opts) -> dict`` with at least a
``"valid"`` key (``True`` / ``False`` / ``"unknown"``), the model carried
by the checker (or the test map).
"""
from __future__ import annotations

import logging
import threading
import traceback as _traceback
from collections import Counter as _Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import history as h
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.models import Model
from jepsen_tpu_torch.op import FAIL, INFO, INVOKE, OK, Op
from jepsen_tpu_torch.util import hashable


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


def check_declining(checker: Checker, test: Optional[Mapping],
                    history: Sequence[Op],
                    opts: Optional[Mapping] = None) -> Dict[str, Any]:
    """Run a checker, turning only a capacity decline (the history does
    not fit the engine: :func:`_capacity_declines`) into ``{"valid":
    "unknown", "error": ...}``. Any other error propagates, a failed
    kernel build or a CUDA launch error above all. ``compose``, the
    ``independent`` checker, the test runner and the command line check
    through this; :func:`check_safe` stays for a caller that wants every
    error made an ``unknown``."""
    try:
        return checker.check(test, history, opts)
    except _capacity_declines() as e:
        return {"valid": "unknown", "error": f"{type(e).__name__}: {e}"}


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
    - ``"reach-chunked"`` — the dense engine, history-parallel
      (:func:`jepsen_tpu_torch.checkers.reach.check_chunked`), with its
      ``n_chunks`` and ``max_matrix`` options.
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
    - ``"linear"`` — sparse just-in-time linearization, upstream
      ``knossos.linear`` (:mod:`jepsen_tpu_torch.checkers.linear`).
    - ``"competition"`` — the C++ WGL search, the dense engine, the
      JIT-linearization and the frontier raced on threads; the first
      definitive verdict wins and the losers are aborted (upstream
      ``knossos.competition``; :func:`_competition`).

    An invalid verdict with an ``op`` renders the failing window as
    ``linear.svg`` into ``test["dir"]`` when the test names one, and
    sets ``report-file``.

    ``device`` (or ``opts["device"]``) names where the device engines
    run: the card by default; ``"cpu"`` runs the plain PyTorch versions.
    ``body`` (or ``opts["body"]``), ``"word"`` or ``"dense"``, picks the
    dense engine's walk body where the word walk admits the geometry
    (``reach.check_packed``); None consults the autotune table.
    """
    model: Optional[Model] = None
    algorithm: str = "auto"
    opts: Dict[str, Any] = field(default_factory=dict)
    device: Optional[str] = None
    body: Optional[str] = None
    name = "linearizable"

    def check(self, test, history, opts=None):
        res = self._check_impl(test, history, opts)
        out_dir = (test or {}).get("dir") if hasattr(test, "get") else None
        if res.get("valid") is False and res.get("op") and out_dir:
            # the upstream-style SVG of the failing window
            # (knossos.linear.report) next to the run's other artifacts
            import os

            from jepsen_tpu_torch.checkers import linear_report
            path = os.path.join(out_dir, "linear.svg")
            try:
                linear_report.render_analysis(history, res, path)
            except Exception:                           # noqa: BLE001
                pass        # a host-side drawing; it never masks a verdict
            else:
                res["report-file"] = path
        return res

    def _check_impl(self, test, history, opts=None):
        from jepsen_tpu_torch.checkers import reach, wgl_ref

        model = _model_from(self.model, test)
        kw = dict(self.opts)
        if self.device is not None:
            kw.setdefault("device", self.device)
        if self.body is not None:
            kw.setdefault("body", self.body)
        if opts:
            kw.update({k: v for k, v in opts.items() if k != "model"})
        algorithm = kw.pop("algorithm", self.algorithm)
        if algorithm == "reach":
            return reach.check(model, history,
                               **_engine_kw(kw, _POSTHOC_KW))
        if algorithm == "reach-chunked":
            with obs.span("facade.pack", ops=len(history)):
                packed = h.pack(history)
            return reach.check_chunked(model, packed=packed,
                                       **_engine_kw(kw, _CHUNKED_KW))
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
        if algorithm == "linear":
            from jepsen_tpu_torch.checkers import linear
            return linear.check(model, history,
                                **_engine_kw(kw, _LINEAR_KW))
        if algorithm == "competition":
            return _competition(model, history, kw)
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
        raise ValueError(f"unknown algorithm {algorithm!r}")


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
        ekw = _with_deadline_abort(_engine_kw(kw, _POSTHOC_KW))
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
    ledger. Results align with ``packed_list``. Without a ``group`` in
    ``kw`` the lockstep group width is the recorded ``group`` winner
    (:func:`_group_width`)."""
    from jepsen_tpu_torch.checkers import reach
    from jepsen_tpu_torch.checkers.events import ConcurrencyOverflow
    from jepsen_tpu_torch.models.memo import StateExplosion

    ekw = _engine_kw(kw, _REACH_MANY_KW)
    ekw["device"] = _device.resolve(kw.get("device"))
    _group_width(ekw)
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


def stage_check_many_packed(model: Model, packed_list, kw: Mapping):
    """The staging half of :func:`auto_check_many_packed` for the check
    daemon's lanes: only the lockstep lane, its collect deferred
    (:func:`reach.stage_check_many`: the union prep, every group's K2
    walk queued on ``kw["device"]``, default the card, nothing fetched).
    Returns a :class:`reach.StagedMany`, whose ``collect()`` gives the
    results :func:`auto_check_many_packed` would, or None when the lane
    would not take the batch, and the caller then runs
    :func:`auto_check_many_packed`. A fault propagates."""
    from jepsen_tpu_torch.checkers import reach

    ekw = _engine_kw(kw, _REACH_MANY_KW)
    ekw["device"] = _device.resolve(kw.get("device"))
    _group_width(ekw)
    with obs.span("facade.stage-many", histories=len(packed_list)):
        staged = reach.stage_check_many(model, packed_list, **ekw)
    if staged is not None:
        obs.engine_selected("reach-many", histories=len(packed_list),
                            engines=["reach-lockstep"], staged=True)
    return staged


def _group_width(ekw: Dict[str, Any]) -> None:
    """Without a ``group`` in ``ekw``, the recorded ``group`` winner
    (:mod:`.autotune`, geometry ``default``, on the device's backend)
    becomes the lockstep group width; else ``reach``'s default stays."""
    from jepsen_tpu_torch.checkers import autotune

    if "group" not in ekw:
        g = autotune.winner("group", "default",
                            backend_name=ekw["device"].type)
        if g and str(g).isdigit():
            ekw["group"] = int(g)


# keyword subsets understood by each engine; user opts are filtered so one
# checker config can carry opts for every algorithm it may route to.
_REACH_KW = ("max_states", "max_slots", "max_dense", "should_abort",
             "device")
_POSTHOC_KW = _REACH_KW + ("body",)     # reach.check and check_packed
_REACH_MANY_KW = _POSTHOC_KW + ("group",)
_CHUNKED_KW = _REACH_KW + ("n_chunks", "max_matrix")
_CHUNKLOCK_KW = ("max_states", "max_slots", "max_dense", "n_chunks",
                 "e_pad", "suffix", "device")
_WGL_KW = ("time_limit", "max_configs", "strategy", "should_abort")
_NATIVE_KW = ("time_limit", "max_configs", "max_states", "abort_flag")
_FRONTIER_KW = ("max_states", "frontier0", "max_frontier", "time_limit",
                "should_abort", "device")
_DECOMPOSE_KW = _REACH_KW + ("time_limit", "max_configs", "frontier0",
                             "max_frontier")
_TXN_KW = ("device", "max_dense_txns", "force_host", "consistency")
_LINEAR_KW = ("time_limit", "max_configs", "rep", "should_abort")


def _engine_kw(kw: Mapping, allowed: Sequence[str]) -> Dict[str, Any]:
    return {k: v for k, v in kw.items() if k in allowed}


@dataclass
class Compose(Checker):
    """Run several named checkers; valid iff all are (upstream
    ``jepsen.checker/compose``). Each runs through
    :func:`check_declining`: a capacity decline is that checker's
    ``unknown``, any other error propagates."""
    checkers: Dict[str, Checker]
    name = "compose"

    def check(self, test, history, opts=None):
        results = {name: check_declining(c, test, history, opts)
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


# -- competition: the searches raced on threads -----------------------------

# the racers' declines: the history does not fit that engine, which is an
# "unknown" in the race, not a fault
def _capacity_declines():
    from jepsen_tpu_torch.checkers import frontier, reach, reach_q
    from jepsen_tpu_torch.checkers.events import ConcurrencyOverflow
    from jepsen_tpu_torch.models.memo import StateExplosion

    return (reach.DenseOverflow, ConcurrencyOverflow, StateExplosion,
            frontier.FrontierOverflow, reach_q.QuotientOverflow)


def _competition(model: Model, history: Sequence[Op],
                 kw: Dict[str, Any]) -> Dict[str, Any]:
    """Race the C++ WGL search, the dense engine, the JIT-linearization
    and the sparse frontier on threads (upstream
    ``knossos.competition/analysis``, which races wgl against linear);
    the first definitive verdict wins (``winner`` names it) and the
    losers are aborted through one :class:`SearchControl` (the C++
    search by its bound ``AbortFlag``, the others by ``should_abort``).

    A racer's capacity decline (:func:`_capacity_declines`), an abort or
    an ``unknown`` counts as ``unknown``; any other exception is a fault
    and is raised. After the abort the two device racers (dense engine,
    frontier) are joined, which stop within one segment, and a fault of
    theirs is raised even when another racer won. Each racer runs under
    a copy of the caller's context, so its spans and ledger records
    reach any active ``obs.capture()``."""
    import contextvars
    import queue

    from jepsen_tpu_torch.checkers import frontier, linear, reach, wgl_native
    from jepsen_tpu_torch.checkers.search import SearchControl

    kw = dict(kw)
    kw["device"] = _device.resolve(kw.get("device"))
    declines = _capacity_declines()
    ctl = SearchControl(time_limit=kw.get("time_limit")).start()
    native_abort = ctl.bind_native(wgl_native.AbortFlag())
    verdicts: "queue.Queue" = queue.Queue()

    def racer(name, fn):
        def run():
            try:
                r = fn()
            except declines as e:
                r = {"valid": "unknown", "cause": type(e).__name__,
                     "error": str(e)}
            except BaseException as e:                  # noqa: BLE001
                verdicts.put((name, None, e))
                return
            verdicts.put((name, r, None))
        ctx = contextvars.copy_context()
        return threading.Thread(target=lambda: ctx.run(run), daemon=True,
                                name=f"competition-{name}")

    device_racers = {
        "reach": racer("reach", lambda: reach.check(
            model, history, should_abort=ctl.should_abort,
            **_engine_kw(kw, _REACH_KW))),
        "frontier": racer("frontier", lambda: frontier.check(
            model, history, should_abort=ctl.should_abort,
            **_engine_kw(kw, ("max_states", "frontier0", "max_frontier",
                              "device")))),
    }
    host_racers = {
        "wgl-native": racer("wgl-native", lambda: wgl_native.check(
            model, history, abort_flag=native_abort,
            **_engine_kw(kw, ("max_configs", "max_states")))),
        "linear": racer("linear", lambda: linear.check(
            model, history, should_abort=ctl.should_abort,
            **_engine_kw(kw, ("max_configs", "rep")))),
    }
    threads = {**host_racers, **device_racers}
    for t in threads.values():
        t.start()
    import time as _time

    winner: Optional[Dict[str, Any]] = None
    fallback: Optional[Dict[str, Any]] = None
    fault: Optional[BaseException] = None
    try:
        for _ in threads:
            name, r, exc = verdicts.get()
            if exc is not None:
                fault = exc
                break
            if r.get("valid") in (True, False):
                winner = dict(r)
                winner["winner"] = name
                break
            fallback = fallback or r    # an unknown, as a last resort
    finally:
        ctl.abort()                         # stop the losers
        t_abort = _time.monotonic()
        for t in device_racers.values():
            t.join()
        ctl.close()
    # the ledger keeps how long the device losers took to stop
    obs.decision("competition", "route",
                 winner=winner["winner"] if winner else None,
                 stop_s=round(_time.monotonic() - t_abort, 6))
    while fault is None and not verdicts.empty():
        name, _r, exc = verdicts.get_nowait()
        if exc is not None and name in device_racers:
            fault = exc
    if fault is not None:
        raise fault
    return winner or fallback or {"valid": "unknown"}


# -- the data-invariant checkers ---------------------------------------------

class NoopChecker(Checker):
    """Always valid (upstream ``jepsen.checker/noop``)."""
    name = "noop"

    def check(self, test, history, opts=None):
        return {"valid": True}


class UnbridledOptimism(Checker):
    """Everything is awesome (upstream
    ``jepsen.checker/unbridled-optimism``)."""
    name = "unbridled-optimism"

    def check(self, test, history, opts=None):
        return {"valid": True}


def noop_checker() -> NoopChecker:
    return NoopChecker()


def unbridled_optimism() -> UnbridledOptimism:
    return UnbridledOptimism()


@dataclass
class SetChecker(Checker):
    """Grow-only set workload: ``add`` ops followed by a final ``read``
    returning the set contents (upstream ``jepsen.checker/set``). Valid iff
    every acknowledged add is present and nothing never-attempted is."""
    name = "set"

    def check(self, test, history, opts=None):
        attempts = set()
        acked = set()
        final_read = None
        for op in history:
            if op.process == "nemesis":
                continue
            if op.f == "add":
                v = hashable(op.value)
                if op.type == INVOKE:
                    attempts.add(v)
                elif op.type == OK:
                    acked.add(v)
            elif op.f == "read" and op.type == OK:
                final_read = {hashable(v) for v in (op.value or [])}
        if final_read is None:
            return {"valid": "unknown", "error": "no final read"}
        lost = acked - final_read
        unexpected = final_read - attempts
        recovered = (final_read & attempts) - acked
        return {
            "valid": not lost and not unexpected,
            "attempt-count": len(attempts), "acknowledged-count": len(acked),
            "ok-count": len(final_read & acked),
            "lost-count": len(lost), "lost": sorted(lost, key=repr),
            "unexpected-count": len(unexpected),
            "unexpected": sorted(unexpected, key=repr),
            "recovered-count": len(recovered),
            "recovered": sorted(recovered, key=repr),
        }


def set_checker() -> SetChecker:
    return SetChecker()


@dataclass
class CounterChecker(Checker):
    """Counter workload: ``add`` deltas (possibly failing or crashing) and
    ``read`` observations (upstream ``jepsen.checker/counter``). Each ok
    read must lie within the interval of possible counter values given
    which adds had definitely / possibly taken effect at that moment."""
    name = "counter"

    def check(self, test, history, opts=None):
        pairs = h.pair(h.index(list(history))
                       if history and history[0].index < 0 else list(history))
        adds, reads = [], []
        INF = 1 << 60
        for p in pairs:
            if p.failed:
                continue
            op = p.invoke
            ret = p.complete.index if not p.crashed else INF
            if op.f == "add":
                adds.append((op.index, ret, op.value or 0, p.crashed))
            elif op.f == "read" and not p.crashed:
                v = p.complete.value
                if v is not None:
                    reads.append((op.index, ret, v))
        if not reads:
            return {"valid": True, "reads-checked": 0}
        a_inv = np.array([a[0] for a in adds], np.int64).reshape(-1, 1)
        a_ret = np.array([a[1] for a in adds], np.int64).reshape(-1, 1)
        a_d = np.array([a[2] for a in adds], np.float64).reshape(-1, 1)
        a_crash = np.array([a[3] for a in adds], bool).reshape(-1, 1)
        bad = []
        for chunk in range(0, len(reads), 4096):
            rs = reads[chunk:chunk + 4096]
            r_inv = np.array([r[0] for r in rs], np.int64)
            r_ret = np.array([r[1] for r in rs], np.int64)
            r_v = np.array([r[2] for r in rs], np.float64)
            if len(adds):
                # definitely applied: acked and returned before the read
                # began; possibly applied: invoked before it returned
                exact = (~a_crash) & (a_ret < r_inv)
                maybe = (a_inv < r_ret) & ~exact
                base = (a_d * exact).sum(axis=0)
                lo = base + (np.minimum(a_d, 0) * maybe).sum(axis=0)
                hi = base + (np.maximum(a_d, 0) * maybe).sum(axis=0)
            else:
                lo = hi = np.zeros(len(rs))
            out = (r_v < lo) | (r_v > hi)
            for i in np.nonzero(out)[0]:
                bad.append({"value": rs[i][2], "index": int(rs[i][0]),
                            "possible": [float(lo[i]), float(hi[i])]})
        return {"valid": not bad, "reads-checked": len(reads),
                "errors": bad[:32], "error-count": len(bad)}


def counter() -> CounterChecker:
    return CounterChecker()


@dataclass
class QueueChecker(Checker):
    """Queue dequeues must come from somewhere: no value dequeued more times
    than it was enqueue-attempted (upstream ``jepsen.checker/queue``)."""
    name = "queue"

    def check(self, test, history, opts=None):
        enq = _Counter()
        deq = _Counter()
        for op in history:
            if op.f == "enqueue" and op.type == INVOKE:
                enq[hashable(op.value)] += 1
            elif op.f == "dequeue" and op.type == OK:
                deq[hashable(op.value)] += 1
        overdrawn = {v: c - enq[v] for v, c in deq.items() if c > enq[v]}
        return {"valid": not overdrawn,
                "dequeued-count": sum(deq.values()),
                "overdrawn": dict(sorted(overdrawn.items(),
                                         key=lambda kv: repr(kv[0]))[:32])}


def queue() -> QueueChecker:
    return QueueChecker()


@dataclass
class TotalQueueChecker(Checker):
    """Every acknowledged enqueue is dequeued exactly once; nothing is
    dequeued that was never enqueued (upstream
    ``jepsen.checker/total-queue``)."""
    name = "total-queue"

    def check(self, test, history, opts=None):
        attempts = _Counter()
        acked = _Counter()
        deq = _Counter()
        for op in history:
            if op.f == "enqueue" and op.type == INVOKE:
                attempts[hashable(op.value)] += 1
            elif op.f == "enqueue" and op.type == OK:
                acked[hashable(op.value)] += 1
            elif op.f == "dequeue" and op.type == OK:
                deq[hashable(op.value)] += 1
        lost = {v: c - deq[v] for v, c in acked.items() if c > deq[v]}
        unexpected = {v: c for v, c in deq.items() if v not in attempts}
        duplicated = {v: c - attempts[v] for v, c in deq.items()
                      if v in attempts and c > attempts[v]}
        recovered = {v: c for v, c in deq.items()
                     if v in attempts and v not in acked}
        return {
            "valid": not lost and not unexpected,
            "attempt-count": sum(attempts.values()),
            "acknowledged-count": sum(acked.values()),
            "ok-count": sum((deq & acked).values()),
            "lost-count": sum(lost.values()),
            "lost": dict(list(lost.items())[:32]),
            "unexpected-count": sum(unexpected.values()),
            "unexpected": dict(list(unexpected.items())[:32]),
            "duplicated-count": sum(duplicated.values()),
            "recovered-count": sum(recovered.values()),
        }


def total_queue() -> TotalQueueChecker:
    return TotalQueueChecker()


@dataclass
class StatsChecker(Checker):
    """Op counts by function and completion type (later-era
    ``jepsen.checker/stats``); valid unless some function had zero
    successes."""
    name = "stats"

    def check(self, test, history, opts=None):
        by_f: Dict[Any, _Counter] = {}
        for op in history:
            if op.type == INVOKE or op.process == "nemesis":
                continue
            by_f.setdefault(op.f, _Counter())[op.type] += 1
        out = {}
        valid = True
        for f, c in sorted(by_f.items(), key=lambda kv: repr(kv[0])):
            n_ok, n_fail, n_info = c[OK], c[FAIL], c[INFO]
            ok_frac = n_ok / max(1, n_ok + n_fail + n_info)
            f_valid = n_ok > 0
            valid = valid and f_valid
            out[f] = {"valid": f_valid, "count": n_ok + n_fail + n_info,
                      "ok-count": n_ok, "fail-count": n_fail,
                      "info-count": n_info, "ok-fraction": round(ok_frac, 4)}
        return {"valid": valid if out else True, "by-f": out}


def stats() -> StatsChecker:
    return StatsChecker()

"""The check daemon's host pieces against the reference's, on the CPU:
the coalescer (``plan_admission``, ``AdmissionQueue``), the recovery
policy (``RetryPolicy``, ``bisect``, ``CircuitBreaker``), the fault
grammar, ``CheckRequest.to_json``, the ``obs`` histograms and their
Prometheus text, ``parse_check_body``; and the port's own: the device
fault predicate, the readiness probes and operand cache, the dispatch
core's window, and the staged batch (``reach.StagedMany``) against
``check_many``. The same inputs go through both packages; every
comparison is exact.
"""
import json
import time
import types

import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as models_ref
from jepsen_tpu import obs as obs_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.serve import coalesce as co_ref
from jepsen_tpu.serve import faults as faults_ref
from jepsen_tpu.serve import http as http_ref
from jepsen_tpu.serve import recovery as rec_ref
from jepsen_tpu.serve import request as rq_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as models_pt
from jepsen_tpu_torch import obs as obs_pt
from jepsen_tpu_torch.checkers import dispatch_core, facade
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import transfer
from jepsen_tpu_torch.serve import coalesce as co_pt
from jepsen_tpu_torch.serve import faults as faults_pt
from jepsen_tpu_torch.serve import http as http_pt
from jepsen_tpu_torch.serve import recovery as rec_pt
from jepsen_tpu_torch.serve import request as rq_pt

torch.set_num_threads(1)

VERDICT = ("valid", "op", "dead-event", "max-linearized", "final-configs",
           "previous-ok")


@pytest.fixture(autouse=True)
def _reset_faults():
    faults_ref.reset()
    faults_pt.reset()
    yield
    faults_ref.reset()
    faults_pt.reset()


def _reqs(rq, models, specs):
    """CheckRequests for the scheduling units: ``specs`` of ``(n_ops,
    tenant, t_submit, model_name, opts)``; the packed history is a stub
    with its length alone (the coalescer reads nothing more)."""
    out = []
    for i, (n, tenant, t, model, opts) in enumerate(specs):
        r = rq.CheckRequest(
            id=f"r{i}", tenant=tenant, model_name=model,
            model=getattr(models, model.replace("-", "_"))(),
            packed=types.SimpleNamespace(n=n), history=[], n_ops=n,
            opts=dict(opts))
        r.t_submit = t
        out.append(r)
    return out


def _specs(seed, n=40, model="cas-register"):
    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    return [(int(rng.integers(1_100, 40_000)), f"t{int(rng.integers(0, 5))}",
             t0 + float(rng.random()), model, {}) for _ in range(n)]


# -- the coalescer ------------------------------------------------------------

@pytest.mark.parametrize("seed,group", [(0, 32), (1, 8), (2, 4)])
def test_plan_admission_equals_reference(seed, group):
    """Lengths past both packers' floor buckets (the reference's is its
    adaptive block, at most 1,024; the port's ``LOCK_BLOCK``): the same
    groups, in the same order, tenants oldest first."""
    specs = _specs(seed)
    ref = co_ref.plan_admission(_reqs(rq_ref, models_ref, specs),
                                group=group)
    pt = co_pt.plan_admission(_reqs(rq_pt, models_pt, specs), group=group)
    assert pt == ref
    assert sorted(i for g in pt for i in g) == list(range(len(specs)))


def _drive_queue(co, rq, models, specs, cap, group):
    """Submit ``specs`` past a bound of 12 and take groups until the
    queue is empty, releasing each after the next selection: the ids of
    each group, the rejected ids and the in-flight views."""
    q = co.AdmissionQueue(max_depth=12, max_inflight_per_tenant=cap,
                          group=group)
    rejected = []
    for r in _reqs(rq, models, specs):
        try:
            q.submit(r)
        except co.Backpressure:
            rejected.append(r.id)
    trace, held = [], []
    while q.depth() or held:
        batch = q.next_batch(timeout=0.01)
        trace.append(([r.id for r in batch], q.inflight()))
        if held:
            q.mark_done(held.pop(0))
        if batch:
            held.append(batch)
    return trace, rejected


@pytest.mark.parametrize("cap,group", [(1, 8), (3, 4), (8, 32)])
def test_admission_queue_equals_reference(cap, group):
    """Oldest-tenant-first selection, the per-tenant in-flight cap, the
    model signature (one model and one option set a group) and
    backpressure at the bound, step by step as the reference's."""
    t0 = time.monotonic()
    specs = [(2_000 + 500 * i, f"t{i % 3}", t0 + 0.01 * i,
              "mutex" if i % 5 == 0 else "cas-register",
              {"max_states": 500} if i % 7 == 3 else {})
             for i in range(15)]
    ref = _drive_queue(co_ref, rq_ref, models_ref, specs, cap, group)
    pt = _drive_queue(co_pt, rq_pt, models_pt, specs, cap, group)
    assert pt == ref
    assert len(pt[1]) == 3


def test_queued_deadline_and_cancel_equal_reference():
    out = []
    for co, rq, models in ((co_ref, rq_ref, models_ref),
                           (co_pt, rq_pt, models_pt)):
        q = co.AdmissionQueue(max_depth=8)
        timed_out = []
        q.on_timeout = timed_out.append
        dead, live, gone = _reqs(rq, models, [
            (2000, "late", time.monotonic(), "cas-register", {}),
            (2000, "ok", time.monotonic(), "cas-register", {}),
            (2000, "x", time.monotonic(), "cas-register", {})])
        dead.deadline = time.monotonic() - 0.01
        for r in (dead, live, gone):
            q.submit(r)
        assert q.cancel(gone.id) is gone and q.cancel("nope") is None
        with (obs_ref if co is co_ref else obs_pt).capture() as cap:
            batch = q.next_batch(timeout=1.0)
        out.append(([r.id for r in batch], [r.id for r in timed_out],
                    cap.counters.get("serve.timeout"),
                    [f["stage"] for f in cap.fallbacks()]))
    assert out[1] == out[0] == (["r1"], ["r0"], 1, ["serve-timeout"])


def test_lane_placement_equals_reference():
    """Three lanes: each group lands on the least-loaded lane from the
    round-robin pointer, as the reference's; a busy lane's group is
    staged for it."""
    out = []
    for co, rq, models in ((co_ref, rq_ref, models_ref),
                           (co_pt, rq_pt, models_pt)):
        q = co.AdmissionQueue(max_depth=64, group=2, lanes=3)
        t0 = time.monotonic()
        for r in _reqs(rq, models, [(1_100 * (1 + i % 4), f"t{i}",
                                     t0 + i, "cas-register", {})
                                    for i in range(10)]):
            q.submit(r)
        got = []
        for lane in (0, 0, 1, 2, 1, 0):
            b = q.next_batch(timeout=0.01, lane=lane)
            got.append(([r.id for r in b], [r.lane for r in b],
                        q.lane_loads()))
        out.append(got)
    assert out[1] == out[0]


# -- recovery -----------------------------------------------------------------

def test_retry_policy_and_bisect_equal_reference():
    for kw in ({}, {"max_retries": 3, "base_s": 0.01, "factor": 3.0,
                    "cap_s": 0.5, "max_requeues": 4}):
        ref, pt = rec_ref.RetryPolicy(**kw), rec_pt.RetryPolicy(**kw)
        assert [pt.delay(a) for a in range(-1, 12)] == \
            [ref.delay(a) for a in range(-1, 12)]
        assert pt.to_json() == ref.to_json()
    for n in range(2, 12):
        batch = list(range(n))
        assert rec_pt.bisect(batch) == rec_ref.bisect(batch)


def _breaker_run(rec, obs):
    """One event sequence through a breaker with a 20 ms cooldown: the
    route after each event, and the transitions it recorded."""
    with obs.capture() as cap:
        b = rec.CircuitBreaker(threshold=2, cooldown_s=0.02)
        seq = []
        for ev in ("f", "s", "f", "f", "r", "f", "wait", "r", "f", "r",
                   "wait", "r", "s", "r", "f", "f", "wait", "r", "s"):
            if ev == "f":
                b.record_failure()
            elif ev == "s":
                b.record_success()
            elif ev == "wait":
                time.sleep(0.03)
            else:
                seq.append(b.route())
            seq.append((b.state, b.degraded))
        trans = [(r["cause"], r["consecutive"])
                 for r in cap.ledger if r["stage"] == "serve-breaker"]
        counts = {k: v for k, v in cap.counters.items()
                  if k.startswith("serve.breaker")}
    return seq, trans, counts


def test_breaker_sequences_equal_reference():
    ref, pt = _breaker_run(rec_ref, obs_ref), _breaker_run(rec_pt, obs_pt)
    assert pt == ref
    assert [c for c, _n in pt[1]] == ["open", "half-open", "open",
                                      "half-open", "closed", "open",
                                      "half-open", "closed"]


def test_device_fault_predicate():
    """The one predicate that keeps the ladder off the card's faults:
    the kernel wrappers' launch failures, any CUDA error, the card's
    accelerator and memory errors. Not: injected faults and capacity
    declines (the ladder's), or other errors."""
    from jepsen_tpu_torch.checkers.events import ConcurrencyOverflow
    from jepsen_tpu_torch.models.memo import StateExplosion
    device = [RuntimeError("batch_walk kernel launch failed: CUDA error 701"),
              RuntimeError("txn square_step kernel launch failed: CUDA "
                           "error 2"),
              RuntimeError("CUDA error: an illegal memory access was "
                           "encountered"),
              torch.AcceleratorError("CUDA error: unspecified launch "
                                     "failure"),
              torch.OutOfMemoryError("CUDA out of memory")]
    ladder = [faults_pt.InjectedFault("injected"),
              reach_pt.DenseOverflow("big"), StateExplosion("big"),
              ConcurrencyOverflow("wide")]
    other = [ValueError("batch_walk: inconsistent shapes"),
             KeyError("x"), RuntimeError("nvcc failed to build x.cu")]
    assert all(rec_pt.is_device_fault(e) for e in device)
    assert not any(rec_pt.is_device_fault(e) for e in ladder + other)
    assert all(rec_pt.ladder_takes(e) for e in ladder)
    assert not any(rec_pt.ladder_takes(e) for e in device + other)


# -- the fault grammar ----------------------------------------------------------

SPEC = "dispatch@3;device@2x3;persist@1;clock-jump@4:3600;poison=tenant-x"


def _fire_trace(faults, arm):
    arm()
    out = []
    for i in range(8):
        for point, tenants in (("tick", None), ("dispatch", ["a"]),
                               ("dispatch", ["tenant-x", "b"]),
                               ("device", ["a"]), ("persist", ["a"])):
            try:
                faults.fire(point, tenants=tenants)
                out.append((i, point, None))
            except faults.InjectedFault as e:
                out.append((i, point, str(e)))
        out.append(("skew", faults.clock_skew()))
    return out, faults.fired_counts()


def test_fault_grammar_equals_reference(monkeypatch):
    """``arm_spec`` (``Daemon(faults=)``, ``--faults``) arms what the
    reference's environment variable arms: the same raises on the same
    invocations, the same clock jump, the same counts."""
    monkeypatch.setenv("JEPSEN_TPU_SERVE_FAULTS", SPEC)
    ref = _fire_trace(faults_ref, lambda: faults_ref.arm_from_env(force=True))
    pt = _fire_trace(faults_pt, lambda: faults_pt.arm_spec(SPEC))
    assert pt == ref
    assert faults_pt.enabled()
    with pytest.raises(ValueError):
        faults_pt.arm_spec("dispatch@x")


# -- requests -------------------------------------------------------------------

def test_check_request_to_json_equals_reference():
    """Queued, dispatched and terminal: the same keys and values (times
    and the trace aside), in both packages' registries."""
    out = []
    for rq, models in ((rq_ref, models_ref), (rq_pt, models_pt)):
        reg = rq.Registry(keep_done=2, max_tenants=2)
        r1, r2, r3 = _reqs(rq, models, [
            (64, "a", 1.0, "cas-register", {}),
            (64, "b", 2.0, "cas-register", {"max_states": 9}),
            (64, "c", 3.0, "mutex", {})])
        views = []
        for r in (r1, r2, r3):
            reg.add(r)
            views.append(sorted(r.to_json()))
            reg.ledger_record(r.tenant, "admitted", id=r.id)
        r1.t_coalesce = r1.t_submit + 0.1
        r1.t_dispatch = r1.t_submit + 0.2
        r1.t_collect = r1.t_submit + 0.3
        r1.device_s, r1.lane = 0.25, 0
        r1.stitch([{"stage": "s", "event": "e"}] * 70)
        reg.finish(r1, rq.DONE, {"valid": True})
        reg.finish(r1, rq.TIMEOUT)
        reg.finish(r2, rq.CANCELLED, {"valid": "unknown"})
        reg.finish(r3, rq.QUARANTINED, {"valid": "unknown"})
        j = r1.to_json()
        views.append(sorted(j))
        views.append([w["stage"] for w in j["waterfall"]])
        views.append((r1.status, len(r1.trace), r1.packed, r1.history,
                      r1.model_sig[0], r2.model_sig[2]))
        views.append((reg.get("r0"), sorted(reg.stats()["requests"].items()),
                      sorted(reg.stats()["tenants"])))
        out.append(views)
    assert out[1] == out[0]


# -- obs histograms and the exposition -------------------------------------------

def _observe(obs):
    r = obs.Recorder()
    rng = np.random.default_rng(3)
    vals = list(np.exp(rng.uniform(np.log(1e-7), np.log(5e3), 400)))
    vals += [obs.HIST_EDGES[40], obs.HIST_EDGES[40] * 1.0001, 0.0]
    for v in vals:
        r.observe("serve.e2e_s", float(v))
    for v in vals[:100]:
        r.observe("serve.queue_wait_s", float(v))
    r.count("serve.completed", 7)
    r.count("serve.tenant.we ird/name.done", 2)
    r.count("a-b", 1)
    r.count("a.b", 2)                       # sanitises onto a-b's name
    r.gauge("serve.queue_depth", 3)
    r.gauge("transfer.mode", {"packed": True})
    return r


def test_histograms_equal_reference():
    ref, pt = _observe(obs_ref).snapshot(), _observe(obs_pt).snapshot()
    assert obs_pt.HIST_EDGES == obs_ref.HIST_EDGES
    assert pt["histograms"] == ref["histograms"]
    h, w = pt["histograms"]["serve.e2e_s"], pt["histograms"]["serve.queue_wait_s"]
    hr = ref["histograms"]["serve.e2e_s"]
    wr = ref["histograms"]["serve.queue_wait_s"]
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert obs_pt.hist_quantile(h, q) == obs_ref.hist_quantile(hr, q)
    assert obs_pt.hist_summary(h) == obs_ref.hist_summary(hr)
    assert obs_pt.hist_merge(h, w) == obs_ref.hist_merge(hr, wr)
    assert obs_pt.hist_delta(h, w) == obs_ref.hist_delta(hr, wr)
    assert obs_pt.hist_delta(None, w) == obs_ref.hist_delta(None, wr)
    assert obs_pt.hist_summary(None) == {"count": 0}
    with obs_pt.capture() as cap:
        obs_pt.histogram("test.h", 123.0)
    assert cap.histograms["test.h"]["count"] == 1
    assert obs_pt.histograms()["test.h"]["count"] >= 1


def test_prometheus_text_equals_reference():
    ref = obs_ref.prometheus_text(_observe(obs_ref))
    pt = obs_pt.prometheus_text(_observe(obs_pt))
    assert pt == ref
    parsed = obs_pt.parse_prometheus(pt)
    assert parsed == obs_ref.parse_prometheus(ref)
    assert not any("serve_tenant" in k for k in parsed)
    assert parsed["jepsen_obs_prom_collisions"][0][1] == 1
    pairs = [(float(lab["le"]), v)
             for lab, v in parsed["jepsen_serve_e2e_s_bucket"]]
    for q in (0.1, 0.5, 0.99):
        assert obs_pt.quantile_from_cumulative(pairs, q) == \
            obs_ref.quantile_from_cumulative(pairs, q)
    with pytest.raises(ValueError):
        obs_pt.parse_prometheus("this is not { exposition\n")


# -- parse_check_body -------------------------------------------------------------

def _hist_dicts():
    return [op.to_dict() for op in
            fx_ref.gen_history("cas", n_ops=12, processes=2, seed=3)]


BODIES = [
    ("application/json", json.dumps({"model": "cas-register",
                                     "history": _hist_dicts(),
                                     "tenant": "t" * 80, "timeout-s": 3,
                                     "idempotency-key": "k" * 200,
                                     "options": {"max_states": 9,
                                                 "devices": "x"}})),
    ("application/json", json.dumps({"history": _hist_dicts(),
                                     "timeout_s": 1.5,
                                     "idempotency_key": 7})),
    ("application/json", json.dumps({"model": "txn-list-append",
                                     "history": _hist_dicts(),
                                     "options": {"consistency":
                                                 ["serializable", "si"]}})),
    ("application/edn",
     '{:model "cas-register" :tenant "e" :history [{:process 0 :type '
     ':invoke :f :write :value 1} {:process 0 :type :ok :f :write '
     ':value 1}]}'),
    ("application/json", json.dumps({"model": "cas-register",
                                     "history": []})),
    ("application/json", json.dumps({"history": "not-a-list"})),
    ("application/json", json.dumps([1, 2])),
    ("application/json", "{not json"),
    ("application/edn", "{:history [] }"),
    ("application/edn", "{:a 1} {:b 2}"),
    ("application/json", json.dumps({"history": _hist_dicts(),
                                     "timeout-s": -1})),
    ("application/json", json.dumps({"history": _hist_dicts(),
                                     "options": {"consistency": "nope"}})),
]


@pytest.mark.parametrize("ctype,body", BODIES)
def test_parse_check_body_equals_reference(ctype, body):
    def parse(mod):
        try:
            t, m, ops, o, ts, k = mod.parse_check_body(
                body.encode(), ctype, default_tenant="hdr")
        except Exception as e:                          # noqa: BLE001
            return ("rejected", isinstance(e, ValueError))
        return t, m, [op.to_dict() for op in ops], o, ts, k
    ref = parse(http_ref)
    assert parse(http_pt) == ref


# -- transfer and the dispatch core -------------------------------------------------

def test_readiness_probes_and_operand_cache():
    """The readiness probe, and the batch's one copy of P: every group
    the scheduler stages reads the same tensor, and the state is ready
    on the CPU, where the walks have run when they are called."""
    class _Ev:
        def __init__(self, done):
            self.done = done

        def query(self):
            return self.done

    assert transfer.device_ready(None)
    assert transfer.device_ready(torch.zeros(3))
    assert transfer.device_ready(_Ev(True))
    assert not transfer.device_ready(_Ev(False))
    from jepsen_tpu_torch.checkers import reach_batch as rb_pt
    rng = np.random.default_rng(0)
    S, M, O1 = 4, 4, 3
    P = (rng.random((O1, S, S)) < 0.4).astype(np.float32)
    P[0] = 0.0
    st = dispatch_core.DispatchState(np.full(4, -1, np.int64), "cpu", P)
    for g in ([0, 1], [2, 3]):
        rets = [rng.integers(0, 2, 6).astype(np.int32) for _ in g]
        ops = [rng.integers(1, O1, (6, 2)).astype(np.int32) for _ in g]
        st.stage(g, rb_pt.prepare_returns_batch(P, rets, ops, M))
    assert all(fl.args[0] is st.P_dev for _g, fl in st.inflight)
    assert st.ready()
    st.collect(0)
    assert not st.inflight and st.dead.shape == (4,)


def test_pipeline_k_and_rescue_once():
    assert dispatch_core.pipeline_k() == dispatch_core.SERVE_PIPE_K == 4
    assert [dispatch_core.pipeline_k(k) for k in (1, 2, 0, -3)] == \
        [1, 2, 1, 1]
    with obs_pt.capture() as cap:
        assert dispatch_core.rescue_once("s", "c", lambda: 7, id=1) == 7
        with pytest.raises(KeyError):
            dispatch_core.rescue_once("s", "c", lambda: {}["x"])
    assert [(f["stage"], f["cause"], f.get("id")) for f in cap.fallbacks()] \
        == [("s", "c", 1)]


# -- the staged batch ----------------------------------------------------------------

def _packed_both(n_keys, n_ops, bad, kind="cas", values=5):
    out = []
    for fx, h in ((fx_ref, h_ref), (fx_pt, h_pt)):
        ps = []
        for k in range(n_keys):
            hk = fx.gen_history(kind, n_ops=n_ops + 37 * k, processes=5,
                                seed=40 + k, values=values)
            ps.append(h.pack(fx.corrupt(hk, seed=k) if k in bad else hk))
        out.append(ps)
    return out


def _verdict(r):
    return {k: json.dumps(r.get(k), sort_keys=True, default=str)
            for k in VERDICT}


def test_staged_batch_equals_check_many(monkeypatch):
    """``stage_check_many`` then ``collect()`` gives ``check_many``'s
    results on the lockstep lane, and the reference's verdicts; its
    readiness reads the groups' events (none on the CPU: ready)."""
    for r in (reach_ref, reach_pt):      # no seeds, none left over
        monkeypatch.setattr(r, "_seed_union_memo", lambda *a: None)
        r._SUPERSET_SEEDS.clear()
    reach_ref._MEMO_CACHE.clear()
    reach_pt._MEMO_CACHE.clear()
    ref_ps, pt_ps = _packed_both(6, 150, bad={1, 4})
    model = models_pt.cas_register()
    staged = facade.stage_check_many_packed(model, pt_ps, {"device": "cpu"})
    assert isinstance(staged, reach_pt.StagedMany) and staged.ready()
    assert len(staged.st.inflight) >= 1
    with obs_pt.capture() as cap:
        got = staged.collect()
    assert [r["cause"] for r in cap.ledger
            if r["stage"] == "reach-many"] == ["lockstep"]
    want = reach_pt.check_many(model, pt_ps, device="cpu")
    strip = lambda r: {k: v for k, v in r.items() if k != "time-s"}  # noqa
    assert [strip(r) for r in got] == [strip(r) for r in want]
    assert [r["engine"] for r in got] == ["reach-lockstep"] * 6
    ref = reach_ref.check_many(models_ref.cas_register(), ref_ps)
    assert [_verdict(r) for r in got] == [_verdict(r) for r in ref]
    assert [r["valid"] for r in got] == [True, False, True, True, False,
                                         True]


def test_staged_batch_declines_where_the_lane_does():
    """None where ``check_many`` would not take the lockstep lane: one
    live history, a union over K2's 32 states (the wide cas alphabet),
    an abort hook that has fired."""
    _ref, one = _packed_both(1, 120, bad=())
    _ref, wide = _packed_both(3, 120, bad=(), values=40)
    _ref, two = _packed_both(2, 120, bad=())
    model = models_pt.cas_register()
    assert reach_pt.stage_check_many(model, one, device="cpu") is None
    assert reach_pt.stage_check_many(model, wide, device="cpu") is None
    assert reach_pt.stage_check_many(model, two, device="cpu",
                                     should_abort=lambda: True) is None
    assert reach_pt.stage_check_many(model, two, device="cpu") is not None

"""The check daemon as a whole, on the CPU: four tenants POST the same
histories concurrently to the port's ``Daemon(device="cpu")`` — cas
histories of 200-420 ops (a quarter corrupted), the ``data/*.edn``
fixtures, a multi-register history and a list-append history — and
every ``GET /check/<id>`` equals the JAX facade's result for the
history on the CPU (``valid``, the failing op, the dead event and
return, ``final-configs``, ``previous-ok``; the txn fields for the
list-append one) and the port's own standalone facade's. Once with the
staged window (``pipeline_k=4``: ``pipeline.staged`` > 0) and once
without (``pipeline_k=1``: no group staged), with the same verdicts.
"""
import glob
import json
import os
import threading
import urllib.error
import urllib.request

import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as models_ref
from jepsen_tpu.checkers import facade as facade_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as models_pt
from jepsen_tpu_torch import edn, obs, serve
from jepsen_tpu_torch.checkers import facade as facade_pt
from jepsen_tpu_torch.checkers import reach as reach_pt

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
VERDICT = ("valid", "op", "dead-event", "max-linearized", "final-configs",
           "previous-ok")
TXN = ("valid", "anomaly", "anomalies", "witness", "edges", "edge-counts",
       "txns")
N_CAS = 12


def _model_of(name):
    for prefix, model in (("multi-register", "multi-register"),
                          ("mutex", "mutex"), ("register", "register")):
        if name.startswith(prefix):
            return model
    return "cas-register"


def _requests(fx, h):
    """(model name, history) of every request, the same in both
    packages."""
    out = []
    for s in range(N_CAS):
        hs = fx.gen_history("cas", n_ops=200 + 20 * s, processes=5, seed=s)
        out.append(("cas-register", fx.corrupt(hs, seed=s) if s % 4 == 1
                    else hs))
    for path in sorted(glob.glob(os.path.join(DATA, "*.edn"))):
        name = os.path.basename(path)[:-4]
        out.append((_model_of(name), h.load_edn(path)))
    out.append(("multi-register", fx.gen_history(
        "multi", n_ops=300, processes=4, keys=2, values=3, seed=5)))
    txns = fx.gen_txn_history(60, keys=3, seed=1)
    txns += [o.with_(index=-1) for o in fx.txn_anomaly_block("G-single")]
    out.append(("txn-list-append", h.index(txns)))
    return out


def _norm(res, fields):
    out = {}
    for k in fields:
        v = res.get(k)
        if k == "final-configs" and v is not None:
            v = sorted(json.dumps(c, sort_keys=True, default=str) for c in v)
        out[k] = json.dumps(v, sort_keys=True, default=str)
    return out


def _checks(facade, models, h, reqs, dev_kw):
    """Each request's result: the generated cas histories through
    ``auto_check_many_packed`` at once, the rest one by one."""
    cas = models.cas_register()
    out = [_norm(r, VERDICT) for r in facade.auto_check_many_packed(
        cas, [h.pack(hist) for _m, hist in reqs[:N_CAS]], dict(dev_kw))]
    for model, history in reqs[N_CAS:]:
        if model == "txn-list-append":
            out.append(_norm(facade.auto_check_txn(history, dict(dev_kw)),
                             TXN))
            continue
        m = getattr(models, model.replace("-", "_"))()
        out.append(_norm(facade.auto_check_packed(m, h.pack(history),
                                                  dict(dev_kw)), VERDICT))
    return out


@pytest.fixture(scope="module")
def expected():
    """Each request's result from the JAX facade on the CPU, and from
    the port's standalone facade."""
    mp = pytest.MonkeyPatch()
    for r in (reach_ref, reach_pt):      # no seeds, none left over
        mp.setattr(r, "_seed_union_memo", lambda *a: None)
        r._SUPERSET_SEEDS.clear()
    reach_ref._MEMO_CACHE.clear()
    reach_pt._MEMO_CACHE.clear()
    try:
        ref = _checks(facade_ref, models_ref, h_ref,
                      _requests(fx_ref, h_ref), {})
        pt = _checks(facade_pt, models_pt, h_pt, _requests(fx_pt, h_pt),
                     {"device": "cpu"})
    finally:
        mp.undo()
    return ref, pt


def _post(url, payload):
    """JSON, or EDN for multi-register histories: their values are maps
    with integer keys, which JSON would turn into strings."""
    if payload["model"] == "multi-register":
        data, ctype = edn.dumps(payload).encode(), "application/edn"
    else:
        data, ctype = json.dumps(payload).encode(), "application/json"
    req = urllib.request.Request(url + "/check", data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("k", [4, 1])
def test_daemon_verdicts_equal_reference(k, expected, tmp_path):
    ref, pt = expected
    reqs = _requests(fx_pt, h_pt)
    d = serve.Daemon(port=0, store_root=str(tmp_path), device="cpu",
                     pipeline_k=k, persist=True)
    d.start(dispatch=False)
    url = f"http://127.0.0.1:{d.port}"
    ids = [None] * len(reqs)

    def tenant(t):
        for i in range(t, len(reqs), 4):
            model, hist = reqs[i]
            ids[i] = _post(url, {"model": model, "tenant": f"tenant-{t}",
                                 "history": [o.to_dict() for o in hist]})["id"]

    try:
        threads = [threading.Thread(target=tenant, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert all(ids)
        c0 = obs.counters()
        d.dispatcher.start()
        assert d.dispatcher.drain(240)
        got = []
        for i, rid in enumerate(ids):
            code, st = _get(url, f"/check/{rid}")
            assert code == 200 and st["status"] == "done", st
            assert not st["result"].get("degraded")
            got.append(_norm(st["result"], TXN if reqs[i][0]
                             == "txn-list-append" else VERDICT))
            assert st["run-dir"] and os.path.isdir(st["run-dir"])
        for i in range(len(reqs)):
            assert got[i] == ref[i] == pt[i], (i, reqs[i][0])
        assert [json.loads(g["valid"]) for g in got].count(False) >= 7
        c1 = obs.counters()
        staged = c1.get("pipeline.staged", 0) - c0.get("pipeline.staged", 0)
        assert (staged > 0) if k > 1 else (staged == 0)
        for key in ("serve.retry.attempts", "serve.device_faults",
                    "serve.breaker.degraded_dispatches"):
            assert c1.get(key, 0) == c0.get(key, 0), key
        st = d.stats()
        assert sum(st["dispatch"].values()) < len(reqs)   # coalesced
        assert {f"tenant-{t}" for t in range(4)} <= set(st["tenants"])
        wall = sum(h["sum"] for n, h in obs.histograms().items()
                   if n == "serve.dispatch_wall_s")
        assert wall > 0 and st["counters"]["serve.pad_waste_s"] == 0
    finally:
        d.shutdown(drain_timeout=30)


@pytest.mark.parametrize("corrupt", [None, 11])
def test_daemon_singleton_takes_chunklock(monkeypatch, corrupt, tmp_path):
    """A long singleton goes to chunk-lockstep from inside the daemon,
    whose checks carry an abort hook (here the walk's threshold is
    lowered to a small history's returns): the verdict and witness equal
    the JAX facade's."""
    from jepsen_tpu_torch.checkers import reach_chunklock as cl_pt

    monkeypatch.setattr(cl_pt, "MIN_RETURNS", 16)
    hs = [fx.gen_history("cas", n_ops=120, processes=4, seed=11)
          for fx in (fx_ref, fx_pt)]
    if corrupt is not None:
        hs = [fx.corrupt(h, seed=corrupt)
              for fx, h in zip((fx_ref, fx_pt), hs)]
    reach_ref._MEMO_CACHE.clear()
    want = _norm(facade_ref.auto_check_packed(
        models_ref.cas_register(), h_ref.pack(hs[0]), {}), VERDICT)
    d = serve.Daemon(port=0, store_root=str(tmp_path), device="cpu")
    d.start()
    url = f"http://127.0.0.1:{d.port}"
    try:
        rid = _post(url, {"model": "cas-register",
                          "history": [o.to_dict() for o in hs[1]]})["id"]
        assert d.dispatcher.drain(60)
        code, st = _get(url, f"/check/{rid}")
        assert code == 200 and st["status"] == "done", st
        assert st["result"]["engine"] == "reach-chunklock"
        assert _norm(st["result"], VERDICT) == want
    finally:
        d.shutdown(drain_timeout=30)

"""The port's load generator (``python -m jepsen_tpu_torch.tools.loadgen``)
against the reference's ``tools/loadgen.py``, on the CPU: the payload
pools byte for byte with their ground truths, the report's quantile
logic on the same inputs, the chaos-tolerant classification against a
dead port, and self-hosted runs end to end (one-shot cas with sessions,
and the mixed-consistency txn pool) under the tool's own exit rule, each
pool's ground truth equal to the reference facade's verdict."""
import importlib.util
import json
import os
import socket

import numpy as np
import pytest
import torch

from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import facade as fa_ref
from jepsen_tpu.op import Op as Op_ref
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.tools import loadgen as lg_pt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


lg_ref = _load_reference_tool("loadgen")

POOLS = [dict(sizes=[16, 32, 48], tenants=4, violation_frac=0.25, seed=7),
         dict(sizes=[32, 96, 200, 400], tenants=4, violation_frac=0.25,
              seed=7),
         dict(sizes=[20], tenants=3, violation_frac=0.6, seed=11,
              model="register", kinds=("register",))]


@pytest.mark.parametrize("kw", POOLS, ids=["quick", "defaults", "register"])
def test_build_pool_equals_reference(kw):
    got, want = lg_pt.build_pool(**kw), lg_ref.build_pool(**kw)
    assert got == want                  # bodies byte for byte, truths


@pytest.mark.parametrize("seed,sizes", [(7, (8, 16)), (7, (12, 30, 60)),
                                        (3, (12, 30))])
def test_build_txn_pool_equals_reference(seed, sizes):
    got = lg_pt.build_txn_pool(tenants=4, seed=seed, clean_sizes=sizes)
    want = lg_ref.build_txn_pool(tenants=4, seed=seed, clean_sizes=sizes)
    assert got == want


@pytest.mark.parametrize("kw", [
    dict(n_sessions=2, ops_per_session=240, appends=6, violation_frac=0.25),
    dict(n_sessions=4, ops_per_session=2000, appends=12,
         violation_frac=0.25),
    dict(n_sessions=20, ops_per_session=60, appends=5, violation_frac=0.5,
         seed=3, tenants=6)], ids=["quick", "defaults", "many"])
def test_build_session_plans_equals_reference(kw):
    assert lg_pt.build_session_plans(**kw) == \
        lg_ref.build_session_plans(**kw)


def _buckets(rng, n_samples):
    """Cumulative ``(le, count)`` pairs on the daemon's edges."""
    from jepsen_tpu_torch import obs
    xs = rng.lognormal(-2.0, 1.0, n_samples)
    counts = np.searchsorted(np.asarray(obs.HIST_EDGES), xs, side="left")
    edges = list(obs.HIST_EDGES) + [float("inf")]
    per = np.bincount(counts, minlength=len(edges))
    return [(float(le), float(c)) for le, c in zip(edges, np.cumsum(per))]


@pytest.mark.parametrize("seed", range(4))
def test_quantile_logic_equals_reference(seed):
    rng = np.random.default_rng(seed)
    xs = list(rng.exponential(0.2, int(rng.integers(1, 200))))
    for q in (0.0, 0.5, 0.99, 1.0):
        assert lg_pt._percentile(xs, q) == lg_ref._percentile(xs, q)
    assert lg_pt._percentile([], 0.5) == lg_ref._percentile([], 0.5)
    before = _buckets(rng, 50)
    after = [(le, c + d) for (le, c), (_, d) in
             zip(before, _buckets(rng, 300))]
    for lg in ({"p50": 0.13, "p99": 0.9}, {"p50": None, "p99": 2.0},
               {"p50": float(rng.uniform(0.01, 1)),
                "p99": float(rng.uniform(1, 5))}):
        assert lg_pt.crosscheck_quantiles(lg, before, after) == \
            lg_ref.crosscheck_quantiles(lg, before, after)
    assert lg_pt.crosscheck_quantiles({}, None, after) is None
    records = [{"t_submit": float(t), "status": str(s),
                "latency_s": float(lat)}
               for t, s, lat in zip(rng.uniform(0, 10, 60),
                                    rng.choice(["done", "rejected", "lost"],
                                               60),
                                    rng.exponential(0.3, 60))]
    assert lg_pt._window_report(records, 0.0, 5.0, 10.0) == \
        lg_ref._window_report(records, 0.0, 5.0, 10.0)
    names = lg_pt._MUX_COUNTERS
    assert names == lg_ref._MUX_COUNTERS
    b = {k: float(rng.integers(0, 5)) for k in names}
    a = {k: b[k] + float(rng.integers(0, 40)) for k in names}
    for before_c, after_c in ((b, a), (b, {k: None for k in names}),
                              ({k: None for k in names}, a)):
        assert lg_pt._mux_efficiency(before_c, after_c) == \
            lg_ref._mux_efficiency(before_c, after_c)
    for rep, rate in (({"sustained_req_s": 13.9}, 20.0),
                      ({"sustained_req_s": 19.0}, 20.0),
                      ({"sustained_req_s": 5.0, "rejected_429": 3}, 20.0),
                      ({"sustained_req_s": 5.0, "latency_crosscheck":
                        {"p99_gate": "waived-queue-overloaded"}}, 20.0),
                      ({}, 20.0), ({"sustained_req_s": 1.0}, 0.0)):
        r1, r2 = dict(rep), dict(rep)
        lg_pt._flag_saturation(r1, rate)
        lg_ref._flag_saturation(r2, rate)
        assert r1 == r2


def test_chaos_tolerant_classifies_restart_errors():
    """Against a port where nothing listens, ``chaos_tolerant`` retries
    and records ``error-restart`` with a ``recovery`` block; the default
    mode records ``error-net`` and no block (the reference's test)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead_url = f"http://127.0.0.1:{s.getsockname()[1]}"
    s.close()
    pool = [{"tenant": "t", "ops": 4, "expect": True, "body": b"{}"}]
    rep = lg_pt.run_load(dead_url, rate=50.0, duration=0.04, pool=pool,
                         poll_timeout=0.3, chaos_tolerant=True)
    assert rep["submitted"] >= 1 and rep["completed"] == 0
    assert rep["recovery"]["refusals"] >= 1
    assert rep["recovery"]["restart_errors"] >= 1
    assert rep["recovery"]["recovery_to_first_verdict_s"] is None
    rep2 = lg_pt.run_load(dead_url, rate=50.0, duration=0.04, pool=pool,
                          poll_timeout=0.3, chaos_tolerant=False)
    assert "recovery" not in rep2


def _run_main(capsys, *args):
    rc = lg_pt.main(["--self-host", "--quick", "--device", "cpu", *args])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_self_hosted_quick_run_with_sessions(capsys, monkeypatch):
    """``--self-host --quick --sessions --device cpu`` end to end: exit 0
    under the tool's rule (completions, every verdict its ground truth,
    the quantile cross-check held, the sessions' closes right, the tenant
    cap enforced), and each pool entry's ground truth is the reference
    facade's verdict on its body. The process-wide ledger starts empty,
    as a daemon's own process does: the report's ``fallbacks`` read the
    daemon's counters, which other tests of this worker may have
    bumped."""
    monkeypatch.setenv("JEPSEN_TPU_NO_PERSIST", "1")
    obs.reset()
    rc, rep = _run_main(capsys, "--sessions")
    assert rc == 0, rep
    assert rep["completed"] > 0 and rep["verdict_mismatches"] == 0
    assert rep["latency_crosscheck"]["ok"] is True
    assert rep["drained"] is True and rep["fallbacks"] == {}
    assert len(rep["windows"]) == 2
    sess = rep["sessions"]
    assert sess["appends"] > 0 and sess["errors"] == 0
    assert sess["verdict_mismatches"] == 0 and sess["false_alarms"] == 0
    assert sess["tenant_cap_probe"]["enforced"] is True
    for entry in lg_pt.build_pool(sizes=[16, 32, 48], tenants=4,
                                  violation_frac=0.25, seed=7):
        hist = [Op_ref.from_dict(d)
                for d in json.loads(entry["body"])["history"]]
        res = fa_ref.auto_check_packed(m_ref.cas_register(),
                                       h_ref.pack(hist), {})
        assert res["valid"] is entry["expect"]


def test_self_hosted_mixed_consistency(capsys, monkeypatch):
    """``--mixed-consistency``: every level's ``holds`` verdict equals the
    lattice fixture's ground truth (the tool's exit rule)."""
    monkeypatch.setenv("JEPSEN_TPU_NO_PERSIST", "1")
    rc, rep = _run_main(capsys, "--mixed-consistency")
    assert rc == 0, rep
    assert rep["completed"] > 0 and rep["verdict_mismatches"] == 0
    assert set(rep["per_level"]) == {"read-committed", "causal", "pl-2",
                                     "si", "serializable"}


def test_self_host_wants_the_card(monkeypatch):
    """Without ``--device cpu`` the self-hosted daemon wants the card and
    raises when there is none: the tool never runs on the CPU by
    itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        lg_pt.run_loadgen({"quick": True})
    with pytest.raises(RuntimeError, match="CUDA"):
        lg_pt.main(["--self-host", "--quick"])

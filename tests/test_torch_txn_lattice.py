"""The port's consistency lattice (``jepsen_tpu_torch.txn.lattice``)
against the reference's (``jepsen_tpu.txn.lattice``), on the CPU.

The crafted fixtures with their documented ground truth (the table of
``tests/test_lattice.py``), the reference's randomized lattice recipe
and the injected serializability blocks go through the reference and
through the port with ``device="cpu"``, for each of the word body (K8's
plain version), the f32 cross-check in its place and the host
reference. The tolerance is
exact equality of every field but the wall time ``check-s``.
"""
import random

import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import obs as obs_ref
from jepsen_tpu import txn as txn_ref
from jepsen_tpu.txn import infer as inf_ref
from jepsen_tpu.txn import lattice as lat_ref
from jepsen_tpu.txn import ops as ops_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import obs as obs_pt
from jepsen_tpu_torch import txn as txn_pt
from jepsen_tpu_torch.txn import cycles as cyc_pt
from jepsen_tpu_torch.txn import lattice as lat_pt
from jepsen_tpu_torch.txn import ops as ops_pt

torch.set_num_threads(1)

ALL_LEVELS = list(lat_ref.LEVELS)
BODIES = ("word", "f32", "host")

# per-fixture ground truth (tests/test_lattice.py's table)
TRUTH = {
    "write-skew": {"read-committed": True, "causal": True,
                   "pl-2": True, "si": False, "serializable": False},
    "lost-update": {lvl: False for lvl in ALL_LEVELS},
    "long-fork": {"read-committed": True, "causal": True,
                  "pl-2": True, "si": False, "serializable": False},
    "session-mr": {"read-committed": True, "causal": True,
                   "pl-2": False, "si": False, "serializable": False},
}
WEAKEST = {"write-skew": "si", "lost-update": "read-committed",
           "long-fork": "si", "session-mr": "pl-2"}


def _block(kind):
    return (h_ref.index([o.with_(index=-1)
                         for o in fx_ref.txn_anomaly_block(kind)]),
            h_pt.index([o.with_(index=-1)
                        for o in fx_pt.txn_anomaly_block(kind)]))


def _strip(res):
    return {k: v for k, v in res.items() if k != "check-s"}


def _records(cap):
    return [{k: v for k, v in r.items() if k != "ts"} for r in cap.ledger]


def _txn_counters(cap):
    return {k: v for k, v in cap.counters.items() if k.startswith("txn.")}


def run_both(monkeypatch, ref_hist, pt_hist, body,
             consistency=ALL_LEVELS, **kw):
    ref_kw = dict(kw, consistency=consistency)
    pt_kw = dict(kw, consistency=consistency, device="cpu")
    if body == "host":
        ref_kw["force_host"] = pt_kw["force_host"] = True
    with obs_ref.capture() as cr:
        ref = txn_ref.check_history(ref_hist, **ref_kw)
    with monkeypatch.context() as m:
        if body == "f32":
            m.setattr(cyc_pt, "_word_booleans", cyc_pt._f32_booleans)
        with obs_pt.capture() as cp:
            pt = txn_pt.check_history(pt_hist, **pt_kw)
    assert _strip(ref) == _strip(pt)
    assert _txn_counters(cr) == _txn_counters(cp)
    assert _records(cr) == _records(cp)
    return pt


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("kind", fx_ref.TXN_LATTICE_KINDS)
def test_fixture_ground_truth(monkeypatch, kind, body):
    ref, pt = _block(kind)
    res = run_both(monkeypatch, ref, pt, body)
    assert res["holds"] == TRUTH[kind]
    assert res["weakest-violated"] == WEAKEST[kind]
    assert res["engine"] == ("txn-lattice-host" if body == "host"
                             else "txn-lattice-mxu")
    for lvl, ok in TRUTH[kind].items():
        d = res["levels"][lvl]
        assert d["holds"] is ok
        if lvl == WEAKEST[kind]:
            assert d["anomalies"] and d.get("witness")
        if ok:
            assert not d["anomalies"]


def _fuzz_cases():
    """The reference's lattice recipe (``tests/test_lattice.py``,
    ``test_lattice_fuzz_differential``: ``random.Random(1717)``)."""
    rng = random.Random(1717)
    out = []
    for t in range(8):
        kw = dict(n_txns=rng.randrange(10, 60), keys=rng.randrange(2, 4),
                  processes=4, seed=rng.randrange(1 << 30))
        kind = rng.choice(fx_ref.TXN_LATTICE_KINDS) if t % 2 else None
        out.append((kw, kind))
    return out


FUZZ = _fuzz_cases()


def _pair(kw, kind=None):
    ref = fx_ref.gen_txn_history(**kw)
    pt = fx_pt.gen_txn_history(**kw)
    if kind is not None:
        ref = ref + [o.with_(index=-1) for o in fx_ref.txn_anomaly_block(kind)]
        pt = pt + [o.with_(index=-1) for o in fx_pt.txn_anomaly_block(kind)]
    return ref, pt


@pytest.mark.parametrize("body", BODIES)
def test_lattice_fuzzed(monkeypatch, body):
    for kw, kind in FUZZ:
        ref, pt = _pair(kw, kind)
        res = run_both(monkeypatch, ref, pt, body)
        if kind is not None:
            assert res["weakest-violated"] == WEAKEST[kind]


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("kind", fx_ref.TXN_ANOMALY_KINDS)
def test_lattice_on_serializability_blocks(monkeypatch, kind, body):
    ref, pt = _pair(dict(n_txns=30, keys=2, seed=5), kind)
    run_both(monkeypatch, ref, pt, body)


@pytest.mark.parametrize("consistency", [
    "causal", "si", ["causal", "si"], "snapshot-isolation", "rc",
    "serializable"])
def test_requested_levels(monkeypatch, consistency):
    ref, pt = _block("write-skew")
    res = run_both(monkeypatch, ref, pt, "word", consistency=consistency)
    assert res["consistency"] == list(lat_ref.canon_levels(consistency))


def _appends(fx, h, *procs):
    """One ``append a 1`` txn a process, each committed."""
    return h.index([op for p in procs for op in (
        fx.invoke(p, "txn", [["append", "a", 1]]),
        fx.ok(p, "txn", [["append", "a", 1]]))])


def test_direct_anomaly_poisons_every_level(monkeypatch):
    for body in BODIES:
        res = run_both(monkeypatch, _appends(fx_ref, h_ref, 0, 1),
                       _appends(fx_pt, h_pt, 0, 1), body)
        assert res["holds"] == {lvl: False for lvl in ALL_LEVELS}
        assert res["engine"] == "txn-infer"


def test_no_edges_and_past_envelope(monkeypatch):
    ref, pt = _pair(dict(n_txns=12, keys=2, seed=3))
    run_both(monkeypatch, ref, pt, "word")
    ref, pt = _block("long-fork")
    res = run_both(monkeypatch, ref, pt, "word", max_dense_txns=2)
    assert res["engine"] == "txn-lattice-host"
    res = run_both(monkeypatch, _appends(fx_ref, h_ref, 0),
                   _appends(fx_pt, h_pt, 0), "word")
    assert res["engine"] == "txn-lattice-noedges"


def test_levels_helpers_equal():
    assert lat_pt.LEVELS == lat_ref.LEVELS
    assert lat_pt.LEVEL_ANOMALIES == lat_ref.LEVEL_ANOMALIES
    for c in ("all", "RC", "pl2", ["si", "causal"], ("serializable",)):
        assert lat_pt.canon_levels(c) == lat_ref.canon_levels(c)
    for bad in ("strict-serializable-ish", [], 3):
        for mod in (lat_ref, lat_pt):
            with pytest.raises(ValueError):
                mod.canon_levels(bad)
    for bits in range(64):
        b = dict(zip(cyc_pt.LATTICE_KEYS,
                     (bool(bits >> i & 1) for i in range(6))))
        for sv in (False, True):
            assert lat_pt.holds_from(b, session_violated=sv) == \
                lat_ref.holds_from(b, session_violated=sv)


@pytest.mark.parametrize("kw,kind", FUZZ)
def test_session_scans_and_cm_equal(kw, kind):
    ref, pt = _pair(kw, kind)
    tr, _ = ops_ref.collect(ref)
    tp, _ = ops_pt.collect(pt)
    assert lat_ref.session_scans(tr) == lat_pt.session_scans(tp)
    starts = np.asarray([t.index for t in tp], np.int64)
    ends = np.asarray([t.end for t in tp], np.int64)
    cm = cyc_pt.commit_mask(starts, ends, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(lat_ref._cm_from(starts, ends), cm)
    np.testing.assert_array_equal(inf_ref.commit_mask(tr), cm)


def test_lattice_fault_raises_with_no_fallback(monkeypatch):
    _ref, pt = _block("write-skew")

    def boom(*a, **k):
        raise RuntimeError("injected lattice failure")

    monkeypatch.setattr(cyc_pt, "lattice_booleans", boom)
    with obs_pt.capture() as cap:
        with pytest.raises(RuntimeError, match="injected"):
            txn_pt.check_history(pt, device="cpu", consistency="all")
    assert cap.fallbacks() == []

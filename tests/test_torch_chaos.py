"""The port's chaos harness (``python -m jepsen_tpu_torch.tools.chaos``)
against the reference's ``tools/chaos.py``, on the CPU: the
known-ground-truth cases are the reference's, and the quick run and the
two-replica fleet run hold every invariant end to end against real
``check-serve --device cpu`` subprocesses."""
import importlib.util
import os

import pytest
import torch

from jepsen_tpu_torch.tools import chaos as ch_pt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_reference_chaos():
    spec = importlib.util.spec_from_file_location(
        "reference_chaos", os.path.join(ROOT, "tools", "chaos.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ch_ref = _load_reference_chaos()


def _plain(cases):
    return [{**c, "ops": [op.to_dict() for op in c["ops"]]} for c in cases]


@pytest.mark.parametrize("kw", [
    dict(seed=7, n=6, sizes=[8, 12], violation_frac=0.3),
    dict(seed=7, n=14, sizes=[8, 12, 16], violation_frac=0.3,
         deadline_frac=0.25),
    dict(seed=1007, n=8, sizes=[10, 14], violation_frac=0.3,
         tenant_prefix="wave2"),
    dict(seed=507, n=1, sizes=[8], violation_frac=0.0,
         tenant_prefix="chaos-poison")],
    ids=["quick", "full", "wave2", "poison"])
def test_build_cases_equal_reference(kw):
    assert _plain(ch_pt.build_cases(**kw)) == _plain(ch_ref.build_cases(**kw))


def test_quick_run_holds_every_invariant(tmp_path):
    """A dispatch fault fires and is retried, the SIGKILL loses no
    acknowledged request, the restart dedups across the journal, the
    session rides the kill, every verdict is its ground truth and the
    in-process facade's, and the journal drains."""
    rep = ch_pt.run_chaos({"quick": True, "device": "cpu",
                           "store_root": str(tmp_path / "store")})
    assert rep["ok"] is True, rep["violations"]
    assert rep["fault_counters"]["serve.fault.dispatch"] >= 1
    assert rep["pre_kill_counters"]["serve.retry.attempts"] >= 1
    assert rep["dedup_across_restart"]["deduped"] is True
    assert rep["session_replayed_appends"] == rep["session_pre_kill_appends"]
    assert rep["session_close"]["valid"] is True
    assert rep["verdict_mismatches"] == 0 and rep["checked_done"] > 0
    assert rep["recovery_to_first_verdict_s"] > 0
    assert rep["final_healthz"]["device"] == "cpu"
    assert rep["final_healthz"]["journal"]["pending"] == 0


def test_fleet_quick_run_holds_every_gate(tmp_path):
    """Two replicas over one store root: the victim's leased work drains
    through the survivor (leases stolen), a duplicate POST to the other
    replica dedups, the victim's session is adopted and closes with the
    facade's verdict, and the survivor ends healthy."""
    rep = ch_pt.run_fleet({"quick": True, "device": "cpu",
                           "store_root": str(tmp_path / "store")})
    assert rep["ok"] is True, rep["violations"]
    assert rep["cross_replica_dedup"]["deduped"] is True
    assert rep["verdict_mismatches"] == 0 and rep["checked_done"] > 0
    if rep["victim_pending_at_kill"]:
        assert rep["leases_stolen"] >= 1
    assert rep["session_close"]["valid"] is True
    assert rep["failover_to_first_verdict_s"] > 0


def test_daemon_that_cannot_start_fails_the_harness(tmp_path):
    """A daemon that exits at start (a device no machine has) is a
    violation at once, never a fallback, and no process is left."""
    rep = ch_pt.run_chaos({"quick": True, "device": "nodevice",
                           "store_root": str(tmp_path / "store")})
    assert rep["violations"] == ["daemon 1 never became ready"]
    assert "ok" not in rep
    log = (tmp_path / "store" / "chaos-daemon.log").read_text()
    assert "nodevice" in log

"""The port's JIT-linearization search (``checkers/linear.py``), its
search control (``checkers/search.py``) and its failure diagram
(``checkers/linear_report.py``) against the reference's, on the CPU.

The search is host work in both packages, so its whole result is
compared: verdict, failing op, config counts, peak set size, final
configs and ``previous-ok``, in both config-set representations, on the
``data/*.edn`` fixtures and on generated cas and register histories
with crashed ops and injected violations; then its budgets (time limit,
config cap, abort hook). The SVG of a failing window must be the
reference's text, character for character.
"""
import os
import time

import pytest

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import linear as lin_ref
from jepsen_tpu.checkers import linear_report as rep_ref
from jepsen_tpu.checkers import search as search_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch.checkers import linear as lin_pt
from jepsen_tpu_torch.checkers import linear_report as rep_pt
from jepsen_tpu_torch.checkers import search as search_pt
from jepsen_tpu_torch.checkers import wgl_native as native_pt

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")

FIXTURES = [
    ("cas-register-ok-small.edn", "cas_register"),
    ("cas-register-ok-large.edn", "cas_register"),
    ("cas-register-bad.edn", "cas_register"),
    ("cas-register-recorded-bad.edn", "cas_register"),
    ("register-ok.edn", "register"),
    ("register-bad.edn", "register"),
    ("mutex-ok.edn", "mutex"),
    ("multi-register-ok.edn", "multi_register"),
    ("multi-register-bad.edn", "multi_register"),
]

# generated histories: (kind, gen_history keywords, corrupted)
GENERATED = [
    ("cas", dict(n_ops=300, processes=4, seed=1), False),
    ("cas", dict(n_ops=300, processes=4, seed=1), True),
    ("cas", dict(n_ops=400, processes=5, seed=2, crash_p=0.01), False),
    ("cas", dict(n_ops=400, processes=5, seed=2, crash_p=0.01), True),
    ("register", dict(n_ops=200, processes=4, seed=3, crash_p=0.02), False),
    ("register", dict(n_ops=200, processes=4, seed=3, crash_p=0.02), True),
    ("mutex", dict(n_ops=200, processes=3, seed=4), False),
]


def _pair(kind, kw, corrupt):
    """The same history in both packages (generated from the seed by
    each package's own fixtures, which must agree)."""
    a = fx_ref.gen_history(kind, **kw)
    b = fx_pt.gen_history(kind, **kw)
    if corrupt:
        a, b = fx_ref.corrupt(a, seed=kw["seed"]), fx_pt.corrupt(b,
                                                                seed=kw["seed"])
    return a, b


@pytest.mark.parametrize("rep", ["auto", "set"])
@pytest.mark.parametrize("fname,model_name", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixtures_whole_result_equal(fname, model_name, rep):
    path = os.path.join(DATA, fname)
    want = lin_ref.check(getattr(m_ref, model_name)(), h_ref.load_edn(path),
                         rep=rep)
    got = lin_pt.check(getattr(m_pt, model_name)(), h_pt.load_edn(path),
                       rep=rep)
    assert got == want


@pytest.mark.parametrize("rep", ["auto", "set"])
@pytest.mark.parametrize("kind,kw,corrupt", GENERATED,
                         ids=[f"{g[0]}-{g[1]['seed']}-{'bad' if g[2] else 'ok'}"
                              for g in GENERATED])
def test_generated_whole_result_equal(kind, kw, corrupt, rep):
    a, b = _pair(kind, kw, corrupt)
    want = lin_ref.check(fx_ref.model_for(kind), a, rep=rep)
    got = lin_pt.check(fx_pt.model_for(kind), b, rep=rep)
    assert got == want
    if corrupt:
        assert got["valid"] is False and got["final-configs"]


@pytest.mark.parametrize("budget", [
    dict(time_limit=0.0), dict(max_configs=3),
    dict(should_abort=lambda: True)], ids=["time", "configs", "abort"])
def test_budgets_give_the_reference_unknown(budget):
    a, b = _pair("cas", dict(n_ops=300, processes=5, seed=6), False)
    want = lin_ref.check(fx_ref.model_for("cas"), a, **budget)
    got = lin_pt.check(fx_pt.model_for("cas"), b, **budget)
    assert got["valid"] == "unknown"
    assert got == want


def test_array_rep_refuses_past_32_slots():
    b = fx_pt.gen_history("register", n_ops=200, processes=40, seed=1)
    with pytest.raises(ValueError, match="32 slots"):
        lin_pt.check(fx_pt.model_for("register"), b, rep="array")
    got = lin_pt.check(fx_pt.model_for("register"), b, max_configs=1000)
    assert got["rep"] == "set"
    assert got == lin_ref.check(
        fx_ref.model_for("register"),
        fx_ref.gen_history("register", n_ops=200, processes=40, seed=1),
        max_configs=1000)


def test_empty_and_unfinished_histories():
    assert lin_pt.check(m_pt.cas_register(), []) == \
        lin_ref.check(m_ref.cas_register(), [])


# -- search control (after tests/test_search_control.py) ---------------------

def test_deadline_aborts():
    with search_pt.SearchControl(time_limit=0.01) as ctl:
        time.sleep(0.03)
        assert ctl.should_abort() is True
        assert ctl.cause == "timeout"


def test_explicit_abort_trips_native_flags():
    class Flag:
        tripped = False

        def abort(self):
            self.tripped = True

    with search_pt.SearchControl() as ctl:
        f = ctl.bind_native(Flag())
        native = ctl.bind_native(native_pt.AbortFlag())
        assert ctl.should_abort() is False
        assert native._flag.value == 0
        ctl.abort("because")
        assert f.tripped is True
        assert native._flag.value == 1
        assert ctl.cause == "because"
        # late-bound flags are tripped immediately
        assert ctl.bind_native(Flag()).tripped is True


def test_memory_watchdog_fires_on_low_threshold():
    free = search_pt.mem_available_bytes()
    ref = search_ref.mem_available_bytes()
    assert (free is None) == (ref is None)
    if free is None:
        return                         # non-Linux: watchdog is inert
    with search_pt.SearchControl(min_free_bytes=free * 4,
                                 watchdog_interval=0.01) as ctl:
        time.sleep(0.1)
        assert ctl.should_abort() is True
        assert ctl.cause == "low-memory"


def test_control_drives_the_search_abort():
    """The search polls the control: an aborted control stops it with
    the reference's ``aborted`` unknown."""
    a, b = _pair("cas", dict(n_ops=300, processes=5, seed=6), False)
    ctl_ref, ctl_pt = search_ref.SearchControl(), search_pt.SearchControl()
    ctl_ref.abort()
    ctl_pt.abort()
    want = lin_ref.check(fx_ref.model_for("cas"), a,
                         should_abort=ctl_ref.should_abort)
    got = lin_pt.check(fx_pt.model_for("cas"), b,
                       should_abort=ctl_pt.should_abort)
    assert got == want and got["cause"] == "aborted"


# -- the failure diagram -----------------------------------------------------

SVG_CASES = [
    ("cas-register-bad.edn", "cas_register"),
    ("cas-register-recorded-bad.edn", "cas_register"),
    ("register-bad.edn", "register"),
    ("multi-register-bad.edn", "multi_register"),
]


@pytest.mark.parametrize("fname,model_name", SVG_CASES,
                         ids=[c[0] for c in SVG_CASES])
def test_svg_equals_reference(fname, model_name, tmp_path):
    path = os.path.join(DATA, fname)
    a, b = h_ref.load_edn(path), h_pt.load_edn(path)
    verdict = lin_pt.check(getattr(m_pt, model_name)(), b)
    assert verdict["valid"] is False
    out = str(tmp_path / "linear.svg")
    svg = rep_pt.render_analysis(b, verdict, out)
    assert svg == rep_ref.render_analysis(a, verdict)
    assert open(out).read() == svg


@pytest.mark.parametrize("kind,kw", [
    ("cas", dict(n_ops=200, processes=4, seed=9, crash_p=0.05)),
    ("register", dict(n_ops=150, processes=4, seed=3, crash_p=0.03))])
def test_svg_generated_with_crashes(kind, kw):
    a, b = _pair(kind, kw, True)
    verdict = lin_pt.check(fx_pt.model_for(kind), b)
    assert verdict["valid"] is False
    assert rep_pt.render_analysis(b, verdict) == \
        rep_ref.render_analysis(a, verdict)
    # an op matched by content when its index is not in the history
    moved = dict(verdict, op=dict(verdict["op"], index=-7))
    assert rep_pt.render_analysis(b, moved) == \
        rep_ref.render_analysis(a, moved)


def test_svg_refuses_a_valid_verdict():
    b = fx_pt.gen_history("cas", n_ops=20, processes=2, seed=0)
    with pytest.raises(ValueError):
        rep_pt.render_analysis(b, {"valid": True})

"""The port's C++ host prep (``jepsen_tpu_torch/native/preproc.cpp``
through ``checkers/preproc_native.py``) against the reference package's
bridge to its own copy and against the port's plain Python scans, on the
CPU.

Same inputs through both: the ``data/*.edn`` histories and generated
ones, with crashed ops and ``fixtures.corrupt``. Every output is an
integer array, compared exactly. Also: ``ConcurrencyOverflow`` past
``max_slots``, ``gen_packed`` field by field with sampled lazy entries,
the build's atomic install when two processes build at once, and a
failed build that raises.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu.checkers import preproc_native as pn_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu_torch import _native
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch.checkers import events as ev_pt
from jepsen_tpu_torch.checkers import preproc_native as pn_pt
from jepsen_tpu_torch.checkers import reach as reach_pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
EDN = sorted(f for f in os.listdir(DATA) if f.endswith(".edn"))

GEN = [("cas", dict(n_ops=300, processes=5, seed=0), False),
       ("cas", dict(n_ops=150, processes=6, seed=1, crash_p=0.04), True),
       ("register", dict(n_ops=200, processes=4, seed=2, crash_p=0.05),
        False),
       ("mutex", dict(n_ops=120, processes=3, seed=3), False),
       ("multi", dict(n_ops=150, processes=4, seed=4, keys=2), True)]


def _histories():
    """``(label, model kind, ops)``: the EDN fixtures, then generated."""
    out = []
    for f in EDN:
        kind = "multi" if f.startswith("multi") else \
            "mutex" if f.startswith("mutex") else "cas"
        out.append((f, kind, h_pt.load_edn(os.path.join(DATA, f))))
    for kind, kw, bad in GEN:
        h = fx_pt.gen_history(kind, **kw)
        out.append((f"{kind}-{kw['seed']}", kind,
                    fx_pt.corrupt(h, seed=kw["seed"]) if bad else h))
    return out


HISTORIES = _histories()


def _stream(kind, ops):
    """The port's event stream of ``ops`` (native slots)."""
    reach_pt._MEMO_CACHE.clear()
    packed = h_pt.pack(ops)
    memo = reach_pt._cached_memo(fx_pt.model_for(kind), packed, 100_000)
    return ev_pt.build(packed, memo, max_slots=20)


@pytest.mark.parametrize("label,kind,ops", HISTORIES,
                         ids=[h[0] for h in HISTORIES])
def test_scans_equal_reference_and_plain(label, kind, ops):
    """``assign_slots`` and ``returns_view``: the port's native scans, the
    reference's and the port's plain scans give the same arrays."""
    st = _stream(kind, ops)
    n_entries = st.n_entries + st.n_dropped_crashed
    got = pn_pt.assign_slots(st.kind, st.entry, n_entries, 20)
    want = pn_ref.assign_slots(st.kind, st.entry, n_entries, 20)
    plain = ev_pt.assign_slots_plain(st.kind, st.entry, 20)
    for a in (want, plain):
        np.testing.assert_array_equal(got[0], a[0])
        assert got[1] == a[1] == st.W
    np.testing.assert_array_equal(got[0], st.slot)
    rv = ev_pt.returns_view(st)
    ref = pn_ref.returns_view(st.kind, st.slot, st.opid, st.entry,
                              max(st.W, 1), st.n_events)
    plain = ev_pt.returns_view_plain(st)
    for f, a in zip(("ret_slot", "slot_ops", "ret_event", "ret_entry"), ref):
        np.testing.assert_array_equal(getattr(rv, f), a)
        np.testing.assert_array_equal(getattr(rv, f), getattr(plain, f))
    assert rv.n_returns == ref[4] == plain.n_returns
    assert (rv.W, rv.R) == (plain.W, plain.R)


@pytest.mark.parametrize("max_slots", [1, 2, 3])
def test_overflow_past_max_slots(max_slots):
    """More pending ops than ``max_slots``: the native scan reports -1 as
    the plain one does, and ``events.build`` raises."""
    ops = fx_pt.gen_history("cas", n_ops=200, processes=5, seed=0)
    st = _stream("cas", ops)
    assert st.W > max_slots
    n = st.n_entries + st.n_dropped_crashed
    got = pn_pt.assign_slots(st.kind, st.entry, n, max_slots)
    assert got[1] == -1 == ev_pt.assign_slots_plain(st.kind, st.entry,
                                                    max_slots)[1]
    assert pn_ref.assign_slots(st.kind, st.entry, n, max_slots)[1] == -1
    packed = h_pt.pack(ops)
    memo = reach_pt._cached_memo(fx_pt.model_for("cas"), packed, 100_000)
    with pytest.raises(ev_pt.ConcurrencyOverflow):
        ev_pt.build(packed, memo, max_slots=max_slots)


def test_entry_out_of_range_is_refused():
    with pytest.raises(ValueError, match="out of range"):
        pn_pt.assign_slots(np.zeros(2, np.int32), np.array([0, 5]), 2, 4)


@pytest.mark.parametrize("max_slots,w_cap", [(20, 20), (3, 20), (20, 4)])
def test_build_keyed_equals_reference(max_slots, w_cap):
    """Every key's slotted return stream over the union alphabet, crashed
    ops and corrupted keys included, in one call: the reference's arrays,
    with overflowing keys (``key_W = -1``) at a low cap."""
    model = fx_ref.model_for("cas")
    packed = []
    for k in range(7):
        h = fx_ref.gen_history("cas", n_ops=60, processes=3 + k % 3,
                               seed=k, crash_p=0.1 * (k % 2))
        packed.append(h_ref.pack(fx_ref.corrupt(h, seed=k) if k in (1, 4)
                                 else h))
    sa = reach_ref._union_stage_a(model, packed, range(7), 100_000)
    offs = np.concatenate([[0], np.cumsum([len(o) for o in sa.opids])])
    args = (offs, np.concatenate(sa.invs), np.concatenate(sa.rets),
            np.concatenate(sa.opids), np.concatenate(sa.crs), sa.noop_op,
            max_slots, w_cap)
    got = pn_pt.build_keyed(*args)
    want = pn_ref.build_keyed(*args)
    for a, b in zip(got[:6], want[:6]):
        np.testing.assert_array_equal(a, b)
    assert got[6] == want[6]
    if max_slots == 3:
        assert (got[3] == -1).any() and (got[3] != -1).any()


@pytest.mark.parametrize("seed,n_ops,processes,values,kind", [
    (0, 500, 5, 5, 1), (7, 300, 3, 2, 0), (1000, 2000, 8, 5, 1)])
def test_gen_history_equals_reference(seed, n_ops, processes, values, kind):
    got = pn_pt.gen_history(seed, n_ops, processes, values, kind)
    want = pn_ref.gen_history(seed, n_ops, processes, values, kind)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4] > 0


@pytest.mark.parametrize("kind,kw", [
    ("cas", dict(n_ops=3_000, processes=5, seed=3)),
    ("register", dict(n_ops=1_000, processes=4, values=3, seed=9)),
    ("mutex", dict(n_ops=200, processes=3, seed=1))])
def test_gen_packed_equals_reference(kind, kw):
    """The port's ``gen_packed`` is the reference's, field by field, with
    its lazily built entries equal at sampled indices."""
    a = fx_ref.gen_packed(kind, **kw)
    b = fx_pt.gen_packed(kind, **kw)
    assert (a.n, a.inf_ev, a.op_keys) == (b.n, b.inf_ev, b.op_keys)
    for f in ("inv_ev", "ret_ev", "op_id", "crashed"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [o.to_dict() for o in a.distinct_ops] == \
        [o.to_dict() for o in b.distinct_ops]
    assert len(a.entries) == len(b.entries) == a.n
    for i in sorted({0, 1, a.n // 3, a.n // 2, a.n - 1}):
        ea, eb = a.entries[i], b.entries[i]
        assert (ea.eid, ea.inv_ev, ea.ret_ev, ea.crashed) == \
            (eb.eid, eb.inv_ev, eb.ret_ev, eb.crashed)
        assert ea.op.to_dict() == eb.op.to_dict()


def test_two_processes_build_at_once(tmp_path):
    """Two processes that build the library into one empty directory at
    once both load it and use it; one whole library is left, and no
    temporary file."""
    code = (
        "import sys\n"
        "from jepsen_tpu_torch import _native\n"
        "_native.BUILD = sys.argv[1]\n"
        "from jepsen_tpu_torch.checkers import preproc_native as pn\n"
        "print(pn.gen_history(0, 100, 3, 3, 1)[4])\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    want = str(pn_ref.gen_history(0, 100, 3, 3, 1)[4])
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == want
    assert os.listdir(tmp_path) == \
        [os.path.basename(_native.library_path())]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile, or no ``g++``, raises: there is no
    fallback to the Python scans."""
    bad = tmp_path / "preproc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "SRC", str(bad))
    monkeypatch.setattr(_native, "BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g.. failed"):
        _native.build()
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        _native.build()

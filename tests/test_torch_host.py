"""The port's host modules against the reference package, on the CPU.

Same seeds through ``jepsen_tpu`` and ``jepsen_tpu_torch``: generated
histories, packing, memo tables, event streams, return views and EDN
loads must be equal exactly (everything compared is an integer array,
a Python value or an op dict). Also: the port imports neither JAX nor
the reference package, and its entry points do not fall back to the
CPU by themselves.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jepsen_tpu import edn as edn_ref
from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu.checkers import events as ev_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu_torch import Linearizable
from jepsen_tpu_torch import edn as edn_pt
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import txn as txn_pt
from jepsen_tpu_torch.checkers import events as ev_pt
from jepsen_tpu_torch.checkers import reach as reach_pt

# tiny tensors: one thread each keeps the parallel test workers from
# crowding each other's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")
EDN_FILES = sorted(f for f in os.listdir(DATA) if f.endswith(".edn"))

GEN_CASES = [
    ("cas", dict(n_ops=120, processes=4, seed=0)),
    ("cas", dict(n_ops=120, processes=4, seed=5, crash_p=0.05)),
    ("register", dict(n_ops=120, processes=3, seed=1)),
    ("mutex", dict(n_ops=80, processes=3, seed=2)),
    ("multi", dict(n_ops=80, processes=3, seed=3, keys=2)),
]


def _cold_memos():
    """Empty both packages' exact memo caches and superset seeds (a
    seed left by an earlier ``check_many`` on the worker would number a
    projected memo's states otherwise than a cold build)."""
    for r in (reach_ref, reach_pt):
        with r._MEMO_CACHE_LOCK:
            r._MEMO_CACHE.clear()
            r._SUPERSET_SEEDS.clear()


def _dicts(history):
    return [op.to_dict() for op in history]


def _packed_equal(a, b):
    assert a.n == b.n and a.inf_ev == b.inf_ev
    for f in ("inv_ev", "ret_ev", "op_id", "crashed"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [o.to_dict() for o in a.distinct_ops] == \
        [o.to_dict() for o in b.distinct_ops]
    assert a.op_keys == b.op_keys


@pytest.mark.parametrize("kind,kw", GEN_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(GEN_CASES)])
def test_gen_and_corrupt_equal(kind, kw):
    h1 = fx_ref.gen_history(kind, **kw)
    h2 = fx_pt.gen_history(kind, **kw)
    assert _dicts(h1) == _dicts(h2)
    if kind != "mutex":                 # mutex histories have no reads
        assert _dicts(fx_ref.corrupt(h1, seed=kw["seed"])) == \
            _dicts(fx_pt.corrupt(h2, seed=kw["seed"]))


@pytest.mark.parametrize("kind,kw", GEN_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(GEN_CASES)])
def test_prep_arrays_equal(kind, kw):
    """pack → memo (cold build on the sorted alphabet) → event stream →
    returns view, exactly equal."""
    h = fx_ref.gen_history(kind, **kw)
    p1, p2 = h_ref.pack(h), h_pt.pack(fx_pt.gen_history(kind, **kw))
    _packed_equal(p1, p2)
    _cold_memos()
    m1, s1, T1, S1, M1 = reach_ref._prep(
        fx_ref.model_for(kind), p1, max_states=100_000, max_slots=20,
        max_dense=1 << 22)
    m2, s2, T2, S2, M2 = reach_pt._prep(
        fx_pt.model_for(kind), p2, max_states=100_000, max_slots=20,
        max_dense=1 << 22)
    np.testing.assert_array_equal(m1.table, m2.table)
    assert [str(s) for s in m1.states] == [str(s) for s in m2.states]
    assert (S1, M1) == (S2, M2)
    np.testing.assert_array_equal(T1, T2)
    for f in ("kind", "slot", "opid", "entry"):
        np.testing.assert_array_equal(getattr(s1, f), getattr(s2, f))
    assert (s1.W, s1.n_events, s1.n_entries, s1.n_dropped_crashed) == \
        (s2.W, s2.n_events, s2.n_entries, s2.n_dropped_crashed)
    r1, r2 = ev_ref.returns_view(s1), ev_pt.returns_view(s2)
    for f in ("ret_slot", "slot_ops", "ret_event", "ret_entry"):
        np.testing.assert_array_equal(getattr(r1, f), getattr(r2, f))
    assert (r1.W, r1.n_returns) == (r2.W, r2.n_returns)
    np.testing.assert_array_equal(
        reach_ref._build_P(m1, S1), reach_pt._build_P(m2, S2))


def test_memo_cache_hit_keeps_cold_numbering():
    """A second history over a permuted alphabet hits the port's cache and
    gets the same table as a cold build would."""
    kw = dict(n_ops=60, processes=3)
    a, b = (h_pt.pack(fx_pt.gen_history("cas", seed=s, **kw))
            for s in (0, 1))
    _cold_memos()
    reach_pt._cached_memo(fx_pt.model_for("cas"), a, 100_000)
    warm = reach_pt._cached_memo(fx_pt.model_for("cas"), b, 100_000)
    _cold_memos()
    cold = reach_pt._cached_memo(fx_pt.model_for("cas"), b, 100_000)
    np.testing.assert_array_equal(warm.table, cold.table)


@pytest.mark.parametrize("fname", EDN_FILES)
def test_edn_load_equal(fname):
    path = os.path.join(DATA, fname)
    assert _dicts(h_ref.load_edn(path)) == _dicts(h_pt.load_edn(path))


def test_edn_keyword_syntax_equal():
    text = ("[{:process 0, :type :invoke, :f :write, :value 1}\n"
            " {:process 0, :type :ok, :f :write, :value [1 {:a nil}]}]")
    assert edn_ref.to_plain(edn_ref.loads(text)) == \
        edn_pt.to_plain(edn_pt.loads(text))
    assert edn_ref.dumps({"a": [1, None, "x"]}) == \
        edn_pt.dumps({"a": [1, None, "x"]})


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port, ``chip_smoke.py`` and every
    module that ``chip_smoke.py`` imports (its imports sit inside
    functions too) in a fresh interpreter leaves ``jax``, ``jepsen_tpu``
    and the reference's ``tools/`` scripts (``tools/ablate_lane.py``) out
    of ``sys.modules``."""
    code = (
        "import ast, os, pkgutil, sys, importlib, jepsen_tpu_torch\n"
        "for m in pkgutil.walk_packages(jepsen_tpu_torch.__path__, "
        "'jepsen_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for node in ast.walk(ast.parse(open('chip_smoke.py').read())):\n"
        "    if isinstance(node, ast.Import):\n"
        "        names = [a.name for a in node.names]\n"
        "    elif isinstance(node, ast.ImportFrom):\n"
        "        names = [node.module] + [node.module + '.' + a.name\n"
        "                                 for a in node.names]\n"
        "    else:\n"
        "        continue\n"
        "    for n in names:\n"
        "        try:\n"
        "            importlib.import_module(n)\n"
        "        except ModuleNotFoundError:\n"
        "            assert '.' in n, n      # a name, not a module\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'jepsen_tpu' or "
        "n.startswith('jepsen_tpu.') or os.path.abspath(getattr("
        "sys.modules[n], '__file__', None) or '').startswith("
        "os.path.abspath('tools') + os.sep))\n"
        "print(' '.join(sorted(n for n in sys.modules "
        "if n.startswith('jepsen_tpu_torch'))))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    imported = set(out.stdout.split())
    assert len(imported) >= 20                   # every module imported
    assert {"jepsen_tpu_torch.checkers.reach_batch",
            "jepsen_tpu_torch.checkers.reach_chunklock",
            "jepsen_tpu_torch.checkers.preproc_native",
            "jepsen_tpu_torch.checkers.dispatch_core",
            "jepsen_tpu_torch.checkers.wgl_native",
            "jepsen_tpu_torch.checkers.reach_q",
            "jepsen_tpu_torch.checkers.frontier",
            "jepsen_tpu_torch.checkers.decompose",
            "jepsen_tpu_torch._native",
            "jepsen_tpu_torch.independent",
            "jepsen_tpu_torch.tools.ablate_lane",
            "jepsen_tpu_torch.txn",
            "jepsen_tpu_torch.txn.ops",
            "jepsen_tpu_torch.txn.infer",
            "jepsen_tpu_torch.txn.host_ref",
            "jepsen_tpu_torch.txn.cycles",
            "jepsen_tpu_torch.txn.lattice",
            "jepsen_tpu_torch.checkers.search",
            "jepsen_tpu_torch.checkers.linear",
            "jepsen_tpu_torch.checkers.linear_report",
            "jepsen_tpu_torch.store",
            "jepsen_tpu_torch.cli",
            "jepsen_tpu_torch.checkers.online",
            "jepsen_tpu_torch.serve.session",
            "jepsen_tpu_torch.serve",
            "jepsen_tpu_torch.serve.request",
            "jepsen_tpu_torch.serve.faults",
            "jepsen_tpu_torch.serve.recovery",
            "jepsen_tpu_torch.serve.coalesce",
            "jepsen_tpu_torch.serve.journal",
            "jepsen_tpu_torch.serve.engine",
            "jepsen_tpu_torch.serve.http",
            "jepsen_tpu_torch.checkers.reach_word",
            "jepsen_tpu_torch.web",
            "jepsen_tpu_torch.checkers.transfer",
            "jepsen_tpu_torch.obs",
            "jepsen_tpu_torch.tools.loadgen",
            "jepsen_tpu_torch.tools.chaos",
            "jepsen_tpu_torch.tools.soak",
            "jepsen_tpu_torch.__main__"} <= imported


def test_no_silent_cpu_fallback(monkeypatch):
    """Without ``device`` the entry points want the card, and raise when
    there is none — they never run on the CPU by themselves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = fx_pt.gen_history("cas", n_ops=20, processes=2, seed=0)
    model = fx_pt.model_for("cas")
    with pytest.raises(RuntimeError, match="CUDA"):
        Linearizable(model).check(None, h)
    with pytest.raises(RuntimeError, match="CUDA"):
        reach_pt.check(model, h)
    with pytest.raises(RuntimeError, match="CUDA"):
        Linearizable(model, device="cuda").check(None, h)
    assert Linearizable(model, device="cpu").check(None, h)["valid"] is True
    th = fx_pt.gen_txn_history(20, keys=2, seed=0)
    for kw in ({}, {"consistency": "all"}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            txn_pt.check_history(th, **kw)
    assert txn_pt.check_history(th, device="cpu")["valid"] is True

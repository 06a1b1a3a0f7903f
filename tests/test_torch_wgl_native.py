"""The port's C++ WGL search (``checkers/wgl_native.py`` over its own copy
of ``native/wgl.cpp``) against the reference's, on the CPU.

Both packages build the same source into their own libraries; on the
``data/*.edn`` fixtures, generated register and cas histories with
crashed ops (valid and corrupted), the crash-heavy history and a tight
``max_configs``, the whole result dict must be equal (verdict, failing
op, ``max-linearized``, ``configs-explored``, ``final-configs``,
``cause``). The two host libraries build at once in two processes.
"""
import os
import subprocess
import sys

import pytest

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import wgl_native as wn_ref
from jepsen_tpu.op import info as info_ref
from jepsen_tpu.op import invoke as inv_ref
from jepsen_tpu.op import ok as ok_ref
from jepsen_tpu_torch import _native
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch.checkers import wgl_native as wn_pt
from jepsen_tpu_torch.op import info as info_pt
from jepsen_tpu_torch.op import invoke as inv_pt
from jepsen_tpu_torch.op import ok as ok_pt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "data")

FIXTURES = [
    ("cas-register-ok-small.edn", "cas_register", True),
    ("cas-register-ok-large.edn", "cas_register", True),
    ("cas-register-bad.edn", "cas_register", False),
    ("cas-register-recorded-bad.edn", "cas_register", False),
    ("register-ok.edn", "register", True),
    ("register-bad.edn", "register", False),
    ("mutex-ok.edn", "mutex", True),
    ("multi-register-ok.edn", "multi_register", True),
    ("multi-register-bad.edn", "multi_register", False),
]


def _both(model, h1, h2, **kw):
    a = wn_ref.check(getattr(m_ref, model)(), h1, **kw)
    b = wn_pt.check(getattr(m_pt, model)(), h2, **kw)
    assert a == b
    return b


def test_the_source_is_the_reference():
    """The port's copy of the search is the reference's, byte for byte."""
    with open(os.path.join(ROOT, "native", "wgl.cpp"), "rb") as f:
        ref = f.read()
    with open(_native.source("wgl"), "rb") as f:
        assert f.read() == ref


@pytest.mark.parametrize("fname,model,want", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixtures_match_reference(fname, model, want):
    path = os.path.join(DATA, fname)
    res = _both(model, h_ref.load_edn(path), h_pt.load_edn(path))
    assert res["valid"] is want and res["engine"] == "wgl-native"
    if want is False:
        assert res["final-configs"] and res["op"]


@pytest.mark.parametrize("corrupt", [False, True], ids=["valid", "corrupt"])
@pytest.mark.parametrize("crash_p", [0.0, 0.1, 0.2])
@pytest.mark.parametrize("kind", ["register", "cas"])
def test_generated_match_reference(kind, crash_p, corrupt):
    for seed in range(2):
        kw = dict(n_ops=60, processes=4, values=3, crash_p=crash_p,
                  seed=seed)
        h1, h2 = fx_ref.gen_history(kind, **kw), fx_pt.gen_history(kind,
                                                                   **kw)
        if corrupt:
            h1, h2 = fx_ref.corrupt(h1, seed=seed), fx_pt.corrupt(h2,
                                                                 seed=seed)
        model = "register" if kind == "register" else "cas_register"
        res = _both(model, h1, h2)
        assert res["valid"] is (not corrupt)


def _crash_heavy(ops, n_crashed=24, n_live=20):
    invoke, ok, info = ops
    h = [invoke(0, "write", 0), ok(0, "write", 0)]
    for c in range(n_crashed):
        h += [invoke(100 + c, "write", 1), info(100 + c, "write", 1),
              invoke(0, "read"), ok(0, "read", 0)]
    for i in range(n_live):
        v = i % 3
        h += [invoke(0, "write", v), ok(0, "write", v),
              invoke(0, "read"), ok(0, "read", v)]
    return h


def _crash_heavy_pair(**kw):
    return (h_ref.index(_crash_heavy((inv_ref, ok_ref, info_ref), **kw)),
            h_pt.index(_crash_heavy((inv_pt, ok_pt, info_pt), **kw)))


def test_crash_heavy_24():
    res = _both("register", *_crash_heavy_pair())
    assert res["valid"] is True


def test_tight_max_configs_is_unknown():
    h1, h2 = (fx.gen_history("register", n_ops=300, processes=5,
                             crash_p=0.05, values=3, seed=5)
              for fx in (fx_ref, fx_pt))
    h1, h2 = fx_ref.corrupt(h1, seed=1), fx_pt.corrupt(h2, seed=1)
    res = _both("register", h1, h2, max_configs=50)
    assert res["valid"] == "unknown"
    assert res["cause"] == "config-set-explosion"


def test_abort_flag():
    flag = wn_pt.AbortFlag()
    flag.abort()
    h = fx_pt.gen_history("cas", n_ops=60, processes=4, seed=0)
    res = wn_pt.check(m_pt.cas_register(), h, abort_flag=flag)
    assert res["valid"] == "unknown" and res["cause"] == "aborted"
    assert wn_pt.check(m_pt.cas_register(), h)["valid"] is True


def test_two_libraries_build_at_once(tmp_path):
    """Two processes that build both host libraries into one empty
    directory at once both load and use them; one whole library each
    is left, and no temporary file."""
    code = (
        "import sys\n"
        "from jepsen_tpu_torch import _native\n"
        "_native.BUILD = sys.argv[1]\n"
        "from jepsen_tpu_torch import fixtures, models\n"
        "from jepsen_tpu_torch.checkers import preproc_native, wgl_native\n"
        "h = fixtures.gen_history('cas', n_ops=40, processes=3, seed=2)\n"
        "print(wgl_native.check(models.cas_register(), h)['valid'],\n"
        "      preproc_native.gen_history(0, 100, 3, 3, 1)[4])\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split()[0] == "True" and int(out.split()[1]) > 0
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(_native.library_path(n)) for n in _native.LIBRARIES)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "wgl.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_native, "WGL_SRC", str(bad))
    monkeypatch.setattr(_native, "BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g.. failed"):
        _native.build("wgl")
    with pytest.raises(ValueError, match="no host library"):
        _native.build("nope")

"""The port's persisted autotune table (``checkers/autotune.py``), on the
CPU, after the reference's ``tests/test_autotune.py``: the round trip,
staleness (schema, torch version, device name, kernel sources), a corrupt
table, the table off without persistence, the mtime invalidation, the
reference's geometry buckets, and route selection following recorded
winners: the post-hoc walk, a lockstep group, the group width, the
sessions' mega crossover, a second process, and ``--bodies`` recording
one. Every test keeps its table under its own ``tmp_path``.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from jepsen_tpu.checkers import autotune as at_ref
from jepsen_tpu_torch import fixtures, history, models, obs
from jepsen_tpu_torch.checkers import autotune, events, facade, reach
from jepsen_tpu_torch.serve import session
from jepsen_tpu_torch.tools import ablate_lane

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def table_dir(tmp_path, monkeypatch):
    """Persistence on (the suite turns it off) under a fresh root."""
    monkeypatch.delenv("JEPSEN_TPU_NO_PERSIST", raising=False)
    monkeypatch.setenv("JEPSEN_TPU_CACHE_DIR", str(tmp_path))
    autotune._CACHE.clear()
    yield str(tmp_path)
    autotune._CACHE.clear()


def _entry_key(kind, geom):
    return f"{kind}|cpu|{geom}"


def test_record_winner_round_trip(table_dir):
    with obs.capture() as cap:
        path = autotune.record("closure", "Np64", "word", metric=123.4,
                               detail={"f32_s": 0.5}, backend_name="cpu")
        assert path == os.path.join(table_dir, "autotune.json")
        assert autotune.winner("closure", "Np64", backend_name="cpu") == \
            "word"
        # another kind, geometry or backend is a miss, not a bleed
        assert autotune.winner("walk", "Np64", backend_name="cpu") is None
        assert autotune.winner("closure", "Np128", backend_name="cpu") \
            is None
        assert autotune.winner("closure", "Np64", backend_name="cuda") \
            is None
    assert cap.counters.get("autotune.record") == 1
    assert cap.counters.get("autotune.hit") == 1
    assert cap.counters.get("autotune.miss") == 3
    data = json.load(open(path))
    assert data["version"] == 1
    entry = data["entries"][_entry_key("closure", "Np64")]
    assert entry["body"] == "word" and entry["metric"] == 123.4
    assert entry["torch"] == torch.__version__ and entry["device"] == "cpu"
    assert entry["kernels"] == autotune.kernel_source_id()


@pytest.mark.parametrize("field,value", [("torch", "0.0.1-not-this-one"),
                                         ("device", "another card"),
                                         ("kernels", "0123456789abcdef"),
                                         ("version", 99)])
def test_stale_entries(table_dir, field, value):
    """An entry measured under another torch, on another device or with
    other kernel sources is stale, as is a table of another schema; a
    record over it rebuilds it."""
    path = autotune.record("walk", "S8-W5-M32-R128", "word",
                           backend_name="cpu")
    data = json.load(open(path))
    if field == "version":
        data["version"] = value
    else:
        data["entries"][_entry_key("walk", "S8-W5-M32-R128")][field] = value
    json.dump(data, open(path, "w"))
    os.utime(path, (os.path.getmtime(path) + 2,) * 2)
    with obs.capture() as cap:
        assert autotune.winner("walk", "S8-W5-M32-R128",
                               backend_name="cpu") is None
    assert cap.counters.get("autotune.stale") == 1
    autotune.record("walk", "S8-W5-M32-R128", "dense", backend_name="cpu")
    assert json.load(open(path))["version"] == 1
    assert autotune.winner("walk", "S8-W5-M32-R128",
                           backend_name="cpu") == "dense"


def test_corrupt_table_reads_empty(table_dir):
    path = os.path.join(table_dir, "autotune.json")
    with open(path, "w") as f:
        f.write("{not json")
    with obs.capture() as cap:
        assert autotune.winner("closure", "Np64") is None
    assert cap.counters.get("autotune.stale") == 1
    autotune.record("closure", "Np64", "f32")
    assert autotune.winner("closure", "Np64") == "f32"


def test_no_persist_turns_the_table_off(table_dir, monkeypatch):
    autotune.record("closure", "Np64", "word")
    monkeypatch.setenv("JEPSEN_TPU_NO_PERSIST", "1")
    with obs.capture() as cap:
        assert autotune.table_path() is None
        assert autotune.winner("closure", "Np64") is None
        assert autotune.record("closure", "Np64", "f32") is None
    assert not cap.counters


def test_mtime_invalidation_picks_up_external_write(table_dir):
    path = autotune.record("closure", "Np64", "word", backend_name="cpu")
    assert autotune.winner("closure", "Np64", backend_name="cpu") == "word"
    data = json.load(open(path))
    data["entries"][_entry_key("closure", "Np64")]["body"] = "f32"
    json.dump(data, open(path, "w"))
    os.utime(path, (os.path.getmtime(path) + 2,) * 2)
    assert autotune.winner("closure", "Np64", backend_name="cpu") == "f32"


def test_record_on_a_read_only_root_counts_a_failure(tmp_path, monkeypatch):
    root = tmp_path / "file"
    root.write_text("not a directory")
    monkeypatch.delenv("JEPSEN_TPU_NO_PERSIST", raising=False)
    monkeypatch.setenv("JEPSEN_TPU_CACHE_DIR", str(root))
    with obs.capture() as cap:
        assert autotune.record("walk", "S8-W5-M32-R128", "word") is None
    assert cap.counters.get("autotune.record_failed") == 1


@pytest.mark.parametrize("args", [(6, 5, 32, 1000), (41, 5, 32, 67_733),
                                  (6, 8, 256, 22_148), (1, 1, 2, 0),
                                  (114, 10, 1024, 1 << 20)])
def test_geometry_buckets_equal_the_reference(args):
    S, W, M, n = args
    assert autotune.walk_key(S, W, M, n) == at_ref.walk_key(S, W, M, n)
    assert autotune.lockstep_key(S, W, M, n) == \
        at_ref.lockstep_key(S, W, M, n)
    assert autotune.closure_key(n) == at_ref.closure_key(n)
    assert autotune._bucket_pow2(n) == at_ref._bucket_pow2(n)
    assert autotune.walk_key(6, 5, 32, 1000) == "S8-W5-M32-R1024"
    assert autotune.lockstep_key(6, 5, 32, 32) == "S8-W5-M32-H32"


# -- route selection follows recorded winners ------------------------------------

def _walk_key(packed):
    memo, stream, _T, _S, M = reach._prep(
        models.cas_register(), packed, max_states=100_000, max_slots=20,
        max_dense=1 << 22)
    return autotune.walk_key(memo.n_states, max(stream.W, 1), M,
                             events.returns_view(stream).n_returns)


def test_posthoc_route_follows_the_walk_winner(table_dir):
    """A ``walk`` winner of ``word`` steers ``check_packed`` to K11's route
    with no keyword; a ``dense`` winner steers it away."""
    packed = history.pack(fixtures.gen_history("cas", n_ops=150,
                                               processes=4, seed=23))
    model = models.cas_register()
    autotune.record("walk", _walk_key(packed), "word", backend_name="cpu")
    with obs.capture() as cap:
        res = reach.check_packed(model, packed, device="cpu")
    assert res["engine"] == "reach-word"
    assert cap.counters.get("autotune.hit", 0) >= 1
    autotune.record("walk", _walk_key(packed), "dense", backend_name="cpu")
    with obs.capture() as cap:
        res2 = reach.check_packed(model, packed, device="cpu")
    assert res2["engine"] == "reach-lane"
    assert res2["valid"] == res["valid"]
    assert {r["stage"]: r["cause"] for r in cap.skipped()}["reach-word"] \
        == "winner"


def _keys(n=4):
    return [history.pack(fixtures.gen_history("cas", n_ops=40 + 9 * i,
                                              processes=3, seed=i))
            for i in range(n)]


def test_lockstep_group_follows_the_lockstep_winner(table_dir):
    """A ``lockstep`` winner of ``word`` for the group's geometry makes
    the group one K11 walk; with none it is K2's."""
    packed = _keys()
    model = models.cas_register()
    with obs.capture() as cap:
        dense = reach.check_many(model, packed, device="cpu")
    assert "lockstep.word_groups" not in cap.counters
    assert {r["engine"] for r in dense} == {"reach-lockstep"}
    # the union's padded geometry: 8 states, W = 3, 4 lanes
    autotune.record("lockstep", autotune.lockstep_key(8, 3, 8, 4), "word",
                    backend_name="cpu")
    with obs.capture() as cap:
        word = reach.check_many(model, packed, device="cpu")
    assert cap.counters.get("lockstep.word_groups") == 1
    assert [r["valid"] for r in word] == [r["valid"] for r in dense]


def test_group_width_follows_the_group_winner(table_dir, monkeypatch):
    """A ``group`` winner reaches ``reach.check_many`` and
    ``stage_check_many`` as the group width; an explicit ``group``
    outranks it."""
    seen = []

    def fake(model, packed_list, **kw):
        seen.append(kw.get("group"))
        return [{"valid": True, "engine": "stub"} for _ in packed_list]

    monkeypatch.setattr(reach, "check_many", fake)
    monkeypatch.setattr(reach, "stage_check_many", fake)
    autotune.record("group", "default", "16", backend_name="cpu")
    packed = _keys(1)
    model = models.cas_register()
    facade.auto_check_many_packed(model, packed, {"device": "cpu"})
    facade.stage_check_many_packed(model, packed, {"device": "cpu"})
    facade.auto_check_many_packed(model, packed, {"device": "cpu",
                                                  "group": 8})
    assert seen == [16, 16, 8]


def test_group_width_reaches_the_lockstep_plan(table_dir):
    """The recorded width splits the lockstep lane's groups."""
    autotune.record("group", "default", "2", backend_name="cpu")
    with obs.capture() as cap:
        facade.auto_check_many_packed(models.cas_register(), _keys(),
                                      {"device": "cpu"})
    assert cap.counters.get("lockstep.groups") == 2


def test_mega_crossover_follows_the_session_winner(table_dir):
    assert session.mega_crossover() == 2
    autotune.record("session-mega", "crossover", "5")
    assert session.mega_crossover() == 5
    autotune.record("session-mega", "crossover", "not a width")
    assert session.mega_crossover() == 2


def test_second_process_honours_a_recorded_winner(table_dir):
    """A winner recorded here steers route selection in a fresh process
    (cold imports, warm table): an ``autotune.hit`` and K11's route."""
    packed = history.pack(fixtures.gen_history("cas", n_ops=120,
                                               processes=4, seed=29))
    autotune.record("walk", _walk_key(packed), "word", backend_name="cpu")
    env = dict(os.environ, JEPSEN_TPU_CACHE_DIR=table_dir)
    env.pop("JEPSEN_TPU_NO_PERSIST", None)
    code = (
        "import json\n"
        "from jepsen_tpu_torch import fixtures, history, models, obs\n"
        "from jepsen_tpu_torch.checkers import reach\n"
        "p = history.pack(fixtures.gen_history('cas', n_ops=120,"
        " processes=4, seed=29))\n"
        "with obs.capture() as cap:\n"
        "    res = reach.check_packed(models.cas_register(), p,"
        " device='cpu')\n"
        "print(json.dumps({'engine': res['engine'],"
        " 'hits': cap.counters.get('autotune.hit', 0)}))\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    assert rep == {"engine": "reach-word", "hits": 1}


def test_bodies_sweep_records_its_winner(table_dir, capsys):
    """``--bodies`` on the CPU prints the reference's row and records the
    faster body as the ``walk`` winner, which ``check_packed`` follows."""
    assert ablate_lane.main(["--bodies", "--ops", "300", "--repeat", "1",
                             "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) == {"geometry", "word_s", "dense_s", "winner",
                        "speedup", "word_engine", "dense_engine",
                        "recorded"}
    assert row["word_engine"] == "reach-word"
    assert row["dense_engine"] == "reach-lane"
    assert row["recorded"] == os.path.join(table_dir, "autotune.json")
    packed = history.pack(fixtures.gen_history("cas", n_ops=300,
                                               processes=5, seed=42))
    key = _walk_key(packed)
    g = row["geometry"]
    assert key == autotune.walk_key(g["S"], g["W"], g["M"], g["returns"])
    assert autotune.winner("walk", key, backend_name="cpu") == row["winner"]
    res = reach.check_packed(models.cas_register(), packed, device="cpu")
    assert res["engine"] == ("reach-word" if row["winner"] == "word"
                             else "reach-lane")

"""The persistent memo tier and its root, port against reference, on the
CPU: ``store.persist_root`` under each environment setting, the disk
tier below the exact memo cache (round trip, model-signature
invalidation, a corrupt entry, an unstable repr, a repr collision, LRU
order), the two packages' entries kept apart, the superset seeds'
projections, and ``check_many``'s one union BFS. Every comparison is
exact."""
import os

import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu import store as store_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch import store as store_pt
from jepsen_tpu_torch.checkers import reach as reach_pt

torch.set_num_threads(1)

PKGS = (reach_ref, reach_pt)


@pytest.fixture(autouse=True)
def _cold(monkeypatch):
    """Each test starts with both packages' exact caches, seeds and
    failed seeds empty, and with no recorded store root."""
    for r in PKGS:
        with r._MEMO_CACHE_LOCK:
            r._MEMO_CACHE.clear()
            r._SUPERSET_SEEDS.clear()
            r._SUPERSET_SEEDS_FAILED.clear()
    monkeypatch.setattr(store_pt, "_PERSIST_STATE", {})
    monkeypatch.setattr(store_ref, "_PERSIST_STATE", {})


def _clear_memo_state():
    """A fresh process, as far as the in-memory tiers go."""
    with reach_pt._MEMO_CACHE_LOCK:
        reach_pt._MEMO_CACHE.clear()
        reach_pt._SUPERSET_SEEDS.clear()
        reach_pt._SUPERSET_SEEDS_FAILED.clear()


def _persist_on(monkeypatch, path):
    monkeypatch.setenv("JEPSEN_TPU_CACHE_DIR", str(path))
    monkeypatch.delenv("JEPSEN_TPU_NO_PERSIST", raising=False)


def _packed(seed, n_ops=60):
    return h_pt.pack(fx_pt.gen_history("cas", n_ops=n_ops, processes=3,
                                       seed=seed))


# -- persist_root ---------------------------------------------------------

ENVS = [("off", {"JEPSEN_TPU_NO_PERSIST": "1"}),
        ("moved", {"JEPSEN_TPU_CACHE_DIR": "/elsewhere/cache"}),
        ("off and moved", {"JEPSEN_TPU_NO_PERSIST": "1",
                           "JEPSEN_TPU_CACHE_DIR": "/elsewhere/cache"}),
        ("default", {})]


@pytest.mark.parametrize("store_root", [None, "runs/custom"])
@pytest.mark.parametrize("label,env", ENVS, ids=[e[0] for e in ENVS])
def test_persist_root_equals_reference(monkeypatch, label, env,
                                       store_root):
    for k in ("JEPSEN_TPU_NO_PERSIST", "JEPSEN_TPU_CACHE_DIR"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert store_pt.persist_root(store_root) == \
        store_ref.persist_root(store_root)


@pytest.mark.parametrize("persist", [True, False])
def test_recorded_store_root_equals_reference(monkeypatch, tmp_path,
                                              persist):
    """A run's store root keys later lookups as the reference's
    ``enable_compilation_cache`` records it: only while persistence is
    on. The port records it at ``create_run_dir``."""
    monkeypatch.delenv("JEPSEN_TPU_CACHE_DIR", raising=False)
    if persist:
        monkeypatch.delenv("JEPSEN_TPU_NO_PERSIST", raising=False)
    root = str(tmp_path / "runs")
    store_pt.create_run_dir({"name": "t", "store-root": root})
    if store_ref.persist_root(root) is not None:
        # the reference's record, without its XLA configuration
        monkeypatch.setitem(store_ref._PERSIST_STATE, "root", root)
    assert store_pt.persist_root() == store_ref.persist_root()
    assert store_pt.persist_root() == (
        os.path.join(root, ".cache") if persist else None)
    monkeypatch.delenv("JEPSEN_TPU_NO_PERSIST", raising=False)
    assert store_pt.persist_root() == os.path.join(
        root if persist else "store", ".cache")


# -- the disk tier: the reference's six tests, on the port ----------------

def test_disk_memo_round_trip(tmp_path, monkeypatch):
    """A fresh in-memory state serves the memo from disk (the same table),
    and the counters record the store and the hit."""
    _persist_on(monkeypatch, tmp_path)
    model = m_pt.cas_register()
    p = _packed(7)
    with obs.capture() as cap:
        m1 = reach_pt._cached_memo(model, p, 100_000)
    assert cap.counters.get("memo_cache.disk.store") == 1
    assert cap.counters.get("memo_cache.miss") == 1
    _clear_memo_state()
    with obs.capture() as cap2:
        m2 = reach_pt._cached_memo(model, p, 100_000)
    assert cap2.counters.get("memo_cache.disk.hit") == 1
    np.testing.assert_array_equal(m1.table, m2.table)
    assert m1.distinct_ops == m2.distinct_ops
    assert m1.initial == m2.initial
    assert m1.states == m2.states
    with obs.capture() as cap3:
        reach_pt._cached_memo(model, p, 100_000)
    assert cap3.counters.get("memo_cache.hit") == 1
    assert "memo_cache.disk.hit" not in cap3.counters


def test_disk_memo_model_signature_invalidation(tmp_path, monkeypatch):
    _persist_on(monkeypatch, tmp_path)
    p = _packed(7)
    reach_pt._cached_memo(m_pt.cas_register(), p, 100_000)
    _clear_memo_state()
    with obs.capture() as cap:
        reach_pt._cached_memo(m_pt.cas_register(value=123), p, 100_000)
    assert "memo_cache.disk.hit" not in cap.counters
    _clear_memo_state()
    with obs.capture() as cap2:
        reach_pt._cached_memo(m_pt.cas_register(), p, 50_000)
    assert "memo_cache.disk.hit" not in cap2.counters
    _clear_memo_state()
    with obs.capture() as cap3:
        reach_pt._cached_memo(m_pt.cas_register(), p, 100_000)
    assert cap3.counters.get("memo_cache.disk.hit") == 1


def test_disk_memo_corrupt_entry_rebuilds(tmp_path, monkeypatch):
    _persist_on(monkeypatch, tmp_path)
    model = m_pt.cas_register()
    p = _packed(9, n_ops=40)
    m1 = reach_pt._cached_memo(model, p, 100_000)
    entries = list((tmp_path / "memo").iterdir())
    assert len(entries) == 1
    entries[0].write_bytes(b"not a pickle")
    _clear_memo_state()
    with obs.capture() as cap:
        m2 = reach_pt._cached_memo(model, p, 100_000)
    assert cap.counters.get("memo_cache.disk.invalid") == 1
    np.testing.assert_array_equal(m1.table, m2.table)
    assert entries[0].read_bytes() != b"not a pickle"   # rebuilt, stored


def test_disk_memo_skips_unstable_model_repr(tmp_path, monkeypatch):
    _persist_on(monkeypatch, tmp_path)

    class Anon:
        pass                            # default <... object at 0x...> repr

    assert reach_pt._disk_memo_path((Anon(), 100_000, ())) is None
    pr = reach_pt._disk_memo_path((m_pt.cas_register(), 100_000, ()))
    assert pr is not None and pr[0].endswith(".memo.pkl")
    assert pr[0].startswith(os.path.join(str(tmp_path), "memo"))


class _Sneaky(m_pt.Model):
    """Module-level (picklable) model whose repr omits its behaviour
    field: the repr-collision adversary of the disk tier."""

    def __init__(self, param):
        self.param = param

    def __repr__(self):
        return "Sneaky()"

    def __eq__(self, other):
        return type(other) is _Sneaky and other.param == self.param

    def __hash__(self):
        return hash(("Sneaky", self.param))

    def step(self, op):
        return self


def test_disk_memo_repr_collision_rejected(tmp_path, monkeypatch):
    _persist_on(monkeypatch, tmp_path)
    p = _packed(2, n_ops=30)
    reach_pt._cached_memo(_Sneaky(2), p, 1000)
    _clear_memo_state()
    with obs.capture() as cap:
        reach_pt._cached_memo(_Sneaky(3), p, 1000)
    assert "memo_cache.disk.hit" not in cap.counters
    assert cap.counters.get("memo_cache.disk.invalid") == 1
    _clear_memo_state()
    with obs.capture() as cap2:
        reach_pt._cached_memo(_Sneaky(3), p, 1000)
    assert cap2.counters.get("memo_cache.disk.hit") == 1


def test_memo_cache_lru_not_insertion_order(monkeypatch):
    monkeypatch.setenv("JEPSEN_TPU_NO_PERSIST", "1")
    monkeypatch.setattr(reach_pt, "_MEMO_CACHE_MAX", 2)
    model = m_pt.cas_register()
    ps = [_packed(100 + i, n_ops=30 + 10 * i) for i in range(3)]
    with obs.capture() as cap:
        reach_pt._cached_memo(model, ps[0], 100_000)   # insert A
        reach_pt._cached_memo(model, ps[1], 100_000)   # insert B (full)
        reach_pt._cached_memo(model, ps[0], 100_000)   # hit A: MRU
        reach_pt._cached_memo(model, ps[2], 100_000)   # insert C, evict B
        reach_pt._cached_memo(model, ps[0], 100_000)   # A still hits
    assert cap.counters.get("memo_cache.hit") == 2
    assert cap.counters.get("memo_cache.miss") == 3
    assert cap.counters.get("memo_cache.evict") == 1
    with obs.capture() as cap2:
        reach_pt._cached_memo(model, ps[1], 100_000)   # B was evicted
    assert cap2.counters.get("memo_cache.miss") == 1


def _store_aged(model, n, seed0=100):
    """``n`` new alphabets stored one after another, each entry's mtime a
    second later than the one before; their file names, oldest first."""
    d = None
    names = []
    for i in range(n):
        packed = _packed(seed0 + i, 30 + 10 * i)
        reach_pt._cached_memo(model, packed, 100_000)
        keys = tuple(sorted(h_pt.op_keys_of(packed),
                            key=reach_pt._op_sort_key))
        path, _rep = reach_pt._disk_memo_path((model, 100_000, keys))
        d = os.path.dirname(path)
        os.utime(path, (1_000_000 + i, 1_000_000 + i))
        names.append(os.path.basename(path))
    return d, names


def test_disk_memo_eviction_past_the_cap(tmp_path, monkeypatch):
    """Past ``_DISK_MEMO_MAX_ENTRIES`` the oldest entries go, down to
    ``_DISK_MEMO_KEEP`` of the cap: at a cap of 4, the fifth store leaves
    the three newest entries."""
    _persist_on(monkeypatch, tmp_path)
    monkeypatch.setattr(reach_pt, "_DISK_MEMO_MAX_ENTRIES", 4)
    model = m_pt.cas_register()
    with obs.capture() as cap:
        d, names = _store_aged(model, 5)
    assert cap.counters.get("memo_cache.disk.store") == 5
    assert cap.counters.get("memo_cache.disk.evict") == 2
    assert sorted(os.listdir(d)) == sorted(names[2:])


def test_disk_memo_lists_its_directory_once_a_batch(tmp_path, monkeypatch):
    """Stores below the cap never list the memo directory after the
    first, and past it one listing evicts a batch: 12 stores at a cap of
    4 list it once to count it and once a batch, not at every store, and
    leave the four newest entries."""
    _persist_on(monkeypatch, tmp_path)
    monkeypatch.setattr(reach_pt, "_DISK_MEMO_MAX_ENTRIES", 4)
    listed = []
    real = os.listdir
    monkeypatch.setattr(os, "listdir",
                        lambda p=".": listed.append(p) or real(p))
    model = m_pt.cas_register()
    with obs.capture() as cap:
        d, names = _store_aged(model, 12)
    memo_lists = [p for p in listed if os.path.samefile(p, d)]
    # the first store counts the directory; stores 5, 7, 9 and 11 pass
    # the cap and list it, each evicting the two oldest down to 3
    assert len(memo_lists) == 1 + 4
    assert cap.counters.get("memo_cache.disk.evict") == 4 * 2
    assert sorted(real(d)) == sorted(names[8:])


# -- the two packages' entries --------------------------------------------

def test_packages_keep_separate_entries(tmp_path, monkeypatch):
    """The same alphabet under one cache dir: one file a package (the
    model's module is in the key), the same table in both, and neither
    package reads the other's file."""
    _persist_on(monkeypatch, tmp_path)
    hist = fx_ref.gen_history("cas", n_ops=60, processes=3, seed=7)
    p_ref = h_ref.pack(hist)
    p_pt = h_pt.pack(fx_pt.gen_history("cas", n_ops=60, processes=3,
                                       seed=7))
    m_r = reach_ref._cached_memo(m_ref.cas_register(), p_ref, 100_000)
    m_p = reach_pt._cached_memo(m_pt.cas_register(), p_pt, 100_000)
    np.testing.assert_array_equal(m_r.table, m_p.table)
    assert m_r.initial == m_p.initial
    files = sorted((tmp_path / "memo").glob("*.memo.pkl"))
    assert len(files) == 2
    path_pt = reach_pt._disk_memo_path(
        (m_pt.cas_register(), 100_000, tuple(sorted(
            h_pt.op_keys_of(p_pt), key=reach_pt._op_sort_key))))[0]
    os.unlink(path_pt)                  # only the reference's is left
    _clear_memo_state()
    with obs.capture() as cap:
        again = reach_pt._cached_memo(m_pt.cas_register(), p_pt, 100_000)
    assert cap.counters.get("memo_cache.disk.miss") == 1
    assert "memo_cache.disk.hit" not in cap.counters
    np.testing.assert_array_equal(again.table, m_p.table)
    os.unlink(next(f for f in files if str(f) != path_pt))
    reach_ref._MEMO_CACHE.clear()       # only the port's is left
    from jepsen_tpu import obs as obs_ref
    with obs_ref.capture() as cap_r:
        reach_ref._cached_memo(m_ref.cas_register(), p_ref, 100_000)
    assert cap_r.counters.get("memo_cache.disk.miss") == 1
    assert "memo_cache.disk.hit" not in cap_r.counters


def test_disk_round_trip_equals_reference(tmp_path, monkeypatch):
    """A memo read back from each package's disk tier equals the other
    package's, in table, initial state and states."""
    _persist_on(monkeypatch, tmp_path)
    mp = [h_ref.pack(fx_ref.gen_history("cas", n_ops=80, processes=4,
                                        seed=3)),
          h_pt.pack(fx_pt.gen_history("cas", n_ops=80, processes=4,
                                      seed=3))]
    models = (m_ref.cas_register(), m_pt.cas_register())
    for r, m, p in zip(PKGS, models, mp):
        r._cached_memo(m, p, 100_000)
        with r._MEMO_CACHE_LOCK:
            r._MEMO_CACHE.clear()
    back = [r._cached_memo(m, p, 100_000) for r, m, p in zip(PKGS, models,
                                                             mp)]
    np.testing.assert_array_equal(back[0].table, back[1].table)
    assert back[0].initial == back[1].initial
    assert [str(s) for s in back[0].states] == \
        [str(s) for s in back[1].states]


# -- superset seeds -------------------------------------------------------

def _seed_both(seeds, n_ops=200):
    """Both packages seeded from cold on the same packed list; returns
    the two lists."""
    lists = ([h_ref.pack(fx_ref.gen_history("cas", n_ops=n_ops, processes=4,
                                            seed=s)) for s in seeds],
             [h_pt.pack(fx_pt.gen_history("cas", n_ops=n_ops, processes=4,
                                          seed=s)) for s in seeds])
    reach_ref._seed_union_memo(m_ref.cas_register(), lists[0], 100_000)
    reach_pt._seed_union_memo(m_pt.cas_register(), lists[1], 100_000)
    return lists


@pytest.mark.parametrize("seed,n_ops", [(2, 40), (5, 30), (11, 24)])
def test_projection_from_seeds_equals_reference(seed, n_ops):
    """A subset history's memo projected from each package's seed is the
    same table, initial state and states, and its exact-cache entry
    serves the next lookup the same table."""
    _seed_both(range(40, 48))
    assert len(reach_pt._SUPERSET_SEEDS) == 1
    (sig_r, (su_r, *_)), = reach_ref._SUPERSET_SEEDS.items()
    (sig_p, (su_p, *_)), = reach_pt._SUPERSET_SEEDS.items()
    np.testing.assert_array_equal(su_r.table, su_p.table)
    p_r = h_ref.pack(fx_ref.gen_history("cas", n_ops=n_ops, processes=3,
                                        seed=seed))
    p_p = h_pt.pack(fx_pt.gen_history("cas", n_ops=n_ops, processes=3,
                                      seed=seed))
    with obs.capture() as cap:
        got = reach_pt._cached_memo(m_pt.cas_register(), p_p, 100_000)
    want = reach_ref._cached_memo(m_ref.cas_register(), p_r, 100_000)
    assert cap.counters.get("memo_cache.miss") == 1
    np.testing.assert_array_equal(got.table, want.table)
    assert got.initial == want.initial
    assert [str(s) for s in got.states] == [str(s) for s in want.states]
    with obs.capture() as cap2:
        hit = reach_pt._cached_memo(m_pt.cas_register(), p_p, 100_000)
    assert cap2.counters.get("memo_cache.hit") == 1
    np.testing.assert_array_equal(hit.table, got.table)


def test_memo_for_ops_projects_and_seed_bound():
    """``_memo_for_ops`` over a covered op tuple projects from the seed
    (no BFS), and a union past ``_SUPERSET_MAX_STATES`` seeds nothing and
    is remembered as failed, in both packages."""
    lists = _seed_both(range(40, 44))
    ops = lists[1][0].distinct_ops
    calls = []
    real = reach_pt.memo_ops

    def counting(*a, **k):
        calls.append(len(a[1]))
        return real(*a, **k)

    import unittest.mock as um
    with um.patch.object(reach_pt, "memo_ops", counting):
        m = reach_pt._memo_for_ops(m_pt.cas_register(), ops, 100_000)
    assert calls == []
    ref = reach_ref._memo_for_ops(m_ref.cas_register(),
                                  lists[0][0].distinct_ops, 100_000)
    np.testing.assert_array_equal(m.table, ref.table)
    for r, mod in zip(PKGS, (m_ref, m_pt)):
        before = dict(r._SUPERSET_SEEDS)
        wide = [(h_ref if r is reach_ref else h_pt).pack(
            (fx_ref if r is reach_ref else fx_pt).gen_history(
                "cas", n_ops=400, processes=4, seed=1, values=40))]
        with um.patch.object(r, "_SUPERSET_MAX_STATES", 8):
            r._seed_union_memo(mod.cas_register(), wide, 100_000)
        assert r._SUPERSET_SEEDS == before
        assert len(r._SUPERSET_SEEDS_FAILED) == 1


# -- check_many: one union BFS --------------------------------------------

def _independent_both(n_keys, n_ops, seed):
    """``n_keys`` keys' cas histories in both packages, packed: the
    independent checker's per-key batch."""
    return ([h_ref.pack(fx_ref.gen_history("cas", n_ops=n_ops, processes=3,
                                           seed=seed + k))
             for k in range(n_keys)],
            [h_pt.pack(fx_pt.gen_history("cas", n_ops=n_ops, processes=3,
                                         seed=seed + k))
             for k in range(n_keys)])


def _count_bfs(monkeypatch, module):
    calls = []
    real = module.memo_ops

    def counting(*a, **k):
        calls.append(len(a[1]))
        return real(*a, **k)

    monkeypatch.setattr(module, "memo_ops", counting)
    return calls


@pytest.mark.parametrize("route", ["lockstep", "per-history"])
def test_check_many_runs_one_union_bfs(monkeypatch, route):
    """64 keys: the port's ``check_many`` runs one BFS, over the union
    (the lockstep lane's union prep, or the seed of the per-history
    route, from which every key's memo and the keyed operands' union
    are projected), and its verdicts equal the reference's."""
    ps_ref, ps_pt = _independent_both(64, 30, seed=3)
    if route == "per-history":
        monkeypatch.setattr(reach_pt, "_check_many_lockstep",
                            lambda *a, **k: None)
        monkeypatch.setattr(reach_pt, "_check_many_native",
                            lambda *a, **k: None)
    calls = _count_bfs(monkeypatch, reach_pt)
    with obs.capture() as cap:
        got = reach_pt.check_many(m_pt.cas_register(), ps_pt, device="cpu")
    union = len({k for p in ps_pt for k in h_pt.op_keys_of(p)})
    assert calls == [union]
    want = reach_ref.check_many(m_ref.cas_register(), ps_ref)
    assert [r["valid"] for r in got] == [r["valid"] for r in want]
    causes = [r.get("cause") for r in cap.ledger
              if r["stage"] == "reach-many" and r["event"] == "route"]
    assert causes == ([route] if route == "lockstep" else ["keyed"])
    assert len(reach_pt._SUPERSET_SEEDS) == (route == "per-history")

"""The keyed walk (kernel K3's module) and the ``independent`` checker
against the reference, on the CPU.

The reference's Pallas keyed kernel runs in interpret mode; the port's
``keyed_walk`` runs its plain PyTorch version (all keys in lockstep),
which the CUDA kernel is held against on the card by ``chip_smoke.py``.
The checker comparison runs the same multi-key histories through
``independent.checker(linearizable(...))`` in both packages; on the CPU
the reference checks the keys with its vmapped batch, the port with its
lockstep lane (K2's plain version), its native keyed lane or the keyed
walk. Verdicts, failing keys, failing ops, dead events and witnesses
must be equal exactly. A union lane answers a valid key in the union
geometry (the union's states, the key's slots and events under the
union's no-op drops): every key's result of such a route is also held
against the reference's own ``_union_results_parts`` on the port's dead
vector.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import independent as ind_ref
from jepsen_tpu.checkers import events as ev_ref
from jepsen_tpu.checkers import facade as fa_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.checkers import reach_lane as lane_ref
from jepsen_tpu.history import pack
from jepsen_tpu_torch import Linearizable, independent, obs
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_batch as rb_pt
from jepsen_tpu_torch.checkers import reach_lane as lane_pt
from jepsen_tpu_torch.checkers import reach_pallas as pallas_pt

# tiny tensors: one thread each keeps the parallel test workers from
# crowding each other's cores
torch.set_num_threads(1)

PER_KEY = ("valid", "op", "dead-event", "max-linearized", "final-configs",
           "previous-ok", "events", "slots", "states")


def _keyed_history(fx, kind, n_keys, n_ops, processes, bad, crash_p=0.0):
    """``n_keys`` single-key histories, values wrapped as ``[key, v]``
    (each key with its own processes), concatenated; keys in ``bad``
    corrupted."""
    out = []
    for k in range(n_keys):
        hk = fx.gen_history(kind, n_ops=n_ops, processes=processes, seed=k,
                            crash_p=crash_p)
        if k in bad:
            hk = fx.corrupt(hk, seed=k)
        out += [op.with_(process=k * processes + op.process,
                         value=[k, op.value]) for op in hk]
    return [op.with_(index=i, time=i) for i, op in enumerate(out)]


def _keyed_operands(kind, n_keys, n_ops, processes, bad, crash_p=0.0):
    """The reference's flat keyed operands over the union alphabet."""
    model = fx_ref.model_for(kind)
    reach_ref._MEMO_CACHE.clear()
    packed = []
    for k in range(n_keys):
        hk = fx_ref.gen_history(kind, n_ops=n_ops, processes=processes,
                                seed=k, crash_p=crash_p)
        packed.append(pack(fx_ref.corrupt(hk, seed=k) if k in bad else hk))
    preps = [reach_ref._prep(model, p, max_states=100_000, max_slots=20,
                             max_dense=1 << 22) for p in packed]
    W = max(max(p[1].W, 1) for p in preps)
    rss = [ev_ref.returns_view(p[1]) for p in preps]
    P, ret, ops, key, _off, _wide = reach_ref._keyed_operands(
        model, packed, rss, list(range(n_keys)), W, 100_000)
    return P, ret, ops, key, 1 << W


@pytest.mark.parametrize("kind,n_keys,processes,bad,crash_p", [
    ("cas", 9, 3, {1, 4, 8}, 0.0),
    ("cas", 6, 4, {2}, 0.1),             # crashed ops widen the union W
    ("register", 7, 3, {0, 6}, 0.0),
    ("mutex", 5, 3, set(), 0.0)])
def test_keyed_walk_matches_reference(kind, n_keys, processes, bad, crash_p):
    """``dead[]`` of the port's keyed walk (and of its plain version on
    the same tensors) equals the reference's interpret-mode kernel."""
    P, ret, ops, key, M = _keyed_operands(kind, n_keys, 40, processes, bad,
                                          crash_p)
    d_ref = lane_ref.walk_returns_keyed(P, ret, ops, key, n_keys, M,
                                        interpret=True)
    d_pt = lane_pt.walk_returns_keyed(P, ret, ops, key, n_keys, M,
                                      device="cpu")
    np.testing.assert_array_equal(d_pt, d_ref)
    assert int((d_pt >= 0).sum()) == len(bad)
    W = ops.shape[1]
    t = [torch.as_tensor(np.ascontiguousarray(a, dt)) for a, dt in
         ((P, np.float32), (ret, np.int32), (ops, np.int32),
          (key, np.int32))]
    np.testing.assert_array_equal(
        lane_pt.keyed_walk_plain(*t, n_keys, W).numpy(), d_ref)


def test_keyed_runs_are_checked():
    """Keys with no returns report -1; a key whose returns are split
    over two runs, or an id past ``n_keys``, is refused."""
    P, ret, ops, key, M = _keyed_operands("cas", 3, 30, 3, {1})
    d = lane_pt.walk_returns_keyed(P, ret, ops, key, 5, M, device="cpu")
    assert list(d[3:]) == [-1, -1] and d[1] >= 0
    split = key.copy()
    split[0] = 2
    with pytest.raises(ValueError, match="contiguous"):
        lane_pt.walk_returns_keyed(P, ret, ops, split, 3, M, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        lane_pt.walk_returns_keyed(P, ret, ops, key, 2, M, device="cpu")


def _ref_union_results(kind, history, r_pt, engine):
    """The reference's ``_union_results_parts`` over the keys of
    ``history`` (packed as the independent checker packs them), on the
    dead vector of the port's results ``r_pt`` (a failed key's
    ``max-linearized`` is its dead return): ``{key: result}``."""
    model = fx_ref.model_for(kind)
    subs = ind_ref.split_history(history)
    keys = sorted(subs, key=repr)
    packed = [pack(subs[k]) for k in keys]
    live = [i for i, p in enumerate(packed) if p.n and p.n_ok]
    sa = reach_ref._union_stage_a(model, packed, live, 100_000)
    _r, _o, key_W, key_R, _off, _W = reach_ref._union_pack_group(
        sa, range(len(live)), 20)
    dead = np.array([-1 if r_pt["results"][keys[i]]["valid"] else
                     r_pt["results"][keys[i]]["max-linearized"]
                     for i in live])
    out = reach_ref._union_results_parts(
        engine, model, packed, live, dead, sa.memo_u, key_W, key_R,
        sa.drop_per_key(), 0.0, 100_000, 20, 1 << 22)
    return dict(zip(keys, out))


def _check_both(kind, n_keys, n_ops, processes, bad, crash_p=0.0,
                algorithm="auto", union=None):
    """Both packages' independent checks of one keyed history. With
    ``union`` (the engine of a union lane) every key's result is also the
    reference's union accounting, and only its verdict fields are held
    against the reference's check."""
    h1 = _keyed_history(fx_ref, kind, n_keys, n_ops, processes, bad,
                        crash_p)
    h2 = _keyed_history(fx_pt, kind, n_keys, n_ops, processes, bad,
                        crash_p)
    reach_ref._MEMO_CACHE.clear()
    r_ref = ind_ref.checker(fa_ref.linearizable(
        fx_ref.model_for(kind), algorithm=algorithm)).check(None, h1)
    with obs.capture() as cap:
        r_pt = independent.checker(Linearizable(
            fx_pt.model_for(kind), algorithm=algorithm,
            device="cpu")).check(None, h2)
    for k in ("valid", "failures", "key-count"):
        assert r_pt[k] == r_ref[k], k
    assert set(r_pt["results"]) == set(r_ref["results"])
    fields = PER_KEY
    if union is not None:
        fields = tuple(x for x in PER_KEY
                       if x not in ("events", "slots", "states"))
        for key, a in _ref_union_results(kind, h1, r_pt, union).items():
            b = r_pt["results"][key]
            diff = {x: (a.get(x), b.get(x)) for x in
                    PER_KEY + ("engine", "dropped-crashed-noops")
                    if a.get(x) != b.get(x)}
            assert not diff, (key, diff)
    for key, a in r_ref["results"].items():
        b = r_pt["results"][key]
        diff = {x: (a.get(x), b.get(x)) for x in fields
                if a.get(x) != b.get(x)}
        assert not diff, (key, diff)
    return r_pt, cap


@pytest.mark.parametrize("kind,n_keys,processes,bad,crash_p", [
    ("cas", 10, 4, {3, 7}, 0.0),
    ("cas", 8, 3, {0, 5}, 0.05),
    ("register", 8, 4, {2}, 0.0),
    ("mutex", 6, 3, set(), 0.0)])
def test_independent_matches_reference(monkeypatch, kind, n_keys, processes,
                                       bad, crash_p):
    """The reference's CPU batch seeds one union memo and projects each
    key's memo from it; the port builds each key's memo cold. The seed
    is kept out so both number the states the same way, which the
    witnesses' order of ``final-configs`` depends on."""
    for r in (reach_ref, reach_pt):      # no seeds, none left over
        monkeypatch.setattr(r, "_seed_union_memo", lambda *a: None)
        r._SUPERSET_SEEDS.clear()
    r_pt, cap = _check_both(kind, n_keys, 40, processes, bad, crash_p,
                            union="reach-lockstep")
    assert r_pt["valid"] is (not bad)
    assert [r.get("cause") for r in cap.ledger
            if r["event"] == "route"] == ["lockstep"]
    assert {r["engine"] for r in r_pt["results"].values()} == \
        {"reach-lockstep"}
    for key in r_pt["failures"]:
        assert r_pt["results"][key]["final-configs"]


def test_reach_algorithm_and_per_history_route(monkeypatch):
    """With ``algorithm="reach"`` the batch stays on the dense engine;
    when the union alphabet fits neither the lockstep kernel nor a keyed
    one, every key goes through the single-history check, with the same
    results."""
    for r in (reach_ref, reach_pt):      # no seeds, none left over
        monkeypatch.setattr(r, "_seed_union_memo", lambda *a: None)
        r._SUPERSET_SEEDS.clear()
    monkeypatch.setattr(rb_pt, "fits", lambda *a: False)
    monkeypatch.setattr(lane_pt, "keyed_fits", lambda *a: False)
    monkeypatch.setattr(pallas_pt, "fits", lambda *a: False)
    r_pt, cap = _check_both("cas", 6, 40, 3, {1, 4}, algorithm="reach")
    routes = [r.get("cause") for r in cap.ledger if r["event"] == "route"
              and r["stage"] == "reach-many"]
    assert routes == ["per-history"]
    assert {r["engine"] for r in r_pt["results"].values()} == \
        {"reach-lane"}
    skipped = {r["stage"]: r["cause"] for r in cap.skipped()}
    assert skipped["reach-lockstep"] == "geometry"
    assert skipped["reach-native-keyed"] == "geometry"
    assert skipped["reach-keyed"] == "DenseOverflow"
    assert skipped["reach-vmapped"] == "not-ported"


def test_wide_keyed_route(monkeypatch):
    """When neither K2 nor K3 takes the union alphabet, K5 does, through
    the native keyed lane (route cause ``keyed-wide``), with the
    reference's results for every key."""
    for r in (reach_ref, reach_pt):      # no seeds, none left over
        monkeypatch.setattr(r, "_seed_union_memo", lambda *a: None)
        r._SUPERSET_SEEDS.clear()
    monkeypatch.setattr(rb_pt, "fits", lambda *a: False)
    monkeypatch.setattr(lane_pt, "keyed_fits", lambda *a: False)
    r_pt, cap = _check_both("cas", 6, 40, 3, {1, 4}, union="reach-keyed")
    assert [r.get("cause") for r in cap.ledger if r["event"] == "route"
            and r["stage"] == "reach-many"] == ["keyed-wide"]
    assert {r["engine"] for r in r_pt["results"].values()} == \
        {"reach-keyed"}
    assert sorted(r_pt["failures"]) == [1, 4]


def test_overflow_falls_back_per_history():
    """A key too concurrent for the dense engine sends the batch to the
    per-history chain (recorded), which decides every key."""
    h = _keyed_history(fx_pt, "cas", 4, 30, 4, {2})
    with obs.capture() as cap:
        res = independent.checker(Linearizable(
            fx_pt.model_for("cas"), device="cpu",
            opts={"max_slots": 2})).check(None, h)
    assert res["valid"] is False and res["failures"] == [2]
    assert ("reach-many", "ConcurrencyOverflow") in {
        (r["stage"], r["cause"]) for r in cap.fallbacks()}


def test_abort_before_dispatch():
    """``should_abort`` is consulted once, before anything runs."""
    from jepsen_tpu_torch import history as h_pt

    res = reach_pt.check_many(
        fx_pt.model_for("cas"),
        [h_pt.pack(fx_pt.gen_history("cas", n_ops=20, processes=2, seed=0))],
        should_abort=lambda: True, device="cpu")
    assert res == [{"valid": "unknown", "cause": "aborted",
                    "engine": "reach-batch"}]


def test_split_history_and_ktuple():
    h = _keyed_history(fx_pt, "register", 3, 10, 2, set())
    subs = independent.split_history(h)
    assert sorted(subs) == [0, 1, 2]
    assert all(not independent.is_ktuple(op.value) or op.f == "write"
               for ops in subs.values() for op in ops)
    assert independent.ktuple("k", 1) == ["k", 1]
    ref = ind_ref.split_history(_keyed_history(fx_ref, "register", 3, 10,
                                               2, set()))
    assert {k: [o.to_dict() for o in v] for k, v in subs.items()} == \
        {k: [o.to_dict() for o in v] for k, v in ref.items()}


def test_keyed_walk_routes_by_device(monkeypatch):
    """``keyed_walk`` takes the plain version only for CPU tensors; any
    other device is the kernel's or an error, never the plain version."""
    calls = []
    monkeypatch.setattr(lane_pt, "keyed_walk_plain",
                        lambda *a: calls.append("plain"))
    monkeypatch.setattr(lane_pt, "_keyed_launch",
                        lambda *a: calls.append("cuda"))
    t = torch.zeros(1)
    lane_pt.keyed_walk(t, t, t, t, 1, 1)
    assert calls == ["plain"]
    with pytest.raises(ValueError):
        lane_pt.keyed_walk(torch.zeros(1, device="meta"), t, t, t, 1, 1)
    assert calls == ["plain"]

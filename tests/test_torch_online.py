"""The port's online monitor (``checkers/online.py``, the C++ monitor
core of ``checkers/preproc_native.py``, ``core.run``'s online hook)
against the reference's, on the CPU (``device="cpu"``; the reference
under ``JAX_PLATFORMS=cpu``).

Both packages' engines are fed the same streams (the fixtures give the
same histories for the same seeds in both): their violation dicts,
settled-return counts and verdicts must be equal, and the final
incremental verdict must equal the post-hoc check's. No wall-clock
bounds: the work bound of a flush is checked structurally.
"""
import os

import numpy as np
import pytest

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu.checkers import online as on_ref
from jepsen_tpu.checkers import preproc_native as pn_ref
from jepsen_tpu_torch import core as core_pt
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import online as on_pt
from jepsen_tpu_torch.checkers import preproc_native as pn_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.suites import register as reg_pt


def _both(kind, n_ops, seed, processes=4, crash_p=0.0, corrupt=False):
    """The same history from both packages' fixtures: ``(port ops,
    reference ops)``, checked equal op for op."""
    out = []
    for fx in (fx_pt, fx_ref):
        h = fx.gen_history(kind, n_ops=n_ops, processes=processes,
                           seed=seed, crash_p=crash_p)
        if corrupt:
            try:
                h = fx.corrupt(h, seed=seed)
            except ValueError:
                pass
        out.append(h)
    assert [o.to_dict() for o in out[0]] == [o.to_dict() for o in out[1]]
    return out


def _ref_ops(ops):
    from jepsen_tpu.op import Op as OpRef
    return [OpRef.from_dict(o.to_dict()) for o in ops]


def _drive(eng, hist, every=32):
    """Feed ``hist`` op by op, advancing every ``every`` ops; terminal on
    the first violation. ``("overflow", None)`` on a capacity decline."""
    try:
        for i, op in enumerate(hist):
            eng.feed(op)
            if i % every == every - 1:
                v = eng.advance()
                if v is not None:
                    return "done", v
        return "done", eng.advance(run_over=True)
    except (on_pt._Overflow, on_ref._Overflow):
        return "overflow", None


# -- the monitor ----------------------------------------------------------

def test_valid_history_no_violation():
    hp, hr = _both("cas", 60, 2)
    out = []
    for mod, fx, h in ((on_pt, fx_pt, hp), (on_ref, fx_ref, hr)):
        mon = mod.OnlineLinearizable(fx.model_for("cas"))
        for op in h:
            mon.observe(op)
        mon.flush()
        out.append(mon.result())
    assert out[0] == out[1]
    assert out[0]["valid"] is True and out[0]["ops-checked"] == len(hp)


def test_violation_detected_mid_stream_and_sticky():
    hp, hr = _both("cas", 80, 3, corrupt=True)
    out = []
    for mod, fx, h in ((on_pt, fx_pt, hp), (on_ref, fx_ref, hr)):
        mon = mod.OnlineLinearizable(fx.model_for("cas"))
        first = None
        for i, op in enumerate(h):
            mon.observe(op)
            if i % 20 == 19:
                v = mon.flush()
                if v is not None and first is None:
                    first = v["prefix-ops"]
        mon.flush()
        res = mon.result()
        assert res["valid"] is False and res["op"]
        assert first is None or res["prefix-ops"] == first   # sticky
        out.append(res)
    assert out[0] == out[1]


def test_pending_invokes_are_not_false_alarms():
    h = fx_pt.gen_history("cas", n_ops=50, processes=5, seed=4)
    mon = on_pt.OnlineLinearizable(fx_pt.model_for("cas"))
    for i, op in enumerate(h):
        mon.observe(op)
        if i % 7 == 6:                  # flush at arbitrary cut points
            assert mon.flush() is None, f"false alarm at op {i}"
    mon.flush()
    assert mon.result()["valid"] is True


@pytest.mark.parametrize("seed", range(8))
def test_incremental_final_verdict_matches_posthoc(seed):
    """Streamed with run-over finalization, both Python engines' verdict
    equals the post-hoc dense check's (valid, corrupted, crashed)."""
    kind = ["cas", "register", "mutex"][seed % 3]
    hp, hr = _both(kind, 60, seed, crash_p=0.1 if seed % 2 else 0.0,
                   corrupt=seed in (1, 4))
    ref = reach_pt.check(fx_pt.model_for(kind), hp, device="cpu")
    got_pt = on_pt.IncrementalEngine(fx_pt.model_for(kind))
    got_ref = on_ref.IncrementalEngine(fx_ref.model_for(kind))
    vs = []
    for eng, h in ((got_pt, hp), (got_ref, hr)):
        v = None
        for op in h:
            eng.feed(op)
            v = v or eng.advance()
        vs.append(v or eng.advance(run_over=True))
    assert (vs[0] is None) == (ref["valid"] is True)
    assert vs[0] == vs[1]
    assert got_pt.settled_returns == got_ref.settled_returns


def test_flush_cost_independent_of_prefix_length():
    """Each settled return is walked once across the whole run: walked
    events equal the settled count, not flushes times prefix."""
    h = fx_pt.gen_history("cas", n_ops=4000, processes=4, seed=9)
    mon = on_pt.OnlineLinearizable(fx_pt.model_for("cas"))
    for i, op in enumerate(h):
        mon.observe(op)
        if i % 100 == 99:
            mon.flush()
    res = mon.stop()
    assert res["valid"] is True and res["ops-checked"] == len(h)
    eng = mon._engine
    assert isinstance(eng, on_pt.NativeStreamEngine)
    assert eng.walked_events == eng.settled_returns == res["settled-returns"]


def test_fail_completions_are_stripped():
    from jepsen_tpu_torch.op import fail, invoke, ok
    h = [invoke(0, "write", 0), ok(0, "write", 0),
         invoke(1, "write", 1),              # will fail
         invoke(2, "read"), ok(2, "read", 0),
         fail(1, "write", 1),
         invoke(2, "read"), ok(2, "read", 0)]
    for cls in (on_pt.IncrementalEngine, on_pt.NativeStreamEngine):
        eng = cls(fx_pt.model_for("register"))
        for op in h:
            eng.feed(op)
        assert eng.advance(run_over=True) is None
        assert eng.settled_returns == 3


def test_alphabet_and_slot_growth():
    """Late fresh values (memo rebuild, state re-encode) and wider
    concurrency (mask re-embed) keep the walk exact."""
    from jepsen_tpu_torch.op import invoke, ok
    h = [invoke(0, "write", 0), ok(0, "write", 0)]
    for i in range(10):
        h += [invoke(0, "write", i % 2), ok(0, "write", i % 2),
              invoke(0, "read"), ok(0, "read", i % 2)]
    h += [invoke(p, "write", 7 + p % 3) for p in range(1, 5)]
    h += [ok(p, "write", 7 + p % 3) for p in range(1, 5)]
    for last, want in ((9, None), (123, False)):
        hh = h + [invoke(0, "read"), ok(0, "read", last)]
        ref = reach_pt.check(fx_pt.model_for("register"), hh, device="cpu")
        assert (ref["valid"] is True) == (want is None)
        for cls in (on_pt.IncrementalEngine, on_pt.NativeStreamEngine):
            eng = cls(fx_pt.model_for("register"))
            for op in hh:
                eng.feed(op)
            v = eng.advance(run_over=True)
            assert (v is None) == (want is None), cls.__name__
            assert eng.W >= 4
        r_eng = on_ref.NativeStreamEngine(fx_ref.model_for("register"))
        r_eng.feed_many(_ref_ops(hh))
        assert r_eng.advance(run_over=True) == v


def test_incremental_violation_is_sticky_and_early():
    hp, _ = _both("cas", 200, 6, corrupt=True)
    mon = on_pt.OnlineLinearizable(fx_pt.model_for("cas"), min_new_ops=1)
    detected = None
    for i, op in enumerate(hp):
        mon.observe(op)
        if i % 10 == 9 and mon.flush() is not None and detected is None:
            detected = i
    res = mon.stop()
    assert res["valid"] is False and res["engine"] == "online-native"
    assert detected is not None and detected < len(hp)
    assert mon.flush() is mon.violation                  # sticky


def test_long_pending_op_bounds_flush_work():
    """One never-completing invoke queues every later return behind it;
    each flush's tail walk stays capped at the first ``_TAIL_CAP``
    items, and the final verdict is exact once the straggler resolves
    as crashed."""
    from jepsen_tpu_torch.op import invoke, ok
    h = [invoke(0, "write", 0), ok(0, "write", 0),
         invoke(99, "write", 1)]            # never completes
    for _ in range(1500):
        h += [invoke(1, "read"), ok(1, "read", 0)]
    eng = on_pt.IncrementalEngine(fx_pt.model_for("register"))
    calls = []
    real = eng._walk_batch

    def walk(R0, rows_list, slots):
        calls.append(len(rows_list))
        return real(R0, rows_list, slots)

    eng._walk_batch = walk
    for i, op in enumerate(h):
        eng.feed(op)
        if i % 500 == 499:
            assert eng.advance() is None
            assert eng.tail_alarm() is None
    assert len(eng._queue) > eng._TAIL_CAP      # genuinely backed up
    assert max(calls) == eng._TAIL_CAP          # capped, not the queue
    assert eng.advance(run_over=True) is None
    assert eng.settled_returns == 1501
    assert reach_pt.check(fx_pt.model_for("register"), h,
                          device="cpu")["valid"] is True


@pytest.mark.parametrize("trial", range(6))
def test_native_walk_matches_numpy_and_reference(trial):
    """``walk_dense`` (bit-packed C++) against the per-return numpy
    fixpoint ``_walk_return`` and the reference's binding, on random
    batches up to W = 8 (several u64 words): dead index and final set."""
    rng = np.random.default_rng(7 + trial)
    for _ in range(10):
        S = int(rng.integers(2, 9))
        W = int(rng.integers(1, 9))
        O = int(rng.integers(2, 6))
        M = 1 << W
        L = int(rng.integers(1, 40))
        T = rng.integers(-1, S, size=(S, O)).astype(np.int32)
        rows = rng.integers(-1, O, size=(L, W)).astype(np.int32)
        slots = rng.integers(0, W, size=L).astype(np.int32)
        R0 = rng.random((S, M)) < 0.3
        R0[0, 0] = True
        P = np.zeros((O, S, S), bool)
        s = np.arange(S)
        for o in range(O):
            okc = T[:, o] >= 0
            P[o, s[okc], T[okc, o]] = True
        R_ref, dead_ref = R0.copy(), -1
        for i in range(L):
            R_ref = on_pt._walk_return(R_ref, rows[i], int(slots[i]), P)
            if not R_ref.any():
                dead_ref = i
                break
        words = on_pt._pack_words(R0, M)
        words_ref = words.copy()
        dead = pn_pt.walk_dense(T, words, W, slots, rows)
        assert dead == dead_ref == pn_ref.walk_dense(T, words_ref, W,
                                                     slots, rows)
        assert (words == words_ref).all()
        if dead_ref < 0:
            np.testing.assert_array_equal(on_pt._unpack_words(words, M),
                                          R_ref)


@pytest.mark.parametrize("kind,n_ops,seeds,corrupt", [
    ("cas", 300, range(6), (1, 4)),
    ("register", 300, range(6), (0, 3)),
    ("mutex", 200, range(4), ())])
def test_native_stream_engine_against_reference(kind, n_ops, seeds,
                                                corrupt):
    """The port's C++-backed engine against the reference's and the
    port's Python engine, on valid, corrupted, crash-heavy streams: the
    same outcome (a capacity decline included), violation dict and
    settled count."""
    for seed in seeds:
        hp, hr = _both(kind, n_ops, seed, crash_p=0.05,
                       corrupt=seed in corrupt)
        a = on_pt.NativeStreamEngine(fx_pt.model_for(kind))
        b = on_ref.NativeStreamEngine(fx_ref.model_for(kind))
        c = on_pt.IncrementalEngine(fx_pt.model_for(kind))
        sa, va = _drive(a, hp)
        sb, vb = _drive(b, hr)
        sc, vc = _drive(c, hp)
        assert sa == sb == sc, (kind, seed)
        assert va == vb, (kind, seed)
        assert (va is None) == (vc is None)
        if va is not None:
            assert va["op"] == vc["op"], (kind, seed)
        if sa == "done":
            assert a.settled_returns == b.settled_returns


def test_tail_alarm_against_reference():
    """A violation stuck behind a never-resolving op is caught by every
    engine's tail alarm, with the reference's dict."""
    from jepsen_tpu_torch.op import invoke, ok
    h = [invoke(9, "write", 7),                    # forever pending
         invoke(0, "write", 1), ok(0, "write", 1),
         invoke(1, "read"), ok(1, "read", 2)]      # reads a ghost
    got = []
    for cls, fx, hh in ((on_pt.IncrementalEngine, fx_pt, h),
                        (on_pt.NativeStreamEngine, fx_pt, h),
                        (on_ref.NativeStreamEngine, fx_ref, _ref_ops(h))):
        eng = cls(fx.model_for("register"))
        for op in hh:
            eng.feed(op)
        assert eng.advance() is None       # queue blocked behind p9
        v = eng.tail_alarm()
        assert v is not None and v["valid"] is False, cls.__name__
        got.append(v)
    assert got[1] == got[2]
    assert got[0]["op"] == got[1]["op"]


def test_monitor_core_stats_drain_and_live():
    """The ``Monitor`` binding's stats, live set, tail and drain against
    the reference's on one stream."""
    from jepsen_tpu_torch.op import invoke, ok
    h = [invoke(0, "write", 1), invoke(1, "read"), ok(0, "write", 1),
         invoke(2, "write", 2), ok(1, "read", 1), invoke(0, "read")]
    engs = [on_pt.NativeStreamEngine(fx_pt.model_for("register")),
            on_ref.NativeStreamEngine(fx_ref.model_for("register"))]
    engs[0].feed_many(h)
    engs[1].feed_many(_ref_ops(h))
    out = []
    for e in engs:
        e._drain()
        m = e._mon
        live = m.live(8)
        tail = m.tail(8, e.W)
        stats = m.stats()
        drained = m.drain(8, e.W)
        out.append([stats, m.stats()] + [a.tolist() for a in live]
                   + [a.tolist() for a in tail]
                   + [a.tolist() for a in drained])
    assert out[0] == out[1]
    assert out[0][0][2] == 2                        # two live invocations


def test_monitor_rejects_bad_operands():
    mon = pn_pt.Monitor(8)
    with pytest.raises(ValueError):
        mon.feed(np.zeros(2), np.zeros(3), np.zeros(2))
    with pytest.raises(ValueError):
        mon.advance(np.zeros((2, 2), np.int32), np.zeros((3, 1), np.uint64))
    with pytest.raises(ValueError):
        pn_pt.walk_dense(np.zeros((2, 2), np.int32),
                         np.zeros((2, 1), np.uint64), 7,
                         np.zeros(1, np.int32), np.zeros((1, 7), np.int32))


# -- capacity declines, recheck mode and faults ----------------------------

def test_overflow_moves_to_recheck_with_route_record():
    """A slot overflow is a capacity decline: one ``online-incremental``
    route record, the re-check (C++ WGL) from there on, the reference's
    verdict."""
    hp, hr = _both("cas", 150, 13, crash_p=0.10)
    out = []
    with obs.capture() as cap:
        mon = on_pt.OnlineLinearizable(fx_pt.model_for("cas"), max_slots=4)
        for op in hp:
            mon.observe(op)
        mon.flush()
        out.append(mon.stop())
    routes = [d for d in cap.ledger if d["stage"] == "online-incremental"]
    assert len(routes) == 1 and routes[0]["event"] == "route"
    assert routes[0]["cause"] == "overflow:_Overflow"
    assert mon._engine is None
    ref = on_ref.OnlineLinearizable(fx_ref.model_for("cas"), max_slots=4)
    for op in hr:
        ref.observe(op)
    ref.flush()
    out.append(ref.stop())
    assert out[0]["valid"] == out[1]["valid"]
    assert out[0].get("op") == out[1].get("op")


@pytest.mark.parametrize("algorithm", [None, "reach"])
def test_recheck_mode_on_the_cpu(algorithm):
    """``mode="recheck"`` through the port's facade on ``device="cpu"``:
    the reference's verdict and failing op at every flush."""
    kw = {} if algorithm is None else {"algorithm": algorithm}
    hp, hr = _both("cas", 120, 1, corrupt=True)
    mon = on_pt.OnlineLinearizable(fx_pt.model_for("cas"), mode="recheck",
                                   device="cpu", **kw)
    ref = on_ref.OnlineLinearizable(fx_ref.model_for("cas"),
                                    mode="recheck", **kw)
    for i in range(0, len(hp), 40):
        for op in hp[i:i + 40]:
            mon.observe(op)
        for op in hr[i:i + 40]:
            ref.observe(op)
        a, b = mon.flush(), ref.flush()
        assert (a is None) == (b is None)
        if a is not None:
            assert a["op"] == b["op"] and a["prefix-ops"] == b["prefix-ops"]
    assert mon.stop()["valid"] is False


def test_flush_fault_stops_the_monitor_and_stop_raises(monkeypatch):
    """A non-capacity fault in a flush is not swallowed: the monitor's
    thread stops keeping it, and ``stop()`` raises it."""
    def boom(self, run_over=False):
        raise RuntimeError("injected flush fault")

    monkeypatch.setattr(on_pt.NativeStreamEngine, "advance", boom)
    mon = on_pt.OnlineLinearizable(fx_pt.model_for("cas"), interval_s=0.01,
                                   min_new_ops=1).start()
    for op in fx_pt.gen_history("cas", n_ops=20, processes=2, seed=0):
        mon.observe(op)
    mon._thread.join(10)
    assert not mon._thread.is_alive()
    assert isinstance(mon.error, RuntimeError)
    with pytest.raises(RuntimeError, match="injected flush fault"):
        mon.stop()
    with pytest.raises(RuntimeError, match="injected flush fault"):
        mon.flush()                     # a caller's flush raises it too


# -- runs -----------------------------------------------------------------

def test_run_with_online_check_fails_fast():
    t = reg_pt.register_test(mode="sloppy", time_limit=8.0, seed=11,
                             with_nemesis=True, nemesis_interval=0.25,
                             concurrency=5, device="cpu")
    t["online-check"] = True
    t["online-opts"] = {"interval_s": 0.3, "min_new_ops": 64}
    with obs.capture():
        done = core_pt.run(t)
    online = done["results"]["online-check"]
    hist = done["history"]
    assert online["valid"] is False and online["engine"] == "online-native"
    assert online["prefix-ops"] <= len(hist)
    # fail-fast: only in-flight ops land after the detection
    assert len(hist) <= online["prefix-ops"] + 2000
    assert done["results"]["valid"] is False
    assert done["results"]["results"]["linear"]["valid"] is False
    # the violation is the one NativeStreamEngine finds on the stored
    # history's detected prefix, as the reference's engine finds it
    eng = on_pt.NativeStreamEngine(fx_pt.model_for("cas"))
    r_eng = on_ref.NativeStreamEngine(fx_ref.model_for("cas"))
    prefix = hist[:online["prefix-ops"]]
    eng.feed_many(prefix)
    r_eng.feed_many(_ref_ops(prefix))
    v = eng.advance() or eng.tail_alarm()
    assert v == (r_eng.advance() or r_eng.tail_alarm())
    assert v is not None and v["op"] == online["op"]


def test_valid_run_with_online_check():
    t = reg_pt.register_test(mode="linearizable", time_limit=1.2, seed=7,
                             with_nemesis=False, concurrency=4,
                             device="cpu")
    t["online-check"] = True
    t["online-opts"] = {"interval_s": 0.2, "min_new_ops": 64}
    done = core_pt.run(t)
    online = done["results"]["online-check"]
    assert online["valid"] is True and online["flushes"] >= 1
    assert online["ops-checked"] == len(done["history"])
    assert done["results"]["results"]["linear"]["valid"] is True


def test_online_check_without_model_is_disabled(caplog):
    """A test map without a model runs unmonitored, with a warning."""
    from jepsen_tpu_torch.tests_base import noop_test
    t = noop_test()
    t.update({"online-check": True, "store": False})
    done = core_pt.run(t)
    assert "online-check" not in done["results"]
    assert "monitoring disabled" in caplog.text


def test_run_monitor_fault_propagates_after_history(monkeypatch, tmp_path):
    """A non-capacity fault in a flush propagates out of ``core.run``,
    with ``history.jsonl`` already on disk."""
    def boom(self, run_over=False):
        raise RuntimeError("injected monitor fault")

    monkeypatch.setattr(on_pt.NativeStreamEngine, "advance", boom)
    t = reg_pt.register_test(n_ops=40, store=True, device="cpu",
                             with_nemesis=False)
    t["store-root"] = str(tmp_path)
    t["online-check"] = True
    t["online-opts"] = {"interval_s": 0.05, "min_new_ops": 4}
    with pytest.raises(RuntimeError, match="injected monitor fault"):
        core_pt.run(t)
    found = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path)
             for f in fs if f == "history.jsonl"]
    assert found and os.path.getsize(found[0]) > 0


def test_cli_run_online(tmp_path, capsys):
    """``run --online`` on the CPU: the sloppy run stops early with the
    violation and exits 1, as the reference's command does."""
    import json

    from jepsen_tpu_torch import cli as cli_pt
    rc = cli_pt.main(["run", "--suite", "register", "--mode", "sloppy",
                      "--online", "--time-limit", "8", "--seed", "11",
                      "--store-root", str(tmp_path), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and line["valid"] is False
    with open(os.path.join(line["dir"], "results.json")) as f:
        res = json.load(f)
    assert res["online-check"]["valid"] is False
    assert line["ops"] <= res["online-check"]["prefix-ops"] + 2000


def test_entry_points_want_the_card(monkeypatch):
    """Without ``device`` the recheck mode's device engines want the
    card; the incremental mode is host work and needs none."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = fx_pt.gen_history("cas", n_ops=20, processes=2, seed=0)
    mon = on_pt.OnlineLinearizable(fx_pt.model_for("cas"))
    for op in h:
        mon.observe(op)
    assert mon.stop()["valid"] is True
    mon = on_pt.OnlineLinearizable(fx_pt.model_for("cas"), mode="recheck",
                                   algorithm="reach")
    for op in h:
        mon.observe(op)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mon.flush()

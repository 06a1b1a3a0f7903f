"""The port's generators (``jepsen_tpu_torch/generators.py``) against the
reference's (``jepsen_tpu/generators.py``): every combinator, drawn on
one thread with fixed process ids and seeds, gives the reference's
sequence of op sketches; then the cases of ``tests/test_generators.py``
on the port. Host Python only: no device is involved."""
import itertools
import threading
import time

import pytest

from jepsen_tpu import generators as g_ref
from jepsen_tpu_torch import generators as g_pt

TEST = {"concurrency": 2}
# the draw order: two clients, then the nemesis, then a successor
PROCS = (0, 1, "nemesis", 2)


def draw(gen, procs=PROCS, test=TEST, cap=2_000):
    """``(process, sketch)`` for ``cap`` draws over ``procs`` in turn, up
    to the first round in which every process saw exhaustion."""
    out, dry = [], 0
    for p in itertools.islice(itertools.cycle(procs), cap):
        s = gen.op(test, p)
        out.append((p, s))
        dry = dry + 1 if s is None else 0
        if dry == len(procs):
            break
    return out


def _keys(g):
    return ["a", "b", "c", "d", "e"]


def _w(g, v=0):
    return g.Fn(lambda: {"f": "w", "value": v})


# each builds one generator tree from a generators module; the seeds fix
# every random choice
CASES = {
    "gen-promotion": lambda g: g.Seq([g.gen({"f": "a"}), g.gen(None),
                                      g.gen([{"f": "b"}, {"f": "c"}]),
                                      g.gen(lambda: None)]),
    "once": lambda g: g.Once({"f": "read"}),
    "void": lambda g: g.Void(),
    "repeat": lambda g: g.Repeat({"f": "r"}, 5),
    "fn-two-args": lambda g: g.limit(6, g.Fn(
        lambda test, p: {"f": "p", "value": p})),
    "seq": lambda g: g.seq({"f": "a"}, g.limit(2, _w(g)), {"f": "c"}),
    "concat": lambda g: g.concat(g.Repeat({"f": "x"}, 2),
                                 g.Repeat({"f": "y"}, 2)),
    "then": lambda g: g.then(g.seq({"f": "a"}), g.seq({"f": "b"})),
    "cycle-factory": lambda g: g.limit(9, g.cycle(
        lambda: g.seq({"f": "a"}, {"f": "b"}))),
    "cycle-times": lambda g: g.cycle({"f": "a"}, times=4),
    "register_workload": lambda g: g.limit(300, g.register_workload(
        seed=7)),
    "register_workload-hi": lambda g: g.limit(300, g.register_workload(
        hi=3, seed=11)),
    "mix": lambda g: g.limit(200, g.mix(_w(g, 1), _w(g, 2),
                                        g.Repeat({"f": "r"}, 7), seed=3)),
    "limit": lambda g: g.limit(5, _w(g)),
    "time-limit": lambda g: g.time_limit(60, g.limit(7, _w(g))),
    "stagger": lambda g: g.Stagger(0.0001, g.limit(
        40, g.register_workload(seed=5)), seed=5),
    "delay": lambda g: g.delay(0.0, g.limit(3, _w(g))),
    "sleep": lambda g: g.sleep(0.5),
    "on": lambda g: g.on(lambda p: p == 1, g.limit(4, _w(g))),
    "clients_gen": lambda g: g.clients_gen(
        g.limit(5, _w(g)), g.seq({"f": "start"}, {"sleep": 1},
                                 {"f": "stop"})),
    "clients_gen-alone": lambda g: g.clients_gen(g.limit(5, _w(g))),
    "nemesis_gen": lambda g: g.nemesis_gen(
        g.Repeat({"f": "start"}, 2), g.Repeat({"f": "read"}, 3)),
    "nemesis_gen-alone": lambda g: g.nemesis_gen(g.Repeat({"f": "kill"},
                                                          2)),
    "each": lambda g: g.each(lambda: g.seq({"f": "a"}, {"f": "b"})),
    "filter_ops": lambda g: g.filter_ops(
        lambda s: s["f"] != "write", g.limit(200, g.register_workload(
            seed=2))),
    "fmap": lambda g: g.fmap(lambda s: {**s, "value": [s.get("value")]},
                             g.limit(50, g.register_workload(seed=4))),
    "log": lambda g: g.seq(g.log_gen("phase"), {"f": "a"}),
    "synchronize": lambda g: g.synchronize(g.seq({"f": "a"}, {"f": "b"})),
    "phases": lambda g: g.phases(g.seq({"f": "a"}), g.each(
        lambda: g.seq({"f": "b"})), g.limit(3, _w(g))),
    "sequential_generator": lambda g: g.sequential_generator(
        _keys(g), lambda k: g.limit(3, g.register_workload(seed=1))),
    "concurrent_generator": lambda g: g.concurrent_generator(
        2, _keys(g), lambda k: g.limit(3, g.register_workload(seed=9))),
    "concurrent_generator-independent": lambda g: g.concurrent_generator(
        4, (f"k{i}" for i in range(8)),
        lambda k: g.Limit(50, g.register_workload(seed=5))),
    "txn_workload": lambda g: g.limit(120, g.txn_workload(seed=3)),
    "txn_workload-single-key": lambda g: g.limit(80, g.txn_workload(
        keys=5, max_len=6, read_p=0.3, seed=8, single_key=True)),
    "unique_values": lambda g: g.limit(30, g.unique_values("add")),
    "partition": lambda g: g.Partition(
        {True: g.gen(g.Repeat({"f": "start"}, 2)),
         False: g.limit(4, _w(g))}, lambda p: p == g.NEMESIS),
    "nemesis-schedule": lambda g: g.clients_gen(
        g.limit(40, g.register_workload(seed=6)),
        g.Seq([{"sleep": 0.5}, g.limit(8, g.cycle(lambda: g.Seq(
            [{"f": "start"}, {"sleep": 1.0}, {"f": "stop"},
             {"sleep": 1.0}])))])),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_combinator_sequence_matches_reference(name):
    want = draw(CASES[name](g_ref))
    got = draw(CASES[name](g_pt))
    assert got == want
    assert any(s is not None for _, s in got) or name == "void"


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_stock_sketches_match_reference(seed):
    import random
    a, b = random.Random(seed), random.Random(seed)
    for _ in range(50):
        assert g_pt.w(a, 7) == g_ref.w(b, 7)
        assert g_pt.cas(a, 3) == g_ref.cas(b, 3)
    assert g_pt.r() == g_ref.r()
    assert g_pt.NEMESIS == g_ref.NEMESIS


# -- the cases of tests/test_generators.py, on the port ----------------------

g = g_pt


def drain(gen, process=0, test=TEST, cap=10_000):
    out = []
    for _ in range(cap):
        sketch = gen.op(test, process)
        if sketch is None:
            return out
        out.append(sketch)
    raise AssertionError("generator did not exhaust")


def test_once_emits_single_op():
    gen = g.gen({"f": "read"})
    assert drain(gen) == [{"f": "read"}]


def test_seq_serves_in_order():
    gen = g.seq({"f": "a"}, {"f": "b"}, {"f": "c"})
    assert [s["f"] for s in drain(gen)] == ["a", "b", "c"]


def test_limit_caps_infinite_generator():
    gen = g.limit(5, g.Fn(lambda: {"f": "read"}))
    assert len(drain(gen)) == 5


def test_mix_draws_from_all_members():
    gen = g.limit(200, g.mix(g.Fn(lambda: {"f": "a"}),
                             g.Fn(lambda: {"f": "b"}), seed=7))
    fs = {s["f"] for s in drain(gen)}
    assert fs == {"a", "b"}


def test_mix_drops_exhausted_members():
    gen = g.mix({"f": "once"}, g.limit(3, g.Fn(lambda: {"f": "x"})), seed=1)
    out = drain(gen)
    assert sum(1 for s in out if s["f"] == "once") == 1
    assert sum(1 for s in out if s["f"] == "x") == 3


def test_time_limit_expires():
    gen = g.time_limit(0.05, g.Fn(lambda: {"f": "read"}))
    out = drain(gen, cap=1_000_000)
    assert out                          # got some ops before expiry
    assert gen.op(TEST, 0) is None      # stays exhausted


def test_repeat_n():
    assert len(drain(g.Repeat({"f": "r"}, 4))) == 4


def test_each_gives_every_process_the_full_sequence():
    gen = g.each(lambda: g.seq({"f": "a"}, {"f": "b"}))
    assert [s["f"] for s in drain(gen, process=0)] == ["a", "b"]
    assert [s["f"] for s in drain(gen, process=1)] == ["a", "b"]


def test_on_routes_by_process():
    gen = g.on(lambda p: p == 1, g.Fn(lambda: {"f": "x"}))
    assert gen.op(TEST, 0) is None
    assert gen.op(TEST, 1) == {"f": "x"}


def test_nemesis_and_clients_split():
    gen = g.nemesis_gen(g.Repeat({"f": "start"}, 1),
                        g.Repeat({"f": "read"}, 2))
    assert gen.op(TEST, g.NEMESIS) == {"f": "start"}
    assert gen.op(TEST, g.NEMESIS) is None
    assert gen.op(TEST, 0) == {"f": "read"}


def test_filter_ops():
    gen = g.filter_ops(lambda s: s["f"] != "w",
                       g.seq({"f": "r"}, {"f": "w"}, {"f": "r"}))
    assert [s["f"] for s in drain(gen)] == ["r", "r"]


def test_fmap_rewrites():
    gen = g.fmap(lambda s: {**s, "value": 1}, g.seq({"f": "w", "value": 0}))
    assert drain(gen) == [{"f": "w", "value": 1}]


def test_concat_and_then():
    gen = g.then(g.seq({"f": "a"}), g.seq({"f": "b"}))
    assert [s["f"] for s in drain(gen)] == ["a", "b"]


def test_cycle_with_factory():
    gen = g.limit(6, g.cycle(lambda: g.seq({"f": "a"}, {"f": "b"})))
    assert [s["f"] for s in drain(gen)] == ["a", "b"] * 3


def test_stagger_delays_but_passes_through():
    gen = g.stagger(0.001, g.limit(3, g.Fn(lambda: {"f": "r"})))
    assert len(drain(gen)) == 3


def test_sleep_directive():
    assert drain(g.sleep(0.5)) == [{"sleep": 0.5}]


def test_seq_is_thread_safe():
    gen = g.Seq([{"f": str(i)} for i in range(500)])
    seen, lock = [], threading.Lock()

    def worker():
        while True:
            s = gen.op(TEST, 0)
            if s is None:
                return
            with lock:
                seen.append(s["f"])

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sorted(seen, key=int) == [str(i) for i in range(500)]


def test_sequential_keys_wraps_values():
    gen = g.sequential_generator(
        ["k1", "k2"], lambda k: g.limit(2, g.Fn(lambda: {"f": "w",
                                                         "value": 9})))
    out = drain(gen)
    assert [s["value"] for s in out] == [["k1", 9], ["k1", 9],
                                         ["k2", 9], ["k2", 9]]


def test_concurrent_keys_partitions_processes():
    gen = g.concurrent_generator(
        2, ["a", "b", "c", "d"],
        lambda k: g.limit(1, g.Fn(lambda: {"f": "w", "value": 0})))
    # group 0 (process 0) serves keys a, c...; group 1 (process 1) b, d
    v00 = gen.op(TEST, 0)["value"]
    v10 = gen.op(TEST, 1)["value"]
    v01 = gen.op(TEST, 2)["value"]          # process 2 → group 0
    assert v00[0] == "a" and v10[0] == "b" and v01[0] == "c"
    assert gen.op(TEST, g.NEMESIS) is None


def test_synchronize_without_active_set_passes():
    gen = g.synchronize(g.seq({"f": "a"}))
    assert gen.op({}, 0) == {"f": "a"}


def test_phases_run_in_order():
    gen = g.phases(g.seq({"f": "a"}), g.seq({"f": "b"}))
    assert [s["f"] for s in drain(gen, test={})] == ["a", "b"]


def test_phases_barrier_with_concurrent_workers():
    """Seq must not hold its lock through a blocking barrier, and the
    barrier must not wait for the nemesis process."""
    active = {0, 1, g.NEMESIS}
    test = {"active-processes": lambda: set(active)}
    gen = g.phases(g.each(lambda: g.seq({"f": "a"})),
                   g.each(lambda: g.seq({"f": "b"})))
    out = {0: [], 1: []}

    def worker(p):
        while True:
            s = gen.op(test, p)
            if s is None:
                active.discard(p)
                return
            out[p].append(s["f"])

    ts = [threading.Thread(target=worker, args=(p,)) for p in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
        assert not t.is_alive(), "phases barrier deadlocked"
    assert out[0] == ["a", "b"] and out[1] == ["a", "b"]


def test_time_limit_starts_at_first_request():
    gen = g.time_limit(0.05, g.Fn(lambda: {"f": "read"}))
    time.sleep(0.08)                    # the clock starts at the first op
    assert gen.op(TEST, 0) == {"f": "read"}

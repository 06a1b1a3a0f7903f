"""The port's transactional checker (``jepsen_tpu_torch.txn``) against
the reference's (``jepsen_tpu.txn``), on the CPU.

The same inputs go through both: histories from each package's own
``fixtures`` with the same seeds (equal op for op, tested first), and
graphs and masks made with numpy from a seed. The reference runs its
jitted closure bodies on the CPU as its own tests do; the port runs with
``device="cpu"``, where K8's wrapper takes its plain version (and, as a
cross-check, with its f32 body in the word body's place). The
tolerance is exact equality of every boolean, array, list and dict: the
results carry no floating-point value but ``check-s`` (a wall time,
left out).
"""
import random

import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import obs as obs_ref
from jepsen_tpu import txn as txn_ref
from jepsen_tpu.checkers import facade as fac_ref
from jepsen_tpu.txn import cycles as cyc_ref
from jepsen_tpu.txn import host_ref as hr_ref
from jepsen_tpu.txn import infer as inf_ref
from jepsen_tpu.txn import ops as ops_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import obs as obs_pt
from jepsen_tpu_torch import txn as txn_pt
from jepsen_tpu_torch.checkers import facade as fac_pt
from jepsen_tpu_torch.txn import cycles as cyc_pt
from jepsen_tpu_torch.txn import host_ref as hr_pt
from jepsen_tpu_torch.txn import infer as inf_pt
from jepsen_tpu_torch.txn import ops as ops_pt

torch.set_num_threads(1)

GEN_CASES = [
    dict(n_txns=40, keys=3, seed=2),
    dict(n_txns=60, keys=3, processes=4, crash_p=0.15, seed=3),
    dict(n_txns=120, keys=6, processes=8, key_rotate=8, seed=1),
    dict(n_txns=80, keys=2, max_len=6, read_p=0.3, crash_p=0.05,
         key_rotate=5, seed=9),
]
ALL_KINDS = fx_ref.TXN_ANOMALY_KINDS + fx_ref.TXN_LATTICE_KINDS


def _dicts(history):
    return [op.to_dict() for op in history]


def _with_block(fx, hist, kind):
    return hist + [o.with_(index=-1) for o in fx.txn_anomaly_block(kind)]


def _fuzz_cases():
    """The reference's fuzz recipe (``tests/test_txn.py``,
    ``test_fuzzed_differential``: ``random.Random(12)``, 12 trials), as
    generator arguments and the injected kind."""
    rng = random.Random(12)
    out = []
    for _ in range(12):
        kw = dict(n_txns=rng.randrange(10, 80), keys=rng.randrange(2, 4),
                  crash_p=rng.choice((0.0, 0.15)),
                  seed=rng.randrange(1 << 30))
        kind = (rng.choice(fx_ref.TXN_ANOMALY_KINDS)
                if rng.random() < 0.5 else None)
        out.append((kw, kind))
    return out


FUZZ = _fuzz_cases()


def _pair(kw, kind=None):
    """The same history from both packages' fixtures."""
    ref = fx_ref.gen_txn_history(**kw)
    pt = fx_pt.gen_txn_history(**kw)
    if kind is not None:
        ref, pt = _with_block(fx_ref, ref, kind), _with_block(fx_pt, pt, kind)
    return ref, pt


def _graphs(kw, kind=None):
    ref, pt = _pair(kw, kind)
    return (inf_ref.infer(*ops_ref.collect(ref)),
            inf_pt.infer(*ops_pt.collect(pt)))


GRAPH_CASES = [(kw, kind) for kw, kind in FUZZ] + \
    [(dict(n_txns=30, keys=2, seed=5), k) for k in ALL_KINDS]


# -- fixtures and ops --------------------------------------------------------

@pytest.mark.parametrize("kw", GEN_CASES)
def test_gen_txn_history_equal(kw):
    ref, pt = _pair(kw)
    assert _dicts(ref) == _dicts(pt)


@pytest.mark.parametrize("kind", ALL_KINDS)
def test_anomaly_block_equal(kind):
    assert _dicts(fx_ref.txn_anomaly_block(kind)) == \
        _dicts(fx_pt.txn_anomaly_block(kind, key_prefix="z", process0=100))
    assert _dicts(fx_ref.txn_anomaly_block(kind, "q", 7)) == \
        _dicts(fx_pt.txn_anomaly_block(kind, "q", 7))


def test_unknown_anomaly_kind_raises_in_both():
    for fx in (fx_ref, fx_pt):
        with pytest.raises(ValueError):
            fx.txn_anomaly_block("G9")


@pytest.mark.parametrize("value", [
    [["append", "k", 1], ["r", "k", [1]]],
    [["read", "k", None], ["r", "j", (2, 3)]],
    (("append", "k", [1, 2]),),
    [],
])
def test_micro_ops_equal(value):
    assert ops_ref.micro_ops(value) == ops_pt.micro_ops(value)


@pytest.mark.parametrize("value", [
    "nope", [["bogus", "k", 1]], [["r", "k", 3]], [["r", "k"]], [7]])
def test_micro_ops_malformed_in_both(value):
    with pytest.raises(ops_ref.MalformedTxn):
        ops_ref.micro_ops(value)
    with pytest.raises(ops_pt.MalformedTxn):
        ops_pt.micro_ops(value)


def _txn_rows(txns):
    return [(t.tid, t.op.to_dict(), t.micros, t.crashed, t.end,
             t.describe()) for t in txns]


@pytest.mark.parametrize("kw", GEN_CASES)
def test_collect_equal(kw):
    ref, pt = _pair(kw)
    # a fail txn and a non-txn op, as a mixed workload leaves them
    ref = ref + [o.with_(index=-1) for o in (
        fx_ref.invoke(50, "txn", [["append", "t0", 999]]),
        fx_ref.fail(50, "txn", [["append", "t0", 999]]),
        fx_ref.invoke(51, "read", None), fx_ref.ok(51, "read", 3))]
    pt = pt + [o.with_(index=-1) for o in (
        fx_pt.invoke(50, "txn", [["append", "t0", 999]]),
        fx_pt.fail(50, "txn", [["append", "t0", 999]]),
        fx_pt.invoke(51, "read", None), fx_pt.ok(51, "read", 3))]
    tr, fr = ops_ref.collect(ref)
    tp, fp = ops_pt.collect(pt)
    assert _txn_rows(tr) == _txn_rows(tp)
    assert [(f.op.to_dict(), f.micros) for f in fr] == \
        [(f.op.to_dict(), f.micros) for f in fp]
    assert len(fp) == 1


@pytest.mark.parametrize("kw", GEN_CASES + [dict(n_txns=300, keys=3, seed=3)])
def test_pack_txns_equal(kw):
    ref, pt = _pair(kw)
    a = ops_ref.pack_txns(ops_ref.collect(ref)[0])
    b = ops_pt.pack_txns(ops_pt.collect(pt)[0])
    assert (a.n_txns, a.n_micros, a.keys, a.key_vals, a.wire_bytes) == \
        (b.n_txns, b.n_micros, b.keys, b.key_vals, b.wire_bytes)
    for f in ("txn_id", "kind", "key_id", "val_code", "read_off",
              "read_len", "read_vals"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_idx_dtype_rule():
    for n, dt in ((1, np.int8), (127, np.int8), (128, np.int16),
                  (32767, np.int16), (32768, np.int32)):
        assert ops_pt.idx_dtype(n) is dt


def test_list_append_model_refuses_steps():
    m = ops_pt.list_append_model()
    assert isinstance(m, ops_pt.ListAppend)
    assert not m.step(fx_pt.invoke(0, "txn", []))


# -- inference, host reference ------------------------------------------------

def _graph_equal(a, b):
    assert a.n == b.n
    for f in ("src", "dst", "et"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.counters == b.counters
    assert list(a.direct) == list(b.direct)
    assert a.edge_counts() == b.edge_counts()
    assert _txn_rows(a.txns) == _txn_rows(b.txns)


@pytest.mark.parametrize("kw,kind", GRAPH_CASES)
def test_infer_equal(kw, kind):
    with obs_ref.capture() as cr, obs_pt.capture() as cp:
        gr, gp = _graphs(kw, kind)
    _graph_equal(gr, gp)
    assert {k: v for k, v in cr.counters.items() if k.startswith("txn.")} \
        == {k: v for k, v in cp.counters.items() if k.startswith("txn.")}


def test_infer_direct_anomalies_equal():
    def seq(mod, *txns, fail_at=()):
        out = []
        for i, t in enumerate(txns):
            out.append(mod.invoke(i, "txn", [[k, kk, None if k == "r" else v]
                                             for k, kk, v in t]))
            done = mod.fail if i in fail_at else mod.ok
            out.append(done(i, "txn", [list(x) for x in t]))
        return out

    cases = [
        dict(txns=([("append", "a", 1)], [("append", "a", 2)],
                   [("r", "a", [1, 2])], [("r", "a", [2])])),
        dict(txns=([("append", "a", 1)], [("append", "a", 1)])),
        dict(txns=([("append", "a", 9)], [("r", "a", [9])]), fail_at=(0,)),
        dict(txns=([("r", "a", [4])],)),
        dict(txns=([("append", "a", 1)], [("r", "a", [1, 1])])),
    ]
    for c in cases:
        ref = h_ref.index(seq(fx_ref, *c["txns"],
                              fail_at=c.get("fail_at", ())))
        pt = h_pt.index(seq(fx_pt, *c["txns"], fail_at=c.get("fail_at", ())))
        _graph_equal(inf_ref.infer(*ops_ref.collect(ref)),
                     inf_pt.infer(*ops_pt.collect(pt)))
        r = txn_ref.check_history(ref)
        p = txn_pt.check_history(pt, device="cpu")
        assert _strip(r) == _strip(p)
        assert p["valid"] is False and p["engine"] == "txn-infer"


@pytest.mark.parametrize("kw,kind", GRAPH_CASES)
def test_host_reference_equal(kw, kind):
    gr, gp = _graphs(kw, kind)
    assert hr_ref.classify_booleans(gr) == hr_pt.classify_booleans(gp)
    for cls in ("G0", "G1c", "G-single", "G2", "nope"):
        assert hr_ref.find_witness(gr, cls) == hr_pt.find_witness(gp, cls)
    ids_r, core_r = hr_ref.trim_core(gr)
    ids_p, core_p = hr_pt.trim_core(gp)
    np.testing.assert_array_equal(ids_r, ids_p)
    _graph_equal(core_r, core_p)
    starts = np.asarray([t.index for t in gp.txns], np.int64)
    ends = np.asarray([t.end for t in gp.txns], np.int64)
    assert hr_ref.lattice_classify_booleans(gr, starts, ends) == \
        hr_pt.lattice_classify_booleans(gp, starts, ends)
    for cls in ("G-SIa", "G-SIb", "G-SI"):
        assert hr_ref.find_lattice_witness(gr, cls, starts, ends) == \
            hr_pt.find_lattice_witness(gp, cls, starts, ends)


def test_derive_anomalies_equal():
    for bits in range(16):
        b = dict(zip(("cyc_ww", "cyc_wwwr", "cyc_full", "gsingle"),
                     (bool(bits >> i & 1) for i in range(4))))
        assert hr_ref.derive_anomalies(b) == hr_pt.derive_anomalies(b)


# -- the closure bodies and K8's plain step ---------------------------------

def _random_lanes(rng, K, Np, per_node):
    """K lane masks and an rw mask, ``per_node`` edges a node on average,
    each lane a superset of the one before (as the checker's are)."""
    p = per_node / Np
    masks = np.zeros((K, Np, Np), bool)
    masks[0] = rng.random((Np, Np)) < p
    for b in range(1, K):
        masks[b] = masks[b - 1] | (rng.random((Np, Np)) < p)
    rw = rng.random((Np, Np)) < p
    return masks, rw


def _pack(a):
    """The reference's packing (``cycles._pack_rows``) in numpy, viewed
    as the port's ``int32`` words."""
    return cyc_ref._pack_rows(a).view(np.int32)


BODY_CASES = [(K, Np, per, seed) for K in (3, 4) for Np in (32, 64, 256)
              for per, seed in ((0.7, 1), (1.5, 2))]


@pytest.mark.parametrize("K,Np,per,seed", BODY_CASES)
def test_bodies_equal_reference(K, Np, per, seed):
    rng = np.random.default_rng(seed)
    masks, rw = _random_lanes(rng, K, Np, per)
    contracts = (1,) if K == 3 else cyc_ref.LATTICE_CONTRACTS
    Cw = cyc_ref._pack_rows(masks)
    CwT = cyc_ref._pack_rows(np.swapaxes(masks, 1, 2))
    Arw = cyc_ref._pack_rows(rw)
    want_word = np.asarray(cyc_ref._lattice_word_call(Np, K, contracts)(
        Cw, CwT, Arw))
    want_f32 = np.asarray(cyc_ref._lattice_call(Np, K, contracts, False)(
        masks.astype(np.uint8), rw.astype(np.uint8)))
    np.testing.assert_array_equal(want_word, want_f32)
    tm, trw = torch.from_numpy(masks), torch.from_numpy(rw)
    np.testing.assert_array_equal(
        cyc_pt._word_booleans(tm, trw, contracts), want_word)
    np.testing.assert_array_equal(
        cyc_pt._f32_booleans(tm, trw, contracts), want_f32)


def _unpack(words, Np):
    return np.unpackbits(words.view(np.uint8), axis=-1,
                         bitorder="little").astype(bool)[..., :Np]


@pytest.mark.parametrize("K,Np,per", [(3, 32, 2.0), (4, 64, 8.0),
                                      (3, 128, 2.0), (4, 96, 1.0)])
def test_square_step_plain_matches_numpy_replay(K, Np, per):
    rng = np.random.default_rng(K * Np)
    masks, _ = _random_lanes(rng, K, Np, per)
    # arbitrary words: CwT need not be Cw's transpose for the step
    Cw = _pack(masks)
    CwT = _pack(rng.random((K, Np, Np)) < per / Np)
    out_w, out_t = cyc_pt.square_step(torch.from_numpy(Cw),
                                      torch.from_numpy(CwT))
    a, b = _unpack(Cw, Np), _unpack(CwT, Np)
    prod = np.einsum("bij,bkj->bik", a.astype(np.int64),
                     b.astype(np.int64)) > 0
    np.testing.assert_array_equal(out_w.numpy(), Cw | _pack(prod))
    np.testing.assert_array_equal(
        out_t.numpy(), CwT | _pack(np.swapaxes(prod, 1, 2)))
    assert out_w.dtype == out_t.dtype == torch.int32


def test_plain_step_chunks_rows(monkeypatch):
    rng = np.random.default_rng(5)
    masks, _ = _random_lanes(rng, 3, 64, 2.0)
    Cw, CwT = cyc_pt.pack_lanes(torch.from_numpy(masks))
    whole = cyc_pt.square_step_plain(Cw, CwT)
    monkeypatch.setattr(cyc_pt, "_PLAIN_ELEMS", 3 * 64 * 2 * 5)
    chunked = cyc_pt.square_step_plain(Cw, CwT)
    for x, y in zip(whole, chunked):
        assert torch.equal(x, y)


def test_pack_rows_torch_matches_numpy():
    rng = np.random.default_rng(3)
    bits = rng.random((2, 5, 96)) < 0.5
    np.testing.assert_array_equal(
        cyc_pt.pack_rows_torch(torch.from_numpy(bits)).numpy(),
        _pack(bits))


@pytest.mark.parametrize("K,Np", [(3, 32), (4, 96)])
def test_pack_lanes_matches_numpy(K, Np):
    masks, _ = _random_lanes(np.random.default_rng(Np), K, Np, 4.0)
    Cw, CwT = cyc_pt.pack_lanes(torch.from_numpy(masks))
    assert Cw.dtype == CwT.dtype == torch.int32
    np.testing.assert_array_equal(Cw.numpy(), _pack(masks))
    np.testing.assert_array_equal(CwT.numpy(),
                                  _pack(np.swapaxes(masks, 1, 2)))


def test_geometry_helpers_equal():
    for n in (0, 1, 7, 8, 9, 33, 100, 8192, 8193):
        assert cyc_pt._pad_n(n) == cyc_ref._pad_n(n)
        assert cyc_pt._pad_n_words(n) == cyc_ref._pad_n_words(n)
        assert cyc_pt.admits(n) == cyc_ref.admits(n)
        assert cyc_pt.admits(n, 50) == cyc_ref.admits(n, 50)
    assert cyc_pt.max_dense() == cyc_ref._MAX_DENSE_DEFAULT
    for n in (8, 32, 33, 1024):
        assert cyc_pt.n_iter(n) == max(1, int(np.ceil(np.log2(n))))


@pytest.mark.parametrize("kw,kind", GRAPH_CASES[::3])
def test_masks_equal(kw, kind):
    gr, gp = _graphs(kw, kind)
    Np = cyc_pt._pad_n(gp.n)
    cpu = torch.device("cpu")
    for x, y in zip(cyc_ref._masks(gr, Np), cyc_pt._masks(gp, Np, cpu)):
        np.testing.assert_array_equal(x, y.numpy())
    cm = inf_ref.commit_mask(gr.txns)
    for x, y in zip(cyc_ref._lattice_masks(gr, Np, cm),
                    cyc_pt._lattice_masks(gp, Np, torch.from_numpy(cm),
                                          cpu)):
        np.testing.assert_array_equal(x, y.numpy())


# -- check_history against the reference -------------------------------------

def _strip(res):
    return {k: v for k, v in res.items() if k != "check-s"}


def _records(cap):
    return [{k: v for k, v in r.items() if k not in ("ts", "elapsed_s")}
            for r in cap.ledger]


def _txn_counters(cap):
    return {k: v for k, v in cap.counters.items() if k.startswith("txn.")}


def run_both(monkeypatch, ref_hist, pt_hist, body, **kw):
    """One check through the reference and the port with ``body``:
    ``"word"`` (the port's one body), ``"f32"`` (its f32 cross-check put
    in the word body's place) or ``"host"`` (``force_host`` on both);
    asserts every result field, the txn counters and the decision ledger
    equal, returns the port's result."""
    ref_kw, pt_kw = dict(kw), dict(kw, device="cpu")
    if body == "host":
        ref_kw["force_host"] = pt_kw["force_host"] = True
    with obs_ref.capture() as cr:
        ref = txn_ref.check_history(ref_hist, **ref_kw)
    with monkeypatch.context() as m:
        if body == "f32":
            m.setattr(cyc_pt, "_word_booleans", cyc_pt._f32_booleans)
        with obs_pt.capture() as cp:
            pt = txn_pt.check_history(pt_hist, **pt_kw)
    assert _strip(ref) == _strip(pt)
    assert _txn_counters(cr) == _txn_counters(cp)
    assert _records(cr) == _records(cp)
    return pt


BODIES = ("word", "f32", "host")


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("kind", fx_ref.TXN_ANOMALY_KINDS)
def test_check_history_injected(monkeypatch, kind, body):
    ref, pt = _pair(dict(n_txns=30, keys=2, seed=5), kind)
    res = run_both(monkeypatch, ref, pt, body)
    assert res["valid"] is False and res["anomalies"] == [kind]
    assert res["engine"] == ("txn-host-scc" if body == "host" else "txn-mxu")


@pytest.mark.parametrize("body", BODIES)
def test_check_history_fuzzed(monkeypatch, body):
    for kw, kind in FUZZ:
        ref, pt = _pair(kw, kind)
        res = run_both(monkeypatch, ref, pt, body)
        if kind is not None:
            assert res["valid"] is False


@pytest.mark.parametrize("body", ("word", "f32"))
def test_check_history_trim_route(monkeypatch, body):
    ref, pt = _pair(dict(n_txns=60, keys=3, seed=6), "G-single")
    res = run_both(monkeypatch, ref, pt, body, max_dense_txns=8)
    assert res["engine"] == "txn-mxu" and res["core-txns"] < res["txns"]
    assert res["anomalies"] == ["G-single"]
    ref, pt = _pair(dict(n_txns=80, keys=3, seed=6))
    res = run_both(monkeypatch, ref, pt, body, max_dense_txns=8)
    assert res["valid"] is True and res["core-txns"] == 0
    # a core still past the envelope: the host, by a recorded route
    ref, pt = _pair(dict(n_txns=40, keys=2, seed=4), "G2")
    res = run_both(monkeypatch, ref, pt, body, max_dense_txns=1)
    assert res["engine"] == "txn-host-scc" and res["core-txns"] > 1


def test_check_history_no_edges_and_ambiguous(monkeypatch):
    ref = h_ref.index([fx_ref.invoke(0, "txn", [["append", "a", 1]]),
                       fx_ref.ok(0, "txn", [["append", "a", 1]])])
    pt = h_pt.index([fx_pt.invoke(0, "txn", [["append", "a", 1]]),
                     fx_pt.ok(0, "txn", [["append", "a", 1]])])
    for body in BODIES:
        res = run_both(monkeypatch, ref, pt, body)
        assert res["engine"] == "txn-noedges"
        assert res["coverage"] == "weakened"


# -- facade, compose, EDN, faults --------------------------------------------

def test_auto_check_txn_one_selected():
    ref, pt = _pair(dict(n_txns=20, seed=1), "G1c")
    with obs_ref.capture() as cr:
        r = fac_ref.auto_check_txn(ref, {})
    with obs_pt.capture() as cp:
        p = fac_pt.auto_check_txn(pt, {"device": "cpu", "max_states": 3})
    assert _strip(r) == _strip(p)
    assert len(cr.selections()) == len(cp.selections()) == 1
    sr, sp = cr.selections()[0], cp.selections()[0]
    assert {k: v for k, v in sr.items() if k not in ("ts", "elapsed_s")} == \
        {k: v for k, v in sp.items() if k not in ("ts", "elapsed_s")}


def test_txn_checker_composes():
    ref, pt = _pair(dict(n_txns=20, seed=1), "G1c")
    r = fac_ref.compose({
        "txn": txn_ref.TxnChecker(),
        "lattice": txn_ref.txn_checker(consistency="all")}).check(
            {}, h_ref.index(ref))
    p = fac_pt.compose({
        "txn": txn_pt.TxnChecker({"device": "cpu"}),
        "lattice": txn_pt.txn_checker(device="cpu",
                                      consistency="all")}).check(
            {}, h_pt.index(pt))
    assert p["valid"] is r["valid"] is False
    for name in ("txn", "lattice"):
        assert _strip(r["results"][name]) == _strip(p["results"][name])
    assert p["results"]["txn"]["anomalies"] == ["G1c"]


def test_edn_round_trip(tmp_path):
    ref, pt = _pair(dict(n_txns=25, keys=2, seed=4, crash_p=0.1), "G0")
    ref, pt = h_ref.index(ref), h_pt.index(pt)
    h_ref.save_edn(ref, str(tmp_path / "ref.edn"))
    h_pt.save_edn(pt, str(tmp_path / "pt.edn"))
    text = (tmp_path / "pt.edn").read_text()
    assert text == (tmp_path / "ref.edn").read_text()
    assert ":append" in text and ":r" in text and ":txn" in text
    back_r = h_ref.load_edn(str(tmp_path / "ref.edn"))
    back_p = h_pt.load_edn(str(tmp_path / "pt.edn"))
    assert _dicts(back_r) == _dicts(back_p)
    assert _strip(txn_pt.check_history(back_p, device="cpu")) == \
        _strip(txn_ref.check_history(back_r)) == \
        _strip(txn_ref.check_history(ref))


def test_closure_fault_raises_with_no_fallback(monkeypatch):
    _ref, pt = _pair(dict(n_txns=25, seed=8), "G0")

    def boom(*a, **k):
        raise RuntimeError("injected closure failure")

    monkeypatch.setattr(cyc_pt, "square_step", boom)
    for kw in ({}, {"consistency": "all"}):
        with obs_pt.capture() as cap:
            with pytest.raises(RuntimeError, match="injected"):
                txn_pt.check_history(pt, device="cpu", **kw)
        assert cap.fallbacks() == []
    # the host is a decision
    assert txn_pt.check_history(pt, device="cpu",
                                force_host=True)["anomalies"] == ["G0"]


def test_check_history_wants_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _ref, pt = _pair(dict(n_txns=10, seed=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        txn_pt.check_history(pt)
    with pytest.raises(RuntimeError, match="CUDA"):
        txn_pt.TxnChecker().check({}, pt)


def test_core_gauge_and_spans():
    _ref, pt = _pair(dict(n_txns=60, keys=3, seed=6), "G-single")
    with obs_pt.capture() as cap:
        res = txn_pt.check_history(pt, device="cpu", max_dense_txns=8)
    assert cap.gauges["txn.core.n"] == res["core-txns"]
    names = {s["name"] for s in cap.spans}
    assert {"txn.collect", "txn.infer", "txn.cycles"} <= names

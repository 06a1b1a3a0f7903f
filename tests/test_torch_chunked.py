"""The port's ``reach.check_chunked`` (the ``reach-chunked`` algorithm)
against the reference's ``check_chunked`` and ``check``, on the CPU.

Verdict, failing op and dead event must be the reference's on every
history. ``chunks`` is the reference's where both packages take the
same route; where the port's forward pass runs on K1 (the restricted
histories, ``Rn·D >= 2^20``, at most 32 states and W ≤ 8) its chunks
align to K1's 1,024-return blocks, which the reference does only on its
accelerator, so ``chunks`` is held to that rule,
``ceil(Rn / align(per, 1024))``. Each route is asserted from the ledger
(``obs.decision("reach-chunked", "route", ...)``). The basis walk's
layout on K2 is replayed in numpy at the full basis (E = D) against
``batch_walk_plain`` and the reference's basis walk.
"""
import os

import numpy as np
import pytest
import torch

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import events as ev_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_batch as batch_pt
from jepsen_tpu_torch.checkers import reach_lane as lane_pt
from jepsen_tpu_torch.checkers import reach_pallas as pallas_pt

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")

KEYS = ("valid", "op", "dead-event", "max-linearized", "events", "slots",
        "states")


def _pair(kind, kw, corrupt):
    a = fx_ref.gen_history(kind, **kw)
    b = fx_pt.gen_history(kind, **kw)
    if corrupt:
        a, b = fx_ref.corrupt(a, seed=kw["seed"]), fx_pt.corrupt(
            b, seed=kw["seed"])
    return a, b


def _routes(ledger):
    return {d["phase"]: d for d in ledger if d["stage"] == "reach-chunked"}


def _lane_chunks(Rn, n_chunks):
    """The reference's lane-route chunk count."""
    n = max(1, min(n_chunks, max(Rn, 1)))
    per = -(-max(Rn, 1) // n)
    per = -(-per // 1024) * 1024
    return -(-Rn // per)


def _check_both(model_ref, model_pt, a, b, n_chunks, **kw):
    reach_ref._MEMO_CACHE.clear()
    want = reach_ref.check_chunked(model_ref, a, n_chunks=n_chunks)
    seq = reach_ref.check(model_ref, a)
    with obs.capture() as cap:
        got = reach_pt.check_chunked(model_pt, b, n_chunks=n_chunks,
                                     device="cpu", **kw)
    diff = {k: (want.get(k), got.get(k)) for k in KEYS
            if want.get(k) != got.get(k)}
    assert not diff, diff
    assert got["engine"] == "reach-chunked"
    assert got["valid"] == seq["valid"]
    assert got.get("dead-event") == seq.get("dead-event")
    return want, got, _routes(cap.ledger)


# -- the reference's own cases (tests/test_reach.py TestChunked) ------------

@pytest.mark.parametrize("n_chunks", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_sequential(seed, n_chunks):
    kw = dict(n_ops=40, processes=3, seed=seed, crash_p=0.05)
    a, b = _pair("cas", kw, corrupt=seed % 2 == 0)
    want, got, routes = _check_both(m_ref.cas_register(),
                                    m_pt.cas_register(), a, b, n_chunks)
    assert got["chunks"] == want["chunks"]
    assert routes["forward"]["engine"] == "none"   # below 2^20: full basis


FIXTURES = [
    ("cas-register-ok-small.edn", "cas_register"),
    ("cas-register-bad.edn", "cas_register"),
    ("register-ok.edn", "register"),
    ("register-bad.edn", "register"),
    ("mutex-ok.edn", "mutex"),
]


@pytest.mark.parametrize("fname,model_name", FIXTURES,
                         ids=[f[0] for f in FIXTURES])
def test_fixtures(fname, model_name):
    """Below 2^20 there is no forward pass: every chunk's full basis
    walks on K2, the fold finds a death and K1 walks the failing prefix
    for the exact dead event."""
    path = os.path.join(DATA, fname)
    want, got, routes = _check_both(
        getattr(m_ref, model_name)(), getattr(m_pt, model_name)(),
        h_ref.load_edn(path), h_pt.load_edn(path), 3)
    assert got["chunks"] == want["chunks"]
    assert routes["forward"]["engine"] == "none"
    assert routes["basis"]["engine"] == "batch_walk"          # K2
    if got["valid"] is False:
        assert routes["localize"]["engine"] == "reach-lane"   # K1


# -- the restricted routes ---------------------------------------------------

def _returns(b, model):
    p = h_pt.pack(b)
    memo, stream, *_ = reach_pt._prep(model, p, max_states=100_000,
                                      max_slots=20, max_dense=1 << 22)
    return int(np.sum(stream.kind == 1))


def _chunks(Rn, n_chunks):
    """The reference's chunk count off the lane route."""
    return max(1, min(n_chunks, max(Rn, 1)))


# seven processes: D = 8·128 = 1,024, so about 1,100 returns pass 2^20
RESTRICTED = dict(n_ops=1_400, processes=7, seed=21)


@pytest.mark.parametrize("corrupt,n_chunks", [(False, 3), (True, 3),
                                              (True, 8)])
def test_restricted_lane_route(corrupt, n_chunks):
    """The forward pass is one K1 walk with its block checkpoints, the
    chunks aligned to K1's 1,024-return blocks; the restricted bases
    walk on K2; a death is K1's own dead return."""
    a, b = _pair("cas", RESTRICTED, corrupt)
    want, got, routes = _check_both(m_ref.cas_register(),
                                    m_pt.cas_register(), a, b, n_chunks)
    assert routes["forward"]["engine"] == "reach-lane"
    assert got["chunks"] == _lane_chunks(_returns(b, m_pt.cas_register()),
                                         n_chunks)
    if corrupt:
        assert got["valid"] is False and "basis" not in routes
    else:
        assert routes["basis"]["engine"] == "batch_walk"
        assert sum(g[0] for g in routes["basis"]["groups"]) == got["chunks"]


def _check_seq(a, b, n_chunks):
    """The port's check_chunked against the reference's sequential
    check (the reference's chunked walk at these shapes costs minutes on
    the CPU); ``chunks`` by the reference's rule off the lane route."""
    reach_ref._MEMO_CACHE.clear()
    seq = reach_ref.check(m_ref.cas_register(), a)
    with obs.capture() as cap:
        got = reach_pt.check_chunked(m_pt.cas_register(), b,
                                     n_chunks=n_chunks, device="cpu")
    for k in ("valid", "op", "dead-event", "max-linearized"):
        assert got.get(k) == seq.get(k), k
    assert got["chunks"] == _chunks(_returns(b, m_pt.cas_register()),
                                    n_chunks)
    return got, _routes(cap.ledger)


@pytest.mark.parametrize("corrupt", [False, True])
def test_wide_route(corrupt):
    """More than 32 states: the forward pass chains the chunks on K4
    (one launch a chunk), the basis walk runs as batched torch ops
    (outside K2's envelope), and the chunks are the reference's."""
    kw = dict(n_ops=2_000, processes=4, seed=4, values=40)
    a, b = _pair("cas", kw, corrupt)
    want, got, routes = _check_both(m_ref.cas_register(),
                                    m_pt.cas_register(), a, b, 3)
    assert routes["forward"]["engine"] == "reach-pallas"
    assert got["chunks"] == want["chunks"]
    if not corrupt:
        assert routes["basis"]["engine"] == "torch"


@pytest.mark.parametrize("corrupt", [False, True])
def test_k4_chain_where_k1_declines(corrupt, monkeypatch):
    """Where K1 does not take the geometry (here made so), the chunks
    chain on K4 and keep the reference's count; the bases still walk on
    K2, whose envelope is its own."""
    monkeypatch.setattr(lane_pt, "lane_fits", lambda *a: False)
    a, b = _pair("cas", RESTRICTED, corrupt)
    got, routes = _check_seq(a, b, 3)
    assert routes["forward"]["engine"] == "reach-pallas"
    if not corrupt:
        assert routes["basis"]["engine"] == "batch_walk"


def test_many_slots_chain_on_k4():
    """W > 8: K1's checkpoints would come from its capped ladder, so the
    forward pass chains on K4 (the corrupted history dies in it)."""
    a, b = _pair("cas", dict(n_ops=300, processes=10, seed=2), True)
    got, routes = _check_seq(a, b, 3)
    assert got["slots"] > lane_pt._FAST_PASSES
    assert routes["forward"]["engine"] == "reach-pallas"
    assert got["valid"] is False and "basis" not in routes


@pytest.mark.parametrize("corrupt", [False, True])
def test_torch_routes(corrupt, monkeypatch):
    """Where no kernel takes the geometry, every phase runs on torch:
    the forward chain, the batched basis walk and the localization."""
    for mod in (lane_pt, pallas_pt, batch_pt):
        name = "lane_fits" if mod is lane_pt else "fits"
        monkeypatch.setattr(mod, name, lambda *a: False)
    a, b = _pair("cas", RESTRICTED, corrupt)
    got, routes = _check_seq(a, b, 3)
    assert routes["forward"]["engine"] == "reach"
    if not corrupt:
        assert routes["basis"]["engine"] == "torch"


# -- declines and aborts -----------------------------------------------------

def test_dense_overflow_as_reference():
    a, b = _pair("cas", dict(n_ops=60, processes=4, seed=1), False)
    with pytest.raises(reach_ref.DenseOverflow):
        reach_ref.check_chunked(m_ref.cas_register(), a, max_matrix=1000)
    with pytest.raises(reach_pt.DenseOverflow, match="transfer matrix"):
        reach_pt.check_chunked(m_pt.cas_register(), b, max_matrix=1000,
                               device="cpu")


def test_abort_before_and_between_segments(monkeypatch):
    good = fx_pt.gen_history("cas", **RESTRICTED)
    bad = fx_pt.corrupt(good, seed=21)
    res = reach_pt.check_chunked(m_pt.cas_register(), good, device="cpu",
                                 should_abort=lambda: True)
    assert res == {"valid": "unknown", "cause": "aborted",
                   "engine": "reach-chunked"}
    # the K1 forward pass runs segmented under a hook: abort at the
    # second segment
    monkeypatch.setattr(lane_pt, "_ABORT_SEG", 1024)
    calls = []

    def hook():
        calls.append(1)
        return len(calls) > 2

    res = reach_pt.check_chunked(m_pt.cas_register(), good, device="cpu",
                                 should_abort=hook)
    assert res["cause"] == "aborted" and len(calls) == 3
    # a hook that never fires gives the plain verdict
    full = reach_pt.check_chunked(m_pt.cas_register(), bad, device="cpu",
                                  should_abort=lambda: False)
    plain = reach_pt.check_chunked(m_pt.cas_register(), bad, device="cpu")
    assert full["valid"] is False
    assert full == dict(plain, **{"time-s": full["time-s"]})


def test_empty_history():
    assert reach_pt.check_chunked(m_pt.cas_register(), [], device="cpu") \
        == reach_ref.check_chunked(m_ref.cas_register(), [])


# -- the basis layout on K2, replayed in numpy -------------------------------

def _ret_step_np(P, R, j, ops_row):
    """The reference's ``_ret_step`` in numpy: W fire passes, then the
    projection on slot ``j`` (-1: identity). ``R`` bool[S, M]."""
    S, M = R.shape
    W = len(ops_row)
    for _ in range(W):
        add = np.zeros_like(R)
        for jj, o in enumerate(ops_row):
            if o < 0:
                continue
            for m in range(M):
                if m >> jj & 1:
                    continue
                img = R[:, m].astype(np.float32) @ P[o]
                add[:, m | 1 << jj] |= img > 0.5
        R = R | add
    if j < 0:
        return R
    out = np.zeros_like(R)
    for m in range(M):
        if not m >> j & 1:
            out[:, m] = R[:, m | 1 << j]
    return out


def test_basis_layout_full_basis_replay():
    """At the full basis (E = D: every config of every chunk), the K2
    layout — lanes the chunks side by side, seed groups the basis
    configs, ``R0[e·M + m, c·S + s]`` one-hot — run through
    ``batch_walk_plain`` gives each config's image that a numpy replay
    of the reference's walk gives, and that the reference's jitted
    basis walk gives."""
    import jax.numpy as jnp

    b = fx_pt.gen_history("cas", n_ops=60, processes=3, seed=7)
    model = m_pt.cas_register()
    memo, stream, _T, S_pad, M = reach_pt._prep(
        model, h_pt.pack(b), max_states=100_000, max_slots=20,
        max_dense=1 << 22)
    W = max(stream.W, 1)
    D = S_pad * M
    P = reach_pt._build_P(memo, S_pad)
    rs = reach_pt.ev.returns_view(stream)
    n_chunks = 3
    per = -(-rs.n_returns // n_chunks)
    rs_p = reach_pt.ev.pad_returns(rs, n_chunks * per)
    ret_c = rs_p.ret_slot.reshape(n_chunks, per)
    ops_c = rs_p.slot_ops.reshape(n_chunks, per, W)
    basis = np.zeros((n_chunks, D, S_pad, M), bool)
    for c in range(n_chunks):
        for e in range(D):
            basis[c, e, e // M, e % M] = True
    # the layout by explicit loops
    R0 = np.zeros((D * M, n_chunks * S_pad), np.float32)
    for c in range(n_chunks):
        for e in range(D):
            R0[e * M + e % M, c * S_pad + e // M] = 1.0
    _, final = batch_pt.batch_walk_plain(
        torch.as_tensor(P), torch.as_tensor(
            np.ascontiguousarray(ops_c.transpose(1, 0, 2)).reshape(-1)),
        torch.as_tensor(np.ascontiguousarray(ret_c.T)), torch.as_tensor(R0),
        per, W)
    final = final.numpy() > 0.5
    got = reach_pt._basis_returns_k2(P, ret_c, ops_c, basis, W, "cpu")
    replay = np.zeros_like(got)
    for c in range(n_chunks):
        for e in range(D):
            replay[c, e] = final[e * M:(e + 1) * M,
                                 c * S_pad:(c + 1) * S_pad].T
    assert np.array_equal(got, replay)
    # the numpy replay of the reference's walk, config by config
    for c in range(n_chunks):
        for e in range(0, D, 7):
            R = basis[c, e]
            for r in range(per):
                R = _ret_step_np(P, R, int(ret_c[c, r]), ops_c[c, r])
            assert np.array_equal(got[c, e], R), (c, e)
    # and the reference's jitted basis walk on the same operands
    xc, bm = reach_ref._xor_bitmask(W, M)
    ref = reach_ref._jitted_basis_returns()(
        jnp.asarray(P), jnp.asarray(xc), jnp.asarray(bm),
        jnp.asarray(ret_c), jnp.asarray(ops_c), jnp.asarray(basis))
    assert np.array_equal(np.asarray(ref), got)
    # the batched torch walk (outside K2's envelope) is the same walk
    tc = reach_pt._basis_returns_torch(
        torch.as_tensor(P), torch.as_tensor(xc), torch.as_tensor(bm),
        ret_c, ops_c, torch.as_tensor(basis))
    assert np.array_equal(tc.numpy(), got)


def test_basis_groups_split_past_the_grid(monkeypatch):
    """More seed groups than one launch takes go in several K2 launches
    with the same images."""
    b = fx_pt.gen_history("cas", n_ops=60, processes=3, seed=7)
    want = reach_pt.check_chunked(m_pt.cas_register(), b, n_chunks=3,
                                  device="cpu")
    calls = []
    real = batch_pt.batch_walk

    def counted(*a):
        calls.append(a[3].shape[0])
        return real(*a)

    monkeypatch.setattr(batch_pt, "batch_walk", counted)
    monkeypatch.setattr(reach_pt, "_K2_MAX_GROUPS", 16)
    got = reach_pt.check_chunked(m_pt.cas_register(), b, n_chunks=3,
                                 device="cpu")
    assert got["valid"] == want["valid"] and len(calls) > 1

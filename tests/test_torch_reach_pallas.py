"""The wide walks (kernels K4 and K5's module) against the reference, on
the CPU.

The reference's first-generation Pallas kernels run in interpret mode;
the port's ``walk`` and ``keyed_walk`` run their plain PyTorch versions,
which the CUDA kernels are held against bit for bit on the card by
``chip_smoke.py``. Every comparison is exact: the config sets are 0/1
and the indices integers. Then the routes: ``Linearizable`` on histories
with more than 32 states takes K4, and the ``independent`` checker on
keys whose union alphabet has more than 32 states takes K5, through the
native keyed lane; verdicts, failing ops, dead events and witnesses
equal the reference facade's, and every key's result (a valid key's in
the union geometry) equals the reference's ``_union_results_parts`` on
the port's dead vector.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import independent as ind_ref
from jepsen_tpu import models as m_ref
from jepsen_tpu.checkers import events as ev_ref
from jepsen_tpu.checkers import facade as fa_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.checkers import reach_pallas as pallas_ref
from jepsen_tpu_torch import Linearizable, independent, obs
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch import models as m_pt
from jepsen_tpu_torch.checkers import facade as fa_pt
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_lane as lane_pt
from jepsen_tpu_torch.checkers import reach_pallas as pallas_pt

# tiny tensors: one thread each keeps the parallel test workers from
# crowding each other's cores
torch.set_num_threads(1)

KEYS = ("valid", "op", "dead-event", "max-linearized", "final-configs",
        "previous-ok", "events", "slots", "states")

MODEL = {"cas": "cas_register", "multi": "multi_register",
         "mutex": "mutex", "register": "register"}

# (kind, generator options): wide alphabets first (S_pad 64), then
# narrow ones (one word a mask)
WIDE_MULTI = ("multi", dict(n_ops=60, processes=5, values=3, keys=3))
WIDE_CAS = ("cas", dict(n_ops=300, processes=5, values=40))


def _history(fx, kind, kw, seed, corrupt=False):
    h = fx.gen_history(kind, seed=seed, **kw)
    return fx.corrupt(h, seed=seed) if corrupt else h


def _operands(kind, kw, seed, corrupt=False):
    """Reference-built numpy operands: ``(P, returns view, one-hot R0)``."""
    reach_ref._MEMO_CACHE.clear()
    memo, stream, _T, S_pad, M = reach_ref._prep(
        getattr(m_ref, MODEL[kind])(),
        h_ref.pack(_history(fx_ref, kind, kw, seed, corrupt)),
        max_states=100_000, max_slots=20, max_dense=1 << 22)
    R0 = np.zeros((S_pad, M), bool)
    R0[0, 0] = True
    return reach_ref._build_P(memo, S_pad), ev_ref.returns_view(stream), R0


def _ref_walk(P, ret_slot, slot_ops, R0_ms, B, rlim):
    """The reference kernel ``_walk_call`` in interpret mode on the
    stream padded to whole blocks of ``B``: ``(dead, R_final [M, S])``."""
    R = ret_slot.shape[0]
    W = slot_ops.shape[1]
    R_pad = max(B, -(-R // B) * B)
    ret_p = np.full(R_pad, -1, np.int32)
    ops_p = np.full((R_pad, W), -1, np.int32)
    ret_p[:R], ops_p[:R] = ret_slot, slot_ops
    M, S = R0_ms.shape
    run = pallas_ref._walk_call(B, W, M, S, P.shape[0], R_pad, True)
    R_out, dead = run(jnp.asarray([rlim], jnp.int32), jnp.asarray(ret_p),
                      jnp.asarray(ops_p.reshape(-1)),
                      jnp.asarray(R0_ms, jnp.float32), jnp.asarray(P))
    return int(dead[0]), np.asarray(R_out)


@pytest.mark.parametrize("kind,kw,seed,corrupt", [
    WIDE_MULTI + (0, False), WIDE_MULTI + (1, True),
    WIDE_CAS + (0, False), WIDE_CAS + (2, True),
    ("cas", dict(n_ops=150, processes=5, values=40, crash_p=0.03), 3,
     False),
    ("cas", dict(n_ops=150, processes=5, values=40, crash_p=0.03), 4, True),
    ("cas", dict(n_ops=80, processes=3), 5, True),
    ("mutex", dict(n_ops=60, processes=3), 6, False)])
def test_walk_plain_matches_pallas_interpret(kind, kw, seed, corrupt):
    """``dead`` and ``R_final`` of the port's walk (its plain version on
    the CPU) equal the reference kernel's, through the host side too."""
    P, rs, R0 = _operands(kind, kw, seed, corrupt)
    d_ref, R_ref = pallas_ref.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                           interpret=True)
    d_pt, R_pt = pallas_pt.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                        device="cpu")
    assert d_pt == d_ref
    np.testing.assert_array_equal(R_pt, R_ref)
    assert (d_pt >= 0) == corrupt
    assert (P.shape[1] > 32) == (kind == "multi" or "values" in kw)


@pytest.mark.parametrize("case", ["multi-block", "rlim", "seed"])
def test_walk_plain_matches_kernel_variants(case):
    """The reference kernel at a small block (many grid steps), with
    ``rlim`` below the stream's length, and from a seed that is not
    one-hot; the port's plain version on the same operands."""
    corrupt = case != "seed"
    P, rs, R0 = _operands(*WIDE_CAS, seed=2, corrupt=corrupt)
    R0_ms = R0.T.astype(np.float32)
    B, rlim = 1024, rs.n_returns
    if case == "multi-block":
        B = 16
    elif case == "rlim":
        d_full, _ = _ref_walk(P, rs.ret_slot, rs.slot_ops, R0_ms, B, rlim)
        assert d_full > 0
        rlim = d_full                    # the death lies past the limit
    else:
        rng = np.random.default_rng(0)
        R0_ms = (rng.random(R0_ms.shape) < 0.1).astype(np.float32)
    d_ref, R_ref = _ref_walk(P, rs.ret_slot, rs.slot_ops, R0_ms, B, rlim)
    t = pallas_pt.operands_from_numpy(P, rs.ret_slot, rs.slot_ops,
                                      R0_ms.T > 0.5, device="cpu")
    d_pt, R_pt = pallas_pt.walk_plain(*t, rlim)
    assert int(d_pt[0]) == d_ref
    np.testing.assert_array_equal(R_pt.numpy(), R_ref)
    if case == "rlim":
        assert d_ref == -1 and not R_ref.any()
    if case == "multi-block":
        assert rs.n_returns > 3 * B and d_ref >= 0


def test_walk_plain_empty_seed_and_stream():
    """An empty seed dies at the first return below ``rlim``; an empty
    stream returns the seed."""
    P, rs, R0 = _operands(*WIDE_MULTI, seed=0)
    t = pallas_pt.operands_from_numpy(P, rs.ret_slot, rs.slot_ops, R0,
                                      device="cpu")
    empty = torch.zeros_like(t[3])
    for rlim, want in ((5, 0), (0, -1)):
        d_ref, _ = _ref_walk(P, rs.ret_slot, rs.slot_ops, empty.numpy(),
                             1024, rlim)
        d_pt, R_pt = pallas_pt.walk(*t[:3], empty, rlim)
        assert int(d_pt[0]) == d_ref == want and not R_pt.any()
    d, R = pallas_pt.walk(t[0], t[1][:0], t[2][:0], t[3], 0)
    assert int(d[0]) == -1 and torch.equal(R, t[3])


def _keyed_history(fx, n_keys, kw, bad):
    """``n_keys`` single-key histories (each with its own processes),
    values wrapped as ``[key, v]`` and concatenated; keys in ``bad``
    corrupted."""
    out = []
    procs = kw["processes"]
    for k in range(n_keys):
        hk = _history(fx, "cas", kw, k, k in bad)
        out += [op.with_(process=k * procs + op.process,
                         value=[k, op.value]) for op in hk]
    return [op.with_(index=i, time=i) for i, op in enumerate(out)]


def _keyed_operands(n_keys, kw, bad):
    """The reference's flat keyed operands over the union alphabet."""
    model = m_ref.cas_register()
    reach_ref._MEMO_CACHE.clear()
    packed = [h_ref.pack(_history(fx_ref, "cas", kw, k, k in bad))
              for k in range(n_keys)]
    preps = [reach_ref._prep(model, p, max_states=100_000, max_slots=20,
                             max_dense=1 << 22) for p in packed]
    W = max(max(p[1].W, 1) for p in preps)
    rss = [ev_ref.returns_view(p[1]) for p in preps]
    P, ret, ops, key, _off, _wide = reach_ref._keyed_operands(
        model, packed, rss, list(range(n_keys)), W, 100_000)
    return P, ret, ops, key, 1 << W


KEYED_KW = dict(n_ops=50, processes=4, values=40)


@pytest.mark.parametrize("block", [1024, 16])
def test_keyed_walk_matches_reference(monkeypatch, block):
    """Every key's dead index from the port's keyed walk (and its plain
    version on the same tensors) equals the reference's interpret-mode
    kernel, on mixed valid and corrupted keys whose union alphabet has
    more than 32 states; at a small block the keys cross grid steps."""
    monkeypatch.setattr(pallas_ref, "_BLOCK", block)
    n_keys, bad = 12, {1, 4, 5, 11}
    P, ret, ops, key, M = _keyed_operands(n_keys, KEYED_KW, bad)
    assert P.shape[1] > 32
    d_ref = pallas_ref.walk_returns_keyed(P, ret, ops, key, n_keys, M,
                                          interpret=True)
    d_pt = pallas_pt.walk_returns_keyed(P, ret, ops, key, n_keys, M,
                                        device="cpu")
    np.testing.assert_array_equal(d_pt, d_ref)
    assert set(np.nonzero(d_pt >= 0)[0]) == bad
    t = [torch.as_tensor(np.ascontiguousarray(a, dt)) for a, dt in
         ((P, np.float32), (ret, np.int32), (ops, np.int32),
          (key, np.int32))]
    np.testing.assert_array_equal(
        pallas_pt.keyed_walk_plain(*t, n_keys).numpy(), d_ref)


def _ref_check(kind, history):
    """The reference facade's verdict (multi-register models straight to
    its ``auto`` chain, past the per-key decomposition both packages try
    first, so that the dense engine's route decides)."""
    reach_ref._MEMO_CACHE.clear()
    model = getattr(m_ref, MODEL[kind])()
    if kind == "multi":
        return fa_ref.auto_check_packed(model, h_ref.pack(history), {})
    return fa_ref.Linearizable(model).check(None, history)


def _same(r_ref, r_pt):
    diff = {k: (r_ref.get(k), r_pt.get(k)) for k in KEYS
            if r_ref.get(k) != r_pt.get(k)}
    assert not diff, diff


@pytest.mark.parametrize("kind,kw,seed,corrupt", [
    WIDE_MULTI + (0, False), WIDE_MULTI + (1, True),
    WIDE_CAS + (0, False), WIDE_CAS + (2, True),
    ("cas", dict(n_ops=150, processes=5, values=40, crash_p=0.03), 4,
     True)])
def test_linearizable_wide_matches_reference(kind, kw, seed, corrupt):
    """Above 32 states ``Linearizable`` takes K4 (route ``reach-pallas``)
    and gives the reference facade's verdict, op, dead event and
    witness; the witness prefix is re-walked by K4 too."""
    h1 = _history(fx_ref, kind, kw, seed, corrupt)
    h2 = _history(fx_pt, kind, kw, seed, corrupt)
    r_ref = _ref_check(kind, h1)
    model = getattr(m_pt, MODEL[kind])()
    with obs.capture() as cap:
        if kind == "multi":
            r_pt = fa_pt.auto_check_packed(model, h_pt.pack(h2),
                                           {"device": "cpu"})
        else:
            r_pt = Linearizable(model, device="cpu").check(None, h2)
    _same(r_ref, r_pt)
    assert r_pt["valid"] is (not corrupt)
    assert r_pt["engine"] == "reach-pallas" and r_pt["states"] > 32
    assert [r["engine"] for r in cap.ledger if r["event"] == "route"] == \
        ["reach-pallas"]
    skipped = {r["stage"]: r["cause"] for r in cap.skipped()}
    assert skipped["reach-chunklock"] == "below-min-returns"
    if corrupt:
        assert r_pt["final-configs"] and r_pt["previous-ok"]


def test_wide_walk_aborts_between_segments(monkeypatch):
    """With ``should_abort`` K4 walks segments with the set carried: the
    same dead return and final set as one walk; a hook that fires gives
    ``valid == "unknown"``."""
    monkeypatch.setattr(lane_pt, "_ABORT_SEG", 16)
    calls = []

    def hook():
        calls.append(1)
        return False

    for corrupt in (False, True):
        P, rs, R0 = _operands(*WIDE_CAS, seed=2, corrupt=corrupt)
        calls.clear()
        got = pallas_pt.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                     device="cpu", should_abort=hook)
        want = pallas_pt.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                      device="cpu")
        assert got[0] == want[0] and np.array_equal(got[1], want[1])
        assert len(calls) > 1
    h = _history(fx_pt, *WIDE_CAS, seed=0)
    res = reach_pt.check(m_pt.cas_register(), h, should_abort=lambda: True,
                         device="cpu")
    assert res == {"valid": "unknown", "cause": "aborted", "engine": "reach"}


def _ref_union_results(history, r_pt):
    """The reference's ``_union_results_parts`` (engine ``reach-keyed``)
    over the keys of ``history``, packed as the independent checker packs
    them, on the dead vector of the port's results (a failed key's
    ``max-linearized`` is its dead return): ``{key: result}``."""
    model = m_ref.cas_register()
    subs = ind_ref.split_history(history)
    keys = sorted(subs, key=repr)
    packed = [h_ref.pack(subs[k]) for k in keys]
    live = list(range(len(packed)))
    sa = reach_ref._union_stage_a(model, packed, live, 100_000)
    _r, _o, key_W, key_R, _off, _W = reach_ref._union_pack_group(
        sa, live, 20)
    dead = np.array([-1 if r_pt["results"][k]["valid"] else
                     r_pt["results"][k]["max-linearized"] for k in keys])
    out = reach_ref._union_results_parts(
        "reach-keyed", model, packed, live, dead, sa.memo_u, key_W, key_R,
        sa.drop_per_key(), 0.0, 100_000, 20, 1 << 22)
    return dict(zip(keys, out))


def _check_independent(kw, n_keys, bad):
    """Both packages' independent checks: the verdict fields against the
    reference's check, every field against its union accounting."""
    h1 = _keyed_history(fx_ref, n_keys, kw, bad)
    h2 = _keyed_history(fx_pt, n_keys, kw, bad)
    reach_ref._MEMO_CACHE.clear()
    r_ref = ind_ref.checker(fa_ref.linearizable(
        m_ref.cas_register())).check(None, h1)
    with obs.capture() as cap:
        r_pt = independent.checker(Linearizable(
            m_pt.cas_register(), device="cpu")).check(None, h2)
    for k in ("valid", "failures", "key-count"):
        assert r_pt[k] == r_ref[k], k
    verdict = tuple(x for x in KEYS if x not in ("events", "slots",
                                                 "states"))
    union = _ref_union_results(h1, r_pt)
    for key, a in r_ref["results"].items():
        b = r_pt["results"][key]
        diff = {x: (a.get(x), b.get(x)) for x in verdict
                if a.get(x) != b.get(x)}
        assert not diff, (key, diff)
        diff = {x: (union[key].get(x), b.get(x))
                for x in KEYS + ("engine", "dropped-crashed-noops")
                if union[key].get(x) != b.get(x)}
        assert not diff, (key, diff)
    return r_pt, cap


@pytest.mark.parametrize("kw,n_keys,bad", [
    (KEYED_KW, 10, {2, 7}),
    # keys of more than 32 states of their own: a failed key's witness
    # is re-walked by K4 in the key's own geometry
    (dict(n_ops=300, processes=5, values=40), 3, {1})])
def test_independent_wide_matches_reference(monkeypatch, kw, n_keys, bad):
    """A union alphabet above 32 states is outside K2's envelope and
    takes K5 through the native keyed lane (route cause ``keyed-wide``);
    every key's result equals the reference's."""
    monkeypatch.setattr(reach_ref, "_seed_union_memo", lambda *a: None)
    r_pt, cap = _check_independent(kw, n_keys, bad)
    assert r_pt["valid"] is False and set(r_pt["failures"]) == bad
    assert [r.get("cause") for r in cap.ledger if r["event"] == "route"
            and r["stage"] == "reach-many"] == ["keyed-wide"]
    assert {r["engine"] for r in r_pt["results"].values()} == \
        {"reach-keyed"}
    for key in r_pt["failures"]:
        assert r_pt["results"][key]["final-configs"]


def test_fits_is_the_kernel_envelope():
    """``fits`` admits every geometry of more than 32 states that the
    reference's ``_pallas_fits`` admits and whose set fits one block's
    shared memory, and refuses sets beyond it and more than 20 slots."""
    assert pallas_pt.fits(64, 32, 734)          # wide cas: P in memory
    assert not pallas_pt.p_shared(5, 64, 735)
    assert pallas_pt.fits(64, 32, 20)           # multi-register: P shared
    assert pallas_pt.p_shared(5, 64, 21)
    assert pallas_pt.fits(8, 32, 35)            # one word a mask
    assert not pallas_pt.fits(64, 1 << 14, 10)  # set beyond 227 KB
    assert not pallas_pt.fits(2, 1 << 21, 3)    # > 20 slots
    for S in (64, 128, 256, 512, 1024, 4096):
        for W in range(1, 21):
            set_bytes = pallas_pt.smem_bytes(W, S, 1) - \
                pallas_pt.table_bytes(S, 1) * pallas_pt.p_shared(W, S, 1)
            for n_ops in (1, 30, 700, 5000):
                if reach_ref._pallas_fits(S, 1 << W, n_ops) and \
                        set_bytes <= pallas_pt._SMEM_BYTES:
                    assert pallas_pt.fits(S, 1 << W, n_ops), (S, W, n_ops)


def test_wrappers_route_by_device(monkeypatch):
    """``walk`` and ``keyed_walk`` take the plain version only for CPU
    tensors; any other device is the kernel's or an error."""
    calls = []
    monkeypatch.setattr(pallas_pt, "walk_plain",
                        lambda *a: calls.append("plain"))
    monkeypatch.setattr(pallas_pt, "keyed_walk_plain",
                        lambda *a: calls.append("plain"))
    t = torch.zeros(1)
    pallas_pt.walk(t, t, t, t, 1)
    pallas_pt.keyed_walk(t, t, t, t, 1)
    assert calls == ["plain", "plain"]
    meta = torch.zeros(1, device="meta")
    with pytest.raises(ValueError):
        pallas_pt.walk(t, t, t, meta, 1)
    with pytest.raises(ValueError):
        pallas_pt.keyed_walk(meta, t, t, t, 1)
    assert calls == ["plain", "plain"]


# -- the redesigned body's host side: image tables, layout, form ---------------

def _alphabet(kind, S):
    """The wide cas (41 states) or multi-register (64 states) alphabet's
    P, cut or zero-padded to ``S`` states."""
    P, _rs, _R0 = _operands(*(WIDE_CAS if kind == "cas" else WIDE_MULTI),
                            seed=0)
    n = min(S, P.shape[1])
    out = np.zeros((P.shape[0], S, S), np.float32)
    out[:, :n, :n] = P[:, :n, :n]
    return out


def _words(bits):
    """bool [..., 32·n] as uint32 words [..., n], bit i of word w the
    element 32w + i."""
    packed = np.packbits(bits.reshape(*bits.shape[:-1], -1, 32), axis=-1,
                         bitorder="little")
    return np.ascontiguousarray(packed).view("<u4")[..., 0]


def _bits(words, S):
    """uint32 words [..., n] as bool [..., S]."""
    b = np.unpackbits(words.astype("<u4")[..., None].view(np.uint8),
                      axis=-1, bitorder="little")
    return b.reshape(*words.shape[:-1], -1)[..., :S].astype(bool)


@pytest.mark.parametrize("kind", ["cas", "multi"])
@pytest.mark.parametrize("S", [33, 41, 64, 100])
def test_image_tables_plain_matches_state_images(kind, S):
    """Word w of a set's image under op o, OR over its nibbles k of
    ``T[o, k, nibble]``, equals the image computed state by state, on
    random sets from a numpy seed; padding words and empty nibbles are
    zero."""
    P = _alphabet(kind, S)
    O1 = P.shape[0]
    T = pallas_pt.image_tables_plain(torch.from_numpy(P)).numpy()
    K, NT = pallas_pt.n_nibbles(S), pallas_pt.table_words(S)
    assert T.shape == (O1, K, 16, NT) and T.dtype == np.int32
    Tu = T.view(np.uint32)
    assert not Tu[:, :, 0].any()
    assert not Tu[..., pallas_pt.n_words(S):].any()
    rng = np.random.default_rng(S)
    for density in (0.03, 0.2, 0.7):
        x = rng.random((16, S)) < density
        ops = rng.integers(0, O1, 16)
        xw = _words(np.pad(x, ((0, 0), (0, 32 * NT - S))))
        for i in range(len(x)):
            want = np.zeros(S, bool)
            for s in np.nonzero(x[i])[0]:
                want |= P[ops[i], s] > 0.5
            got = np.zeros(NT, np.uint32)
            for k in range(K):
                nib = (xw[i, k // 8] >> np.uint32(4 * (k % 8))) & 15
                got |= Tu[ops[i], k, nib]
            np.testing.assert_array_equal(_bits(got, 32 * NT)[:S], want)
            assert not _bits(got, 32 * NT)[S:].any()


def _table_walk(P, ret_slot, slot_ops, R0_ms, rlim):
    """The kernels' arithmetic in numpy: mask m's set as NT words, each
    return's up to ``c`` passes firing slot j's op into the masks with
    bit j from the partner's pass-start words, one table entry a nibble,
    until a pass adds nothing; then the projection; the walk stops at
    the first empty set. Returns
    ``(dead, final bool [M, S])``."""
    T = pallas_pt.image_tables_plain(torch.from_numpy(P)).numpy()
    Tu = T.view(np.uint32)
    _O1, K, _, NT = T.shape
    M, S = R0_ms.shape
    W = slot_ops.shape[1]
    x = _words(np.pad(R0_ms > 0.5, ((0, 0), (0, 32 * NT - S))))
    masks = np.arange(M)
    dead = 0 if len(ret_slot) and not x.any() else -1
    for r in range(len(ret_slot) if dead < 0 else 0):
        ops = slot_ops[r]
        for _ in range(int((ops >= 0).sum())):
            acc = x.copy()
            for j in np.nonzero(ops >= 0)[0]:
                hi = masks[(masks >> j) & 1 == 1]
                y = x[hi ^ (1 << j)]
                for k in range(K):
                    nib = (y[:, k // 8] >> np.uint32(4 * (k % 8))) & 15
                    acc[hi] |= Tu[ops[j], k, nib]
            x, grew = acc, (acc != x).any()
            if not grew:                # the fixpoint: the rest are identity
                break
        js = ret_slot[r]
        if js >= 0:
            x = np.where((masks[:, None] >> js) & 1 == 1, np.uint32(0),
                         x[masks | (1 << js)])
            if not x.any():
                dead = r
                break
    return (dead if dead < rlim else -1), _bits(x, S)


@pytest.mark.parametrize("kind,kw,seed,corrupt,S", [
    WIDE_MULTI + (0, False, 64), WIDE_MULTI + (1, True, 64),
    WIDE_CAS + (0, False, 64), WIDE_CAS + (2, True, 64),
    WIDE_CAS + (0, False, 80),          # NW = 3 in entries of 4 words
    WIDE_MULTI + (0, False, 100),       # NW = NT = 4
    ("cas", dict(n_ops=80, processes=3), 5, True, 8)])   # one word
def test_table_walk_matches_walk_plain(kind, kw, seed, corrupt, S):
    """The kernels' walk on the nibble tables (numpy, word by word)
    gives the plain version's dead return and final set, at one, two,
    three (padded to four) and four words a mask."""
    P0, rs, _ = _operands(kind, kw, seed, corrupt)
    n = P0.shape[1]
    P = np.zeros((P0.shape[0], S, S), np.float32)
    P[:, :n, :n] = P0
    M = 1 << rs.W
    R0 = np.zeros((S, M), bool)
    R0[0, 0] = True
    t = pallas_pt.operands_from_numpy(P, rs.ret_slot, rs.slot_ops, R0,
                                      device="cpu")
    d_plain, R_plain = pallas_pt.walk_plain(*t, rs.n_returns)
    d, R = _table_walk(P, rs.ret_slot, rs.slot_ops, R0.T, rs.n_returns)
    assert d == int(d_plain[0]) and (d >= 0) == corrupt
    np.testing.assert_array_equal(R, R_plain.numpy() > 0.5)


def _old_envelope(W, S):
    """The envelope of the previous body, where the block form held
    every walk: the set ``[2, M, NW]`` and a chunk of the stream in one
    block's shared memory."""
    return 1 <= W <= 20 and 4 * (2 * (1 << W) * pallas_pt.n_words(S)
                                 + 256 * (W + 1)) <= 227 * 1024


@pytest.mark.parametrize("W,S,n_ops", [
    (5, 64, 20), (5, 64, 734),          # multi-register, wide cas
    (7, 64, 18), (12, 64, 20), (12, 64, 734),
    (13, 64, 20),                       # the largest W at S = 64
    (9, 1024, 5), (13, 32 + 1, 40)])
def test_fits_keeps_pinned_geometries(W, S, n_ops):
    """Each pinned geometry the previous layout took still routes to K4
    (past the lane kernel) and, as a union, to K5."""
    M = 1 << W
    assert _old_envelope(W, S)
    assert pallas_pt.fits(S, M, n_ops)
    assert not lane_pt.lane_fits(S, M, n_ops)
    assert reach_pt._keyed_kernel(S, M, n_ops) == "keyed-wide"


def test_fits_equals_the_previous_envelope():
    """``fits`` takes exactly the geometries the previous layout took:
    the warp form needs less shared memory, but only where the block
    form fitted anyway; W = 20, the kernels' slot limit, fits at no S
    (its set alone is 2^21 words), and more slots never."""
    for W in range(1, 23):
        for S in (1, 2, 8, 32, 33, 41, 64, 100, 128, 256, 257, 512, 1024,
                  4096):
            for O1 in (2, 21, 735, 5000):
                assert pallas_pt.fits(S, 1 << W, O1 - 1) == \
                    _old_envelope(W, S), (W, S, O1)
    assert not any(pallas_pt.fits(S, 1 << 20, 10) for S in (1, 64, 1024))
    assert pallas_pt.fits(64, 1 << 13, 20)
    assert not pallas_pt.fits(64, 1 << 14, 20)


@pytest.mark.parametrize("W,S,warp", [
    (5, 256, True), (5, 257, False), (6, 256, False), (6, 33, False),
    (1, 1, True), (4, 64, True), (5, 64, True), (1, 257, False),
    (20, 64, False)])
def test_form_selection_boundaries(W, S, warp):
    """The warp form exactly when W <= 5 and NW <= 8, and the layout
    each form takes: no set in shared memory in the warp form, the set
    double-buffered in the block form; the tables join when they fit."""
    assert pallas_pt.warp_form(W, S) is warp
    NW = pallas_pt.n_words(S)
    chunk = 4 * 256 * (W + 1)
    set_bytes = 0 if warp else 8 * (1 << W) * NW
    T = pallas_pt.table_bytes(S, 3)
    shared = set_bytes + chunk + T <= 227 * 1024
    assert pallas_pt.p_shared(W, S, 3) is shared
    assert pallas_pt.smem_bytes(W, S, 3) == set_bytes + chunk + T * shared


def test_table_layout():
    """Entries of NT words: NW rounded up to a power of two up to 8,
    else NW; K = ceil(S / 4) nibbles, rounded up to a power of two up to
    256 states (8·NT at 33 states and more); the two alphabets' table
    sizes."""
    words = {1: (1, 1), 5: (1, 2), 17: (1, 8), 32: (1, 8), 33: (2, 16),
             64: (2, 16), 65: (4, 32), 96: (4, 32), 128: (4, 32),
             129: (8, 64), 256: (8, 64), 257: (9, 65), 1024: (32, 256)}
    for S, (nt, k) in words.items():
        assert pallas_pt.table_words(S) == nt, S
        assert pallas_pt.n_nibbles(S) == k, S
    assert pallas_pt.table_bytes(64, 21) == 43_008
    assert pallas_pt.table_bytes(64, 735) == 1_505_280
    assert pallas_pt.p_shared(5, 64, 21) and not pallas_pt.p_shared(5, 64,
                                                                    735)


def test_image_tables_routes_by_device(monkeypatch):
    """``image_tables`` takes the plain version only for a CPU tensor;
    any other device is the kernel's or an error."""
    P = torch.from_numpy(_alphabet("multi", 64))
    assert torch.equal(pallas_pt.image_tables(P),
                       pallas_pt.image_tables_plain(P))
    with pytest.raises(ValueError):
        pallas_pt.image_tables(torch.zeros(2, 4, 4, device="meta"))

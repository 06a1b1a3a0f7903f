"""The lane walk (kernel K1's module) against the reference, on the CPU.

The reference's Pallas lane kernel runs in interpret mode; the port's
``lane_walk`` runs its plain PyTorch version, which the CUDA kernel is
held against bit for bit on the card by ``chip_smoke.py``. Every
comparison is exact: the config sets are 0/1 and the indices integers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu.checkers import events as ev_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.checkers import reach_lane as lane_ref
from jepsen_tpu.op import invoke, ok
from jepsen_tpu_torch.checkers import reach as reach_pt
from jepsen_tpu_torch.checkers import reach_lane as lane_pt


# tiny tensors: one thread each keeps the parallel test workers from
# crowding each other's cores
torch.set_num_threads(1)


def _operands(kind, history):
    """Reference-built numpy operands (what both walks consume)."""
    reach_ref._MEMO_CACHE.clear()
    memo, stream, T, S_pad, M = reach_ref._prep(
        fx_ref.model_for(kind), h_ref.pack(history), max_states=100_000,
        max_slots=20, max_dense=1 << 22)
    rs = ev_ref.returns_view(stream)
    R0 = np.zeros((S_pad, M), bool)
    R0[0, 0] = True
    return reach_ref._build_P(memo, S_pad), rs, R0


def _history(kind, seed, corrupt, n_ops=40, processes=3):
    h = fx_ref.gen_history(kind, n_ops=n_ops, processes=processes,
                           seed=seed)
    return fx_ref.corrupt(h, seed=seed) if corrupt else h


def _deep_chain_history(depth: int):
    """A linearizable history whose first return can only fire as a
    ``depth``-long chain: cas(0,1), ..., cas(depth-2, depth-1) and a read
    of depth-1 are all pending when the read returns first."""
    h = [invoke(0, "write", 0), ok(0, "write", 0)]
    for p in range(depth - 1):
        h.append(invoke(p, "cas", (p, p + 1)))
    h.append(invoke(depth - 1, "read"))
    h.append(ok(depth - 1, "read", depth - 1))
    for p in range(depth - 1):
        h.append(ok(p, "cas", (p, p + 1)))
    return h


@pytest.mark.parametrize("kind,seed,corrupt,n_pass", [
    ("cas", 0, False, 8), ("cas", 1, True, 8), ("cas", 2, False, 2),
    ("register", 3, True, 8), ("mutex", 4, False, 1)])
def test_plain_matches_pallas_interpret(kind, seed, corrupt, n_pass):
    """ckpt and final of ``lane_walk_plain`` equal the reference kernel's
    ``_lane_call(..., interpret=True)`` at B=32, including capped
    ladders (n_pass below the pending counts); a dead walk's checkpoints
    past its dead return are empty."""
    P, rs, R0 = _operands(kind, _history(kind, seed, corrupt, n_ops=80))
    B = 32
    args = lane_pt.operands_from_numpy(P, rs.ret_slot, rs.slot_ops, R0,
                                       B=B, device="cpu")
    Pt, ret_t, ops_t, R0t = args
    R_pad, W = ops_t.shape
    M, S = R0t.shape
    n_pass = min(n_pass, W)
    run = lane_ref._lane_call(B, W, M, S, P.shape[0], R_pad, n_pass, True)
    ck_ref, fin_ref = run(jnp.asarray(ret_t.numpy()),
                          jnp.asarray(ops_t.numpy().reshape(-1)),
                          jnp.asarray(P), jnp.asarray(R0t.numpy()))
    ck, fin, dead = lane_pt.lane_walk(*args, B, n_pass)
    assert R_pad // B >= 2                  # more than one checkpoint
    np.testing.assert_array_equal(ck.numpy(), np.asarray(ck_ref))
    np.testing.assert_array_equal(fin.numpy(), np.asarray(fin_ref))
    d = int(dead[0])
    assert (d >= 0) == (not fin.any())
    if d >= 0:
        assert not ck[d // B + 1:].any()


# mutex histories have no reads, so they are never corrupted
@pytest.mark.parametrize("kind,corrupt", [
    ("cas", False), ("cas", True), ("register", False), ("register", True),
    ("mutex", False)])
def test_walk_returns_matches_reference(kind, corrupt):
    """Dead index and final set of the port's walk equal the reference
    lane walk's, valid and corrupted."""
    P, rs, R0 = _operands(kind, _history(kind, 1, corrupt))
    d_ref, R_ref = lane_ref.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                         interpret=True)
    d_pt, R_pt = lane_pt.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                      device="cpu", B=32)
    assert d_pt == d_ref
    assert (d_ref >= 0) == corrupt
    if d_ref < 0:
        np.testing.assert_array_equal(R_pt, R_ref)


def test_multiblock_death_in_middle_block():
    """Death in a middle block of many, as the walk reports it."""
    h = fx_ref.corrupt(fx_ref.gen_history("cas", n_ops=120, processes=4,
                                          seed=9), seed=0)
    P, rs, R0 = _operands("cas", h)
    d_ref, _ = lane_ref.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                     interpret=True)
    d_pt, _ = lane_pt.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                   device="cpu", B=8)
    assert d_pt == d_ref and 16 <= d_pt < rs.n_returns - 16


@pytest.mark.parametrize("depth", [3, 5])
def test_deep_chains_stay_exact(depth):
    P, rs, R0 = _operands("cas", _deep_chain_history(depth))
    d_pt, R_pt = lane_pt.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                      device="cpu", B=32)
    d_ref, R_ref = lane_ref.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                         interpret=True)
    assert d_pt == d_ref == -1
    np.testing.assert_array_equal(R_pt, R_ref)


def test_rescue_path_forced(monkeypatch):
    """With the ladder capped at 2 passes a 4-deep chain falsely dies in
    the fast walk; the exact rescue makes it valid, in both packages,
    with the same final set."""
    monkeypatch.setattr(lane_ref, "_FAST_PASSES", 2)
    monkeypatch.setattr(lane_pt, "_FAST_PASSES", 2)
    P, rs, R0 = _operands("cas", _deep_chain_history(4))
    assert rs.W >= 4
    args = lane_pt.operands_from_numpy(P, rs.ret_slot, rs.slot_ops, R0,
                                       B=32, device="cpu")
    _, capped, _ = lane_pt.lane_walk(*args, 32, 2)
    assert not capped.any()                 # the capped walk dies ...
    d_pt, R_pt = lane_pt.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                      device="cpu", B=32)
    d_ref, R_ref = lane_ref.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                         interpret=True)
    assert d_pt == d_ref == -1              # ... the rescue revives it
    np.testing.assert_array_equal(R_pt, R_ref)


def test_abortable_segments(monkeypatch):
    """The should_abort drive walks segments with the set carried and
    finds the same death; a firing hook raises Aborted."""
    monkeypatch.setattr(lane_pt, "_ABORT_SEG", 16)
    h = fx_ref.corrupt(fx_ref.gen_history("cas", n_ops=120, processes=4,
                                          seed=9), seed=2)
    P, rs, R0 = _operands("cas", h)
    d_ref, _ = lane_ref.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                     interpret=True)
    d_pt, _ = lane_pt.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                   device="cpu", B=8,
                                   should_abort=lambda: False)
    assert d_pt == d_ref
    with pytest.raises(lane_pt.Aborted):
        lane_pt.walk_returns(P, rs.ret_slot, rs.slot_ops, R0, device="cpu",
                             B=8, should_abort=lambda: True)


@pytest.mark.parametrize("corrupt", [False, True])
def test_torch_walk_returns_matches_xla_walk(corrupt):
    """The port's returns walk (and its refinement) equals the reference's
    XLA walk: pointer, final set, liveness, block set, dead event."""
    P, rs, R0 = _operands("cas", _history("cas", 5, corrupt, n_ops=60))
    rs = ev_ref.pad_returns(rs, reach_ref._bucket(rs.n_returns,
                                                  reach_ref._UNROLL))
    W, M = rs.W, R0.shape[1]
    xc, bm = reach_ref._xor_bitmask(W, M)
    ref = reach_ref._jitted_walk_returns()(
        jnp.asarray(P), jnp.asarray(xc), jnp.asarray(bm),
        jnp.asarray(rs.ret_slot), jnp.asarray(rs.slot_ops),
        jnp.asarray(R0))
    Pt = torch.as_tensor(P)
    xct, bmt = torch.as_tensor(xc), torch.as_tensor(bm)
    out = reach_pt._walk_returns(Pt, xct, bmt, rs.ret_slot,
                                 torch.as_tensor(rs.slot_ops),
                                 torch.as_tensor(R0))
    assert out[0] == int(ref[0]) and out[2] == bool(ref[2])
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    if corrupt:
        assert not out[2]
        assert reach_pt._refine_dead(Pt, xct, bmt, rs, out[0], out[3]) == \
            reach_ref._refine_dead(jnp.asarray(P), jnp.asarray(xc),
                                   jnp.asarray(bm), rs, int(ref[0]), ref[3])


def _bad_read(process):
    """A read of a value no op writes: it can never linearize."""
    return [invoke(process, "read"), ok(process, "read", 99)]


def _dead_history(case):
    if case == "first":                 # the first return cannot linearize
        return [invoke(0, "read"), ok(0, "read", 3),
                invoke(1, "write", 3), ok(1, "write", 3)]
    if case == "middle":                # in a middle block of many
        return fx_ref.corrupt(fx_ref.gen_history(
            "cas", n_ops=120, processes=4, seed=9), seed=0)
    if case == "last":                  # the last real return, then padding
        return fx_ref.gen_history("cas", n_ops=40, processes=3,
                                  seed=1) + _bad_read(7)
    # W = 10, past the ladder's cap of 8 passes: the capped walk dies
    # falsely at the read that needs a 10-deep chain; the exact walk
    # lives on, and with a bad read at the end dies there
    chain = _deep_chain_history(10)
    return chain if case == "ladder-valid" else chain + _bad_read(20)


@pytest.mark.parametrize("case", ["first", "middle", "last",
                                  "ladder-valid", "ladder-dead"])
def test_plain_dead_matches_reference(case):
    """``lane_walk_plain``'s dead return equals the reference lane walk's
    (``walk_returns`` with ``interpret=True``), as does the port's
    ``walk_returns``; its ckpt and final equal the reference kernel's,
    the empty sets past the death included. At W = 10 the capped walk's
    false death is the rescue's to undo."""
    B = 8
    P, rs, R0 = _operands("cas", _dead_history(case))
    d_ref, _ = lane_ref.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                     interpret=True)
    args = lane_pt.operands_from_numpy(P, rs.ret_slot, rs.slot_ops, R0,
                                       B=B, device="cpu")
    Pt, ret_t, ops_t, R0t = args
    R_pad, W = ops_t.shape
    M, S = R0t.shape
    ck, fin, dead = lane_pt.lane_walk(*args, B, W)
    assert int(dead[0]) == d_ref
    assert lane_pt.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                device="cpu", B=B)[0] == d_ref
    want = {"first": 0, "middle": None, "last": rs.n_returns - 1,
            "ladder-valid": -1, "ladder-dead": rs.n_returns - 1}[case]
    if want is None:
        assert B <= d_ref < rs.n_returns - B
    else:
        assert d_ref == want
    if case == "last":
        assert R_pad > rs.n_returns         # padding follows the death
    if case.startswith("ladder"):
        assert W == 10
        assert int(lane_pt.lane_walk(*args, B, 8)[2][0]) == 1
    run = lane_ref._lane_call(B, W, M, S, P.shape[0], R_pad, W, True)
    ck_ref, fin_ref = run(jnp.asarray(ret_t.numpy()),
                          jnp.asarray(ops_t.numpy().reshape(-1)),
                          jnp.asarray(P), jnp.asarray(R0t.numpy()))
    np.testing.assert_array_equal(ck.numpy(), np.asarray(ck_ref))
    np.testing.assert_array_equal(fin.numpy(), np.asarray(fin_ref))
    if d_ref >= 0:
        assert not ck[d_ref // B + 1:].any() and not fin.any()


def test_walk_returns_runs_no_torch_walk(monkeypatch):
    """A death is the walk's own dead return: no torch returns walk
    refines it, on the plain route or the abortable one."""
    from jepsen_tpu_torch.checkers import reach as reach_pt_mod

    def no_torch_walk(*a, **k):
        raise AssertionError("the torch returns walk ran")

    monkeypatch.setattr(reach_pt_mod, "_walk_returns", no_torch_walk)
    monkeypatch.setattr(lane_pt, "_ABORT_SEG", 16)
    P, rs, R0 = _operands("cas", _dead_history("middle"))
    d_ref, _ = lane_ref.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                     interpret=True)
    for hook in (None, lambda: False):
        assert lane_pt.walk_returns(P, rs.ret_slot, rs.slot_ops, R0,
                                    device="cpu", B=8,
                                    should_abort=hook)[0] == d_ref >= 0


def _narrow_alphabet(S):
    """A cas alphabet of at most ``S`` states (``S_pad == S``): its P."""
    values = {4: 3, 8: 5, 16: 12, 32: 25}[S]
    P, _rs, _R0 = _operands("cas", fx_ref.gen_history(
        "cas", n_ops=400, processes=4, values=values, seed=S))
    assert P.shape[1] == S
    return P


@pytest.mark.parametrize("S", [4, 8, 16, 32])
def test_narrow_tables_match_state_images(S):
    """At most 32 states an image table entry is one word and a table
    K = 1, 2, 4 or 8 nibbles: the OR over a set's nibbles k of
    ``T[o, k, nibble]`` equals its image computed state by state, on
    random sets from a numpy seed; the empty nibble's entries and the
    sentinel op's are zero."""
    P = _narrow_alphabet(S)
    O1 = P.shape[0]
    T = lane_pt.image_tables_plain(torch.from_numpy(P)).numpy()
    K = lane_pt.n_nibbles(S)
    assert T.shape == (O1, K, 16, 1) and K == {4: 1, 8: 2, 16: 4, 32: 8}[S]
    Tu = T.view(np.uint32)[..., 0]
    assert not Tu[:, :, 0].any() and not Tu[O1 - 1].any()
    rng = np.random.default_rng(S)
    for density in (0.1, 0.4, 0.8):
        x = rng.random((32, S)) < density
        ops = rng.integers(0, O1, 32)
        words = (x.astype(np.uint64) << np.arange(S, dtype=np.uint64)).sum(1)
        for i in range(len(x)):
            want = (x[i].astype(np.int32) @ (P[ops[i]] > 0.5)) > 0
            got = 0
            for k in range(K):
                got |= int(Tu[ops[i], k, (int(words[i]) >> (4 * k)) & 15])
            bits = (got >> np.arange(32)) & 1
            np.testing.assert_array_equal(bits[:S].astype(bool), want)
            assert not bits[S:].any()


def _old_lane_envelope(W, S, O1):
    """The narrow walks' envelope before the image tables: R (unless the
    warp kernel holds it), a chunk of the stream and P's ``[O1, S]``
    words in one block's shared memory."""
    R = 0 if W <= 5 else 2 * (1 << W)
    return 1 <= W <= 16 and 1 <= S <= 32 and \
        4 * (R + 256 * (W + 1) + O1 * S) <= 227 * 1024


def test_lane_fits_equals_the_previous_envelope():
    """``lane_fits`` takes exactly the geometries it took before the
    tables (the routes do not move), over a grid of (W, S, O1) that
    crosses every limit."""
    for W in range(1, 19):
        for S in (1, 2, 4, 8, 16, 31, 32, 33, 64):
            for O1 in (2, 37, 100, 442, 443, 1000, 1767, 1768, 1769, 2000,
                       4096, 6000):
                assert lane_pt.lane_fits(S, 1 << W, O1 - 1) == \
                    _old_lane_envelope(W, S, O1), (W, S, O1)
                assert lane_pt.keyed_smem_bytes(W, S, O1) == 4 * (
                    (0 if W <= 5 else 2 << W) + 256 * (W + 1) + O1 * S)


@pytest.mark.parametrize("W,S,O1,warp,shared", [
    (5, 8, 37, True, True),             # cas: 4,736 bytes of tables
    (5, 8, 37, False, True),            # the block form at W = 5
    (7, 8, 37, True, True),             # the block form from W = 6
    (5, 32, 442, True, True),           # the largest alphabet that fits
    (5, 32, 443, True, False),          # and one op more
    (5, 32, 1000, True, False),         # many ops: tables in device memory
    (16, 32, 100, True, False),         # the set crowds them out
    (13, 4, 50, True, True)])
def test_smem_layout(W, S, O1, warp, shared):
    """K1 and K2's layout: the tables ``[O1, K, 16]`` words in shared
    memory when they fit beside the set (block form only) and a chunk of
    the stream, else in device memory."""
    K = lane_pt.n_nibbles(S)
    base = 4 * ((0 if warp and W <= 5 else 2 << W) + 256 * (W + 1))
    T = 4 * O1 * K * 16
    assert lane_pt.table_bytes(S, O1) == T
    assert lane_pt.tables_shared(W, S, O1, warp) is shared
    assert shared == (base + T <= 227 * 1024)
    assert lane_pt.smem_bytes(W, S, O1, warp) == base + T * shared
    assert lane_pt.lane_fits(S, 1 << W, O1 - 1) == \
        _old_lane_envelope(W, S, O1)
    assert lane_pt.tables_scratch(O1, S, "cpu").shape == (O1, K, 16, 1)


def test_lane_fits_is_the_kernel_envelope():
    assert lane_pt.lane_fits(8, 32, 35)          # the headline geometry
    assert lane_pt.lane_fits(32, 1 << 14, 100)
    assert not lane_pt.lane_fits(64, 32, 35)     # > 32 states
    assert not lane_pt.lane_fits(8, 1 << 17, 35)  # > 16 slots
    assert not lane_pt.lane_fits(32, 32, 4096)   # P beyond 227 KB


def test_lane_walk_routes_by_device(monkeypatch):
    """``lane_walk`` takes the plain version only for CPU tensors; any
    other device is the kernel's or an error, never the plain version."""
    calls = []
    monkeypatch.setattr(lane_pt, "lane_walk_plain",
                        lambda *a: calls.append("plain"))
    monkeypatch.setattr(lane_pt, "_lane_walk_cuda",
                        lambda *a: calls.append("cuda"))
    t = torch.zeros(1)
    lane_pt.lane_walk(t, t, t, t, 1, 1)
    assert calls == ["plain"]
    with pytest.raises(ValueError):
        lane_pt.lane_walk(t, t, t, torch.zeros(1, device="meta"), 1, 1)
    assert calls == ["plain"]

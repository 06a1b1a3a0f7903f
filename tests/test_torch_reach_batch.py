"""The lockstep batch walk (kernel K2's module) against the reference, on
the CPU.

The reference's Pallas batch kernel runs in interpret mode at B=32 in
float32; the port's ``batch_walk`` runs its plain PyTorch version, which
the CUDA kernel is held against bit for bit on the card by
``chip_smoke.py``. Operands are built as the reference's own batch tests
build them (``reach._keyed_operands``, one shared alphabet). Every
comparison is exact: the config sets are 0/1 and the indices integers.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu.checkers import events as ev_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.checkers import reach_batch as rb_ref
from jepsen_tpu.history import pack
from jepsen_tpu.op import invoke, ok
from jepsen_tpu_torch.checkers import reach_batch as rb_pt

# tiny tensors: one thread each keeps the parallel test workers from
# crowding each other's cores
torch.set_num_threads(1)

B = 32


def _operands(kind, hists):
    """Per-history streams over the union alphabet: ``(P, ret_slots,
    slot_ops, M)``."""
    model = fx_ref.model_for(kind)
    reach_ref._MEMO_CACHE.clear()
    packed = [pack(h) for h in hists]
    preps = [reach_ref._prep(model, p, max_states=100_000, max_slots=20,
                             max_dense=1 << 22) for p in packed]
    W = max(max(p[1].W, 1) for p in preps)
    rss = [ev_ref.returns_view(p[1]) for p in preps]
    P, ret_flat, ops_flat, _key, off, _wide = reach_ref._keyed_operands(
        model, packed, rss, list(range(len(packed))), W, 100_000)
    n = len(packed)
    return (P, [ret_flat[off[k]:off[k + 1]] for k in range(n)],
            [ops_flat[off[k]:off[k + 1]] for k in range(n)], 1 << W)


def _hists(kind, sizes, corrupt=(), processes=4):
    out = []
    for s, n in enumerate(sizes):
        h = fx_ref.gen_history(kind, n_ops=n, processes=processes, seed=s)
        out.append(fx_ref.corrupt(h, seed=s) if s in corrupt else h)
    return out


def _reference_walk(args, n_pass, Mp):
    P, ops, rs, R0 = (a.numpy() for a in args)
    R_pad, H = rs.shape
    S = P.shape[1]
    W = ops.size // (R_pad * H)
    run = rb_ref._batch_call(B, W, Mp, S, H, P.shape[0], R_pad, n_pass,
                             True, "float32")
    ck, fin = run(jnp.asarray(ops), jnp.asarray(rs), jnp.asarray(P),
                  jnp.asarray(R0))
    return np.asarray(ck), np.asarray(fin)


@pytest.mark.parametrize("kind,sizes,corrupt,n_pass", [
    ("cas", (90, 40, 130), (1,), None),       # ragged lanes, one dead
    ("cas", (90, 40, 130), (), 2),            # the capped ladder
    ("register", (60, 100), (0,), None),
    ("mutex", (160, 50, 90), (), 1)])
def test_plain_matches_pallas_interpret(kind, sizes, corrupt, n_pass):
    """ckpt and final of ``batch_walk_plain`` equal the reference kernel's
    ``_batch_call(B=32, ..., interpret=True, dtype="float32")``."""
    P, rs, ops, M = _operands(kind, _hists(kind, sizes, corrupt))
    geom, args, _ = rb_pt.pack_batch_operands(P, rs, ops, M, B=B,
                                              device="cpu")
    W, R_pad = geom[1], geom[6]
    n_pass = W if n_pass is None else n_pass
    ck, fin = rb_pt.batch_walk(*args, B, n_pass)
    ck_ref, fin_ref = _reference_walk(args, n_pass, M)
    assert R_pad // B >= 2                  # more than one checkpoint
    np.testing.assert_array_equal(ck.numpy(), ck_ref)
    np.testing.assert_array_equal(fin.numpy(), fin_ref)


@pytest.mark.parametrize("e_pad,density", [(4, 0.3), (2, 0.8)])
def test_plain_matches_pallas_interpret_seed_groups(e_pad, density):
    """Chunk-lockstep's phase-B shape: ``e_pad·M`` rows per lane, seeded
    with arbitrary sets; fire and projection stay inside each group of
    M rows."""
    P, rs, ops, M = _operands("cas", _hists("cas", (70, 110, 50)))
    _geom, args, _ = rb_pt.pack_batch_operands(P, rs, ops, M, B=B,
                                               device="cpu")
    H, S = len(rs), P.shape[1]
    R0 = np.random.default_rng(e_pad).random((e_pad * M, H * S)) < density
    args = args[:3] + (torch.as_tensor(R0.astype(np.float32)),)
    W = int(ops[0].shape[1])
    ck, fin = rb_pt.batch_walk(*args, B, W)
    ck_ref, fin_ref = _reference_walk(args, W, e_pad * M)
    assert fin.shape == (e_pad * M, H * S) and fin.any()
    np.testing.assert_array_equal(ck.numpy(), ck_ref)
    np.testing.assert_array_equal(fin.numpy(), fin_ref)


@pytest.mark.parametrize("kind,sizes,corrupt", [
    ("cas", (90, 60, 120, 40), (1, 2)),
    ("register", (90, 70), (0,)),
    ("mutex", (60, 90), ())])
def test_walk_returns_batch_matches_reference(kind, sizes, corrupt):
    """Per-lane dead indices equal the reference's lockstep walk."""
    P, rs, ops, M = _operands(kind, _hists(kind, sizes, corrupt))
    d_ref = rb_ref.walk_returns_batch(P, rs, ops, M, interpret=True)
    d_pt = rb_pt.walk_returns_batch(P, rs, ops, M, B=B, device="cpu")
    np.testing.assert_array_equal(d_pt, d_ref)
    assert (d_ref >= 0).sum() == len(corrupt)


def _deep_chain_history(depth: int):
    """A linearizable history whose first return can only fire as a
    ``depth``-long chain of pending ops."""
    h = [invoke(0, "write", 0), ok(0, "write", 0)]
    for p in range(depth - 1):
        h.append(invoke(p, "cas", (p, p + 1)))
    h.append(invoke(depth - 1, "read"))
    h.append(ok(depth - 1, "read", depth - 1))
    for p in range(depth - 1):
        h.append(ok(p, "cas", (p, p + 1)))
    return h


def test_capped_ladder_rescue(monkeypatch):
    """With the ladder capped at 2 passes the deep-chain lane falsely
    dies in the capped walk; the exact rescue revives it, and the truly
    dead lane keeps its index, in both packages."""
    monkeypatch.setattr(rb_ref, "_FAST_PASSES", 2)
    monkeypatch.setattr(rb_pt, "_FAST_PASSES", 2)
    hists = [_deep_chain_history(4),
             fx_ref.corrupt(fx_ref.gen_history("cas", n_ops=60, processes=3,
                                               seed=3), seed=3),
             fx_ref.gen_history("cas", n_ops=50, processes=3, seed=4)]
    P, rs, ops, M = _operands("cas", hists)
    assert M >= 16
    geom, args, _ = rb_pt.pack_batch_operands(P, rs, ops, M, B=B,
                                              device="cpu")
    _, capped = rb_pt.batch_walk(*args, B, 2)
    S = P.shape[1]
    assert not capped.view(M, 3, S)[:, 0].any()    # the capped walk dies
    d_ref = rb_ref.walk_returns_batch(P, rs, ops, M, interpret=True)
    d_pt = rb_pt.walk_returns_batch(P, rs, ops, M, B=B, device="cpu")
    np.testing.assert_array_equal(d_pt, d_ref)
    assert d_pt[0] == -1 and d_pt[1] >= 0 and d_pt[2] == -1


def test_group_geom_pads_to_whole_blocks():
    assert rb_pt.group_geom(1, 32) == 32
    assert rb_pt.group_geom(100, 32) == 128
    assert rb_pt.group_geom(2295, 256) % 256 == 0
    assert rb_pt.group_geom(2295, 256) >= 2295


def test_batch_walk_routes_by_device(monkeypatch):
    """``batch_walk`` takes the plain version only for CPU tensors; any
    other device is the kernel's or an error, never the plain version."""
    calls = []
    monkeypatch.setattr(rb_pt, "batch_walk_plain",
                        lambda *a: calls.append("plain"))
    monkeypatch.setattr(rb_pt, "_batch_walk_cuda",
                        lambda *a: calls.append("cuda"))
    t = torch.zeros(1)
    rb_pt.batch_walk(t, t, t, t, 1, 1)
    assert calls == ["plain"]
    with pytest.raises(ValueError):
        rb_pt.batch_walk(t, t, t, torch.zeros(1, device="meta"), 1, 1)
    assert calls == ["plain"]

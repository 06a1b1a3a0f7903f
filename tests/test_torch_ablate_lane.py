"""The ablation walk (kernel K6's module) against the reference harness,
on the CPU.

The reference harness's Pallas kernel (``tools/ablate_lane.py``
``make_call``) is built and run in TPU interpret mode; the port's
``ablate_walk`` runs its plain PyTorch version, which the CUDA kernel
is held against bit for bit on the card by ``chip_smoke.py``. Every
comparison is exact (tolerance 0): the checkpoints and final sets are
0/1 after each projection, in the count variants too.
"""
import importlib.util
import os
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu import history as h_ref
from jepsen_tpu import models as models_ref
from jepsen_tpu.checkers import events as ev_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu_torch.tools import ablate_lane as ab_pt

# tiny tensors: one thread each keeps the parallel test workers from
# crowding each other's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 32


def _load_reference():
    """``tools/ablate_lane.py``, the reference harness (not a package)."""
    spec = importlib.util.spec_from_file_location(
        "_reference_ablate_lane", os.path.join(ROOT, "tools",
                                               "ablate_lane.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ab_ref = _load_reference()

# (n_ops, processes, seed, corrupt): a valid history of 96 returns at
# W = 5; a corrupted one at W = 5, where the sets empty; one at W = 3
HISTORIES = {
    "valid": (140, 5, 3, False),
    "corrupted": (90, 5, 5, True),
    "w3": (90, 3, 4, False),
}
# histories that share a geometry share one reference build
GROUPS = {"w5": ("valid", "corrupted"), "w3": ("w3",)}


def _stream(name):
    """Reference-built numpy operands of one history: ``(P, ret_slot,
    slot_ops)``."""
    n_ops, procs, seed, corrupt = HISTORIES[name]
    h = fx_ref.gen_history("cas", n_ops=n_ops, processes=procs, seed=seed)
    if corrupt:
        h = fx_ref.corrupt(h, seed=seed)
    reach_ref._MEMO_CACHE.clear()
    memo, stream, _T, S, _M = reach_ref._prep(
        models_ref.cas_register(), h_ref.pack(h), max_states=100_000,
        max_slots=20, max_dense=1 << 22)
    rs = ev_ref.returns_view(stream)
    return reach_ref._build_P(memo, S), rs.ret_slot, rs.slot_ops


@lru_cache(maxsize=None)
def group_operands(group):
    """The histories of ``group`` padded to one geometry (the longest
    stream in whole blocks of B, P's zero rows up to the largest
    alphabet, the sentinel last). Returns ``(geom, {history: (ret_slot,
    slot_ops, P, PJ, R0)})`` as numpy arrays."""
    streams = {n: _stream(n) for n in GROUPS[group]}
    O1 = max(P.shape[0] for P, _, _ in streams.values())
    R_pad = max(-(-len(r) // B) * B for _, r, _ in streams.values())
    (W,) = {o.shape[1] for _, _, o in streams.values()}
    (S,) = {P.shape[1] for P, _, _ in streams.values()}
    M = 1 << W
    out = {}
    for n, (P, ret, ops) in streams.items():
        Pp = np.zeros((O1, S, S), np.float32)
        Pp[:P.shape[0] - 1] = P[:-1]
        ret_p = np.full(R_pad, -1, np.int32)
        ret_p[:len(ret)] = ret
        ops_p = np.full((R_pad, W), -1, np.int32)
        ops_p[:len(ops)] = ops
        R0 = np.zeros((M, S), np.float32)
        R0[0, 0] = 1.0
        out[n] = (ret_p, ops_p, Pp, ab_ref._proj_table_np(W, M), R0)
    return (B, W, M, S, O1, R_pad), out


def reference_outputs(build, runs):
    """Build the reference kernel once (``build()``) and run it on each
    operand set of ``runs``, in TPU interpret mode: ``[(ckpt, final)]``
    as numpy arrays."""
    with pltpu.force_tpu_interpret_mode():
        call = build()
        outs = []
        for ret, ops, P, PJ, R0 in runs:
            ck, fin = call(jnp.asarray(ret), jnp.asarray(ops.reshape(-1)),
                           jnp.asarray(P), jnp.asarray(PJ),
                           jnp.asarray(R0))
            outs.append((np.asarray(ck), np.asarray(fin)))
    return outs


def torch_operands(opnds):
    ret, ops, P, PJ, R0 = (torch.as_tensor(a) for a in opnds)
    return ret, ops, P, PJ, R0


def assert_same(got, want, label):
    ck, fin = got
    np.testing.assert_array_equal(ck.numpy(), want[0], err_msg=label)
    np.testing.assert_array_equal(fin.numpy(), want[1], err_msg=label)


WALK_VARIANTS = [n for n, s in ab_pt.VARIANTS.items()
                 if not s[1].startswith("stream")]


def check_walk_variant(name, group):
    """ckpt and final of the port's run of variant ``name`` (``variant``,
    on CPU tensors the plain version) equal the reference's
    ``make_call`` on the histories of ``group``, exactly."""
    geom, runs = group_operands(group)
    Bk, W, M, S, O1, R_pad = geom
    s = ab_ref.VARIANTS[name]
    fire, proj, counts, unroll, n_pass = s[:5]
    cgate = s[5] if len(s) > 5 else 0
    n_pass = min(W, 5) if n_pass is None else n_pass
    want = reference_outputs(
        lambda: ab_ref.make_call(Bk, W, M, S, O1, R_pad, n_pass, fire,
                                 proj, counts, unroll, cgate),
        runs.values())
    run = ab_pt.variant(name, geom, torch.device("cpu"))
    for (hist, opnds), ref in zip(runs.items(), want):
        ret, ops, P, PJ, R0 = torch_operands(opnds)
        assert_same(run(ret, ops, P, PJ, R0), ref, f"{name} on {hist}")


def check_counts_gs(group):
    """``_fire_counts_gs``, in no variant but a body ``make_call``
    takes, with the blend projection and counts, as
    :func:`check_walk_variant` holds a variant."""
    geom, runs = group_operands(group)
    Bk, W, M, S, O1, R_pad = geom
    want = reference_outputs(
        lambda: ab_ref.make_call(Bk, W, M, S, O1, R_pad, min(W, 5),
                                 ab_ref._fire_counts_gs, "blend", True),
        runs.values())
    for (hist, opnds), ref in zip(runs.items(), want):
        ret, ops, P, PJ, R0 = torch_operands(opnds)
        got = ab_pt.ablate_walk(P, ret, ops, PJ, R0, Bk, min(W, 5),
                                ab_pt._fire_counts_gs, "blend", True)
        assert_same(got, ref, f"counts-gs on {hist}")


# the W = 3 history's cases are in test_torch_ablate_stream.py, which
# keeps each file near a minute on the CPU
@pytest.mark.parametrize("name", WALK_VARIANTS)
def test_variant_matches_make_call(name):
    """Each of the 19 non-stream variants on the valid and the corrupted
    history at W = 5."""
    check_walk_variant(name, "w5")


def test_counts_gs_matches_make_call():
    """``_fire_counts_gs`` on the valid and the corrupted history."""
    check_counts_gs("w5")


def test_histories_cover_death_and_survival():
    """The valid history keeps every exact variant's set, and the
    corrupted one empties it: the comparisons see both."""
    geom, runs = group_operands("w5")
    W = geom[1]
    run = ab_pt.variant("v2-bool-blend", geom, torch.device("cpu"))
    alive = {h: bool(run(*torch_operands(o))[1].any())
             for h, o in runs.items()}
    assert alive == {"valid": True, "corrupted": False}
    assert W == 5 and group_operands("w3")[0][1] == 3


def test_variants_table_matches_reference():
    """The port's VARIANTS: the reference's names, in order, with the same
    pass bodies (by name), projections, counts, unrolls, pass counts and
    gate ladders."""
    def names(fire):
        return tuple(f.__name__ for f in fire) if isinstance(fire, tuple) \
            else fire.__name__

    assert list(ab_pt.VARIANTS) == list(ab_ref.VARIANTS)
    for name, s in ab_ref.VARIANTS.items():
        p = ab_pt.VARIANTS[name]
        assert len(p) == len(s) and names(p[0]) == names(s[0]) \
            and p[1:] == s[1:], name


def test_ablate_walk_on_cpu_is_the_plain_version(monkeypatch):
    """On CPU tensors the wrapper runs the plain version, never the
    kernel: no library is loaded and no launch counted."""
    def no_kernel():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(ab_pt, "_walk_lib", no_kernel)
    monkeypatch.setattr(ab_pt, "_stream_lib", no_kernel)
    geom, runs = group_operands("w5")
    Bk, W = geom[:2]
    ret, ops, P, PJ, R0 = torch_operands(runs["valid"])
    before = (ab_pt.ABLATE_LAUNCHES, ab_pt.STREAM_LAUNCHES)
    got = ab_pt.ablate_walk(P, ret, ops, PJ, R0, Bk, 3, ab_pt._fire_bool,
                            "matmul", False, 1, (1, 1))
    want = ab_pt.ablate_walk_plain(P, ret, ops, PJ, R0, Bk, 3,
                                   ab_pt._fire_bool, "matmul", False, 1,
                                   (1, 1))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    G = ab_pt.stream_operand(P, ops, torch.int8)
    got = ab_pt.ablate_stream(ret, G, R0, Bk, W, ab_pt._fire_bool, False)
    want = ab_pt.ablate_stream_plain(ret, G, R0, Bk, W, ab_pt._fire_bool,
                                     False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (ab_pt.ABLATE_LAUNCHES, ab_pt.STREAM_LAUNCHES) == before


def test_fits_refuses_the_table_from_w7():
    """K6's envelope: the projection table is (W+1)·M²·4 bytes — 24 KB at
    W = 5, 114 KB at W = 6, too large for one block's shared memory from
    W = 7 — so bool-matmulproj is refused there, while the blend
    variants still fit; on the card the harness refuses the variant
    before any launch."""
    def table(W):
        return ab_pt.smem_bytes(W, 8, 23, False, True) \
            - ab_pt.smem_bytes(W, 8, 23, False, False)

    assert (table(5), table(6)) == (24 * 1024, 112 * 1024)
    assert ab_pt.fits(5, 32, 8, 23, "matmul", False)
    assert ab_pt.fits(6, 64, 8, 23, "matmul", False)
    assert not ab_pt.fits(7, 128, 8, 23, "matmul", False)
    assert ab_pt.fits(7, 128, 8, 23, "blend", False)
    assert ab_pt.fits(7, 128, 8, 23, "blend", True)
    assert not ab_pt.fits(5, 32, 33, 23, "blend", False)   # one word a mask
    geom = (1024, 7, 128, 8, 23, 1024)
    with pytest.raises(ValueError, match="does not take W=7"):
        ab_pt.variant("bool-matmulproj", geom, torch.device("cuda"))
    ab_pt.variant("v2-bool-blend", geom, torch.device("cuda"))


def test_kernel_bodies():
    """Which kernel instance runs each variant: bool passes as words,
    the count passes as f32 add or max, the tuple fires by a pass mask;
    bodies the kernel lacks are refused."""
    for name in WALK_VARIANTS:
        fire, _proj, counts, _u, n_pass, cgate = ab_pt.spec(name, 5)
        n = n_pass + sum(cgate)
        rep, order, mask = ab_pt._body(fire, counts, n)
        assert rep == {"cnt-tree-blend": 1, "maxnc-blend": 2}.get(name, 0)
        if name.startswith("alt") or name == "cgate-ladder-alt":
            assert order == 2 and mask == 0b1010 & ((1 << n) - 1)
        else:
            assert (order, mask) == (0, 0)
    assert ab_pt._body(ab_pt._fire_bool_rev, False, 5) == (0, 1, 0)
    with pytest.raises(ValueError, match="mix"):
        ab_pt._body((ab_pt._fire_bool, ab_pt._fire_maxnc), True, 5)
    with pytest.raises(ValueError, match="without counts"):
        ab_pt._body(ab_pt._fire_bool, True, 5)
    assert [n for n in ab_pt.VARIANTS if ab_pt.exact(n, 5)] == [
        "v2-bool-blend", "cnt-tree-blend", "maxnc-blend", "bool-matmulproj",
        "bool-stream", "maxnc-stream", "bool-stream-i8", "cgate4+1",
        "cgate3+2", "cgate2+3", "cgate3+1+1", "cgate2+1+1+1", "cgate2+2+1",
        "cgate1+1+1+1+1", "cgate-ladder-u2", "cgate-ladder-alt"]

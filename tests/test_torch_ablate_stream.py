"""The streamed ablation walk (kernel K7's module), the W = 3 history of
the ablation walk (K6), and the harness's entry point, on the CPU.

As in ``test_torch_ablate_lane.py``: the reference harness's Pallas
kernels (``tools/ablate_lane.py`` ``make_call_stream`` and
``make_call``) run in TPU interpret mode, the port's wrappers run their
plain PyTorch versions on CPU tensors, and every comparison is exact.
"""
import numpy as np
import pytest
import torch

from jepsen_tpu_torch.tools import ablate_lane as ab_pt
from tests.test_torch_ablate_lane import (GROUPS, WALK_VARIANTS, ab_ref,
                                          assert_same, check_counts_gs,
                                          check_walk_variant,
                                          group_operands,
                                          reference_outputs, torch_operands)

torch.set_num_threads(1)

STREAM_VARIANTS = [n for n, s in ab_pt.VARIANTS.items()
                   if s[1].startswith("stream")]


@pytest.mark.parametrize("name", WALK_VARIANTS)
def test_walk_variant_matches_make_call_at_w3(name):
    """Each of the 19 non-stream variants of K6 on the W = 3 history."""
    check_walk_variant(name, "w3")


def test_counts_gs_matches_make_call_at_w3():
    check_counts_gs("w3")


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("name", STREAM_VARIANTS)
def test_stream_variant_matches_make_call_stream(name, group):
    """bool-stream, maxnc-stream and bool-stream-i8: ckpt and final of the
    port's run (``stream_operand`` then ``ablate_stream``, on CPU tensors
    the plain version) equal the reference's ``make_call_stream`` on the
    valid, corrupted and W = 3 histories, exactly."""
    geom, runs = group_operands(group)
    B, W, M, S, O1, R_pad = geom
    fire, proj, counts, _unroll, n_pass = ab_ref.VARIANTS[name][:5]
    n_pass = min(W, 5) if n_pass is None else n_pass
    g_dtype = "int8" if proj == "stream-i8" else "float32"
    want = reference_outputs(
        lambda: ab_ref.make_call_stream(B, W, M, S, O1, R_pad, n_pass,
                                        fire, counts, g_dtype=g_dtype),
        runs.values())
    run = ab_pt.variant(name, geom, torch.device("cpu"))
    for (hist, opnds), ref in zip(runs.items(), want):
        assert_same(run(*torch_operands(opnds)), ref, f"{name} on {hist}")


def test_stream_operand_layout():
    """G[k] is return k's fire operand: element (s, j·S + t) is
    P[o_kj][s][t], slot -1 the sentinel row; int8 holds the same 0/1
    values."""
    geom, runs = group_operands("w5")
    _B, W, _M, S, O1, R_pad = geom
    ret, ops, P, _PJ, _R0 = runs["corrupted"]
    G = ab_pt.stream_operand(torch.as_tensor(P), torch.as_tensor(ops))
    o = np.where(ops < 0, O1 - 1, ops)
    want = P[o].transpose(0, 2, 1, 3).reshape(R_pad, S, W * S)
    np.testing.assert_array_equal(G.numpy(), want)
    G8 = ab_pt.stream_operand(torch.as_tensor(P), torch.as_tensor(ops),
                              torch.int8)
    assert G8.dtype == torch.int8
    np.testing.assert_array_equal(G8.numpy(), want.astype(np.int8))
    for k in (0, 17, R_pad - 1):
        np.testing.assert_array_equal(
            G[k].numpy(), ab_pt._gather_G(torch.as_tensor(ops),
                                          torch.as_tensor(P), k, W,
                                          O1).numpy())


def test_main_on_cpu_prints_the_ladder(capsys):
    """``main`` with ``--device cpu`` runs the plain versions on the
    harness's cas operands and prints the geometry and one line a
    variant; the exact variants end on K1's final set."""
    names = ["v2-bool-blend", "cgate2+3", "bool-stream-i8", "v2-p2"]
    rc = ab_pt.main(["--ops", "400", "--device", "cpu", "--repeat", "1",
                     "--variants", ",".join(names)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("geometry B=1024 W=5 M=32 S=8 ")
    assert [ln.split()[0] for ln in lines[1:]] == names
    for ln in lines[1:]:
        name, ms, unit, ns, ns_unit, match, alive = ln.split()
        assert (unit, ns_unit) == ("ms", "ns/ret") and float(ms) > 0
        if ab_pt.exact(name, 5):
            assert (match, alive) == ("match=True", "alive=True"), ln


@pytest.mark.parametrize("mode", ["--bodies", "--pipeline"])
def test_main_unported_modes_exit_nonzero(mode, capsys):
    """The word-packed body sweep and the pipeline sweep need modules not
    ported yet: they exit non-zero and name the ROADMAP items."""
    assert ab_pt.main([mode]) != 0
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP queue 1" in err


def test_main_needs_the_card_unless_asked_for_cpu(monkeypatch):
    """Without ``--device`` the harness wants the card and raises when
    there is none; it never runs the plain versions by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_pt.main(["--ops", "40", "--variants", "v2-bool-blend"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ab_pt.main(["--ops", "40", "--device", "cuda"])

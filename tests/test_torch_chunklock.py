"""The chunk-lockstep engine against the reference, on the CPU.

The reference's ``reach_chunklock.check_packed`` runs its Pallas kernels
in interpret mode; the port's runs the plain PyTorch versions of K2 (both
phases) and K1 (rescues, death location, witness), with the same
``n_chunks``, ``suffix`` and ``e_pad``. Every key of the result but the
engine and the time must be equal — verdict, failing op, dead event,
witness, and the engine's own ``chunks``, ``rescues`` and
``basis-max`` — across the regimes of the reference's own tests:
single-config seeds, union seeds with rescues, a tight bound with none,
deaths in different chunks, and the gates.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jepsen_tpu import fixtures as fx_ref
from jepsen_tpu.checkers import reach as reach_ref
from jepsen_tpu.checkers import reach_chunklock as cl_ref
from jepsen_tpu.history import pack as pack_ref
from jepsen_tpu_torch import Linearizable, obs
from jepsen_tpu_torch import fixtures as fx_pt
from jepsen_tpu_torch import history as h_pt
from jepsen_tpu_torch.checkers import reach_chunklock as cl_pt

# tiny tensors: one thread each keeps the parallel test workers from
# crowding each other's cores
torch.set_num_threads(1)

WITNESS = ("valid", "op", "dead-event", "max-linearized", "final-configs",
           "previous-ok", "events", "slots", "states")


def _pair(kind, n_ops, seed, corrupt, processes=4):
    """The same history from both packages; ``corrupt`` is the seed of
    the corruption, None for none."""
    kw = dict(n_ops=n_ops, processes=processes, seed=seed)
    h1, h2 = fx_ref.gen_history(kind, **kw), fx_pt.gen_history(kind, **kw)
    if corrupt is not None:
        h1, h2 = fx_ref.corrupt(h1, seed=corrupt), fx_pt.corrupt(h2,
                                                                seed=corrupt)
    return h1, h2


def _both(kind, h1, h2, **kw):
    """The reference's and the port's results; every key but the engine
    and the time equal."""
    reach_ref._MEMO_CACHE.clear()
    r_ref = cl_ref.check_packed(fx_ref.model_for(kind), pack_ref(h1),
                                interpret=True, **kw)
    r_pt = cl_pt.check_packed(fx_pt.model_for(kind), h_pt.pack(h2),
                              device="cpu", **kw)
    skip = ("engine", "time-s")
    keys = (set(r_ref) | set(r_pt)) - set(skip)
    diff = {k: (r_ref.get(k), r_pt.get(k)) for k in keys
            if r_ref.get(k) != r_pt.get(k)}
    assert not diff, diff
    assert r_pt["engine"] == "reach-chunklock"
    return r_pt


@pytest.mark.parametrize("kind,seed,corrupt", [
    ("cas", 0, None), ("cas", 1, 1), ("register", 2, None),
    ("register", 3, 3), ("mutex", 4, None)])
def test_singleton_seeds(kind, seed, corrupt):
    h1, h2 = _pair(kind, 120, seed, corrupt)
    res = _both(kind, h1, h2, n_chunks=4, suffix=8, e_pad=4)
    assert res["valid"] is (corrupt is None) and res["chunks"] == 4


@pytest.mark.parametrize("seed,corrupt", [(0, None), (2, 2), (5, 5)])
def test_union_seeds_and_rescue(seed, corrupt):
    """e_pad=1 deals every multi-config boundary into one union seed and
    suffix=2 makes the bound loose: the rescues restore the exact result
    and are counted as in the reference."""
    h1, h2 = _pair("cas", 150, seed, corrupt)
    res = _both("cas", h1, h2, n_chunks=5, suffix=2, e_pad=1)
    assert res["rescues"] >= 1


def test_tight_bound_no_rescue():
    """A full-chunk suffix replays each chunk exactly: no rescue."""
    h1, h2 = _pair("cas", 140, 1, None)
    res = _both("cas", h1, h2, n_chunks=3, suffix=10_000, e_pad=16)
    assert res["rescues"] == 0 and res["valid"] is True


@pytest.mark.parametrize("seed", [40, 43, 46])
def test_dead_chunk_localization(seed):
    """Violations in different chunks localize to the return the serial
    walk reports, witness included."""
    h1, h2 = _pair("cas", 160, seed, seed - 40, processes=5)
    res = _both("cas", h1, h2, n_chunks=6, suffix=6, e_pad=2)
    assert res["valid"] is False


def test_gates():
    with pytest.raises(cl_pt.ChunklockUnfit):
        # W beyond the exact-ladder cap is refused up front
        cl_pt.walk_chunklock(
            np.zeros((3, 2, 2), np.float32), np.zeros(40, np.int32),
            np.zeros((40, cl_pt._FAST_PASSES + 1), np.int32), 4,
            device="cpu")
    res = cl_pt.check_packed(fx_pt.model_for("cas"), h_pt.pack([]),
                             device="cpu")
    assert res["valid"] is True
    assert cl_pt.fits(8, 32, 5, 32, 8)
    assert not cl_pt.fits(64, 32, 5, 32, 8)          # > 32 states
    assert not cl_pt.fits(8, 1 << 9, 9, 32, 8)       # past the ladder cap
    assert cl_pt.admits(8, 32, 5, cl_pt.MIN_RETURNS)
    assert not cl_pt.admits(8, 32, 5, cl_pt.MIN_RETURNS - 1)
    assert cl_pt._auto_chunks(8, 73_430) == cl_ref._auto_chunks(8, 73_430)
    assert cl_pt._auto_chunks(32, 1 << 21) == cl_ref._auto_chunks(32,
                                                                  1 << 21)


@pytest.mark.parametrize("e_pad", [1, 3])
def test_glue_and_fold_match_reference(e_pad):
    """The torch glue and fold (boolean ops) equal the reference's XLA
    ones on the same phase-A and phase-B sets."""
    C, M, S = 5, 8, 4
    rng = np.random.default_rng(e_pad)
    final_a = (rng.random((M, C * S)) < 0.2).astype(np.float32)
    seeds, r0b, cnt = cl_pt._glue_call(torch.as_tensor(final_a), C, M, S,
                                       e_pad)
    s_ref, r0_ref, c_ref = cl_ref._glue_call(C, M, S, e_pad)(
        jnp.asarray(final_a))
    np.testing.assert_array_equal(seeds.numpy(), np.asarray(s_ref) > 0.5)
    np.testing.assert_array_equal(r0b.numpy(), np.asarray(r0_ref))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(c_ref))
    final_b = (rng.random((e_pad * M, C * S)) < 0.3).astype(np.float32)
    final_b[:, 2 * S:3 * S] = 0.0                   # chunk 2's images die
    out = cl_pt._fold_call(torch.as_tensor(final_b), seeds, cnt, C, M, S,
                           e_pad)
    ref = cl_ref._fold_call(C, M, S, e_pad)(jnp.asarray(final_b), s_ref,
                                            c_ref)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_check_packed_routes_chunklock(monkeypatch):
    """Above ``MIN_RETURNS`` the dense engine takes chunk-lockstep: the
    ledger records the route, and the result equals the reference's
    check, witness included."""
    from jepsen_tpu.checkers import facade as fa_ref

    monkeypatch.setattr(cl_pt, "MIN_RETURNS", 16)
    h1, h2 = _pair("cas", 120, 11, 11)
    reach_ref._MEMO_CACHE.clear()
    r_ref = fa_ref.Linearizable(fx_ref.model_for("cas")).check(None, h1)
    with obs.capture() as cap:
        r_pt = Linearizable(fx_pt.model_for("cas"), device="cpu").check(
            None, h2)
    assert [r["engine"] for r in cap.ledger if r["event"] == "route"] == \
        ["reach-chunklock"]
    assert r_pt["engine"] == "reach-chunklock" and r_pt["chunks"] >= 2
    for k in WITNESS:
        assert r_pt.get(k) == r_ref.get(k), k
    assert r_pt["valid"] is False and r_pt["final-configs"]


def test_facade_algorithm():
    """``algorithm="chunklock"`` routes the engine's options through."""
    _h1, h2 = _pair("cas", 130, 21, None)
    res = Linearizable(fx_pt.model_for("cas"), algorithm="chunklock",
                       device="cpu",
                       opts={"n_chunks": 4, "e_pad": 2, "suffix": 8}).check(
        None, h2)
    assert res["valid"] is True and res["engine"] == "reach-chunklock"
    assert res["chunks"] == 4


def test_walk_error_is_not_hidden(monkeypatch):
    """A fault in the chunk-lockstep walk propagates; the dense engine
    does not fall back to the lane walk."""
    monkeypatch.setattr(cl_pt, "MIN_RETURNS", 16)

    def fail(*a, **k):
        raise cl_pt.ChunklockUnfit("fold death not confirmed by re-walk")

    monkeypatch.setattr(cl_pt, "walk_chunklock", fail)
    _h1, h2 = _pair("cas", 100, 3, None)
    with pytest.raises(cl_pt.ChunklockUnfit, match="not confirmed"):
        Linearizable(fx_pt.model_for("cas"), device="cpu").check(None, h2)


def test_walk_split_death_runs_no_torch_walk(monkeypatch):
    """The walk-split tool on a corrupted chunk-lockstep check: both K2
    phases, the glue and the fold run once, K1 once on the dead chunk
    (its own dead return: no refinement, no torch returns walk), once
    for each chunk the host fold rescues and once for the witness
    prefix; the staged run finds the unstaged run's dead
    event, and the wrapped functions are restored after."""
    from jepsen_tpu_torch.checkers import reach as reach_pt
    from jepsen_tpu_torch.checkers import reach_lane as lane_pt
    from jepsen_tpu_torch.tools import walk_split

    monkeypatch.setattr(cl_pt, "MIN_RETURNS", 16)
    _h1, h2 = _pair("cas", 120, 11, 11)
    before = (lane_pt.lane_walk, reach_pt._walk_returns, cl_pt._localize)
    st = walk_split.split(h2, "cpu")
    assert (lane_pt.lane_walk, reach_pt._walk_returns,
            cl_pt._localize) == before
    assert st["valid"] is False and st["engine"] == "reach-chunklock"
    calls = dict(st["calls"])
    # the host fold's rescues re-walk chunks with K1 too: one launch each
    assert calls.pop("localize") == calls.pop("k1 in localize") >= 1
    assert calls == {"phase-a": 1, "glue": 1, "phase-b": 1, "fold": 1,
                     "witness-prefix": 1, "k1 in witness-prefix": 1}
    assert st["torch_walk_returns"] == 0
    assert set(st["split_ms"]) == set(st["calls"])
    assert st["spans_s"]["reach.walk"] > 0 and st["wall_s"] > 0


def test_walk_split_missing_stage_raises(monkeypatch):
    """A stage the tool cannot find raises, so a stage with no calls is
    one the check did not run; the stages wrapped before it are
    restored."""
    from jepsen_tpu_torch.checkers import reach as reach_pt
    from jepsen_tpu_torch.checkers import reach_lane as lane_pt
    from jepsen_tpu_torch.tools import walk_split

    before = lane_pt.lane_walk
    monkeypatch.delattr(reach_pt, "_walk_returns")
    with pytest.raises(AttributeError, match="_walk_returns"):
        with walk_split.staged(torch.device("cpu")):
            pass
    assert lane_pt.lane_walk is before

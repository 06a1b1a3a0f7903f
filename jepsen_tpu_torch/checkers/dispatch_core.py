"""The dispatch and collect state of the lockstep scheduler, single
device: the counterpart of the reference package's
``checkers/dispatch_core.py``.

The lockstep lane's scheduler (``reach._dispatch_lockstep_groups``)
stages each group's walk on the card (:func:`reach_batch.dispatch_prepared`:
copies and one K2 launch, nothing fetched) and collects the groups in
order (:func:`reach_batch.collect_returns_batch`), keeping
:data:`PIPE_DEPTH` groups queued beyond the one being collected, so the
host marshals and launches group g+1 while the card walks group g. The
staged batch of the check daemon's lanes (``reach.StagedMany``) stages
every group of a batch at once and polls their readiness
(:meth:`DispatchState.ready`) before it collects.
"""
from __future__ import annotations

import time as _time
from typing import List, Optional

import numpy as np

import torch

from jepsen_tpu_torch import device as _device
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import reach_batch, transfer

# groups queued beyond the one being collected: one walks while the
# host stages the next; more pin more operand sets on the card for no
# added overlap (the host stage is the longer)
PIPE_DEPTH = 1

# the check daemon's window: staged batches a lane keeps in flight,
# the one being collected included
SERVE_PIPE_K = 4


def pipeline_k(k: Optional[int] = None, *,
               default: int = SERVE_PIPE_K) -> int:
    """The in-flight window K a caller asked for (``Daemon(pipeline_k=)``,
    ``check-serve --pipeline-k``), else ``default``; at least 1. K = 1
    collects every batch before the next is staged."""
    return max(1, int(default if k is None else k))


class DispatchState:
    """Per-dispatch bookkeeping of the scheduler: the queued groups, in
    order, and the seconds spent collecting. ``dead`` (over the live
    axis) receives each group's verdicts as it is collected. The groups
    of one batch share the union's transition tensor ``P``: it is copied
    to the card once, here, and every group's walk reads that copy."""

    __slots__ = ("device", "depth", "dead", "inflight", "fetch_s", "P_dev")

    def __init__(self, dead: np.ndarray, device, P: np.ndarray):
        self.device = _device.resolve(device)
        self.depth = PIPE_DEPTH
        self.dead = dead
        self.inflight: List[tuple] = []
        self.fetch_s = 0.0
        self.P_dev = torch.as_tensor(np.ascontiguousarray(P, np.float32),
                                     device=self.device)

    def stage(self, g, prep: "reach_batch.BatchPrepared") -> dict:
        """Copy group ``g``'s prepared operands to the card and queue its
        walk, fetching nothing. Returns the group's diag."""
        with obs.span("lockstep.dispatch", lanes=len(g)):
            fl = reach_batch.dispatch_prepared(prep, device=self.device,
                                               P_dev=self.P_dev)
        self.inflight.append((g, fl))
        obs.count("lockstep.staged")
        return reach_batch.group_diag(prep.geom, prep.R_lens)

    def ready(self) -> bool:
        """True when every queued group has walked (a collect would not
        wait on the card)."""
        return all(transfer.device_ready(fl.event)
                   for _g, fl in self.inflight)

    def collect(self, limit: int = 0) -> None:
        """Collect groups in order until at most ``limit`` stay queued
        (0: all)."""
        while len(self.inflight) > limit:
            g, fl = self.inflight.pop(0)
            t0 = _time.monotonic()
            with obs.span("lockstep.collect", lanes=len(g)):
                self.dead[np.asarray(g, np.int64)] = \
                    reach_batch.collect_returns_batch(fl)
            self.fetch_s += _time.monotonic() - t0


def rescue_once(stage: str, cause: str, fn, **fields):
    """Run a recovery ``fn()`` and record its one ``engine.fallback(stage,
    cause)`` only after it succeeded: a failure that persists through the
    recovery propagates unrecorded."""
    out = fn()
    obs.engine_fallback(stage, cause, **fields)
    return out

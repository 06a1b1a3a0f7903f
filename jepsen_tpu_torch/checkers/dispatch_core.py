"""The dispatch and collect state of the lockstep scheduler, single
device: the counterpart of the reference package's
``dispatch_core.DispatchState``.

The lockstep lane's scheduler (``reach._dispatch_lockstep_groups``)
stages each group's walk on the card (:func:`reach_batch.dispatch_prepared`:
copies and one K2 launch, nothing fetched) and collects the groups in
order (:func:`reach_batch.collect_returns_batch`), keeping
:data:`PIPE_DEPTH` groups queued beyond the one being collected, so the
host marshals and launches group g+1 while the card walks group g.
"""
from __future__ import annotations

import time as _time
from typing import List

import numpy as np

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checkers import reach_batch

# groups queued beyond the one being collected: one walks while the
# host stages the next; more pin more operand sets on the card for no
# added overlap (the host stage is the longer)
PIPE_DEPTH = 1


class DispatchState:
    """Per-dispatch bookkeeping of the scheduler: the queued groups, in
    order, and the seconds spent collecting. ``dead`` (over the live
    axis) receives each group's verdicts as it is collected."""

    __slots__ = ("device", "depth", "dead", "inflight", "fetch_s")

    def __init__(self, dead: np.ndarray, device):
        self.device = device
        self.depth = PIPE_DEPTH
        self.dead = dead
        self.inflight: List[tuple] = []
        self.fetch_s = 0.0

    def stage(self, g, prep: "reach_batch.BatchPrepared") -> dict:
        """Copy group ``g``'s prepared operands to the card and queue its
        walk, fetching nothing. Returns the group's diag."""
        with obs.span("lockstep.dispatch", lanes=len(g)):
            fl = reach_batch.dispatch_prepared(prep, device=self.device)
        self.inflight.append((g, fl))
        obs.count("pipeline.staged")
        return reach_batch.group_diag(prep.geom, prep.R_lens)

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

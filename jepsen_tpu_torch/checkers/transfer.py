"""Host-to-card transfer helpers of the dispatch paths: the readiness
probe of queued work (a port of ``device_ready`` of the reference
package's ``checkers/transfer.py``). The reference's operand cache
(``cached_put``) has no counterpart: the lockstep scheduler copies a
batch's shared P to the card once (:class:`dispatch_core.DispatchState`).

Readiness is a CUDA event's ``query()``: an event recorded on the stream
a group's launches used after them reads ready once they have run. Work
on the CPU runs when it is called, so it is always ready. The
reference's wire diet (narrow index dtypes, ``pack_bool``, the sextet
ops lane, ``count_put``, ``record_mode``) has no counterpart here
(``ROADMAP.md``, Queue 1 item 6).
"""
from __future__ import annotations

from typing import Any

import torch


def device_ready(x: Any) -> bool:
    """True when waiting on ``x`` would not block: ``None`` (nothing was
    queued), a ``torch.cuda.Event`` that has completed, or a tensor on
    the CPU. A tensor on the card is ready when an event recorded now on
    its device's current stream has completed, i.e. when everything
    queued there before it has run."""
    if x is None:
        return True
    if isinstance(x, torch.Tensor):
        if x.device.type != "cuda":
            return True
        ev = torch.cuda.Event()
        with torch.cuda.device(x.device):
            ev.record()
        return ev.query()
    return bool(x.query())

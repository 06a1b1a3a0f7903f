"""The check daemon's recovery policy (a port of the reference package's
``jepsen_tpu/serve/recovery.py``): deterministic bounded-backoff retry,
group bisection, the device-path circuit breaker, and the line the port
draws between what the ladder may recover and what it may not.

- :class:`RetryPolicy`: a backoff schedule with no jitter (a replayed
  fault schedule gets the same attempts every run), shared by the group
  retry and the hung-dispatch requeue cap.
- :func:`bisect`: the poison hunt's step. A group that fails and fails
  its retry is halved; each half gets one attempt and halves again on
  failure, so one poison request is cornered in O(log n) dispatches
  while the rest complete.
- :class:`CircuitBreaker`: repeated failures of the card's route open
  the breaker and send the following groups to the host checkers; after
  a cooldown a half-open probe sends one group back to the card, whose
  outcome closes or reopens it::

      closed --(threshold consecutive failures)--> open
      open   --(cooldown elapsed)---------------> half-open (one probe)
      half-open --success--> closed
      half-open --failure--> open (the cooldown restarts)

- :func:`ladder_takes` and :func:`is_device_fault`: only an injected
  fault (:class:`faults.InjectedFault`) or a capacity decline (the
  history does not fit an engine) takes that ladder and feeds the
  breaker. A device fault (a kernel wrapper's launch failure, ``...
  kernel launch failed: CUDA error ...``, any other CUDA error, a
  ``torch.AcceleratorError``, the card's memory exhausted) is never
  retried, bisected or rescued on the host: a rescue would hand back a
  host verdict and hide the card's fault. Neither is any other engine
  fault. Such a group's members end with ``status: "error"``.

Counters: ``serve.retry.attempts``, ``.bisects``, ``.requeued``,
``serve.quarantined`` (bumped by the dispatcher), ``serve.breaker.opened``,
``.half_open``, ``.closed`` and the gauge ``serve.breaker.state`` (0
closed, 1 open, 2 half-open) from here.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Sequence, Tuple

import torch

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.serve import faults

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"

_STATE_CODE = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


def is_device_fault(e: BaseException) -> bool:
    """True for a fault of the card: a ``torch.AcceleratorError``, its
    memory exhausted (``torch.OutOfMemoryError``), or a ``RuntimeError``
    naming a CUDA error, as the kernel wrappers' launch failures do."""
    if isinstance(e, (torch.AcceleratorError, torch.OutOfMemoryError)):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


def ladder_takes(e: BaseException) -> bool:
    """True when the recovery ladder may retry, bisect and rescue after
    ``e``: an injected fault, or a capacity decline."""
    from jepsen_tpu_torch.checkers import facade

    return isinstance(e, (faults.InjectedFault,)
                      + facade._capacity_declines())


class RetryPolicy:
    """Deterministic bounded exponential backoff: ``max_retries`` retries
    of a whole group, ``max_requeues`` requeues of a hung dispatch's
    survivor; ``delay(attempt)`` depends on the attempt alone."""

    def __init__(self, *, max_retries: int = 1, base_s: float = 0.05,
                 factor: float = 2.0, cap_s: float = 1.0,
                 max_requeues: int = 2) -> None:
        self.max_retries = int(max_retries)
        self.base_s = float(base_s)
        self.factor = float(factor)
        self.cap_s = float(cap_s)
        self.max_requeues = int(max_requeues)

    def delay(self, attempt: int) -> float:
        return min(self.cap_s,
                   self.base_s * (self.factor ** max(0, attempt)))

    def to_json(self) -> Dict[str, Any]:
        return {"max_retries": self.max_retries, "base_s": self.base_s,
                "factor": self.factor, "cap_s": self.cap_s,
                "max_requeues": self.max_requeues}


def bisect(batch: Sequence) -> Tuple[List, List]:
    """Halve a group, keeping its order (``len(batch) >= 2``)."""
    mid = max(1, len(batch) // 2)
    return list(batch[:mid]), list(batch[mid:])


class CircuitBreaker:
    """The card's route health as a route decision: ``route()`` is
    ``"device"`` (closed, and the half-open probe) or ``"host"`` (open).
    ``record_failure()`` and ``record_success()`` take the outcome of
    every attempt on the card's route; a host attempt says nothing about
    the card. Driven by one lane thread; the lock guards the readers
    (``/healthz``, ``/stats``)."""

    def __init__(self, *, threshold: int = 5,
                 cooldown_s: float = 15.0) -> None:
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        obs.gauge("serve.breaker.state", 0)

    def route(self) -> str:
        with self._lock:
            if self._state == OPEN and \
                    time.monotonic() - self._opened_at >= self.cooldown_s:
                self._to(HALF_OPEN)
            return "host" if self._state == OPEN else "device"

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive += 1
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._consecutive >= self.threshold):
                self._to(OPEN)
            elif self._state == OPEN:
                # a late probe's failure: the cooldown restarts
                self._opened_at = time.monotonic()

    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state != CLOSED:
                self._to(CLOSED)

    def _to(self, state: str) -> None:
        # the caller holds the lock
        if state == self._state:
            return
        self._state = state
        if state == OPEN:
            self._opened_at = time.monotonic()
            obs.count("serve.breaker.opened")
        elif state == HALF_OPEN:
            obs.count("serve.breaker.half_open")
        else:
            obs.count("serve.breaker.closed")
        obs.gauge("serve.breaker.state", _STATE_CODE[state])
        obs.decision("serve-breaker", "transition", cause=state,
                     consecutive=self._consecutive)

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def degraded(self) -> bool:
        """True while the breaker is open or probing."""
        with self._lock:
            return self._state != CLOSED

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "threshold": self.threshold,
                "cooldown_s": self.cooldown_s}
            if self._state == OPEN:
                out["open_for_s"] = round(
                    time.monotonic() - self._opened_at, 3)
            return out

"""``jepsen_tpu_torch.serve`` — the checker as a service, and the
streaming session engines.

The check daemon (``python -m jepsen_tpu_torch check-serve``; protocol
``docs/SERVING.md``) keeps the kernels built and the process warm and
serves concurrent linearizability and list-append checks over HTTP,
coalescing compatible requests into lockstep groups on the card:

- :mod:`.request` — the request state machine, the registry and the
  per-tenant serve ledgers;
- :mod:`.coalesce` — the bounded admission queue, the coalescer
  (``reach_batch.plan_buckets`` groups, oldest tenant first, per-tenant
  in-flight caps, queue-side deadlines) and lane placement;
- :mod:`.engine` — the dispatcher's lanes, each with a window of staged
  groups, a circuit breaker and the recovery ladder; device-time
  attribution and the stats;
- :mod:`.http` — the protocol and :class:`Daemon`;
- :mod:`.journal` — the admission journal (replay after a crash,
  idempotent dedup, fleet leases);
- :mod:`.recovery` — retry, bisection, the circuit breaker, and which
  faults the ladder may recover (a device fault is never rescued);
- :mod:`.faults` — the self-nemesis's fault points.

Streaming sessions (:mod:`.session`): the register family's carried
frontier on the card (:class:`~.session.DeviceFrontierEngine`), the
transactional incremental closure (:class:`~.session.TxnSessionEngine`),
the :class:`~.session.Session` above them with its registry, and the
mega-group advance (:func:`~.session.advance_group`), many sessions'
blocks in one launch of K10; the daemon's ``/session`` endpoints, their
journal entries, replay and idle sweeper.

    from jepsen_tpu_torch import serve
    d = serve.Daemon(port=8642, store_root="store").start()
    # ... POST /check ...
    d.shutdown()
"""
from jepsen_tpu_torch.serve.coalesce import (AdmissionQueue, Backpressure,
                                             plan_admission)
from jepsen_tpu_torch.serve.engine import Dispatcher
from jepsen_tpu_torch.serve.http import Daemon, parse_check_body, resolve_model
from jepsen_tpu_torch.serve.journal import Journal
from jepsen_tpu_torch.serve.recovery import CircuitBreaker, RetryPolicy
from jepsen_tpu_torch.serve.request import (CANCELLED, DISPATCHED, DONE, ERROR,
                                            QUARANTINED, QUEUED, TIMEOUT,
                                            CheckRequest, Registry)
from jepsen_tpu_torch.serve.session import (AdvanceAborted,
                                            DeviceFrontierEngine, Session,
                                            SessionRegistry,
                                            TxnSessionEngine, advance_group)

__all__ = [
    "AdmissionQueue", "Backpressure", "plan_admission", "Dispatcher",
    "Daemon", "parse_check_body", "resolve_model", "CheckRequest",
    "Registry", "Journal", "CircuitBreaker", "RetryPolicy",
    "DeviceFrontierEngine", "TxnSessionEngine", "AdvanceAborted",
    "Session", "SessionRegistry", "advance_group",
    "QUEUED", "DISPATCHED", "DONE", "TIMEOUT", "CANCELLED", "QUARANTINED",
    "ERROR",
]

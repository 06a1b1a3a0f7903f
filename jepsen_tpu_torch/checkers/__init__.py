"""Checkers — upstream: ``jepsen/src/jepsen/checker.clj`` plus Knossos.

- :mod:`.facade` — the composable ``Checker`` API, the ``auto`` chain,
  the ``competition`` race and the data-invariant checkers.
- :mod:`.reach` — the dense-reachability search (host prep, routing,
  torch walks, witness); ``check_many`` and ``check_batch`` for many
  histories at once.
- :mod:`.reach_batch` — the lockstep walk of many histories (K2) and its
  split dispatch; :mod:`.dispatch_core` — the lockstep schedulers'
  dispatch and collect state.
- :mod:`.reach_lane` — the single-history walk as one CUDA kernel, with
  its plain PyTorch version.
- :mod:`.reach_pallas` — the walks of more than 32 states (one history,
  and many keys), as CUDA kernels with their plain versions.
- :mod:`.wgl_ref` — the Python Wing-Gong-Lowe oracle.
- :mod:`.linear` — sparse just-in-time linearization (upstream
  ``knossos.linear``), host only; :mod:`.linear_report` — the SVG of a
  failing window; :mod:`.search` — deadline, abort and memory watchdog.
- :mod:`.events` — host-side slot/event-stream preprocessing, on the C++
  scans of :mod:`.preproc_native` (``native/preproc.cpp``).
- :mod:`.online` — the live monitor of a run (``run --online``) and its
  streaming engines, on the C++ monitor core of :mod:`.preproc_native`.
"""
from jepsen_tpu_torch.checkers.facade import (  # noqa: F401
    Checker, check_declining, check_safe, compose, counter, linearizable,
    noop_checker, queue, set_checker, stats, total_queue, unbridled_optimism,
)

"""Checkers — upstream: ``jepsen/src/jepsen/checker.clj`` plus Knossos.

- :mod:`.facade` — the composable ``Checker`` API and the ``auto`` chain.
- :mod:`.reach` — the dense-reachability search (host prep, routing,
  torch walks, witness).
- :mod:`.reach_lane` — the single-history walk as one CUDA kernel, with
  its plain PyTorch version.
- :mod:`.reach_pallas` — the walks of more than 32 states (one history,
  and many keys), as CUDA kernels with their plain versions.
- :mod:`.wgl_ref` — the Python Wing-Gong-Lowe oracle.
- :mod:`.events` — host-side slot/event-stream preprocessing.
"""

"""Base test map — upstream ``jepsen/src/jepsen/tests.clj``:
``noop_test`` is the canonical minimal test every suite
merges over.
"""
from __future__ import annotations

from typing import Any, Dict

from jepsen_tpu_torch.checkers.facade import unbridled_optimism
from jepsen_tpu_torch.client import noop_client


def noop_test() -> Dict[str, Any]:
    """A test that does nothing, successfully (upstream
    ``jepsen.tests/noop-test``)."""
    return {
        "name": "noop",
        "nodes": [],
        "concurrency": 1,
        "os": None,
        "db": None,
        "client": noop_client(),
        "nemesis": None,
        "generator": None,
        "checker": unbridled_optimism(),
        "model": None,
        "ssh": {},
        "store": True,
        "store-root": "store",
    }

"""Report helpers — upstream ``jepsen/src/jepsen/report.clj``: spit an
analysis to a file alongside the run.
"""
from __future__ import annotations

import json
import os
from typing import Any, Mapping


def to(path: str, results: Mapping[str, Any]) -> str:
    """Write ``results`` (JSON) to ``path``, creating parents (upstream
    ``report/to``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2, default=str)
    return path

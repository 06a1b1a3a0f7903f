"""DB automation protocols — upstream ``jepsen/src/jepsen/db.clj``:
install/start/stop the system under test on each node.

Protocols (duck-typed; implement what applies, like upstream's optional
``Primary``/``LogFiles`` protocols):

- ``setup(test, node)`` / ``teardown(test, node)`` — required.
- ``primaries(test)`` / ``setup_primary(test, node)`` — Primary.
- ``log_files(test, node)`` — LogFiles; paths are downloaded by
  ``snarf_logs`` at the end of a run.
- ``pause/resume/kill/start`` — Process (drives the kill/pause nemeses).
"""
from __future__ import annotations

import os
from typing import Any, List, Mapping, Optional, Sequence

from jepsen_tpu_torch import control


class DB:
    """Base DB (upstream ``jepsen.db/DB`` protocol)."""

    def setup(self, test: Mapping, node: str) -> None:
        pass

    def teardown(self, test: Mapping, node: str) -> None:
        pass

    # -- LogFiles ------------------------------------------------------------
    def log_files(self, test: Mapping, node: str) -> List[str]:
        return []

    # -- Primary -------------------------------------------------------------
    def primaries(self, test: Mapping) -> List[str]:
        return []

    # -- Process (for kill/pause nemeses) -------------------------------------
    def kill(self, test: Mapping, node: str) -> None:
        raise NotImplementedError

    def start(self, test: Mapping, node: str) -> None:
        raise NotImplementedError

    def pause(self, test: Mapping, node: str) -> None:
        raise NotImplementedError

    def resume(self, test: Mapping, node: str) -> None:
        raise NotImplementedError


class NoopDB(DB):
    """No database to set up (upstream ``jepsen.db/noop``)."""


def noop() -> NoopDB:
    return NoopDB()


def cycle_db(db: DB, test: Mapping, node: str) -> None:
    """Teardown then setup (upstream ``jepsen.db/cycle!``)."""
    db.teardown(test, node)
    db.setup(test, node)


def setup_all(test: Mapping) -> None:
    """Run ``db.setup`` on every node in parallel (called by the core
    runner; upstream ``core/run!`` via ``on-nodes``)."""
    db = test.get("db")
    if db is None:
        return
    control.on_nodes(test, lambda s, node: db.setup(test, node))
    for node in db.primaries(test):
        if hasattr(db, "setup_primary"):
            db.setup_primary(test, node)


def teardown_all(test: Mapping) -> None:
    db = test.get("db")
    if db is None:
        return
    control.on_nodes(test, lambda s, node: db.teardown(test, node))


def snarf_logs(test: Mapping, dest_dir: str) -> List[str]:
    """Download every node's DB log files into ``dest_dir/<node>/``
    (upstream ``core/snarf-logs!``)."""
    db = test.get("db")
    if db is None:
        return []
    got: List[str] = []

    def grab(s: control.Session, node: str) -> None:
        for path in db.log_files(test, node):
            local_dir = os.path.join(dest_dir, str(node))
            os.makedirs(local_dir, exist_ok=True)
            local = os.path.join(local_dir, os.path.basename(path))
            try:
                s.download(path, local)
                got.append(local)
            except Exception:                           # noqa: BLE001
                pass                                    # missing log ≠ failure

    control.on_nodes(test, grab)
    return got

"""Client protocol — upstream ``jepsen/src/jepsen/client.clj``:
the per-process connection to the system under test.

Lifecycle, as driven by :mod:`jepsen_tpu_torch.core`:

- ``open(test, node)`` → a client bound to one node (upstream ``open!``;
  era-tolerant: clients that don't override it are shared as-is, like the
  pre-``open!`` era where ``setup!`` did the binding).
- ``setup(test)`` once after open (schema creation etc.).
- ``invoke(test, op)`` → completed op (``ok``/``fail``/``info``) for each
  invocation the generator emits. MUST be exception-safe: the runner maps
  exceptions to ``info`` (indeterminate) exactly like the upstream worker.
- ``teardown(test)`` / ``close(test)`` on shutdown.

``invoke`` receives the full invocation :class:`~jepsen_tpu_torch.op.Op` and
returns its completion — typically ``op.with_(type=OK, value=...)``.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from jepsen_tpu_torch.op import FAIL, INFO, OK, Op


class Client:
    """Base client (upstream ``jepsen.client/Client`` protocol)."""

    def open(self, test: Mapping, node: Any) -> "Client":
        """Return a client instance bound to ``node``. Default: bind self
        (single shared client, pre-``open!`` era semantics)."""
        return self

    def setup(self, test: Mapping) -> None:
        pass

    def invoke(self, test: Mapping, op: Op) -> Op:
        raise NotImplementedError

    def teardown(self, test: Mapping) -> None:
        pass

    def close(self, test: Mapping) -> None:
        pass


class NoopClient(Client):
    """Acknowledges every op without doing anything (upstream
    ``jepsen.client/noop-client``); the default in ``noop_test``."""

    def invoke(self, test: Mapping, op: Op) -> Op:
        return op.with_(type=OK)


def noop_client() -> NoopClient:
    return NoopClient()


def closable(client: Client) -> bool:
    """Whether the client overrides ``close`` (upstream
    ``jepsen.client/closable?``)."""
    return type(client).close is not Client.close


def ok(op: Op, value: Any = None) -> Op:
    """Complete ``op`` successfully, optionally replacing its value."""
    return op.with_(type=OK, value=value if value is not None else op.value)


def _with_error(op: Op, type_: str, error: Optional[str]) -> Op:
    if error is None:
        return op.with_(type=type_)
    extra = dict(op.extra or {})
    extra["error"] = error
    return op.with_(type=type_, extra=extra)


def fail(op: Op, error: Optional[str] = None) -> Op:
    """The op definitely did not happen."""
    return _with_error(op, FAIL, error)


def info(op: Op, error: Optional[str] = None) -> Op:
    """Indeterminate: the op may or may not have happened (timeouts,
    crashes). Checkers must keep it pending forever."""
    return _with_error(op, INFO, error)

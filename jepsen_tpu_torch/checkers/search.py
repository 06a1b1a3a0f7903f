"""Search control — upstream ``knossos/src/knossos/search.clj``: deadline
and abort management plus the memory watchdog that aborts a search
before the process dies of heap exhaustion (the upstream watches the JVM
heap; here ``/proc/meminfo`` MemAvailable).

Engines poll :meth:`SearchControl.should_abort` (the Python searches and
the device walks between their segments) or share the ctypes flag
(:class:`~jepsen_tpu_torch.checkers.wgl_native.AbortFlag`) through
:meth:`SearchControl.bind_native`. Host only.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Any, List, Optional


def mem_available_bytes() -> Optional[int]:
    """MemAvailable in bytes, or None where ``/proc/meminfo`` cannot be
    read (the watchdog then never fires)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


class SearchControl:
    """Cooperative abort: deadline, explicit abort, low-memory watchdog."""

    def __init__(self, time_limit: Optional[float] = None,
                 min_free_bytes: int = 256 << 20,
                 watchdog_interval: float = 0.5):
        self._deadline = (None if time_limit is None
                          else _time.monotonic() + time_limit)
        self._aborted = threading.Event()
        self._cause: Optional[str] = None
        self._min_free = min_free_bytes
        self._natives: List[Any] = []
        self._watchdog: Optional[threading.Thread] = None
        self._interval = watchdog_interval
        self._stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SearchControl":
        if self._watchdog is None:
            self._watchdog = threading.Thread(
                target=self._watch, daemon=True, name="jepsen-search-watchdog")
            self._watchdog.start()
        return self

    def close(self) -> None:
        self._stop.set()

    def __enter__(self) -> "SearchControl":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- abort surface -------------------------------------------------------
    def abort(self, cause: str = "aborted") -> None:
        if not self._aborted.is_set():
            self._cause = cause
            self._aborted.set()
            for flag in self._natives:
                flag.abort()

    def should_abort(self) -> bool:
        if self._aborted.is_set():
            return True
        if (self._deadline is not None
                and _time.monotonic() > self._deadline):
            self.abort("timeout")
            return True
        return False

    @property
    def cause(self) -> Optional[str]:
        return self._cause

    def bind_native(self, flag: Any) -> Any:
        """Register a native AbortFlag to be tripped on abort."""
        self._natives.append(flag)
        if self._aborted.is_set():
            flag.abort()
        return flag

    # -- watchdog ------------------------------------------------------------
    def _watch(self) -> None:
        while not self._stop.wait(self._interval):
            if self.should_abort():
                return
            free = mem_available_bytes()
            if free is not None and free < self._min_free:
                self.abort("low-memory")
                return

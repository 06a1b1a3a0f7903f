"""Build and load the package's C++ host library.

``native/preproc.cpp`` (the event-stream scans, the keyed union prep
and the benchmark-history generator) is compiled by ``g++`` at first use
into ``_build/``, keyed by a hash of the source and the flags, then
loaded with :mod:`ctypes`. Each process compiles into a file of its own
and installs it with ``os.replace``, so processes that build at once
(test workers) all load a whole library. A missing ``g++`` or a failed
build raises: there is no fallback to the Python scans.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_PKG, "native", "preproc.cpp")
BUILD = os.path.join(_PKG, "_build")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD, f"preproc-{digest.hexdigest()[:16]}.so")


def build() -> float:
    """Compile the library unless it is there; the wall seconds taken."""
    t0 = time.perf_counter()
    so = library_path()
    if os.path.exists(so):
        return time.perf_counter() - t0
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host library "
                           "native/preproc.cpp is compiled at first use")
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    out = subprocess.run([gxx, *FLAGS, "-o", tmp, SRC],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed to build native/preproc.cpp "
                           f"(exit {out.returncode}):\n{out.stderr}")
    os.replace(tmp, so)
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            _LIB = ctypes.CDLL(library_path())
        return _LIB

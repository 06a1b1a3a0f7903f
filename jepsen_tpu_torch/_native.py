"""Build and load the package's C++ host libraries.

Two sources, each compiled by ``g++`` at first use into a library of its
own under ``_build/``, keyed by a hash of the source and the flags, then
loaded with :mod:`ctypes`:

- ``preproc`` (``native/preproc.cpp``): the event-stream scans, the keyed
  union prep and the benchmark-history generator;
- ``wgl`` (``native/wgl.cpp``): the WGL search
  (:mod:`jepsen_tpu_torch.checkers.wgl_native`).

Each process compiles into a file of its own and installs it with
``os.replace``, so processes that build at once (test workers) all load
a whole library. A missing ``g++`` or a failed build raises: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_PKG, "native", "preproc.cpp")
WGL_SRC = os.path.join(_PKG, "native", "wgl.cpp")
BUILD = os.path.join(_PKG, "_build")
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
LIBRARIES = ("preproc", "wgl")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def source(name: str = "preproc") -> str:
    """The C++ source of library ``name``."""
    if name not in LIBRARIES:
        raise ValueError(f"no host library {name!r}; have {LIBRARIES}")
    return SRC if name == "preproc" else WGL_SRC


def library_path(name: str = "preproc") -> str:
    """Where library ``name`` of the current source and flags lives."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(source(name), "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str = "preproc") -> float:
    """Compile library ``name`` unless it is there; the wall seconds
    taken."""
    t0 = time.perf_counter()
    src = source(name)
    so = library_path(name)
    if os.path.exists(so):
        return time.perf_counter() - t0
    rel = os.path.relpath(src, _PKG)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the host library {rel} is "
                           f"compiled at first use")
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    out = subprocess.run([gxx, *FLAGS, "-o", tmp, src],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed to build {rel} "
                           f"(exit {out.returncode}):\n{out.stderr}")
    os.replace(tmp, so)
    return time.perf_counter() - t0


def load(name: str = "preproc") -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build(name)
            lib = _LIBS[name] = ctypes.CDLL(library_path(name))
        return lib

"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library under
``_build/``, keyed by a hash of the source, the headers and the flags,
then loaded with :mod:`ctypes`. No PyTorch headers are involved, so a
build takes
seconds. The build happens at first use; :func:`build_all` starts one
``nvcc`` per source at once. A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are compiled "
                           "at first use and need the CUDA toolkit")
    return path


def sources() -> Iterable[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(os.path.basename(p)[:-3]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def _paths(name: str):
    """Source, library and log paths of ``csrc/<name>.cu``. The hash
    covers the source, every header in ``csrc/`` (the walk kernels share
    ``walk.cuh``) and the flags, so an edit to any of them rebuilds."""
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.join(BUILD, f"{name}-{digest.hexdigest()[:16]}")
    return src, stem + ".so", stem + ".log"


def _start(name: str) -> Optional[subprocess.Popen]:
    src, so, log = _paths(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    return subprocess.Popen(
        [_nvcc(), *FLAGS, "-o", tmp, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    _src, so, log = _paths(name)
    out, _ = proc.communicate()
    with open(log, "w") as f:
        f.write(out)
    tmp = f"{so}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)


def build_all(names: Optional[Iterable[str]] = None) -> float:
    """Build every named source (default: all) with one ``nvcc`` each,
    all started together. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    names = list(sources() if names is None else names)
    with _LOCK:
        procs = [(n, _start(n)) for n in names]
        try:
            for n, p in procs:
                if p is not None:
                    _finish(n, p)
        finally:
            for _n, p in procs:
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """What ``nvcc`` printed (``ptxas`` register and shared-memory use)
    for the current build of ``name``; empty if it was not built here."""
    log = _paths(name)[2]
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(_paths(name)[1])
    return lib

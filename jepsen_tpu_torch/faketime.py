"""libfaketime clock lies — upstream ``jepsen.faketime``:
start DB daemons under ``LD_PRELOAD=libfaketime`` so their clocks drift or
jump without touching the node's real clock (no root clock changes, works
alongside ntp).

Usage mirrors upstream: wrap the daemon launch::

    ctl_util.start_daemon(s, binary, ..., env=faketime.env("-30s", rate=1.1))
"""
from __future__ import annotations

from typing import Dict, Optional

from jepsen_tpu_torch.control import Session

# common soname locations, era-dependent across distros
_LIBS = ("/usr/lib/x86_64-linux-gnu/faketime/libfaketime.so.1",
         "/usr/lib/faketime/libfaketime.so.1",
         "/usr/lib64/faketime/libfaketime.so.1")


def install(s: Session) -> None:
    """Install the faketime package on a node (upstream installs via apt)."""
    s = s.su()
    if s.exec_raw("which faketime").exit_code != 0:
        s.exec_raw("apt-get -qy install faketime || "
                   "yum -y -q install libfaketime || true")


def lib_path(s: Session) -> Optional[str]:
    for p in _LIBS:
        if s.exec_raw(f"test -e {p}").exit_code == 0:
            return p
    out = s.exec_raw(
        "find /usr/lib* -name 'libfaketime.so*' 2>/dev/null | head -1")
    return out.out.strip() or None


def env(offset: str = "+0s", rate: Optional[float] = None,
        lib: str = _LIBS[0]) -> Dict[str, str]:
    """Environment for a faketime'd daemon: ``offset`` like ``"-30s"`` /
    ``"+2h"``; ``rate`` speeds up or slows down the clock (upstream
    ``faketime/jvm-opts``-style ``x`` rates)."""
    spec = offset if rate is None else f"{offset} x{rate}"
    return {"LD_PRELOAD": lib, "FAKETIME": spec,
            "FAKETIME_NO_CACHE": "1"}


def wrap(cmd: str, offset: str = "+0s", rate: Optional[float] = None) -> str:
    """Prefix a shell command with the faketime CLI (simpler alternative
    when the binary is available)."""
    spec = offset if rate is None else f"{offset} x{rate}"
    return f"faketime -f {spec!r} {cmd}"

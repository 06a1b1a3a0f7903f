"""Node-automation helpers — upstream ``jepsen/src/jepsen/control/util.clj``:
daemon management, archive installs, process killing.
All functions take a :class:`~jepsen_tpu_torch.control.Session`.
"""
from __future__ import annotations

import os
from typing import Any, Mapping, Optional

from jepsen_tpu_torch.control import Session, escape


def exists(s: Session, path: str) -> bool:
    return s.exec_raw(f"test -e {path}").exit_code == 0


def ls_full(s: Session, dir: str) -> list:
    """Absolute paths of directory entries (upstream ``ls-full``)."""
    out = s.exec_raw(f"ls -A {dir}")
    if out.exit_code != 0:
        return []
    return [os.path.join(dir, name) for name in out.out.split()]


def start_daemon(s: Session, binary: str, *args: Any,
                 logfile: str = "/dev/null",
                 pidfile: Optional[str] = None,
                 chdir: Optional[str] = None,
                 env: Optional[Mapping[str, str]] = None) -> None:
    """Start a long-running process detached from the session, recording
    its pid (upstream ``start-daemon!`` — which drives
    ``start-stop-daemon``; plain nohup+pidfile is portable to every node
    image)."""
    cmd = " ".join(escape(a) for a in (binary,) + args)
    if env:
        cmd = " ".join(f"{k}={escape(v)}" for k, v in env.items()) + " " + cmd
    if chdir:
        cmd = f"cd {escape(chdir)} && {cmd}"
    pidfile = pidfile or f"/tmp/{os.path.basename(binary)}.pid"
    s.exec_raw(f"nohup {cmd} >> {escape(logfile)} 2>&1 & echo $! > "
               f"{escape(pidfile)}")


def stop_daemon(s: Session, binary: str,
                pidfile: Optional[str] = None) -> None:
    """Kill a daemon by pidfile, falling back to pkill (upstream
    ``stop-daemon!``)."""
    pidfile = pidfile or f"/tmp/{os.path.basename(binary)}.pid"
    s.exec_raw(f"test -f {pidfile} && kill -9 $(cat {pidfile}) ; "
               f"rm -f {pidfile}")
    grepkill(s, os.path.basename(binary))


def grepkill(s: Session, pattern: str, signal: int = 9) -> None:
    """Kill every process matching ``pattern`` (upstream ``grepkill!``)."""
    s.exec_raw(f"pkill -{signal} -f {pattern} || true")


def daemon_running(s: Session, pidfile: str) -> bool:
    return s.exec_raw(
        f"test -f {pidfile} && kill -0 $(cat {pidfile})").exit_code == 0


def wget(s: Session, url: str, dest: Optional[str] = None,
         force: bool = False) -> str:
    """Download a file on the node, cached unless ``force`` (upstream
    ``wget!``)."""
    dest = dest or os.path.basename(url)
    if force:
        s.exec_raw(f"rm -f {dest}")
    if not exists(s, dest):
        s.exec("wget", "-q", "-O", dest, url)
    return dest


def install_archive(s: Session, url: str, dest_dir: str,
                    force: bool = False) -> str:
    """Fetch a .tar.gz/.tgz/.zip and unpack it into ``dest_dir``, stripping
    a single top-level directory (upstream ``install-archive!`` /
    ``install-tarball!``)."""
    if force:
        s.exec_raw(f"rm -rf {dest_dir}")
    if exists(s, dest_dir):
        return dest_dir
    tmp = f"/tmp/jepsen-archive-{os.path.basename(dest_dir)}"
    s.exec_raw(f"rm -rf {tmp} && mkdir -p {tmp}")
    if url.startswith("file://"):
        archive = url[len("file://"):]
    else:
        archive = wget(s, url, f"{tmp}/archive")
    s.exec("mkdir", "-p", dest_dir)
    if url.endswith(".zip"):
        s.exec("unzip", "-q", archive, "-d", tmp)
        s.exec_raw(f"sh -c 'mv {tmp}/*/* {dest_dir}/ 2>/dev/null || "
                   f"mv {tmp}/* {dest_dir}/'")
    else:
        s.exec("tar", "-xzf", archive, "-C", dest_dir,
               "--strip-components", "1")
    s.exec_raw(f"rm -rf {tmp}")
    return dest_dir

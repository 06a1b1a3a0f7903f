"""Remote control — upstream ``jepsen/src/jepsen/control.clj``:
run commands on DB nodes, upload/download files.

The upstream drives JSch (Java SSH) with dynamic vars ``*host* *session*
*sudo* *dir*``. Here the seam is an explicit :class:`Remote` protocol (the
later-upstream design, which grew pluggable docker/dummy remotes) with
three implementations:

- :class:`SSHRemote` — drives the system ``ssh``/``scp`` binaries
  (paramiko is not in the image; OpenSSH with ControlMaster multiplexing
  is faster than JSch anyway).
- :class:`LocalRemote` — runs commands in a local shell, node name ignored
  (the docker/CI story: every "node" is this machine).
- :class:`FakeRemote` — records commands and returns scripted replies; for
  unit tests of nemeses/DB automation without any cluster.

A :class:`Session` binds a Remote to one node plus sudo/dir context, giving
the upstream verbs: ``exec``, ``upload``, ``download``, ``su``, ``cd``.
"""
from __future__ import annotations

import os
import shlex
import subprocess
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union


class RemoteError(RuntimeError):
    """Non-zero exit from a remote command (upstream throws on bad exit)."""

    def __init__(self, cmd: str, exit_code: int, out: str, err: str):
        super().__init__(
            f"remote command failed ({exit_code}): {cmd}\n"
            f"stdout: {out.strip()[:500]}\nstderr: {err.strip()[:500]}")
        self.cmd = cmd
        self.exit_code = exit_code
        self.out = out
        self.err = err


@dataclass
class Result:
    exit_code: int
    out: str
    err: str


class Remote:
    """Transport protocol (upstream later-era ``jepsen.control/Remote``)."""

    def connect(self, node: str, ssh: Mapping) -> None:
        pass

    def disconnect(self, node: str) -> None:
        pass

    def execute(self, node: str, cmd: str, *, timeout: Optional[float] = None
                ) -> Result:
        raise NotImplementedError

    def upload(self, node: str, local: str, remote_path: str) -> None:
        raise NotImplementedError

    def download(self, node: str, remote_path: str, local: str) -> None:
        raise NotImplementedError


class LocalRemote(Remote):
    """Every node is the local machine (CI / single-box testing)."""

    def execute(self, node, cmd, *, timeout=None):
        p = subprocess.run(["/bin/sh", "-c", cmd], capture_output=True,
                           text=True, timeout=timeout)
        return Result(p.returncode, p.stdout, p.stderr)

    def upload(self, node, local, remote_path):
        subprocess.run(["cp", "-r", local, remote_path], check=True)

    def download(self, node, remote_path, local):
        subprocess.run(["cp", "-r", remote_path, local], check=True)


class SSHRemote(Remote):
    """OpenSSH binary transport with per-node ControlMaster multiplexing
    (one real TCP/auth handshake per node, upstream keeps one JSch session
    the same way). The ControlMaster sockets live in ``control_dir``,
    by default ``jepsen-ssh`` under the temporary directory."""

    def __init__(self, control_dir: Optional[str] = None):
        control_dir = control_dir or os.path.join(tempfile.gettempdir(),
                                                  "jepsen-ssh")
        os.makedirs(control_dir, exist_ok=True)
        self._control_dir = control_dir
        self._opts: Dict[str, List[str]] = {}

    def _base(self, node: str) -> List[str]:
        return ["ssh"] + self._opts.get(node, []) + [
            "-o", f"ControlPath={self._control_dir}/%r@%h:%p",
            "-o", "ControlMaster=auto", "-o", "ControlPersist=60",
            "-o", "StrictHostKeyChecking=no",
            "-o", "UserKnownHostsFile=/dev/null",
            "-o", "LogLevel=ERROR"]

    def connect(self, node, ssh):
        opts: List[str] = []
        if ssh.get("username"):
            opts += ["-l", str(ssh["username"])]
        if ssh.get("port"):
            opts += ["-p", str(ssh["port"])]
        if ssh.get("private-key-path"):
            opts += ["-i", str(ssh["private-key-path"])]
        self._opts[node] = opts

    def disconnect(self, node):
        subprocess.run(self._base(node) + ["-O", "exit", node],
                       capture_output=True)

    def execute(self, node, cmd, *, timeout=None):
        p = subprocess.run(self._base(node) + [node, cmd],
                           capture_output=True, text=True, timeout=timeout)
        return Result(p.returncode, p.stdout, p.stderr)

    def _scp_target(self, node: str) -> str:
        user = ""
        opts = self._opts.get(node, [])
        if "-l" in opts:
            user = opts[opts.index("-l") + 1] + "@"
        return f"{user}{node}"

    def upload(self, node, local, remote_path):
        p = subprocess.run(
            ["scp", "-r", "-o", "StrictHostKeyChecking=no",
             "-o", "UserKnownHostsFile=/dev/null", "-o", "LogLevel=ERROR",
             "-o", f"ControlPath={self._control_dir}/%r@%h:%p",
             local, f"{self._scp_target(node)}:{remote_path}"],
            capture_output=True, text=True)
        if p.returncode:
            raise RemoteError(f"scp {local}", p.returncode, p.stdout, p.stderr)

    def download(self, node, remote_path, local):
        p = subprocess.run(
            ["scp", "-r", "-o", "StrictHostKeyChecking=no",
             "-o", "UserKnownHostsFile=/dev/null", "-o", "LogLevel=ERROR",
             "-o", f"ControlPath={self._control_dir}/%r@%h:%p",
             f"{self._scp_target(node)}:{remote_path}", local],
            capture_output=True, text=True)
        if p.returncode:
            raise RemoteError(f"scp {remote_path}", p.returncode, p.stdout,
                              p.stderr)


class FakeRemote(Remote):
    """Scripted remote for unit tests: records every command; replies from
    ``responses`` (cmd-substring → stdout), else empty success."""

    def __init__(self, responses: Optional[Dict[str, str]] = None):
        self.commands: List[Tuple[str, str]] = []   # (node, cmd)
        self.uploads: List[Tuple[str, str, str]] = []
        self.downloads: List[Tuple[str, str, str]] = []
        self.responses = responses or {}
        self._lock = threading.Lock()

    def execute(self, node, cmd, *, timeout=None):
        with self._lock:
            self.commands.append((node, cmd))
        for key, out in self.responses.items():
            if key in cmd:
                if isinstance(out, tuple):
                    return Result(out[0], out[1], "")
                return Result(0, out, "")
        return Result(0, "", "")

    def upload(self, node, local, remote_path):
        with self._lock:
            self.uploads.append((node, local, remote_path))

    def download(self, node, remote_path, local):
        with self._lock:
            self.downloads.append((node, remote_path, local))


def lit(s: str) -> "Literal":
    """An unescaped literal for command construction (upstream
    ``control/lit``)."""
    return Literal(s)


@dataclass(frozen=True)
class Literal:
    s: str


def escape(arg: Any) -> str:
    """Shell-escape one argument (upstream ``control/escape``)."""
    if isinstance(arg, Literal):
        return arg.s
    return shlex.quote(str(arg))


@dataclass
class Session:
    """A Remote bound to one node + sudo/dir context — the upstream dynamic
    vars made explicit. Cheap to copy; ``su``/``cd`` return new sessions."""

    remote: Remote
    node: str
    sudo: Optional[str] = None
    dir: Optional[str] = None
    ssh: Mapping = field(default_factory=dict)

    def connect(self) -> "Session":
        self.remote.connect(self.node, self.ssh)
        return self

    def disconnect(self) -> None:
        self.remote.disconnect(self.node)

    def su(self, user: str = "root") -> "Session":
        return Session(self.remote, self.node, sudo=user, dir=self.dir,
                       ssh=self.ssh)

    def cd(self, dir: str) -> "Session":
        return Session(self.remote, self.node, sudo=self.sudo, dir=dir,
                       ssh=self.ssh)

    def wrap(self, cmd: str) -> str:
        if self.dir:
            cmd = f"cd {escape(self.dir)} && {cmd}"
        if self.sudo:
            cmd = f"sudo -S -u {escape(self.sudo)} /bin/sh -c {escape(cmd)}"
        return cmd

    def exec(self, *args: Any, timeout: Optional[float] = None,
             check: bool = True) -> str:
        """Run a command built from escaped args; returns trimmed stdout
        (upstream ``control/exec``)."""
        cmd = " ".join(escape(a) for a in args)
        res = self.remote.execute(self.node, self.wrap(cmd), timeout=timeout)
        if check and res.exit_code != 0:
            raise RemoteError(cmd, res.exit_code, res.out, res.err)
        return res.out.strip()

    def exec_raw(self, cmd: str, timeout: Optional[float] = None) -> Result:
        return self.remote.execute(self.node, self.wrap(cmd), timeout=timeout)

    def upload(self, local: str, remote_path: str) -> None:
        self.remote.upload(self.node, local, remote_path)

    def download(self, remote_path: str, local: str) -> None:
        self.remote.download(self.node, remote_path, local)


def remote_for(test: Mapping) -> Remote:
    """The test map's remote: ``test["remote"]`` if given, else a shared
    SSH remote cached into the test map (so ControlMaster sockets and
    per-node credentials persist across sessions). Upstream defaults to
    SSH; ``--dummy`` style local runs pass ``LocalRemote``."""
    r = test.get("remote")
    if r is not None:
        return r
    r = SSHRemote()
    try:
        test["remote"] = r                              # type: ignore[index]
    except TypeError:
        pass                                    # immutable test map: one-shot
    return r


def session(test: Mapping, node: str) -> Session:
    """A connected session for ``node`` — registers the test's ssh
    credentials (username/port/key) with the remote. Note: password auth
    is not supported (no sshpass in the image); use key-based auth."""
    return Session(remote_for(test), node,
                   ssh=test.get("ssh") or {}).connect()


def on_nodes(test: Mapping, fn, nodes: Optional[Sequence[str]] = None
             ) -> Dict[str, Any]:
    """Run ``fn(session, node)`` on every node in parallel threads
    (upstream ``control/on-many`` / ``core/on-nodes``)."""
    nodes = list(nodes if nodes is not None else test.get("nodes", []))
    out: Dict[str, Any] = {}
    errs: Dict[str, Exception] = {}

    def run(node: str) -> None:
        try:
            out[node] = fn(session(test, node), node)
        except Exception as e:                          # noqa: BLE001
            errs[node] = e

    threads = [threading.Thread(target=run, args=(n,), daemon=True)
               for n in nodes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        node, e = next(iter(errs.items()))
        raise RuntimeError(f"on_nodes failed on {node}: {e}") from e
    return out

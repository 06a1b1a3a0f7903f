"""OS automation — upstream ``jepsen/src/jepsen/os.clj`` + ``os/debian.clj``
``os/centos.clj`` ``os/ubuntu.clj``: prepare each node's operating system
before the DB is installed.
"""
from __future__ import annotations

from typing import Mapping, Sequence

from jepsen_tpu_torch import control


class OS:
    """Base OS (upstream ``jepsen.os/OS`` protocol); default no-op
    (upstream ``jepsen.os/noop``)."""

    def setup(self, test: Mapping, node: str) -> None:
        pass

    def teardown(self, test: Mapping, node: str) -> None:
        pass


class NoopOS(OS):
    pass


def noop() -> NoopOS:
    return NoopOS()


class DebianOS(OS):
    """Debian/Ubuntu prep (upstream ``jepsen.os.debian``): hostname, apt
    update (cached), base packages."""

    def __init__(self, packages: Sequence[str] = ("wget", "curl", "unzip",
                                                  "iptables", "psmisc",
                                                  "tar", "bzip2",
                                                  "ntpdate", "faketime")):
        self.packages = list(packages)

    def setup(self, test, node):
        s = control.session(test, node).su()
        s.exec_raw(f"hostname {control.escape(node)}")
        missing = [p for p in self.packages if s.exec_raw(
            f"dpkg -s {p} >/dev/null 2>&1").exit_code != 0]
        if missing:
            s.exec_raw("apt-get -qy update")
            s.exec("env", "DEBIAN_FRONTEND=noninteractive", "apt-get",
                   "-qy", "install", *missing)


class CentosOS(OS):
    """RHEL-family prep (upstream ``jepsen.os.centos``)."""

    def __init__(self, packages: Sequence[str] = ("wget", "curl", "unzip",
                                                  "iptables", "psmisc",
                                                  "tar", "bzip2")):
        self.packages = list(packages)

    def setup(self, test, node):
        s = control.session(test, node).su()
        s.exec_raw(f"hostname {control.escape(node)}")
        s.exec_raw("yum -y -q install " + " ".join(self.packages))


def debian() -> DebianOS:
    return DebianOS()


def ubuntu() -> DebianOS:
    """Ubuntu uses the Debian toolchain (upstream ``jepsen.os.ubuntu`` is
    a thin wrapper over the debian ns)."""
    return DebianOS()


def centos() -> CentosOS:
    return CentosOS()


def setup_all(test: Mapping) -> None:
    os_ = test.get("os")
    if os_ is None:
        return
    control.on_nodes(test, lambda s, node: os_.setup(test, node))


def teardown_all(test: Mapping) -> None:
    os_ = test.get("os")
    if os_ is None:
        return
    control.on_nodes(test, lambda s, node: os_.teardown(test, node))

"""Network fault primitives — upstream ``jepsen/src/jepsen/net.clj``:
the ``Net`` protocol ``drop!/heal!/slow!/flaky!/
fast!`` with an iptables/tc implementation, plus an in-process
implementation driving a :class:`~jepsen_tpu_torch.fake.cluster.FakeCluster`
(no root, no SSH — the CI story).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

from jepsen_tpu_torch import control


class Net:
    """Upstream ``jepsen.net/Net`` protocol."""

    def drop(self, test: Mapping, src: str, dst: str) -> None:
        """One-way: packets from ``src`` to ``dst`` are dropped."""
        raise NotImplementedError

    def heal(self, test: Mapping) -> None:
        """Remove all partitions."""
        raise NotImplementedError

    def slow(self, test: Mapping, mean_ms: float = 50.0,
             variance_ms: float = 10.0) -> None:
        """Add latency to all node traffic."""
        raise NotImplementedError

    def flaky(self, test: Mapping, prob: float = 0.2) -> None:
        """Drop a fraction of all packets."""
        raise NotImplementedError

    def fast(self, test: Mapping) -> None:
        """Remove slow/flaky impairments."""
        raise NotImplementedError


class IptablesNet(Net):
    """Drives ``iptables`` (partitions) and ``tc``/netem (latency, loss)
    over the control session, exactly the upstream recipe:
    ``iptables -A INPUT -s <src-ip> -j DROP -w`` on the destination node."""

    def drop(self, test, src, dst):
        s = control.session(test, dst).su()
        s.exec("iptables", "-A", "INPUT", "-s", src, "-j", "DROP", "-w")

    def heal(self, test):
        def fn(s: control.Session, node: str):
            s = s.su()
            s.exec("iptables", "-F", "-w")
            s.exec("iptables", "-X", "-w")
        control.on_nodes(test, fn)

    def slow(self, test, mean_ms=50.0, variance_ms=10.0):
        def fn(s: control.Session, node: str):
            s.su().exec("tc", "qdisc", "add", "dev", "eth0", "root",
                        "netem", "delay", f"{mean_ms}ms",
                        f"{variance_ms}ms", "distribution", "normal")
        control.on_nodes(test, fn)

    def flaky(self, test, prob=0.2):
        def fn(s: control.Session, node: str):
            s.su().exec("tc", "qdisc", "add", "dev", "eth0", "root",
                        "netem", "loss", f"{prob * 100:.1f}%",
                        "75%")
        control.on_nodes(test, fn)

    def fast(self, test):
        def fn(s: control.Session, node: str):
            s.su().exec_raw("tc qdisc del dev eth0 root")
        control.on_nodes(test, fn)


class FakeNet(Net):
    """In-process faults against a fake cluster (``test["cluster"]`` — see
    :mod:`jepsen_tpu_torch.fake.cluster`). No upstream analogue; replaces the
    docker/SSH integration path for CI."""

    def drop(self, test, src, dst):
        test["cluster"].drop_link(src, dst)

    def heal(self, test):
        test["cluster"].heal()

    def slow(self, test, mean_ms=50.0, variance_ms=10.0):
        test["cluster"].set_latency(mean_ms / 1000.0)

    def flaky(self, test, prob=0.2):
        test["cluster"].set_loss(prob)

    def fast(self, test):
        test["cluster"].set_latency(0.0)
        test["cluster"].set_loss(0.0)


def iptables() -> IptablesNet:
    return IptablesNet()


def fake() -> FakeNet:
    return FakeNet()


def net_for(test: Mapping) -> Net:
    n = test.get("net")
    if n is not None:
        return n
    if test.get("cluster") is not None:
        return FakeNet()
    return IptablesNet()

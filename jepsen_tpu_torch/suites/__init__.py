"""Per-DB test suites — upstream top-level dirs (``etcd/``, ``zookeeper/``
…), each a small project wiring client + db + generator + checker into a
test map. Here: exemplar suites against the in-proc fake cluster (and
real systems when reachable): :mod:`.register`, :mod:`.mutex`,
:mod:`.set_suite`, :mod:`.counter`, :mod:`.queue`, :mod:`.etcd` (HTTP),
:mod:`.redis` (RESP) and the list-append :mod:`.txn`."""
from __future__ import annotations

from typing import Optional

from jepsen_tpu_torch import generators as g


def partition_cycle(time_limit: float, interval: float,
                    seed: Optional[int] = None) -> g.Generator:
    """Shared nemesis phase: partition start/stop cycles for
    ``time_limit`` seconds, then exactly one final heal so post-fault
    client phases (drains, final reads) run against a healed system."""
    cyc = g.TimeLimit(time_limit, g.cycle(lambda: g.Seq(
        [{"f": "start"}, {"sleep": interval},
         {"f": "stop"}, {"sleep": interval}])))
    return g.Seq([cyc, g.Once({"f": "stop"})])

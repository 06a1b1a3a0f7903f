"""Shared suite scaffolding: the standard start/sleep/stop nemesis
schedule and the standard composed checker set, used by every suite
(upstream repeats these per-suite in each Leiningen project's runner;
here they live once)."""
from __future__ import annotations

from typing import Any, Optional

from jepsen_tpu_torch import generators as g
from jepsen_tpu_torch import models as m
from jepsen_tpu_torch.checkers import facade, perf, timeline


def nemesis_schedule(client_gen: "g.GenLike",
                     interval: float = 1.0) -> "g.GenLike":
    """Client ops interleaved with the classic start/sleep/stop fault
    cycle (upstream's ``gen/nemesis`` + ``gen/cycle`` wiring)."""
    nem_gen = g.Seq([{"sleep": interval / 2},
                     g.cycle(lambda: g.Seq([
                         {"f": "start"},
                         {"sleep": interval},
                         {"f": "stop"},
                         {"sleep": interval}]))])
    return g.clients_gen(client_gen, nem_gen)


def standard_checker(model: "m.Model", algorithm: str = "auto",
                     device: Optional[str] = None,
                     **linear_opts: Any) -> "facade.Compose":
    """linearizable + timeline + latency/rate charts + stats — the
    composition every register-family suite ships. ``device`` is where
    the linearizability check runs: the card by default, ``"cpu"`` for
    the plain PyTorch versions."""
    return facade.compose({
        "linear": facade.Linearizable(model, algorithm=algorithm,
                                      opts=linear_opts, device=device),
        "timeline": timeline.html(),
        "latency": perf.latency_graph(),
        "rate": perf.rate_graph(),
        "stats": facade.stats(),
    })

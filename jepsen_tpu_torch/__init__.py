"""jepsen_tpu_torch — the linearizability and transactional checkers on
PyTorch and CUDA.

A port of the ``jepsen_tpu`` package to one NVIDIA H100: the dense
reachability walks and the transactional closure's squaring
(``jepsen_tpu_torch.txn``) run as hand-written CUDA kernels
(``csrc/*.cu``), built by ``nvcc`` at first use. Entry points run on the card unless the
caller passes ``device="cpu"``; they never fall back to the CPU by
themselves.

    from jepsen_tpu_torch import Linearizable, fixtures, independent, models
    h = fixtures.gen_history("cas", n_ops=100_000, processes=5, seed=0)
    Linearizable(models.cas_register()).check(None, h)
    # a history whose values are [key, value] pairs, checked per key
    independent.checker(Linearizable(models.cas_register())).check(None, hk)
"""
from jepsen_tpu_torch import fixtures, history, models, obs  # noqa: F401
from jepsen_tpu_torch import independent  # noqa: F401
from jepsen_tpu_torch.checkers.facade import (  # noqa: F401
    Checker, Linearizable, auto_check_packed, check_safe, linearizable)
from jepsen_tpu_torch.device import default_device  # noqa: F401
from jepsen_tpu_torch.op import Op, fail, info, invoke, ok  # noqa: F401

__all__ = [
    "Checker", "Linearizable", "Op", "auto_check_packed", "check_safe",
    "default_device", "fail", "fixtures", "history", "independent", "info",
    "invoke", "linearizable", "models", "obs", "ok",
]

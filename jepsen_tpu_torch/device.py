"""Device selection for the port's entry points: the card unless the
caller names the CPU, and never the CPU by itself."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def default_device() -> torch.device:
    """The first CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda")


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` → :func:`default_device`; a CUDA device is checked to
    exist; anything else is taken as given."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev

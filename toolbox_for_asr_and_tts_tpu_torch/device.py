"""Device resolution for the port's entry points.

Entry points run on the card unless the caller passes `device="cpu"` (as the
tests do). With no card and no explicit device they raise: nothing falls back
to the CPU quietly.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None → `cuda` (raises without a card); anything else is taken as is,
    and a CUDA device is checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        hint = "" if device is not None else " (pass device='cpu' to run on the CPU)"
        raise RuntimeError(f"no CUDA device is available{hint}")
    return dev

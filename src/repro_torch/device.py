"""Device resolution shared by every entry point of the port.

The port runs on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and asking for ``"cuda"`` where no card is visible raises
instead of falling back, so a run can never report CPU work as card work.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

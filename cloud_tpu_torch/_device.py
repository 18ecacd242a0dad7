"""Device resolution shared by every entry point of the port.

Entry points run on the card unless the caller asks for the CPU: the
default is ``cuda``, ``"cpu"`` is honoured only when passed explicitly,
and a CUDA request on a host without a usable card raises instead of
quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the CPU; any CUDA device is
    checked for availability and raises ``RuntimeError`` if missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


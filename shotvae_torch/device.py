"""Device resolution for the port's entry points.

The port runs on the card. The CPU is taken only when the caller names it
(``device="cpu"``, as the tests do); a missing card is an error, never a
quiet fall-through to the plain PyTorch path.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Raises if a CUDA device is asked for and
    this process sees no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "shotvae_torch runs on a CUDA card and torch sees none; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


"""Input conversion. Port of shotvae_tpu/data/pipeline.py:47-52.

Only ``to_float`` is ported with the serving slice; the resident dataset
and the augmentation come with training.
"""

from __future__ import annotations

import torch


def to_float(images: torch.Tensor, *, normalize: bool = False) -> torch.Tensor:
    """uint8 -> float32 in [0,1] (ToTensor parity) or [-1,1] (Normalize(0.5))."""
    x = images.to(torch.float32) / 255.0
    if normalize:
        x = x * 2.0 - 1.0
    return x

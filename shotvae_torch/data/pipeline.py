"""Input conversion and train-time augmentation. Port of
shotvae_tpu/data/pipeline.py:47-94.

Images are NHWC batches, as in the JAX package; the augmentation runs on
the images' device. The resident dataset comes with the loop slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def to_float(images: torch.Tensor, *, normalize: bool = False) -> torch.Tensor:
    """uint8 -> float32 in [0,1] (ToTensor parity) or [-1,1] (Normalize(0.5))."""
    x = images.to(torch.float32) / 255.0
    if normalize:
        x = x * 2.0 - 1.0
    return x


def augment_batch(images: torch.Tensor, *, pad: int = 4, crop: int = 32,
                  flip: bool = True,
                  generator: Optional[torch.Generator] = None,
                  offsets: Optional[Tuple[torch.Tensor, ...]] = None
                  ) -> torch.Tensor:
    """Reflect-pad + per-sample random crop + per-sample horizontal flip of
    (B, H, W, C) float images -> (B, crop, crop, C).

    Parity: the train transforms Pad(4, reflect) -> RandomCrop(32) ->
    RandomHorizontalFlip. ``generator`` lives on the images' device.
    ``offsets=(off_y, off_x, flip)``, each (B,), replaces the draws, so that
    a test can replay the JAX package's crops; ``flip=False`` ignores the
    third entry.
    """
    b, h, w, _ = images.shape
    padded = F.pad(images.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                   mode="reflect").permute(0, 2, 3, 1)
    if offsets is None:  # uniform over the crop positions, flip at 1/2
        kw = dict(generator=generator, device=images.device)
        offsets = (torch.randint(0, h + 2 * pad - crop + 1, (b,), **kw),
                   torch.randint(0, w + 2 * pad - crop + 1, (b,), **kw),
                   torch.rand((b,), **kw) < 0.5)
    off_y, off_x, do_flip = (torch.as_tensor(t, device=images.device)
                             for t in offsets)
    steps = torch.arange(crop, device=images.device)
    rows = off_y.long()[:, None] + steps[None, :]
    cols = steps[None, :].expand(b, crop)
    if flip:
        cols = torch.where(do_flip.reshape(b, 1).bool(), crop - 1 - cols,
                           cols)
    cols = off_x.long()[:, None] + cols
    batch = torch.arange(b, device=images.device)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]

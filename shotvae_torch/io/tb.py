"""TensorBoard logging with the reference's tag vocabulary. Port of
shotvae_tpu/io/tb.py:16-63.

The scalar tags and the 2x2 ``Raw_Image`` / ``Reconstruct_Image`` grids of
the SHOT-VAE trainer (shotvae_tpu/train/loop.py:398-458) go through
torch's ``SummaryWriter``; where the ``tensorboard`` package is missing,
the writer is a no-op (``live`` is False), as it is where it is not
``enabled`` (a data-parallel run's ranks but the first).
"""

from __future__ import annotations

import numpy as np


def make_image_grid(images: np.ndarray, nrow: int = 2) -> np.ndarray:
    """(N, H, W, C) -> one (H', W', C) grid, as torchvision's make_grid
    lays it out (2-pixel padding of 0)."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    ncol = nrow
    nrow_cells = -(-n // ncol)
    pad = 2
    grid = np.zeros((nrow_cells * (h + pad) + pad, ncol * (w + pad) + pad, c),
                    dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return grid


class TBWriter:
    def __init__(self, log_dir: str, enabled: bool = True):
        SummaryWriter = None
        if enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # tensorboard is not installed
                pass
        self._w = None if SummaryWriter is None else SummaryWriter(
            log_dir=log_dir)
        self.log_dir = log_dir

    @property
    def live(self) -> bool:
        """Whether events are written (``tensorboard`` is installed)."""
        return self._w is not None

    def scalar(self, tag: str, value, step: int):
        if self._w is not None:
            self._w.add_scalar(tag=tag, scalar_value=float(value),
                               global_step=step)

    def image_grid(self, tag: str, images, step: int, nrow: int = 2):
        """``images``: (N, H, W, C) floats in [0, 1], logged as one HWC
        grid."""
        if self._w is None:
            return
        grid = make_image_grid(np.asarray(images), nrow=nrow)
        self._w.add_image(tag=tag, img_tensor=grid, global_step=step,
                          dataformats="HWC")

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()

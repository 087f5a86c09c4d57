"""The resident dataset, input conversion, train-time augmentation and
the host's index streams. Port of shotvae_tpu/data/pipeline.py:23-148.

The whole dataset lives on the card as uint8 NHWC (CIFAR-10's train set is
153.6 MB), and each step gathers its batch there from one host index array:
only the indices cross PCIe. Conversion to float and the augmentation run
on the images' device. The index streams (``epoch_batches``,
``infinite_batches``) are numpy, drawn as the JAX package draws them, so
one seed gives both packages the same batches.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from shotvae_torch.data.datasets import ArrayDataset
from shotvae_torch.device import DeviceLike, resolve_device


class DeviceDataset:
    """uint8 NHWC images and int64 labels resident on one device."""

    def __init__(self, dataset: ArrayDataset, *, device: DeviceLike = None):
        device = resolve_device(device)
        self.images = torch.from_numpy(np.ascontiguousarray(
            dataset.images)).to(device)
        self.labels = torch.from_numpy(np.asarray(dataset.labels,
                                                  np.int64)).to(device)

    def __len__(self):
        return self.images.shape[0]

    def gather(self, indices) -> Tuple[torch.Tensor, torch.Tensor]:
        """(uint8 images, int64 labels) of ``indices`` (host or device
        integers), gathered on the dataset's device: the host sends only
        the indices."""
        idx = torch.as_tensor(indices).to(self.images.device, torch.int64,
                                          non_blocking=True)
        return (self.images.index_select(0, idx),
                self.labels.index_select(0, idx))


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


def epoch_batches(rng: np.random.Generator, indices: np.ndarray,
                  batch_size: int, *, drop_last: bool = True,
                  shuffle: bool = True) -> Iterator[np.ndarray]:
    """One shuffled epoch of index batches; ``drop_last`` drops the ragged
    tail (the unlabeled stream keeps static shapes)."""
    order = rng.permutation(indices) if shuffle else np.asarray(indices)
    limit = (len(order) // batch_size) * batch_size if drop_last \
        else len(order)
    for start in range(0, limit, batch_size):
        yield order[start:start + batch_size]


def infinite_batches(rng: np.random.Generator, indices: np.ndarray,
                     batch_size: int) -> Iterator[np.ndarray]:
    """An endless reshuffled stream of full batches, the reference's
    ``cycle(labeled_loader)``: at the end of the pool it wraps around into a
    reshuffle, looping where the pool is smaller than the batch."""
    if len(indices) == 0:
        raise ValueError("infinite_batches needs a non-empty index set")
    pool = rng.permutation(indices)
    pos = 0
    while True:
        if pos + batch_size <= len(pool):
            yield pool[pos:pos + batch_size]
            pos += batch_size
        else:
            parts = [pool[pos:]]
            need = batch_size - len(parts[0])
            while need > 0:
                pool = rng.permutation(indices)
                take = min(need, len(pool))
                parts.append(pool[:take])
                need -= take
            pos = 0 if len(parts[-1]) == len(pool) else len(parts[-1])
            yield np.concatenate(parts)


def num_batches(n: int, batch_size: int, *, drop_last: bool = True) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)

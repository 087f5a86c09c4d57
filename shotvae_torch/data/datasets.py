"""Raw dataset parsers: MNIST idx, CIFAR pickle, SVHN mat. Port of
shotvae_tpu/data/datasets.py:22-138, plain numpy with the same semantics.

Standard on-disk formats parsed directly (no torchvision), with a
deterministic synthetic stand-in when files are absent and the caller asks
for it. Images are uint8 NHWC and labels int32; conversion to float and
augmentation happen on the device (``shotvae_torch.data.pipeline``).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import NamedTuple

import numpy as np


class ArrayDataset(NamedTuple):
    images: np.ndarray  # (N, H, W, C) uint8
    labels: np.ndarray  # (N,) int32


def _open_maybe_gz(path):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def load_mnist(root: str, train: bool = True) -> ArrayDataset:
    """Parse the idx-ubyte files (the standard 4 files under ``root``, raw
    or ``.gz``)."""
    prefix = "train" if train else "t10k"
    with _open_maybe_gz(os.path.join(root, f"{prefix}-images-idx3-ubyte")) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad idx magic {magic}")
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols,
                                                                 1)
    with _open_maybe_gz(os.path.join(root, f"{prefix}-labels-idx1-ubyte")) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad idx magic {magic}")
        labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
    return ArrayDataset(images, labels)


def _load_cifar_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def load_cifar10(root: str, train: bool = True) -> ArrayDataset:
    """Parse cifar-10-batches-py (data_batch_1..5 / test_batch)."""
    base = os.path.join(root, "cifar-10-batches-py")
    files = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    imgs, labels = [], []
    for name in files:
        d = _load_cifar_pickle(os.path.join(base, name))
        imgs.append(d[b"data"])
        labels.extend(d[b"labels"])
    images = np.concatenate(imgs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(images),
                        np.asarray(labels, np.int32))


def load_cifar100(root: str, train: bool = True) -> ArrayDataset:
    """Parse cifar-100-python (train / test pickles, fine labels)."""
    base = os.path.join(root, "cifar-100-python")
    d = _load_cifar_pickle(os.path.join(base, "train" if train else "test"))
    images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return ArrayDataset(np.ascontiguousarray(images),
                        np.asarray(d[b"fine_labels"], np.int32))


def load_svhn(root: str, train: bool = True, *,
              remap_label_10: bool = True) -> ArrayDataset:
    """Parse train_32x32.mat / test_32x32.mat. ``remap_label_10`` maps
    label 10 to 0, as torchvision does."""
    import scipy.io

    name = "train_32x32.mat" if train else "test_32x32.mat"
    mat = scipy.io.loadmat(os.path.join(root, name))
    images = np.ascontiguousarray(mat["X"].transpose(3, 0, 1, 2))  # HWCN->NHWC
    labels = mat["y"].ravel().astype(np.int32)
    if remap_label_10:
        labels = np.where(labels == 10, 0, labels)
    return ArrayDataset(images, labels)


def synthetic_dataset(num: int, shape=(32, 32, 3), num_classes: int = 10,
                      seed: int = 0) -> ArrayDataset:
    """Deterministic class-structured fake data for tests and benchmarks:
    each class has its own mean image, so the data can be learned."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num).astype(np.int32)
    base = rng.integers(0, 255, (num_classes,) + shape).astype(np.uint8)
    noise = rng.integers(-30, 30, (num,) + shape)
    images = np.clip(base[labels].astype(np.int32) + noise, 0,
                     255).astype(np.uint8)
    return ArrayDataset(images, labels)


_LOADERS = {
    "Cifar10": (load_cifar10, 10, ("dataset", "cifar")),
    "Cifar100": (load_cifar100, 100, ("dataset", "cifar")),
    "SVHN": (load_svhn, 10, ("dataset", "svhn")),
    "Mnist": (load_mnist, 10, ("dataset", "mnist")),
}


def load_dataset(name: str, base_path: str, train: bool = True, *,
                 synthetic_fallback: bool = False,
                 synthetic_size: int = 2048) -> tuple[ArrayDataset, int]:
    """(dataset, num_classes) by the reference's dataset name ('Cifar10',
    ...), under ``<base_path>/dataset/{cifar,svhn,mnist}``. With
    ``synthetic_fallback``, missing files give a synthetic stand-in of
    ``synthetic_size`` samples (seed 0 for train, 1 for test)."""
    loader, num_classes, subdir = _LOADERS[name]
    root = os.path.join(base_path, *subdir)
    try:
        return loader(root, train), num_classes
    except FileNotFoundError:
        if not synthetic_fallback:
            raise
        shape = (32, 32, 1) if name == "Mnist" else (32, 32, 3)
        return (synthetic_dataset(synthetic_size, shape, num_classes,
                                  seed=0 if train else 1), num_classes)

"""The port's data layer against the JAX package's: the parsers on tiny
files of each format, the synthetic set, the splits, the index streams and
the eval batches, array-equal; the resident dataset's gather against numpy
indexing; the config's fields and per-dataset overrides."""

import dataclasses
import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import scipy.io
import torch

from shotvae_tpu import config as jax_config
from shotvae_tpu.data import datasets as jax_datasets
from shotvae_tpu.data import pipeline as jax_pipeline
from shotvae_tpu.data import splits as jax_splits
from shotvae_tpu.train import loop as jax_loop
from shotvae_torch import config as port_config
from shotvae_torch.data import datasets, pipeline, splits
from shotvae_torch.train import loop


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(a, b):
    """Array-equal, and of one dtype, field by field."""
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _write_mnist(root, prefix, images, labels, opener=open, suffix=""):
    os.makedirs(root, exist_ok=True)
    n, h, w, _ = images.shape
    with opener(os.path.join(root, f"{prefix}-images-idx3-ubyte{suffix}"),
                "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, h, w) + images.tobytes())
    with opener(os.path.join(root, f"{prefix}-labels-idx1-ubyte{suffix}"),
                "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _write_cifar(root, rng):
    base10 = os.path.join(root, "cifar-10-batches-py")
    base100 = os.path.join(root, "cifar-100-python")
    for base in (base10, base100):
        os.makedirs(base, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(base10, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (3, 3072), np.uint8),
                         b"labels": rng.integers(0, 10, 3).tolist()}, f)
    for name in ("train", "test"):
        with open(os.path.join(base100, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072), np.uint8),
                         b"fine_labels": rng.integers(0, 100, 4).tolist()}, f)


def _write_svhn(root, rng):
    os.makedirs(root, exist_ok=True)
    for name in ("train_32x32.mat", "test_32x32.mat"):
        scipy.io.savemat(os.path.join(root, name), {
            "X": rng.integers(0, 256, (32, 32, 3, 5), np.uint8),
            "y": np.array([[10], [1], [10], [3], [9]], np.uint8)})


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_mnist_parser_matches_jax(tmp_path, gz, train):
    rng = np.random.default_rng(0)
    prefix = "train" if train else "t10k"
    _write_mnist(str(tmp_path), prefix,
                 rng.integers(0, 256, (5, 28, 28, 1), np.uint8),
                 rng.integers(0, 10, 5).astype(np.uint8),
                 gzip.open if gz else open, ".gz" if gz else "")
    _same(datasets.load_mnist(str(tmp_path), train),
          jax_datasets.load_mnist(str(tmp_path), train))


@pytest.mark.parametrize("train", [True, False])
def test_cifar_and_svhn_parsers_match_jax(tmp_path, train):
    rng = np.random.default_rng(1)
    _write_cifar(str(tmp_path), rng)
    _write_svhn(str(tmp_path / "svhn"), rng)
    for name in ("load_cifar10", "load_cifar100"):
        _same(getattr(datasets, name)(str(tmp_path), train),
              getattr(jax_datasets, name)(str(tmp_path), train))
    got = datasets.load_svhn(str(tmp_path / "svhn"), train)
    _same(got, jax_datasets.load_svhn(str(tmp_path / "svhn"), train))
    assert got.labels.tolist() == [0, 1, 0, 3, 9]  # label 10 -> 0
    _same(datasets.load_svhn(str(tmp_path / "svhn"), train,
                             remap_label_10=False),
          jax_datasets.load_svhn(str(tmp_path / "svhn"), train,
                                 remap_label_10=False))


def test_load_dataset_and_synthetic_match_jax(tmp_path):
    for name in ("Cifar10", "Cifar100", "SVHN", "Mnist"):
        for train in (True, False):
            got, k = datasets.load_dataset(name, str(tmp_path), train,
                                           synthetic_fallback=True,
                                           synthetic_size=96)
            want, kj = jax_datasets.load_dataset(name, str(tmp_path), train,
                                                 synthetic_fallback=True,
                                                 synthetic_size=96)
            assert k == kj
            _same(got, want)
    with pytest.raises(FileNotFoundError):
        datasets.load_dataset("Cifar10", str(tmp_path))
    for seed in (0, 1, 7):
        _same(datasets.synthetic_dataset(50, (8, 8, 3), 5, seed),
              jax_datasets.synthetic_dataset(50, (8, 8, 3), 5, seed))


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_splits_match_jax(seed):
    labels = np.random.default_rng(seed + 10).integers(0, 10, 300).astype(
        np.int32)
    for valid, annotated in ((5, 3), (20, 40), (0, 10)):
        _same(splits.ssl_split(labels, valid, annotated, 10, seed=seed),
              jax_splits.ssl_split(labels, valid, annotated, 10, seed=seed))
    _same(splits.sl_split(labels, 7, 10, seed=seed),
          jax_splits.sl_split(labels, 7, 10, seed=seed))
    np.testing.assert_array_equal(
        splits.labeled_subset_per_class(labels, 40, seed=seed),
        jax_splits.labeled_subset_per_class(labels, 40, seed=seed))


@pytest.mark.parametrize("pool,batch", [(23, 5), (5, 12), (4, 4), (9, 9)])
def test_index_streams_match_jax(pool, batch):
    """epoch_batches (both tails, shuffled or not) and infinite_batches over
    several epochs, the wrap-around where the pool is smaller than the
    batch included, each keyed by [seed, epoch] as the loop keys them."""
    indices = np.arange(100, 100 + pool)
    for epoch in range(3):
        for kw in ({}, {"drop_last": False}, {"shuffle": False}):
            got = list(pipeline.epoch_batches(
                np.random.default_rng([2, epoch]), indices, batch, **kw))
            want = list(jax_pipeline.epoch_batches(
                np.random.default_rng([2, epoch]), indices, batch, **kw))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        it = pipeline.infinite_batches(np.random.default_rng([1, epoch]),
                                       indices, batch)
        jt = jax_pipeline.infinite_batches(np.random.default_rng([1, epoch]),
                                           indices, batch)
        for _ in range(7):
            np.testing.assert_array_equal(next(it), next(jt))
    for drop_last in (True, False):
        assert pipeline.num_batches(pool, batch, drop_last=drop_last) \
            == jax_pipeline.num_batches(pool, batch, drop_last=drop_last)
    with pytest.raises(ValueError):
        next(pipeline.infinite_batches(np.random.default_rng(0),
                                       np.arange(0), batch))


@pytest.mark.parametrize("n,batch", [(100, 32), (64, 64), (5, 8)])
def test_padded_eval_batches_match_jax(n, batch):
    indices = np.random.default_rng(3).permutation(1000)[:n]
    got = list(loop._padded_eval_batches(indices, batch))
    want = list(jax_loop._padded_eval_batches(indices, batch))
    assert len(got) == len(want)
    for (idx, w), (jidx, jw) in zip(got, want):
        np.testing.assert_array_equal(idx, np.asarray(jidx))
        np.testing.assert_array_equal(w, np.asarray(jw))


def test_device_dataset_gather_on_cpu():
    data = datasets.synthetic_dataset(40, (8, 8, 3), 4, seed=2)
    ds = pipeline.DeviceDataset(data, device="cpu")
    assert len(ds) == 40 and ds.images.dtype == torch.uint8
    assert ds.labels.dtype == torch.int64
    for idx in (np.array([0, 5, 39, 5]), torch.tensor([3, 1]),
                np.arange(40)[::-1].copy()):
        images, labels = ds.gather(idx)
        np.testing.assert_array_equal(images.numpy(),
                                      data.images[np.asarray(idx)])
        np.testing.assert_array_equal(labels.numpy(),
                                      data.labels[np.asarray(idx)])


def _defaults(cls):
    return {f.name: (f.default if f.default is not dataclasses.MISSING
                     else f.default_factory())
            for f in dataclasses.fields(cls)}


def test_config_fields_and_overrides_match_jax():
    port = _defaults(port_config.ShotVaeConfig)
    want = _defaults(jax_config.ShotVaeConfig)
    assert list(port) == list(want) and port == want
    for name in ("Cifar10", "Cifar100", "SVHN"):
        for kw in ({}, {"valid_per_class": 7, "annotated_per_class": 3},
                   {"annotated_ratio": 0.25}):
            cfg = port_config.ShotVaeConfig(dataset=name, **kw)
            jcfg = jax_config.ShotVaeConfig(dataset=name, **kw)
            assert dataclasses.asdict(cfg.apply_dataset_overrides()) \
                == dataclasses.asdict(jcfg.apply_dataset_overrides())
            assert cfg.asdict() == jcfg.asdict()
    with pytest.raises(NotImplementedError):
        port_config.ShotVaeConfig(dataset="Mnist").apply_dataset_overrides()

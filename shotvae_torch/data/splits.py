"""Seeded per-class valid / labeled / unlabeled index splits. Port of
shotvae_tpu/data/splits.py:16-77, plain numpy with the same semantics.

For each class: shuffle its indices, take the first ``valid_per_class`` as
validation, the next ``annotated_per_class`` as labeled, and let the
unlabeled pool be everything except the validation part: it includes the
labeled samples, as the reference's samplers do.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SSLSplit(NamedTuple):
    valid: np.ndarray
    labeled: np.ndarray
    unlabeled: np.ndarray


def ssl_split(labels: np.ndarray, valid_per_class: int,
              annotated_per_class: int, num_classes: int, *,
              seed: int = 1) -> SSLSplit:
    """The three-way split of the semi-supervised trainers."""
    rng = np.random.default_rng(seed)
    valid, labeled, unlabeled = [], [], []
    for c in range(num_classes):
        loc = rng.permutation(np.flatnonzero(labels == c))
        valid.extend(loc[:valid_per_class].tolist())
        labeled.extend(
            loc[valid_per_class:valid_per_class + annotated_per_class].tolist())
        unlabeled.extend(loc[valid_per_class:].tolist())
    return SSLSplit(np.asarray(valid, np.int64), np.asarray(labeled, np.int64),
                    np.asarray(unlabeled, np.int64))


class SLSplit(NamedTuple):
    valid: np.ndarray
    train: np.ndarray


def sl_split(labels: np.ndarray, valid_per_class: int, num_classes: int, *,
             seed: int = 1) -> SLSplit:
    """The two-way per-class split of the supervised trainer."""
    rng = np.random.default_rng(seed)
    valid, train = [], []
    for c in range(num_classes):
        loc = rng.permutation(np.flatnonzero(labels == c))
        valid.extend(loc[:valid_per_class].tolist())
        train.extend(loc[valid_per_class:].tolist())
    return SLSplit(np.asarray(valid, np.int64), np.asarray(train, np.int64))


def labeled_subset_per_class(labels: np.ndarray, size_labeled_data: int,
                             num_classes: int = 10, *,
                             seed: int = 1) -> np.ndarray:
    """The one-stage loader's labeled pick: the first n/K shuffled indices
    of each class (its unlabeled pool is the whole train set)."""
    rng = np.random.default_rng(seed)
    indices = rng.permutation(len(labels))
    shuffled_labels = labels[indices]
    mask = np.zeros(len(labels), dtype=bool)
    per_class = int(size_labeled_data / num_classes)
    for c in range(num_classes):
        mask[indices[shuffled_labels == c][:per_class]] = True
    return np.flatnonzero(mask).astype(np.int64)

"""The benchmark's inputs, made from ``--seed`` on the device: synthetic
CIFAR-shaped images and labels, and the model's starting weights.

Both the program and the reference receive these same arrays; neither
makes its own. Every seed gives the same sizes: the labels are a seeded
permutation of equal class counts, so every split and every epoch has the
same number of steps whatever the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TAGS = {"train": 1, "test": 2, "weights": 3, "calls": 4, "sample": 5}


def sub_seed(seed: int, tag: str) -> int:
    """A 64-bit seed for one use of ``seed`` (any whole number >= 0)."""
    return int(np.random.SeedSequence([seed, TAGS[tag]]).generate_state(
        1, np.uint64)[0])


def images_and_labels(seed: int, tag: str, n: int, num_classes: int,
                      shape, device):
    """(n, H, W, C) uint8 images and (n,) int64 labels with n / K of each
    class, from one device generator."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, tag))
    images = torch.randint(0, 256, (n, *shape), generator=gen,
                           device=device, dtype=torch.uint8)
    labels = torch.randperm(n, generator=gen, device=device) % num_classes
    return images, labels


def dataset(seed: int, data: dict, model: dict, device):
    """{"train": (images, labels), "test": (images, labels)} of a
    configuration's ``data`` section."""
    shape = (model["image_size"], model["image_size"],
             model["input_channels"])
    return {split: images_and_labels(seed, split, data[f"{split}_images"],
                                     model["num_classes"], shape, device)
            for split in ("train", "test")}


def _fan_in(shape, kind: str) -> int:
    if kind == "convT":  # (Cin, Cout, kh, kw): the input channels' taps
        return shape[0] * math.prod(shape[2:])
    return shape[1] * math.prod(shape[2:])


def weights(seed: int, spec, device) -> dict:
    """{name: tensor} for ``spec`` ((name, shape, kind) rows): every conv,
    transposed conv and linear weight U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    from one uniform draw over all of them (in name order), biases and BN
    shifts 0, BN scales 1, running means 0 and variances 1, float32; the
    BN counters int64 0."""
    rows = sorted(spec)
    drawn = [r for r in rows if r[2] in ("conv", "convT", "linear")]
    total = sum(math.prod(r[1]) for r in drawn)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                              "weights"))
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, pos = {}, 0
    for name, shape, kind in drawn:
        n = math.prod(shape)
        bound = 1.0 / math.sqrt(_fan_in(shape, kind))
        out[name] = (flat[pos:pos + n] * bound).reshape(shape)
        pos += n
    fill = {"bias": 0.0, "bn_bias": 0.0, "bn_mean": 0.0, "bn_weight": 1.0,
            "bn_var": 1.0}
    for name, shape, kind in rows:
        if kind in fill:
            out[name] = torch.full(shape, fill[kind], device=device)
        elif kind == "bn_count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return out


TRAINABLE = ("conv", "convT", "linear", "bias", "bn_weight", "bn_bias")


def trainable(spec) -> list:
    return sorted(name for name, _, kind in spec if kind in TRAINABLE)

"""Configuration of the SHOT-VAE train step.

The port's own copy of the parts of shotvae_tpu/config.py:17-124
(``ShotVaeConfig``, ``DatasetSpec``, ``apply_dataset_overrides``) that the
port reads: the dataset, the loss schedules, the optimizer and the mixup.
Field names and defaults follow the reference flag names
(main_shot_vae.py:30-106), and ``apply_dataset_overrides`` reproduces the
per-dataset values the reference sets inside ``main()``. Fields of the
reference surface that drive a part the port does not have yet (the loop,
checkpoints, data parallelism) come with the slice that adds it.
``compute_dtype`` is the model's trunk dtype, as shotvae_tpu/train/loop.py:223
picks it from ``bf16``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import torch


@dataclass
class ShotVaeConfig:
    # Dataset parameters
    dataset: str = "Cifar10"
    batch_size: int = 768
    epochs: int = 600
    annotated_ratio: float = 0.1
    valid_per_class: int = 0      # >0 overrides the dataset's valid split size
    annotated_per_class: int = 0  # >0 overrides the labeled split size
    # Reconstruction
    br: bool = False              # BCE reconstruction
    x_sigma: float = 1.0
    # Loss schedule
    cmi: float = 0.0
    dmi: float = 0.0
    kbmc: float = 1e-3
    kbmd: float = 1e-3
    akb: int = 200
    ewm: float = 1e-3
    aew: int = 400
    wrd: float = 1.0
    wmf: float = 0.4
    pwm: float = 1.0
    apw: float = 200.0
    # Optimizer
    lr: float = 0.1
    adjust_lr: List[int] = field(default_factory=lambda: [400, 500, 550])
    wd: float = 5e-4
    # Optimal transport estimation
    epsilon: float = 0.1
    om: bool = False
    # bfloat16 trunk compute (shotvae_tpu/config.py:65; ``--no-bf16`` opts out)
    bf16: bool = True

    def compute_dtype(self) -> Optional[torch.dtype]:
        """The model's ``dtype``: bfloat16 with ``bf16``, else None (f32)."""
        return torch.bfloat16 if self.bf16 else None

    def apply_dataset_overrides(self, *, m2: bool = False) -> "DatasetSpec":
        """Per-dataset hard-coded overrides + dataset facts, in one place."""
        spec = self._dataset_spec(m2=m2)
        if self.valid_per_class:
            spec.valid_per_class = self.valid_per_class
        if self.annotated_per_class:
            spec.annotated_per_class = self.annotated_per_class
        return spec

    def _dataset_spec(self, *, m2: bool) -> "DatasetSpec":
        if self.dataset == "Cifar10":
            self.dmi = 2.3
            if m2:
                self.cmi = 200
            return DatasetSpec("Cifar10", 10, 3, 500,
                               round(4000 * self.annotated_ratio))
        if self.dataset == "Cifar100":
            self.akb = 150
            self.apw = 400
            self.dmi = 4.6
            if m2:
                self.cmi = 1280
            return DatasetSpec("Cifar100", 100, 3, 50,
                               round(400 * self.annotated_ratio))
        if self.dataset == "SVHN":
            self.dmi = 2.3
            if m2:
                self.cmi = 200
            return DatasetSpec("SVHN", 10, 3, 100, 100)
        raise NotImplementedError(f"Dataset {self.dataset} not implemented")


@dataclass
class DatasetSpec:
    name: str
    num_classes: int
    input_channels: int
    valid_per_class: int
    annotated_per_class: int
    small_input: bool = True

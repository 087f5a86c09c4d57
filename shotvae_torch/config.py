"""Configuration of the SHOT-VAE trainer.

The port's own copy of shotvae_tpu/config.py:17-124 (``ShotVaeConfig``,
``DatasetSpec``, ``apply_dataset_overrides``): every field, with the JAX
package's names and defaults, which follow the reference's flag names
(main_shot_vae.py:30-106), and ``apply_dataset_overrides``, the per-dataset
values the reference sets inside ``main()``. ``compute_dtype`` is the
model's trunk dtype, as shotvae_tpu/train/loop.py:223 picks it from
``bf16``. Fields that drive a part the port does not have yet (data
parallelism, multi-step dispatch, the DenseNet) are refused by the loop
(``shotvae_torch.train.loop``), never ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch


@dataclass
class ShotVaeConfig:
    # Dataset parameters
    base_path: str = "."
    dataset: str = "Cifar10"
    image_size: Tuple[int, int] = (32, 32)
    workers: int = 4              # accepted for CLI parity; data is resident
    batch_size: int = 768
    # Train preprocess
    train_time: int = 1
    epochs: int = 600
    start_epoch: int = 0
    dp: bool = True               # reference quirk: --dp *disables* DataParallel
    print_freq: int = 3
    reconstruct_freq: int = 20
    resume: str = ""
    annotated_ratio: float = 0.1
    # Model
    net_name: str = "wideresnet-28-2"
    temperature: float = 0.67
    drop_rate: float = 0.0
    br: bool = False              # BCE reconstruction
    x_sigma: float = 1.0
    ldc: int = 128                # continuous latent dim
    cmi: float = 0.0
    dmi: float = 0.0
    # Loss schedule
    ei: bool = False              # parsed, never used (reference parity)
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
    beta1: float = 0.9
    adjust_lr: List[int] = field(default_factory=lambda: [400, 500, 550])
    wd: float = 5e-4
    # Optimal transport estimation
    epsilon: float = 0.1
    om: bool = False
    gpu: str = ""                 # accepted for CLI parity; one card
    # --- extensions of the JAX package (not in the reference surface) ---
    seed: int = 1
    bf16: bool = True             # bfloat16 trunk compute
    num_devices: Optional[int] = None
    synthetic_data: bool = False  # tests / data-less environments
    yes: bool = False             # skip the interactive run-dir removal prompt
    efficient: bool = False       # densenet remat
    synthetic_size: int = 2048    # synthetic train-set size
    ckpt_every: int = 1           # checkpoint cadence in epochs (1 = parity)
    profile_dir: str = ""         # profiler trace of epoch start+1
    valid_per_class: int = 0      # >0 overrides the dataset's valid split size
    annotated_per_class: int = 0  # >0 overrides the labeled split size
    bn_per_replica: bool = False  # per-replica BN statistics
    steps_per_call: int = 1       # train steps per host dispatch
    global_mixup: bool = False    # with bn_per_replica: global mixup partners

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

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class DatasetSpec:
    name: str
    num_classes: int
    input_channels: int
    valid_per_class: int
    annotated_per_class: int
    small_input: bool = True

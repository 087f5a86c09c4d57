"""Configuration of the SHOT-VAE, M2, classifier and smooth-ELBO trainers.

The port's own copy of shotvae_tpu/config.py:17-169 (``ShotVaeConfig``,
``DatasetSpec``, ``apply_dataset_overrides``, ``ClassifierConfig``,
``SmoothElboConfig``, ``svhn_smooth_defaults``): every
field, with the JAX package's names and defaults, which follow the
reference's flag names (main_shot_vae.py:30-106), and
``apply_dataset_overrides``, the per-dataset values the reference sets
inside ``main()``. ``compute_dtype`` is the model's trunk dtype, as
shotvae_tpu/train/loop.py:223 picks it from ``bf16``. The data-parallel
fields (``dp``, ``num_devices``, ``bn_per_replica``, ``global_mixup``) are
read by ``shotvae_torch.parallel.setup`` and the steps; a field that drives
a part the port does not have yet (multi-step dispatch) is refused by the
loop (``shotvae_torch.train.loop``), never ignored.
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
    gpu: str = ""                 # accepted for CLI parity; torchrun places
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


@dataclass
class ClassifierConfig(ShotVaeConfig):
    """The supervised classifier's surface: the SSL flags with its own
    defaults (main_classifier.py:41, 63)."""

    epochs: int = 500
    adjust_lr: List[int] = field(default_factory=lambda: [300, 350, 400])


@dataclass
class SmoothElboConfig:
    """The one-stage smooth-ELBO trainers' surface
    (main_smooth_ELBO_{mnist,svhn}.py), MNIST's defaults."""

    base_path: str = "."
    latent_spec_cont: int = 10
    latent_spec_disc: Tuple[int, ...] = (10,)
    disc_capacity: Tuple[float, float, int, float] = (0.0, 17.0, 25000, 30.0)
    cont_capacity: Tuple[float, float, int, float] = (0.0, 17.5, 25000, 30.0)
    learning_rate: float = 5e-4
    alpha: float = 50.0
    epochs: int = 300
    size_labeled_data: int = 100
    labeled_batch_size: int = 4
    unlabeled_batch_size: int = 128
    test_batch_size: int = 1000
    path_to_data: str = ""
    gpu: str = ""                 # accepted for CLI parity; one card
    train_time: int = 1
    # --- extensions of the JAX package ---
    seed: int = 1
    synthetic_data: bool = False
    use_plateau_scheduler: bool = False  # SVHN's ReduceLROnPlateau

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def svhn_smooth_defaults() -> SmoothElboConfig:
    """main_smooth_ELBO_svhn.py:16-30's defaults."""
    return SmoothElboConfig(
        latent_spec_cont=32, disc_capacity=(0.0, 50.0, 50000, 1.0),
        cont_capacity=(0.0, 50.0, 50000, 1.0), learning_rate=1e-3,
        alpha=1500.0, epochs=500, size_labeled_data=1000,
        labeled_batch_size=512, unlabeled_batch_size=256, test_batch_size=128,
        use_plateau_scheduler=True)

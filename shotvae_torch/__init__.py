"""shotvae_torch: the PyTorch / NVIDIA H100 port of shotvae_tpu.

The JAX package ``shotvae_tpu`` is the reference this package is held
against; nothing here imports it, nor JAX. It covers eval-mode serving of
the SHOT-VAE (``shotvae_torch.api.ShotVaeInference``), its training step
and eval step (``shotvae_torch.train.steps``) and the training loop around
them (``shotvae_torch.train.loop``, ``python -m
shotvae_torch.cli.main_shot_vae``), the M2 and supervised-classifier
baselines (``python -m shotvae_torch.cli.main_m2_vae``, ``python -m
shotvae_torch.cli.main_classifier``) and the one-stage smooth-ELBO
trainers (``python -m shotvae_torch.cli.main_smooth_elbo_mnist``, ``python
-m shotvae_torch.cli.main_smooth_elbo_svhn``): the WideResNet,
PreActResNet and DenseNet encoders, the classifiers, the DCGAN decoder,
the smooth VAEs, the latent draw, losses, mixup, schedules, augmentation,
the datasets resident on the card, checkpoints and TensorBoard logging,
and the pairwise distance metrics (``shotvae_torch.utils``), with
hand-written Hopper kernels on the BatchNorm and sampling paths
(``shotvae_torch.ops.kernels``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version instead (``shotvae_torch.device.resolve_device``).
"""

from shotvae_torch.device import resolve_device

__all__ = ["resolve_device"]

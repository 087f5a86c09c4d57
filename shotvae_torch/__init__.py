"""shotvae_torch: the PyTorch / NVIDIA H100 port of shotvae_tpu.

The JAX package ``shotvae_tpu`` is the reference this package is held
against; nothing here imports it, nor JAX. It covers eval-mode serving of
the SHOT-VAE (``shotvae_torch.api.ShotVaeInference``), its training step
and eval step (``shotvae_torch.train.steps``) and the training loop around
them (``shotvae_torch.train.loop``, ``python -m
shotvae_torch.cli.main_shot_vae``): the WRN encoder, the DCGAN decoder, the
latent draw, losses, mixup, schedules, augmentation, the datasets resident
on the card, checkpoints and TensorBoard logging, with hand-written Hopper
kernels on the path (``shotvae_torch.ops.kernels``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version instead (``shotvae_torch.device.resolve_device``).
"""

from shotvae_torch.device import resolve_device

__all__ = ["resolve_device"]

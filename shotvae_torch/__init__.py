"""shotvae_torch: the PyTorch / NVIDIA H100 port of shotvae_tpu.

The JAX package ``shotvae_tpu`` is the reference this package is held
against; nothing here imports it, nor JAX. It covers eval-mode serving of
the SHOT-VAE (``shotvae_torch.api.ShotVaeInference``) and its training
step and eval step (``shotvae_torch.train.steps``): the WRN encoder, the
DCGAN decoder, the latent draw, losses, mixup, schedules and augmentation,
with hand-written Hopper kernels on the path (``shotvae_torch.ops.kernels``).

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch
version instead (``shotvae_torch.device.resolve_device``).
"""

from shotvae_torch.device import resolve_device

__all__ = ["resolve_device"]
